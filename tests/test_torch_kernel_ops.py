"""The kernel entries as ``torch.library`` ops (``paddle_tpu_torch/kernels/
_ops.py``): every row of the kernel table has a ``paddle_tpu::*`` op with
a CPU implementation (the plain version), a CUDA one (the launch) and a
fake; ``torch.library.opcheck`` passes on the CPU implementations at
float32, with int8 caches and int8 / int4 weights (schema, aliasing and
mutation, the fake's shapes, dtypes and strides against the real
outputs, a dynamic-shape trace);
each op's CPU output is the plain version's; a trace over fake tensors
reaches the fakes; ``torch.export`` keeps the ops as nodes. The ops
against their kernels on the card are ``chip_smoke.py``'s ``kernel ops``
phase; the plain versions against JAX are the kernel modules' own tests.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.kernels import _ops
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import group_norm as tgn
from paddle_tpu_torch.kernels import mha as tm
from paddle_tpu_torch.kernels import op_samples
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.kernels import selective_scan as tss

# float32 here (the card's phase checks every dtype its library is built
# for: float32, float16 and bfloat16)
SAMPLES = list(op_samples.samples("cpu"))


def _id(i):
    name, args = SAMPLES[i]
    kinds = {str(a.dtype).split(".")[1] for a in args
             if isinstance(a, torch.Tensor) and a.is_floating_point()
             or isinstance(a, torch.Tensor) and a.dtype == torch.int8}
    return f"{name}-{'-'.join(sorted(kinds))}-{i}"


def test_every_row_has_an_op_with_three_implementations():
    rows = {row for row, _ in _ops.OPS.values()}
    assert rows == set(range(1, 14))
    # row 10 has its forward with and without states
    assert len(_ops.OPS) == 14
    for name in _ops.OPS:
        qual = f"paddle_tpu::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), \
                (name, key)
    mutating = {name for name, (_, op) in _ops.OPS.items()
                if any(a.is_write for a in op._schema.arguments
                       if a.alias_info is not None)}
    assert mutating == {"fused_contiguous_decode", "fused_paged_decode"}


@pytest.mark.parametrize("i", range(len(SAMPLES)),
                         ids=[_id(i) for i in range(len(SAMPLES))])
def test_opcheck_on_the_cpu_implementation(i):
    name, args = SAMPLES[i]
    result = torch.library.opcheck(_ops.OPS[name][1], args)
    assert set(result.values()) == {"SUCCESS"}, result


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def test_each_op_on_the_cpu_is_its_plain_version():
    """The op, through its wrapper, gives the plain version's outputs
    bit for bit; the decode ops append into the caches as the plain
    versions do."""
    for name, args in SAMPLES:
        got_args, want_args = _clone(args), _clone(args)
        got = _ops.OPS[name][1](*got_args)
        if name == "flash_forward":
            want = tm.mha_forward_plain(*want_args[:3], want_args[5],
                                        want_args[6])[0]
        elif name == "flash_forward_lse":
            want = tm.mha_forward_plain(*want_args[:3], want_args[5],
                                        want_args[6])
        elif name == "flash_bwd_dq":
            want = tm.mha_bwd_dq_plain(*want_args[:6], want_args[8],
                                       want_args[9])
        elif name == "flash_bwd_dkv":
            want = tm.mha_bwd_dkv_plain(*want_args[:6], want_args[8],
                                        want_args[9])
        elif name == "flash_bwd_fused":
            want = tm.mha_bwd_fused_plain(*want_args[:6], want_args[8],
                                          want_args[9], span=want_args[11])
        elif name == "fused_contiguous_decode":
            want = tda.fused_contiguous_decode_plain(*want_args)[0]
        elif name == "fused_paged_decode":
            want = tpa.fused_paged_decode_plain(*want_args)[0]
        elif name == "paged_decode":
            want = tpa.paged_decode_plain(*want_args)
        elif name == "weight_only_matmul":
            x, qw, sc, gs, wd = want_args
            want = tqm.weight_only_matmul_plain(x, qw, sc, group_size=gs,
                                                weight_dtype=wd)
        elif name.startswith("selective_scan_fwd"):
            want = tss.selective_scan_fwd_plain(
                *want_args, name.endswith("states"))
        elif name == "selective_scan_bwd":
            want = tss.selective_scan_bwd_plain(*want_args)
        elif name == "group_norm_fwd":
            want = tgn.group_norm_fwd_plain(*want_args)
        else:
            want = tgn.group_norm_bwd_plain(*want_args)
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        assert len(gots) == len(wants), name
        for g, w in zip(gots, wants):
            assert torch.equal(g, w), name
        for g, w in zip(got_args, want_args):
            if isinstance(g, torch.Tensor):
                assert torch.equal(g, w), name  # the same appends


def test_a_trace_over_fake_tensors_reaches_the_fakes():
    """Attention forward and backward over fake tensors: the wrappers
    reach the ops' fakes (rows 6 and 8 here), which give the launches'
    shapes, and no kernel or plain version runs."""
    before = dict(_ops.FAKE_CALLS)
    with FakeTensorMode():
        q = torch.empty(2, 256, 4, 64, requires_grad=True)
        k = torch.empty(2, 256, 2, 64, requires_grad=True)
        v = torch.empty(2, 256, 2, 64, requires_grad=True)
        o = tm.mha(q, k, v, causal=True)
        o.sum().backward()
        assert o.shape == q.shape and q.grad.shape == q.shape
        assert k.grad.shape == k.shape and v.grad.shape == v.shape
        x3 = torch.empty(2, 16, 64)
        y, mean, rstd = tgn.group_norm_fwd(x3, torch.empty(64),
                                           torch.empty(64), 8, 1e-5)
        assert y.shape == x3.shape and mean.shape == (2, 8)
    grew = {n: _ops.FAKE_CALLS[n] - before[n] for n in before}
    assert grew["flash_forward_lse"] == 1 and grew["flash_bwd_fused"] == 1
    assert grew["group_norm_fwd"] == 1 and grew["flash_forward"] == 0


def test_export_keeps_the_ops_as_nodes():
    """A module calling the kernel wrappers exports with the ops as call
    nodes (on the CPU they run their plain versions), and the exported
    program gives the eager outputs."""

    class Attn(torch.nn.Module):
        def forward(self, q, k, v):
            return tm.mha(q, k, v, causal=True)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 32, generator=g) for _ in range(3))
    with torch.no_grad():
        ep = torch.export.export(Attn(), (q, k, v))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("paddle_tpu.flash_forward.default") == 1
        assert torch.equal(ep.module()(q, k, v), Attn()(q, k, v))
