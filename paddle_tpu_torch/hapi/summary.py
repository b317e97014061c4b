"""Model introspection (counterpart of ``paddle_tpu/hapi/summary.py``;
parity: ``paddle.summary`` / ``paddle.flops``,
python/paddle/hapi/model_summary.py and hapi/dynamic_flops.py).

Forward post-hooks on the leaf layers over one shape-only pass: the
network runs once on the ``meta`` device (``torch.func.functional_call``
with meta copies of its parameters and buffers and meta inputs), which
allocates and computes nothing, so summarizing a full-width model costs
nothing and leaves the model where it is. JAX runs the same pass under
``jax.eval_shape``. The table and the counts are JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod


def _norm_sizes(sz):
    """Accept one shape (tuple or list of ints) or a list of shapes."""
    if sz is None:
        return None
    if isinstance(sz, (tuple, list)) and sz and all(
            isinstance(i, int) for i in sz):
        return [tuple(sz)]
    return [tuple(s) for s in sz]


def _shapes_of(out):
    if hasattr(out, "shape"):
        return [tuple(int(d) for d in out.shape)]
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(_shapes_of(o))
        return res
    return []


def _n(p) -> int:
    return int(np.prod(tuple(p.shape)))


def _trainable(p) -> bool:
    return bool(getattr(p, "trainable", p.requires_grad))


def _collect(net, input_spec, dtypes, kwargs):
    """One meta-device pass recording (layer, output shapes) per leaf."""
    records = []
    handles = []
    targets = [(n, m) for n, m in net.named_modules() if m is not net]
    if not targets:              # the net itself is a single leaf layer
        targets = [("", net)]
    for name, sub in targets:
        if sub._modules:         # only leaves get rows (reference style)
            continue

        def mk(name, sub):
            def hook(lyr, inputs, out):
                params = [p for p in sub._parameters.values()
                          if p is not None]
                records.append({
                    "name": name,
                    "type": type(sub).__name__,
                    "out": _shapes_of(out),
                    "params": int(sum(_n(p) for p in params)),
                    # MAC-bearing params only (weight matrices and
                    # filters, ndim >= 2): paddle.flops counts
                    # 2 * tokens * in * out and excludes bias vectors
                    "mac_params": int(sum(_n(p) for p in params
                                          if len(p.shape) >= 2)),
                    "data_format": getattr(sub, "data_format", "NCHW"),
                    "in": _shapes_of(inputs),
                })
                return out

            return hook

        handles.append(sub.register_forward_hook(mk(name, sub)))

    try:
        args = [torch.empty(s, dtype=d, device="meta")
                for s, d in zip(input_spec, dtypes)]
        values = {n: torch.empty_like(t, device="meta")
                  for n, t in [*net.named_parameters(),
                               *net.named_buffers()]}
        with torch.no_grad():
            torch.func.functional_call(net, values, tuple(args), kwargs)
    finally:
        for h in handles:
            h.remove()
    return records


def _dtypes(dtypes, n):
    dts = dtypes or [torch.float32] * n
    if not isinstance(dts, (list, tuple)):
        dts = [dts] * n
    return [dtype_mod.convert_dtype(d) for d in dts]


def summary(net, input_size=None, dtypes=None, input=None,  # noqa: A002
            **kwargs):
    """Parity: paddle.summary: prints the layer table, returns
    {'total_params', 'trainable_params'}."""
    if input is not None:
        given = input if isinstance(input, (tuple, list)) else [input]
        specs = [tuple(np.shape(x)) for x in given]
        dts = [x.dtype if isinstance(x, torch.Tensor)
               else dtype_mod.convert_dtype(np.asarray(x).dtype)
               for x in given]
    else:
        specs = _norm_sizes(input_size)
        dts = _dtypes(dtypes, len(specs))
    records = _collect(net, specs, dts, kwargs)

    header = f"{'Layer (type)':<38}{'Output Shape':<26}{'Param #':>12}"
    sep = "=" * len(header)
    lines = [sep, header, sep]
    for r in records:
        shape = str(r["out"][0] if len(r["out"]) == 1 else r["out"])
        lines.append(
            f"{r['name'] + ' (' + r['type'] + ')':<38}"
            f"{shape:<26}{r['params']:>12,}")
    all_params = int(sum(_n(p) for _, p in net.named_parameters()))
    trainable = int(sum(_n(p) for _, p in net.named_parameters()
                        if _trainable(p)))
    lines += [sep,
              f"Total params: {all_params:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {all_params - trainable:,}",
              sep]
    print("\n".join(lines))
    return {"total_params": all_params, "trainable_params": trainable}


_FLOP_RULES = {}


def _rule(*type_names):
    def deco(fn):
        for t in type_names:
            _FLOP_RULES[t] = fn
        return fn

    return deco


@_rule("Linear", "ColumnParallelLinear", "RowParallelLinear")
def _linear_flops(rec):
    out = rec["out"][0]
    # 2 * tokens * in * out: weight MACs only, bias add excluded
    tokens = int(np.prod(out[:-1])) if len(out) > 1 else 1
    return 2 * tokens * rec["mac_params"]


@_rule("Conv2D", "Conv1D", "Conv3D", "Conv2DTranspose")
def _conv_flops(rec):
    out = rec["out"][0]
    # batch * spatial positions, layout-aware (channels at index 1 for
    # the NCHW family, last otherwise)
    ch_axis = 1 if rec.get("data_format", "NCHW").startswith("NC") else -1
    spatial = int(np.prod(out)) // out[ch_axis]
    return 2 * spatial * rec["mac_params"]


@_rule("Embedding", "VocabParallelEmbedding")
def _emb_flops(rec):
    return 0


def flops(net, input_size, dtypes=None, print_detail=False, **kwargs):
    """Parity: paddle.flops: a MAC-based FLOPs estimate from one
    shape-only pass (matmul-bearing leaves; normalizations and
    activations count 0, the reference's dominant-term accounting)."""
    input_size = _norm_sizes(input_size)
    records = _collect(net, input_size, _dtypes(dtypes, len(input_size)),
                       kwargs)
    total = 0
    for r in records:
        rule = _FLOP_RULES.get(r["type"])
        if rule is not None and r["out"]:
            f = int(rule(r))
            total += f
            if print_detail:
                print(f"{r['name']:<40}{r['type']:<20}{f:>16,}")
    if print_detail:
        print(f"{'Total FLOPs:':<60}{total:>16,}")
    return total
