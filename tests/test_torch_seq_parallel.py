"""The port's sequence (context) parallelism against the JAX package's,
over the 4-rank gloo pool (``tests/torch_dist_pool.py``, jobs in
``tests/torch_dist_jobs.py``) and ``jax.devices()[:4]``:
``kernels/ring_attention.py`` at sep 2 and 4 in its three layouts
(non-causal, zigzag causal, contiguous causal for an odd local chunk),
forward and gradients, and its bodies driven in one process
(``run_ring_virtual``); ``kernels/ulysses.py`` at sep 2 and 4 and at sep
2 x tp 2, where the kv heads (or all heads) do not divide over sep; and
``TrainStep`` trajectories of the tiny Llama at dp 2 x sep 2 (ring and
Ulysses, the ``-100`` labels on the chunk boundaries), at cp 4 (ring)
and at sep 2 x tp 2, against the JAX ``TrainStep`` on the same mesh.
The JAX ring runs its dense ``_attn_lse`` blocks on the CPU; the port's
run the plain versions of rows 6-9.

Tolerances (float32 both sides): attention outputs rtol 1e-5 with atol
1e-6; their gradients rtol 1e-5 with atol 1e-5 (the flash backward's
``delta = rowsum(do * o)`` leaves float32 rounding, 2.5e-6 seen, where
JAX's autodiff of a query that sees one key gives an exact 0); losses
along a 5-step trajectory rtol 1e-5, the parameters after it rtol 1e-4
with atol 5e-6 (AdamW's normalised step on near-zero gradients)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import models as jmodels
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.sharding import mesh_context
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.distributed.strategy import HybridConfig as JHybrid
from paddle_tpu.kernels.ring_attention import ring_attention as jring
from paddle_tpu.kernels.ulysses import ulysses_attention as julysses
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch.kernels import ring_attention as tring
from paddle_tpu_torch.kernels.flash_attention import _reference_attention

import torch_dist_jobs as jobs
import torch_dist_pool as tdp

N = 4
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
OPT = dict(learning_rate=1e-3, weight_decay=0.01, epsilon=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(N, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jmesh(**kw):
    need = int(np.prod(list(kw.values())))
    return jdist.build_mesh(devices=jax.devices()[:need], **kw)


def _qkv(seed, b, s, h, d, hk=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, d)).astype(f),
            rng.standard_normal((b, s, hk or h, d)).astype(f),
            rng.standard_normal((b, s, hk or h, d)).astype(f))


def _jax_attention(fn, q, k, v, mesh):
    """The JAX attention's output and the gradients of sum(out**2)."""
    sh = NamedSharding(mesh, P(None, "sep", None, None))

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out ** 2), out

    with mesh_context(mesh):
        (_, out), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jax.device_put(jnp.asarray(t), sh) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in g]


def _check_blocks(got, out, grads, n, tp=1):
    for res in got:
        if res is None:
            continue
        c, t = res["sep"], res["tp"]

        def block(a):
            h = a.shape[2] // tp
            a = a[:, :, t * h:(t + 1) * h]
            s = a.shape[1] // n
            return a[:, c * s:(c + 1) * s]

        np.testing.assert_allclose(res["out"], block(out), **OUT)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(res[name], block(g), err_msg=name,
                                       **GRAD)


@pytest.mark.parametrize("n,s,causal", [
    (4, 32, True), (4, 32, False), (2, 32, True), (4, 12, True),
    (2, 6, True)],
    ids=["sep4-zigzag", "sep4-plain", "sep2-zigzag", "sep4-contiguous",
         "sep2-contiguous"])
def test_ring_attention_matches_jax(pool, n, s, causal):
    q, k, v = _qkv(n + s, 2, s, 2, 16)
    mesh = _jmesh(sep=n)
    out, grads = _jax_attention(
        lambda q, k, v: jring(q, k, v, mesh=mesh, causal=causal), q, k, v,
        mesh)
    kind = tring.layout(n, s // n, causal)
    assert kind == ("plain" if not causal else
                    "zigzag" if (s // n) % 2 == 0 else "contiguous")
    got = pool.run(jobs.attention_job, "ring", q, k, v, causal, n, True)
    _check_blocks(got, out, grads, n)


def test_ring_bodies_in_one_process_match_whole_attention():
    """``run_ring_virtual``: the bodies of 4 virtual ranks, forward and
    backward, against one dense attention and its autograd gradients
    (grouped-query heads, every layout)."""
    n = 4
    for s, causal in ((32, True), (32, False), (12, True)):
        q, k, v = (torch.as_tensor(t) for t in _qkv(7, 1, s, 4, 16, hk=2))
        kind = tring.layout(n, s // n, causal)
        scale = 16 ** -0.5
        sl = s // n
        blocks = [tuple(t[:, r * sl:(r + 1) * sl] for t in (q, k, v))
                  for r in range(n)]
        fwd = tring.run_ring_virtual([
            tring.ring_forward_body(kind, *blocks[r], r, n, scale)
            for r in range(n)])
        out = torch.cat([o for o, _ in fwd], dim=1)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        want = _reference_attention(qr, kr, vr, causal=causal)
        torch.testing.assert_close(out, want, **OUT)
        do = torch.as_tensor(np.random.default_rng(s).standard_normal(
            tuple(q.shape)).astype(np.float32))
        (want * do).sum().backward()
        bwd = tring.run_ring_virtual([
            tring.ring_backward_body(kind, fwd[r][1],
                                     do[:, r * sl:(r + 1) * sl], r, n, scale)
            for r in range(n)])
        for i, ref in enumerate((qr.grad, kr.grad, vr.grad)):
            torch.testing.assert_close(
                torch.cat([g[i] for g in bwd], dim=1), ref, **GRAD)


@pytest.mark.parametrize("n,tp,h,hk", [(2, 1, 4, 4), (4, 1, 4, 2),
                                       (4, 1, 2, 2), (2, 2, 4, 2)],
                         ids=["sep2", "sep4-kv-gathered", "sep4-all-gathered",
                              "sep2-tp2"])
def test_ulysses_attention_matches_jax(pool, n, tp, h, hk):
    q, k, v = _qkv(n * tp, 2, 16, h, 16, hk=hk)
    mesh = _jmesh(sep=n, tp=tp)
    out, grads = _jax_attention(
        lambda q, k, v: julysses(q, k, v, causal=True, use_flash=False),
        q, k, v, mesh)
    got = pool.run(jobs.attention_job, "ulysses", q, k, v, True, n, True,
                   tp)
    assert sum(r is not None for r in got) == n * tp
    _check_blocks(got, out, grads, n, tp)


def _batch():
    """4 rows of 32 tokens; -100 labels on the chunk boundaries at sep 2
    (position 16) and 4 (8, 16, 24) and around them, unevenly."""
    ids = np.random.default_rng(0).integers(0, 256, (4, 32))
    labels = ids.copy()
    labels[0, 15:18] = -100
    labels[1, 8] = -100
    labels[1, 24:] = -100
    labels[2, 16] = -100
    labels[3, 1:9] = -100
    return {"input_ids": ids, "labels": labels}


@pytest.mark.parametrize("mesh_kw,mode", [
    (dict(dp=2, sep=2), "ring"), (dict(dp=2, sep=2), "ulysses"),
    (dict(cp=4), "ring"), (dict(sep=2, tp=2), "ulysses")],
    ids=["dp2-sep2-ring", "dp2-sep2-ulysses", "cp4-ring",
         "sep2-tp2-ulysses"])
def test_train_step_over_sep_matches_jax(pool, mesh_kw, mode):
    cfg = dict(sep_attention=mode, use_flash_attention=False)
    pt.seed(5)
    jmodel = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    sep = mesh_kw.get("sep", 1) * mesh_kw.get("cp", 1)
    s = JStrategy()
    s.hybrid_configs = JHybrid(dp_degree=mesh_kw.get("dp", 1),
                               mp_degree=mesh_kw.get("tp", 1),
                               sep_degree=sep)
    mesh = _jmesh(dp=mesh_kw.get("dp", 1), sep=sep, tp=mesh_kw.get("tp", 1))
    ts = JTrainStep(jmodel, jopt.AdamW(
        grad_clip=jopt.ClipGradByGlobalNorm(1.0), **OPT), mesh, s)
    batch = _batch()
    losses = [float(ts.run(ts.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}))) for _ in range(5)]
    params = {n: np.asarray(v) for n, v in ts.state_dict()["params"].items()}
    got = pool.run(jobs.sep_train_job, mesh_kw, state, cfg, batch, 5, OPT)
    for res in got:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        for n, w in params.items():
            np.testing.assert_allclose(res["params"][n], w, rtol=1e-4,
                                       atol=5e-6, err_msg=n)
        # the sequence is cut over sep, the labels shifted before the cut
        rows = 4 // mesh_kw.get("dp", 1)
        assert res["local_batch"] == {"input_ids": (rows, 32 // sep),
                                      "shifted_labels": (rows, 32 // sep)}
    assert losses[-1] < losses[0]
