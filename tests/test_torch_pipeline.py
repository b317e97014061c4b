"""The port's pipeline parallelism (``paddle_tpu_torch/distributed/
pipeline.py``) against the JAX package's, over the 4-rank gloo pool
(``tests/torch_dist_pool.py``; jobs in ``tests/torch_dist_jobs.py``) and
``jax.devices()[:4]``: GPipe (``pipeline_apply``) at pp 4, forward and
gradients; ``PipelineLayer``'s forward at pp 4; ``pipeline_1f1b_step``
at pp 4 for vpp 1 and 2 over several micro-batch counts and at (pp 2,
vpp 3); the 1F1B bound on micro-batches in flight; cost-balanced segmentation and ``seg_method``/``cost_fn``; the
heterogeneous module with a tied embedding, its forward over pp and its
``PipelineTrainStep`` trajectories under 1F1B, VPP and F-then-B
(uniform and not, one with dp 2), and its state moved between the
packages by their checkpoints; and the Llama pipeline module at pp 2,
pp 2 x tp 2, pp 2 x fsdp 2 at ZeRO-3 with recompute, and dp 2 x pp 2
under VPP, against JAX's ``PipelineTrainStep`` trajectory.

Tolerances (float32 both sides, the two frameworks' matmuls summing in
other orders): forward values rtol 1e-5 with atol 1e-6 (five float32
layers already differ by 5e-6 relative, so 1e-6 does not hold); one
step's gradients rtol 1e-5 with atol 1e-6; losses along a trajectory
rtol 1e-5, and the parameters after it rtol 1e-4 (atol 1e-6), as the
mesh trajectories of ``tests/test_torch_dist_train.py`` are held, with
atol 5e-6 after the Llama's AdamW steps (its normalised step moves an
entry whose gradient is near zero by float32 rounding: 3.7e-6 seen, on
one entry of 8192)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import llama_pipeline_module as jllama_pipe
from paddle_tpu_torch.distributed import pipeline as tpipe

import torch_dist_jobs as jobs
import torch_dist_pool as tdp

N = 4
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=1e-4, atol=1e-6)
ADAM_PARAMS = dict(rtol=1e-4, atol=5e-6)
H = 16


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(N, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jmesh(**kw):
    need = int(np.prod(list(kw.values())))
    return jdist.build_mesh(devices=jax.devices()[:need], **kw)


def _got(results):
    return [r for r in results if r is not None]


# ---------------------------------------------------------------------------
# GPipe and PipelineLayer
# ---------------------------------------------------------------------------
def _stage_fn(w, mb):
    return jnp.tanh(mb @ w)


def test_pipeline_apply_forward_and_grads_match_jax(pool):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N, 8, 8)) * 0.5).astype(np.float32)
    mesh = _jmesh(pp=N)
    x = rng.standard_normal((4, 2, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda ws, x: jpipe.pipeline_apply(
        _stage_fn, ws, x, mesh=mesh, n_micro=4))(jnp.asarray(ws),
                                                  jnp.asarray(x)))
    got = pool.run(jobs.pipeline_apply_job, ws, x, 4)
    np.testing.assert_allclose(got[-1]["ys"], want, **FWD)
    assert all(r["ys"] is None for r in got[:-1])
    # the gradients of sum(y**2) by each stage's weight
    x = rng.standard_normal((2, 2, 8)).astype(np.float32)
    g = np.asarray(jax.jit(jax.grad(lambda ws: jnp.sum(jpipe.pipeline_apply(
        _stage_fn, ws, jnp.asarray(x), mesh=mesh, n_micro=2) ** 2)))(
            jnp.asarray(ws)))
    got = pool.run(jobs.pipeline_apply_job, ws, x, 2)
    for s, r in enumerate(got):
        np.testing.assert_allclose(r["gw"], g[s], **GRAD)


def test_pipeline_layer_forward_matches_jax(pool):
    pt.seed(77)
    trunk = jpipe.PipelineLayer(jpipe.LayerDesc(jnn.Linear, 16, 16),
                                num_layers=8, num_stages=4)
    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    want = np.asarray(trunk(jnp.asarray(x)))  # no mesh: the layers in turn
    stacked = {k: np.asarray(v) for k, v in trunk.stage_params().items()}
    got = _got(pool.run(jobs.pipeline_layer_job, stacked, x, 2, 4))
    assert len(got) == 1
    np.testing.assert_allclose(got[0], want, **FWD)


# ---------------------------------------------------------------------------
# pipeline_1f1b_step
# ---------------------------------------------------------------------------
def _first_fn(fp, x):
    return jnp.tanh(x @ fp["emb"])


def _jstage_fn(cp, h):
    return jnp.tanh(h @ cp["w"] + cp["b"])


def _last_fn(lp, y, aux):
    return jnp.mean((y @ lp["head"] - aux) ** 2)


@pytest.mark.parametrize("pp,vpp,n_micro", [(4, 1, 6), (4, 2, 5), (4, 1, 2),
                                            (2, 3, 4)])
def test_1f1b_step_matches_jax(pool, pp, vpp, n_micro):
    V = pp * vpp
    rng = np.random.default_rng(vpp + n_micro)
    f32 = np.float32
    fp = {"emb": (rng.standard_normal((8, H)) * 0.3).astype(f32)}
    sp = {"w": (rng.standard_normal((V, H, H)) * 0.3).astype(f32),
          "b": (rng.standard_normal((V, H)) * 0.1).astype(f32)}
    lp = {"head": (rng.standard_normal((H, 4)) * 0.3).astype(f32)}
    x = rng.standard_normal((n_micro, 2, 8)).astype(f32)
    aux = rng.standard_normal((n_micro, 2, 4)).astype(f32)
    j = jax.tree_util.tree_map(jnp.asarray, (fp, sp, lp, x, aux))
    loss, dfp, dsp, dlp = jpipe.pipeline_1f1b_step(
        _first_fn, _jstage_fn, _last_fn, *j, mesh=_jmesh(pp=pp), vpp=vpp)
    got = _got(pool.run(jobs.f1b_job, fp, sp, lp, x, aux, pp, vpp))
    assert len(got) == pp
    for r in got:
        np.testing.assert_allclose(r["loss"], float(loss), **FWD)
        np.testing.assert_allclose(r["dfp"]["emb"], np.asarray(dfp["emb"]),
                                   **GRAD)
        np.testing.assert_allclose(r["dlp"]["head"],
                                   np.asarray(dlp["head"]), **GRAD)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["dsp"][k],
                                       np.asarray(dsp[k])[r["vs"]], **GRAD)


class _InFlight(torch.autograd.Function):
    """Counts the micro-batches whose forward ran and backward did not."""
    live = 0
    peak = 0

    @staticmethod
    def forward(ctx, x):
        _InFlight.live += 1
        _InFlight.peak = max(_InFlight.peak, _InFlight.live)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _InFlight.live -= 1
        return g


@pytest.mark.parametrize("vpp", [1, 2, 3])
def test_1f1b_keeps_micro_batches_in_flight_bounded(vpp):
    """The 1F1B property (JAX's ``test_1f1b_memory_independent_of_
    n_micro``, counted here at the schedule rather than in XLA's memory
    analysis): the micro-batches between their forward and their
    backward on a rank holding all V virtual stages stay as many at 16
    micro-batches as at 4, and within V**2 (virtual stage v holds at
    most 2 (V-1-v) + 1); F-then-B holds all V x n."""
    w = torch.nn.Parameter(torch.eye(4))
    peak = {}
    for f_then_b in (False, True):
        for n in (4, 16):
            _InFlight.live = _InFlight.peak = 0
            tpipe.run_schedule(
                tpipe._Local(), vpp, n, f_then_b,
                lambda f: torch.ones((2, 4)) * (f + 1),
                lambda v, h: _InFlight.apply(h @ w),
                lambda y, f: y.square().mean(), ((2, 4), torch.float32,
                                                 "cpu"), 1.0 / n)
            assert _InFlight.live == 0
            peak[f_then_b, n] = _InFlight.peak
    assert peak[False, 4] == peak[False, 16] <= vpp * vpp
    assert (peak[True, 4], peak[True, 16]) == (vpp * 4, vpp * 16)


def test_segment_layers_match_jax():
    for costs, parts in [([1] * 8, 4), ([10, 1, 1, 1], 2), ([1, 1, 1, 10], 2),
                         ([0, 0, 0, 5], 4), ([3, 1, 4, 1, 5, 9, 2, 6], 3),
                         ([1.0] * 7, 2)]:
        assert tpipe.segment_layers(costs, parts) == \
            jpipe.segment_layers(costs, parts)
    with pytest.raises(ValueError):
        tpipe.segment_layers([1, 2], 3)
    for costs in ([1.0] * 5, [2.0, 1.0, 1.0, 3.0, 1.0, 1.0]):
        plan, jplan = tpipe.SegmentPlan(costs, 2), jpipe.SegmentPlan(costs, 2)
        assert (plan.bounds, plan.sizes) == (jplan.bounds, jplan.sizes)
    # VPP's round-robin placement: rank 1 of pp 2 holds virtual stages 1, 3
    assert tpipe.stage_layers(tpipe.SegmentPlan([1.0] * 8, 4), 2, 1) == \
        [2, 3, 6, 7]


def test_seg_method_and_cost_fn_match_jax():
    from paddle_tpu_torch import nn as tnn

    pt.seed(0)
    jdescs = ([jpipe.LayerDesc(jnn.Embedding, 12, 16)]
              + [jpipe.LayerDesc(jnn.Linear, 16, 16) for _ in range(5)])
    tdescs = ([tpipe.LayerDesc(tnn.Embedding, 12, 16, device="cpu")]
              + [tpipe.LayerDesc(tnn.Linear, 16, 16, device="cpu")
                 for _ in range(5)])
    for kw in (dict(seg_method="layer:Linear"), dict(cost_fn=lambda d: 1.0)):
        m = tpipe.PipelineModule(tdescs, num_stages=2, **kw)
        jm = jpipe.PipelineModule(jdescs, num_stages=2, **kw)
        assert m.segments == jm.segments == [0, 3, 5]
        assert m.trunk_range == jm.trunk_range
    for kw in (dict(seg_method="layer:Conv2D"), dict(seg_method="bogus")):
        with pytest.raises(ValueError):
            tpipe.PipelineModule(tdescs, num_stages=2, **kw)


# ---------------------------------------------------------------------------
# the tied module and PipelineTrainStep
# ---------------------------------------------------------------------------
def _jtied(L):
    pt.seed(0)
    descs = ([jpipe.SharedLayerDesc("emb", jnn.Embedding, 12, 16)]
             + [jpipe.LayerDesc(jnn.Linear, 16, 16) for _ in range(L)]
             + [jpipe.SharedLayerDesc(
                 "emb", jnn.Embedding, 12, 16,
                 forward_func=lambda layer, x: x @ layer.weight.value.T)])
    return jpipe.PipelineModule(descs, num_stages=2)


def _state(m):
    """The module's parameters as its train step holds them (the JAX
    trunk's prototype layer is not one of them)."""
    return {n: np.asarray(p.value) for n, p in m.named_parameters()
            if ".prototype." not in n}


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 12, (4, 6)), rng.integers(0, 12, (4, 6))


@pytest.mark.parametrize("L", [4, 5])
def test_tied_module_forward_over_pp_matches_jax(pool, L):
    m = _jtied(L)
    assert [n for n in _state(m) if n.startswith("shared_emb")] == \
        ["shared_emb.weight"]
    ids, _ = _ids(3)
    want = np.asarray(m(jnp.asarray(ids)))  # the layers in turn
    got = pool.run(jobs.pipeline_forward_job, _state(m), L, ids, 2, 2)
    assert got[0] is None  # the logits are on the last stage
    np.testing.assert_allclose(got[1], want, **FWD)


def _jax_traj(m, mesh, schedule, vpp, loss_fn, ids, labels, steps, opt):
    st = JStrategy()
    st.pipeline_configs.schedule_mode = schedule
    st.pipeline_configs.vpp_degree = vpp
    st.pipeline_configs.accumulate_steps = 2
    ts = jpipe.PipelineTrainStep(m, opt, mesh, st, loss_fn)
    losses = [float(ts.run(jnp.asarray(ids), jnp.asarray(labels)))
              for _ in range(steps)]
    return losses, {n: np.asarray(v) for n, v in ts.params.items()}, ts


def _onehot_mse(logits, labels):
    return jnp.mean((logits - jax.nn.one_hot(labels, 12)) ** 2)


def _check_traj(res, losses, params, tol=PARAMS):
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    assert set(res["params"]) == set(params)
    for n, w in params.items():
        np.testing.assert_allclose(res["params"][n], w, err_msg=n, **tol)


@pytest.mark.parametrize("L,vpp", [(4, 1), (5, 1), (6, 2)])
def test_pipeline_train_step_schedules_match_jax(pool, L, vpp):
    """1F1B at this vpp and F-then-B (and at L 4, 1F1B over pp 2 x dp 2)
    against JAX's 1F1B trajectory: a tied embedding updated from both of
    its uses, uniform and cost-balanced non-uniform stages."""
    ids, labels = _ids(1)
    m = _jtied(L)
    state = _state(m)
    losses, params, ts = _jax_traj(m, _jmesh(pp=2), "1F1B", vpp, _onehot_mse,
                                   ids, labels, 4,
                                   jopt.SGD(learning_rate=0.02))
    assert ts._plan_v.uniform == (L % (2 * vpp) == 0)
    assert losses[-1] < losses[0]
    runs = [(dict(pp=2), "1F1B", vpp), (dict(pp=2), "F-then-B", 1)]
    if L == 4:
        runs.append((dict(dp=2, pp=2), "1F1B", 1))
    for mesh_kw, schedule, v in runs:
        got = _got(pool.run(jobs.pipeline_train_job, "tied", mesh_kw, state,
                            L, schedule, v, 2, ids, labels, 4,
                            ("SGD", dict(learning_rate=0.02))))
        for res in got:
            _check_traj(res, losses, params)
        emb = "shared_emb.weight"
        assert np.abs(got[0]["params"][emb] - state[emb]).max() > 1e-6
        # each pp rank holds its stages' layers only
        held = sorted(j for r in got[:2] for j in r["held"])
        assert held == list(range(L)) and len(got[0]["held"]) < L


def test_a_pipeline_checkpoint_moves_between_the_packages(pool, tmp_path):
    """JAX's ``PipelineTrainStep`` state after 2 steps, saved by JAX's
    checkpoint, resumed by the port's at dp 2 x pp 2 (each rank takes its
    stages' layers of the stacked trunk): 2 more steps match JAX's, and
    the port's gathered state, saved by the port, reads back in JAX as
    JAX's own parameters."""
    from paddle_tpu.distributed import checkpoint as jckpt

    ids, labels = _ids(4)
    m = _jtied(4)
    state = _state(m)
    opt = dict(learning_rate=1e-2, epsilon=1e-6)
    st = JStrategy()
    st.pipeline_configs.accumulate_steps = 2
    ts = jpipe.PipelineTrainStep(m, jopt.AdamW(**opt), _jmesh(pp=2), st,
                                 _onehot_mse)
    for _ in range(2):
        ts.run(jnp.asarray(ids), jnp.asarray(labels))
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_state_dict({"params": ts.params, "opt_state": ts.opt_state},
                          jpath)
    want = [float(ts.run(jnp.asarray(ids), jnp.asarray(labels)))
            for _ in range(2)]
    params = {n: np.asarray(v) for n, v in ts.params.items()}
    got = _got(pool.run(jobs.pipeline_ckpt_job, state, jpath, tpath, ids,
                        labels, 2, opt))
    for res in got:
        _check_traj(res, want, params)
    back = jckpt.load_state_dict(tpath)["params"]
    assert set(back) == set(params)
    for n, w in params.items():
        np.testing.assert_allclose(np.asarray(back[n]), w, err_msg=n,
                                   **PARAMS)


@pytest.fixture(scope="module")
def llama_jax():
    cfg = dict(num_hidden_layers=4, tie_word_embeddings=True,
               use_flash_attention=False)
    jcfg = JLlamaConfig.tiny(**cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (4, 16))
    labels = rng.integers(0, jcfg.vocab_size, (4, 16))

    def loss_fn(logits, labels):
        return jnn.functional.cross_entropy(
            logits.reshape(-1, jcfg.vocab_size), labels.reshape(-1))

    pt.seed(0)
    m = jllama_pipe(jcfg, num_stages=2)
    state = _state(m)
    losses, params, _ = _jax_traj(
        m, _jmesh(pp=2), "1F1B", 1, loss_fn, ids, labels, 5,
        jopt.AdamW(learning_rate=1e-3, epsilon=1e-6))
    return cfg, state, ids, labels, losses, params


@pytest.mark.parametrize("mesh_kw,schedule,vpp,stage,recompute", [
    (dict(pp=2), "1F1B", 1, 0, False),
    (dict(pp=2, tp=2), "1F1B", 1, 0, False),
    (dict(pp=2, fsdp=2), "F-then-B", 1, 3, True),
    (dict(dp=2, pp=2), "VPP", 2, 0, False)],
    ids=["pp2", "pp2-tp2", "pp2-fsdp2-zero3-recompute", "dp2-pp2-vpp2"])
def test_llama_pipeline_matches_jax(pool, llama_jax, mesh_kw, schedule, vpp,
                                    stage, recompute):
    cfg, state, ids, labels, losses, params = llama_jax
    got = _got(pool.run(jobs.pipeline_train_job, "llama", mesh_kw, state,
                        cfg, schedule, vpp, 2, ids, labels, 5,
                        ("AdamW", dict(learning_rate=1e-3, epsilon=1e-6)),
                        stage, recompute))
    assert len(got) == int(np.prod(list(mesh_kw.values())))
    for res in got:
        _check_traj(res, losses, params, ADAM_PARAMS)
    assert losses[-1] < losses[0]
    q = got[0]["local"]["trunk.block__self_attn__q_proj__weight"]
    assert q[0] == len(got[0]["held"]) < 4
    assert q[2] == 64 // mesh_kw.get("tp", 1)
