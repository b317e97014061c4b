"""The port's one-card MoE (``paddle_tpu_torch/distributed/moe.py``) and
ERNIE-MoE (``models/ernie_moe.py``) against the JAX package on the CPU:
the GShard top-2 and Switch top-1 gates (combine, dispatch, aux loss,
dropped fraction) and the dropless top-k gate on logits full of ties
(which expert wins a tie decides everything downstream) at capacities
that drop; ``MoELayer`` (both gates) and ``DroplessMoELayer`` outputs,
aux losses and gradients; the tiny ERNIE-MoE's loss and every gradient
on both arms, and a 3-step AdamW ``TrainStep`` trajectory. Tolerances as
``tests/torch_parity.py`` states them.

Expert parallelism runs over a pool of 4 gloo ranks
(``tests/torch_dist_pool.py``, jobs in ``tests/torch_dist_jobs.py``),
started once for the file: the layers of ``tests/test_moe.py``'s
expert-parallel cases on 4-rank meshes (ep with tp, fsdp or alone), each
rank's rows of the output, the aux loss and the global gradients of
``sum(y**2) + aux`` against the meshless JAX layer (forward 1e-5,
gradients 1e-4), and ERNIE-MoE ``TrainStep`` trajectories at ep 2
(capacity gate) and ep 4 (dropless) against the JAX ``TrainStep`` on the
same mesh (losses rtol 1e-5, parameters rtol 1e-4 with atol 5e-6: Adam's
normalised step)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models import ErnieMoEConfig as JConfig
from paddle_tpu.models import ErnieMoEForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.models import ErnieMoEConfig, ErnieMoEForCausalLM
from torch_parity import (FWD_TOL, GRAD_TOL, carry, check_grads, close,
                          jax_value_and_grads, trajectory)

import torch_dist_jobs as jobs
import torch_dist_pool as tdp

T, E = 48, 4


def _tied_logits(seed):
    """Integer logits in [0, 3): most rows hold ties, some whole rows
    are one value."""
    logits = np.random.default_rng(seed).integers(0, 3, (T, E))
    logits[:4] = 1
    return logits.astype(np.float32)


@pytest.mark.parametrize("gate, capacity", [
    ("top2", 16), ("top2", 40), ("switch", 10), ("switch", 48)])
def test_capacity_gating_matches_jax_with_ties(gate, capacity):
    logits = _tied_logits(1)
    jfn = getattr(jmoe, f"_{gate}_gating")
    tfn = getattr(tmoe, f"_{gate}_gating")
    want = jfn(jnp.asarray(logits), capacity)
    got = tfn(torch.as_tensor(logits), capacity)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])
    close(got[3], want[3])
    if capacity < T // 2:
        assert float(got[3]) > 0.0  # the small capacity drops tokens


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_dropless_gating_matches_jax_with_ties(top_k):
    logits = _tied_logits(2)
    want = jmoe._dropless_topk_gating(jnp.asarray(logits), top_k)
    got = tmoe._dropless_topk_gating(torch.as_tensor(logits), top_k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1], want[1])
    close(got[2], want[2])


def _layer_pair(kind, **kw):
    pt.seed(3)
    jlayer = getattr(jmoe, kind)(32, E, d_hidden=48, **kw)
    tlayer = getattr(tmoe, kind)(32, E, d_hidden=48, device="cpu", **kw)
    return jlayer, carry(jlayer, tlayer)


@pytest.mark.parametrize("kind, kw", [
    ("MoELayer", dict(gate="gshard", capacity_factor=0.75)),
    ("MoELayer", dict(gate="switch")),
    ("DroplessMoELayer", dict(top_k=2))])
def test_moe_layers_match_jax(kind, kw):
    """Output, aux loss, dropped fraction, and the gradients of
    ``sum(y * w) + aux`` by the input and every parameter."""
    jlayer, tlayer = _layer_pair(kind, **kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    w = rng.standard_normal((2, 12, 32)).astype(np.float32)

    def jloss(p, xj):
        y, aux = functional_call(jlayer, p, xj)
        return jnp.sum(y * w) + aux, (y, aux, jlayer.last_drop_fraction)

    (want_loss, (want_y, want_aux, want_drop)), (want_p, want_x) = \
        jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            extract_params(jlayer), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    y, aux = tlayer(xt)
    loss = (y * torch.as_tensor(w)).sum() + aux
    loss.backward()
    close(y, want_y)
    close(aux, want_aux)
    close(loss, want_loss)
    close(tlayer.last_drop_fraction, want_drop)
    close(xt.grad, want_x, 1e-4)
    check_grads(tlayer, want_p)


def test_capacity_factor_defaults_to_the_flag():
    layer = tmoe.MoELayer(8, 4, device="cpu")
    assert layer.capacity_factor == tflags.flag("moe_capacity_factor") \
        == 1.25
    assert layer.capacity(64) == 40 and layer.capacity(4) == 4
    # without a mesh the expert-parallel dispatch is the one-card one
    dl = tmoe.DroplessMoELayer(8, 4, d_hidden=16, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (10, 8)).astype(np.float32))
    ex = dl.experts
    y, aux = tmoe.dropless_moe_ep_apply(x, dl.gate_weight, ex.w1, ex.b1,
                                        ex.w2, ex.b2, ex.act, 2, None)
    idx, gates, want_aux = tmoe._dropless_topk_gating(dl._gate_logits(x), 2)
    close(y, tmoe.dropless_moe_apply(x, idx, gates, ex.w1, ex.b1, ex.w2,
                                     ex.b2, ex.act))
    close(aux, want_aux)


def _model_pair(seed=5, **cfg):
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               **cfg)
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    return jmodel, carry(jmodel, ErnieMoEForCausalLM(
        ErnieMoEConfig.tiny(**cfg), device="cpu"))


@pytest.mark.parametrize("cfg", [dict(), dict(moe_dropless=True),
                                 dict(gate="switch", moe_every=2)])
def test_ernie_moe_loss_and_every_gradient_match_jax(cfg):
    jmodel, tmodel = _model_pair(**cfg)
    ids = np.random.default_rng(3).integers(0, 256, (2, 24))
    want_loss, want = jax_value_and_grads(jmodel, jnp.asarray(ids),
                                          labels=jnp.asarray(ids))
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(ids))
    loss.backward()
    close(loss, want_loss, FWD_TOL)
    check_grads(tmodel, want)


def test_ernie_moe_train_step_trajectory_matches_jax():
    jmodel, tmodel = _model_pair(seed=7)
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    trajectory(jmodel, tmodel, {"input_ids": ids, "labels": ids})


# ---------------------------------------------------------------------------
# expert parallelism over the gloo pool
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


EP_CASES = [
    # tests/test_moe.py:66 (ep 4 x tp 2 there)
    ("MoELayer", dict(num_experts=8, d_hidden=32), 3, (4, 16, 16),
     dict(ep=2, tp=2)),
    ("MoELayer", dict(num_experts=8, d_hidden=32), 3, (4, 16, 16),
     dict(ep=4)),
    # :113 (fsdp 2 x ep 2 x tp 2 there)
    ("MoELayer", dict(num_experts=4, d_hidden=32), 7, (4, 8, 16),
     dict(fsdp=2, ep=2)),
    # :203
    ("DroplessMoELayer", dict(num_experts=4, d_hidden=32, top_k=2), 11,
     (2, 8, 16), dict(ep=2)),
    ("DroplessMoELayer", dict(num_experts=4, d_hidden=32, top_k=2), 11,
     (2, 8, 16), dict(ep=4)),
    # :240 (fsdp 2 x ep 2 x tp 2 there)
    ("DroplessMoELayer", dict(num_experts=4, d_hidden=16, top_k=2), 12,
     (4, 4, 8), dict(fsdp=2, ep=2)),
    ("DroplessMoELayer", dict(num_experts=4, d_hidden=16, top_k=2), 12,
     (4, 4, 8), dict(ep=2, tp=2)),
]


@pytest.mark.parametrize("kind,kw,seed,shape,mesh_kw", EP_CASES, ids=[
    f"{c[0]}-" + "-".join(f"{k}{v}" for k, v in c[4].items())
    for c in EP_CASES])
def test_expert_parallel_layers_match_jax(pool, kind, kw, seed, shape,
                                          mesh_kw):
    pt.seed(seed)
    kw = dict(kw)
    jlayer = getattr(jmoe, kind)(shape[-1], kw.pop("num_experts"), **kw)
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)

    def jloss(p):
        y, aux = functional_call(jlayer, p, jnp.asarray(x))
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (want_y, want_aux)), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(extract_params(jlayer))
    state = {n: np.asarray(v) for n, v in jlayer.state_dict().items()}
    kw["num_experts"] = jlayer.num_experts
    got = pool.run(jobs.moe_layer_job, kind, kw, mesh_kw, state, x)
    rows = shape[0] // mesh_kw.get("fsdp", 1)
    ep = mesh_kw["ep"]
    assert sum(r is not None for r in got) == int(np.prod(list(
        mesh_kw.values())))
    for r, res in enumerate(got):
        if res is None:  # a rank outside the mesh
            continue
        # rank r's rows: its fsdp block (the mesh's axis order dp, pp,
        # fsdp, ep, sep, tp)
        f = r // (ep * mesh_kw.get("tp", 1))
        close(res["y"], np.asarray(want_y)[f * rows:(f + 1) * rows])
        close(res["aux"], want_aux)
        for n, g in want_g.items():
            close(res["grads"][n], g, GRAD_TOL)
        # each rank holds its experts, cut over tp
        w1 = res["local_shapes"]["experts.w1"]
        assert w1[0] == jlayer.num_experts // ep
        assert w1[2] == jlayer.experts.w1.value.shape[2] // mesh_kw.get(
            "tp", 1)


def test_dropless_tokens_must_divide_over_ep(pool):
    for name, msg in pool.run(jobs.moe_refusal_job):
        assert name == "InvalidArgumentError" and "divisible by ep" in msg


@pytest.mark.parametrize("ep,cfg", [(2, dict()), (4, dict(moe_dropless=True))],
                         ids=["ep2-capacity", "ep4-dropless"])
def test_ernie_moe_train_step_over_ep_matches_jax(pool, ep, cfg):
    from paddle_tpu import distributed as jdist
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.trainer import TrainStep as JTrainStep

    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               **cfg)
    pt.seed(9)
    jmodel = JModel(JConfig.tiny(**cfg))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    opt = dict(learning_rate=1e-3, weight_decay=0.01, epsilon=1e-6)
    mesh = jdist.build_mesh(ep=ep, devices=jax.devices()[:ep])
    js = JTrainStep(jmodel, jopt.AdamW(
        grad_clip=jopt.ClipGradByGlobalNorm(1.0), **opt), mesh)
    ids = np.random.default_rng(1).integers(0, 256, (2, 24))
    batch = {"input_ids": ids, "labels": ids}
    losses = [float(js.run({k: jnp.asarray(v) for k, v in batch.items()}))
              for _ in range(3)]
    params = {n: np.asarray(v) for n, v in js.state_dict()["params"].items()}
    got = [r for r in pool.run(jobs.moe_train_job, dict(ep=ep), state, cfg,
                               batch, 3, opt) if r is not None]
    assert len(got) == ep
    for res in got:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        for n, w in params.items():
            np.testing.assert_allclose(res["params"][n], w, rtol=1e-4,
                                       atol=5e-6, err_msg=n)
        assert res["local_shapes"]["blocks.0.moe.experts.w1"][0] == 4 // ep
    assert losses[-1] < losses[0]
