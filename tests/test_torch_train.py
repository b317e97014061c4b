"""The port's training slice against the JAX package on the CPU:
``cross_entropy``, the learning-rate schedulers, the clippers, Adam and
AdamW ``update``, the tiny Llama's loss and every parameter's gradient,
and ``TrainStep``'s loss trajectory (paired, master-only with bf16
parameters, gradient merge), its ``state_dict`` round trip and a resume
from a JAX train state. Inputs come from numpy with one seed; the JAX
side runs on the CPU, where its flash attention takes the dense
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.distributed.strategy import (
    DistributedStrategy as JStrategy,
)
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (
    load_numpy_state_dict,
    load_numpy_train_state,
)
from paddle_tpu_torch.distributed import DistributedStrategy, HybridConfig
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.trainer import TrainStep


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ losses
CE_CASES = [
    dict(reduction="mean"), dict(reduction="sum"), dict(reduction="none"),
    dict(reduction="mean", ignore_index=3),
    dict(reduction="mean", label_smoothing=0.1),
    dict(reduction="sum", label_smoothing=0.2, ignore_index=-100),
    dict(reduction="mean", soft_label=True),
    dict(reduction="mean", axis=1),
    dict(reduction="mean", axis=1, soft_label=True),
    dict(reduction="mean", bf16=True),
]


@pytest.mark.parametrize("kw", CE_CASES)
def test_cross_entropy_matches_jax(kw):
    kw = dict(kw)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    axis = kw.get("axis", -1)
    classes = logits.shape[axis]
    if kw.get("soft_label"):
        label = rng.random(logits.shape).astype(np.float32)
        label /= label.sum(axis=axis, keepdims=True)
    else:
        shape = list(logits.shape)
        del shape[axis]
        label = rng.integers(0, classes, shape)
        label[0, 0] = kw.get("ignore_index", -100)  # one ignored entry
    jl, tl = jnp.asarray(logits), torch.tensor(logits)
    if kw.pop("bf16", False):
        jl, tl = jl.astype(jnp.bfloat16), tl.bfloat16()
    want = JF.cross_entropy(jl, jnp.asarray(label), **kw)
    got = TF.cross_entropy(tl, torch.tensor(label), **kw)
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


# -------------------------------------------------------------- schedulers
def _schedulers(mod):
    return [
        mod.ConstantLR(0.3),
        mod.LinearWarmup(0.5, warmup_steps=4, start_lr=0.0, end_lr=0.5),
        mod.LinearWarmup(mod.CosineAnnealingDecay(0.2, T_max=10),
                         warmup_steps=3, start_lr=0.01, end_lr=0.2),
        mod.CosineAnnealingDecay(0.1, T_max=12, eta_min=0.001),
        mod.PolynomialDecay(0.4, decay_steps=10, end_lr=0.01, power=2.0),
    ]


def test_schedulers_lr_at_match_jax():
    for js, ts in zip(_schedulers(jlr), _schedulers(tlr)):
        for step in range(16):
            want = js.lr_at(jnp.asarray(step))
            got = ts.lr_at(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            _close(got, want, 1e-7)
            _close(ts.lr_at(torch.tensor(step, dtype=torch.int32)), want,
                   1e-7)
        for _ in range(5):
            js.step()
            ts.step()
        assert ts.get_lr() == pytest.approx(js.get_lr(), rel=1e-7)
        assert ts.state_dict() == pytest.approx(js.state_dict())


# ---------------------------------------------------------------- clippers
def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32) * 3,
            "b": rng.standard_normal((5,)).astype(np.float32) * 0.1,
            "c": rng.standard_normal((2, 2)).astype(np.float32)}


@pytest.mark.parametrize("make", [
    lambda m: m.ClipGradByGlobalNorm(1.0),
    lambda m: m.ClipGradByGlobalNorm(100.0),
    lambda m: m.ClipGradByNorm(0.5),
    lambda m: m.ClipGradByValue(0.7),
    lambda m: m.ClipGradByValue(0.7, min=-0.2),
])
def test_clippers_match_jax(make):
    g = _grads(1)
    want = make(jopt)({k: jnp.asarray(v) for k, v in g.items()})
    got = make(topt)({k: torch.tensor(v) for k, v in g.items()})
    # bf16 gradients keep their dtype
    got16 = make(topt)({k: torch.tensor(v).bfloat16() for k, v in g.items()})
    # a norm the caller already holds gives the same clip
    tg = {k: torch.tensor(v) for k, v in g.items()}
    given = make(topt)(tg, norm=topt.clip.global_norm(tg))
    for k in g:
        _close(got[k], want[k], 1e-6)
        assert got16[k].dtype == torch.bfloat16
        assert torch.equal(given[k], got[k])
    clip = topt.ClipGradByGlobalNorm(1.0)
    _close(clip.global_norm({k: torch.tensor(v) for k, v in g.items()}),
           jopt.ClipGradByGlobalNorm(1.0).global_norm(
               {k: jnp.asarray(v) for k, v in g.items()}), 1e-6)


# --------------------------------------------------------------- optimizers
@pytest.mark.parametrize("kind,moment_dtype", [("Adam", None),
                                               ("AdamW", None),
                                               ("AdamW", "bfloat16")])
def test_adam_update_matches_jax_over_steps(kind, moment_dtype):
    """Four updates of bf16 parameters with float32 masters, a float32
    parameter without one, weight decay skipped for the bias by
    ``apply_decay_param_fun``, global-norm clipping, a warm-up schedule
    and the ``scale`` divisor."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "bias": rng.standard_normal((4,)).astype(np.float32),
              "f32": rng.standard_normal((3,)).astype(np.float32)}
    low = ("w", "bias")

    def make(m, lrm):
        return getattr(m, kind)(
            learning_rate=lrm.LinearWarmup(1e-2, 2, 0.0, 1e-2),
            weight_decay=0.1, grad_clip=m.ClipGradByGlobalNorm(1.0),
            multi_precision=True, moment_dtype=moment_dtype,
            apply_decay_param_fun=lambda n: n != "bias")

    jo, to = make(jopt, jlr), make(topt, tlr)
    jp = {n: jnp.asarray(v, jnp.bfloat16 if n in low else jnp.float32)
          for n, v in params.items()}
    tp = {n: torch.tensor(v).to(torch.bfloat16 if n in low
                                else torch.float32)
          for n, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts["master"]) == set(js["master"]) == set(low)
    for step in range(4):
        g = {n: rng.standard_normal(v.shape).astype(np.float32)
             for n, v in params.items()}
        jp, js = jo.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                           jp, scale=2.0)
        tp, ts = to.update({n: torch.tensor(v) for n, v in g.items()}, ts,
                           tp, scale=2.0)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for n in params:
            assert tp[n].dtype == (torch.bfloat16 if n in low
                                   else torch.float32)
            _close(tp[n], jp[n], 1e-2 if n in low else 1e-6)
        for n in low:
            _close(ts["master"][n], js["master"][n], 1e-6)
        for n in params:
            for slot in ("moment1", "moment2"):
                assert ts["slots"][n][slot].dtype == (
                    torch.bfloat16 if moment_dtype else torch.float32)
                _close(ts["slots"][n][slot], js["slots"][n][slot],
                       1e-2 if moment_dtype else 1e-6)


# ------------------------------------------------------------- tiny Llama
def _pair(seed=5, **cfg):
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_numpy_state_dict(tmodel, state)
    return jmodel, tmodel


@pytest.mark.parametrize("cfg", [
    dict(use_flash_attention=True),
    dict(use_flash_attention=False),
    dict(use_flash_attention=True, use_recompute=True),
    dict(use_flash_attention=True, use_recompute=True,
         recompute_policy="nothing_saveable"),
])
def test_tiny_llama_loss_and_every_gradient_match_jax(cfg):
    jmodel, tmodel = _pair(**cfg)
    ids = np.random.default_rng(3).integers(0, 256, (2, 24))
    labels = ids.copy()
    labels[0, 5] = -100  # an ignored position

    def jloss(p):
        return functional_call(jmodel, p, jnp.asarray(ids),
                               labels=jnp.asarray(labels))

    want_loss, want = jax.value_and_grad(jloss)(extract_params(jmodel))
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    _close(loss, want_loss, 1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want) and len(got) == 21
    for name, g in want.items():
        _close(got[name].grad, g, 1e-5)


# -------------------------------------------------------------- TrainStep
def _jax_step(jmodel, residency="paired", merge_k=1, **opt_kw):
    mesh = jdist.build_mesh(devices=jax.devices()[:1])
    strategy = JStrategy()
    if merge_k > 1:
        strategy.gradient_merge = True
        strategy.gradient_merge_k_steps = merge_k
    return JTrainStep(jmodel, jopt.AdamW(**opt_kw), mesh, strategy,
                      master_residency=residency)


def _port_step(tmodel, residency="paired", merge_k=1, **opt_kw):
    strategy = DistributedStrategy()
    if merge_k > 1:
        strategy.gradient_merge = True
        strategy.gradient_merge_k_steps = merge_k
    return TrainStep(tmodel, topt.AdamW(**opt_kw), strategy=strategy,
                     master_residency=residency)


_OPT = dict(learning_rate=3e-3, weight_decay=0.01,
            grad_clip=None, multi_precision=True)


def _batch(seed=0, b=4, s=16):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s))
    return {"input_ids": ids, "labels": ids}


@pytest.mark.parametrize("mode", ["paired", "master_only_bf16",
                                  "gradient_merge"])
def test_train_step_loss_trajectory_matches_jax(mode):
    """Five steps of AdamW with global-norm clipping on one fixed batch.
    float32 within 1e-5 per step; bf16 parameters (master-only residency)
    within 2e-2, the two frameworks rounding bf16 at other places."""
    bf16 = mode == "master_only_bf16"
    jmodel, tmodel = _pair(seed=7, **({"dtype": "bfloat16"} if bf16
                                      else {}))
    if bf16:
        jmodel.to(pt.bfloat16)
        load_numpy_state_dict(tmodel, {k: np.asarray(v) for k, v in
                                       jmodel.state_dict().items()})
    opt_kw = dict(_OPT, grad_clip=None)
    residency = "master_only" if bf16 else "paired"
    merge_k = 2 if mode == "gradient_merge" else 1
    opt_j = dict(opt_kw, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    opt_t = dict(opt_kw, grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = _jax_step(jmodel, residency, merge_k, **opt_j)
    ts = _port_step(tmodel, residency, merge_k, **opt_t)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(5):
        want = float(js.run(jbatch))
        got = ts.run(batch)
        losses.append(float(got))
        assert got.dtype == torch.float32
        assert np.isfinite(float(ts.last_grad_norm))
        np.testing.assert_allclose(float(got), want,
                                   rtol=2e-2 if bf16 else 1e-5)
    assert losses[-1] < losses[0]
    if bf16:
        # between steps the masters are the only resident copy
        assert all(p.numel() == 0 for p in tmodel.parameters())
        ts.sync_to_model()
        assert all(p.dtype == torch.bfloat16 and p.numel() > 0
                   for p in tmodel.parameters())


def test_gradient_merge_equals_one_step_over_the_whole_batch():
    """k = 2 micro-batches of a mean loss give the whole batch's mean
    gradient when the micro-batches count alike (no ignored labels). The
    two sum in other orders; epsilon 1e-2 keeps Adam's normalised update
    from turning that float32 rounding in a near-zero gradient into a
    whole step of its own."""
    _, t1 = _pair(seed=8)
    _, t2 = _pair(seed=8)
    whole = _port_step(t1, epsilon=1e-2, **_OPT)
    merged = _port_step(t2, merge_k=2, epsilon=1e-2, **_OPT)
    batch = _batch(seed=1)
    for _ in range(2):
        _close(merged.run(batch), whole.run(batch), 1e-5)
    for (n, a), (_, b) in zip(t1.named_parameters(), t2.named_parameters()):
        _close(a, b, 1e-5)


def test_state_dict_round_trip_and_resume_from_jax():
    jmodel, tmodel = _pair(seed=9)
    opt_j = dict(_OPT, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    opt_t = dict(_OPT, grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = _jax_step(jmodel, **opt_j)
    batch = _batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        js.run(jbatch)
    state = jax.tree_util.tree_map(np.asarray, js.state_dict())
    # a port TrainStep over other weights resumes from the JAX state
    _, other = _pair(seed=10)
    ts = _port_step(other, **opt_t)
    load_numpy_train_state(ts, state)
    assert ts.step_count == 2 and int(ts.opt_state["step"]) == 2
    for _ in range(2):
        np.testing.assert_allclose(float(ts.run(batch)),
                                   float(js.run(jbatch)), rtol=1e-5)
    # the port's own round trip: a fresh step restored from it continues
    # identically
    sd = {"params": {n: p.clone() for n, p in
                     ts.state_dict()["params"].items()},
          "opt_state": jax.tree_util.tree_map(
              lambda t: t.clone(), ts.state_dict()["opt_state"]),
          "step": ts.step_count}
    _, fresh = _pair(seed=11)
    ts2 = _port_step(fresh, **opt_t)
    ts2.set_state_dict(sd)
    assert ts2.step_count == 4
    assert float(ts2.run(batch)) == float(ts.run(batch))
    bad = dict(state, params=dict(state["params"], extra=np.zeros(2)))
    with pytest.raises(KeyError):
        load_numpy_train_state(ts, bad)


def test_train_step_refuses_what_it_does_not_run():
    _, tmodel = _pair()
    with pytest.raises(NotImplementedError, match="one card"):
        TrainStep(tmodel, topt.AdamW(), mesh=object())
    with pytest.raises(NotImplementedError, match="one card"):
        TrainStep(tmodel, topt.AdamW(), strategy=DistributedStrategy(
            hybrid_configs=HybridConfig(dp_degree=2)))
    with pytest.raises(ValueError, match="master_only"):
        TrainStep(tmodel, topt.AdamW(), master_residency="master_only")
    with pytest.raises(ValueError, match="master_residency"):
        TrainStep(tmodel, topt.AdamW(), master_residency="offload")
    # options that mean nothing on one card refuse a value that would
    # change something on a mesh
    with pytest.raises(NotImplementedError, match="batch_seq_axis"):
        TrainStep(tmodel, topt.AdamW(), batch_seq_axis=0)
    with pytest.raises(NotImplementedError, match="donate"):
        TrainStep(tmodel, topt.AdamW(), donate=False)
    ts = TrainStep(tmodel, topt.AdamW(), batch_seq_axis=None)
    with pytest.raises(NotImplementedError, match="sharded"):
        ts.run(_batch(), sharded=True)


def test_train_step_computes_the_grad_norm_once(monkeypatch):
    """The step's norm is the one the global-norm clip uses: the clip
    does not compute its own."""
    def no_second_norm(self, grads):
        raise AssertionError("the clip computed the norm again")

    monkeypatch.setattr(topt.ClipGradByGlobalNorm, "global_norm",
                        no_second_norm)
    _, tmodel = _pair(seed=12)
    grads_seen = {}
    ts = _port_step(tmodel, **dict(
        _OPT, grad_clip=topt.ClipGradByGlobalNorm(1.0)))
    update = ts.optimizer.update

    def spy(grads, *a, **kw):
        grads_seen.update({n: g.clone() for n, g in grads.items()})
        return update(grads, *a, **kw)

    monkeypatch.setattr(ts.optimizer, "update", spy)
    ts.run(_batch(seed=3))
    want = torch.sqrt(sum(torch.sum(g.double() ** 2)
                          for g in grads_seen.values()))
    _close(ts.last_grad_norm, want, 1e-6)
