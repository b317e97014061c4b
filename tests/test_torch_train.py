"""The port's training slice against the JAX package on the CPU:
``cross_entropy``, the learning-rate schedulers, the clippers, Adam and
AdamW ``update``, the tiny Llama's loss and every parameter's gradient,
and ``TrainStep``'s loss trajectory (paired, master-only with bf16
parameters, gradient merge), its ``state_dict`` round trip and a resume
from a JAX train state. Inputs come from numpy with one seed; the JAX
side runs on the CPU, where its flash attention takes the dense
reference."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import flags as jflags
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
from paddle_tpu_torch import flags as tflags
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
    # the chunked head + loss, with chunks that do not divide the 23
    # shifted positions: the untied head, and the tied one (whose loss
    # gradient reaches the embedding)
    dict(fused_head_loss_chunk=8),
    dict(fused_head_loss_chunk=5, tie_word_embeddings=True),
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
    tied = cfg.get("tie_word_embeddings", False)
    assert set(got) == set(want) and len(got) == (20 if tied else 21)
    for name, g in want.items():
        _close(got[name].grad, g, 1e-5)
    if cfg.get("fused_head_loss_chunk"):
        # the port's fused loss and gradients are its unfused ones
        unfused = LlamaForCausalLM(LlamaConfig.tiny(
            **dict(cfg, fused_head_loss_chunk=0)), device="cpu")
        unfused.load_state_dict(tmodel.state_dict())
        ref = unfused(torch.as_tensor(ids), torch.as_tensor(labels))
        ref.backward()
        _close(loss, ref, 1e-5)
        for name, p in unfused.named_parameters():
            _close(got[name].grad, p.grad, 1e-5)


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


# ------------------------------------ other optimizers, schedulers, flags
def _any_step(model, opt, lib, **kw):
    if lib is jopt:
        mesh = jdist.build_mesh(devices=jax.devices()[:1])
        return JTrainStep(model, opt, mesh, JStrategy(), **kw)
    return TrainStep(model, opt, **kw)


TRAJECTORIES = [
    ("Lamb", dict(lamb_weight_decay=0.01,
                  exclude_from_weight_decay_fn=lambda n: "norm" in n),
     lambda m: m.OneCycleLR(max_learning_rate=3e-3, total_steps=8),
     None, dict(fused_head_loss_chunk=6)),
    ("RMSProp", dict(centered=True, momentum=0.5),
     lambda m: m.CosineAnnealingWarmRestarts(1e-3, T_0=2, T_mult=2),
     None, {}),
    # MultiplicativeDecay keeps its rate on the host. The JAX step reads
    # it once, while its program is traced (ROADMAP.md Queue C), so JAX
    # runs the same rates through a LambdaDecay: update k reads
    # 2e-3 * 0.8^(k - 1)
    ("NAdam", dict(weight_decay=0.01),
     lambda m: m.MultiplicativeDecay(2e-3, lambda e: 0.8),
     lambda m: m.LambdaDecay(2e-3, lambda e: 0.8 ** (e - 1)),
     dict(fused_head_loss_chunk=5, tie_word_embeddings=True)),
]


@pytest.mark.parametrize("kind,kw,sched,jsched,cfg", TRAJECTORIES,
                         ids=[t[0] for t in TRAJECTORIES])
def test_train_step_with_other_optimizers_matches_jax(kind, kw, sched,
                                                      jsched, cfg):
    """Five ``TrainStep`` steps with global-norm clipping, a scheduler the
    step advances after each update (a host-state one too), and the
    chunked head + loss: float32 losses within 1e-5 of JAX's."""
    jmodel, tmodel = _pair(seed=13, **cfg)

    def make(m, lrm, schedule):
        return getattr(m, kind)(learning_rate=schedule(lrm),
                                grad_clip=m.ClipGradByGlobalNorm(1.0), **kw)

    js = _any_step(jmodel, make(jopt, jlr, jsched or sched), jopt)
    ts = _any_step(tmodel, make(topt, tlr, sched), topt)
    batch = _batch(seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(5):
        want = float(js.run(jbatch))
        losses.append(float(ts.run(batch)))
        np.testing.assert_allclose(losses[-1], want, rtol=1e-5)
        if jsched is None:
            assert ts.optimizer.get_lr() == pytest.approx(
                js.optimizer.get_lr(), rel=1e-6)
    assert losses[-1] < losses[0]


@pytest.fixture
def debug_flags():
    """Sets a debug flag in both packages; restores both."""
    saved = {n: (jflags.flag(n), tflags.flag(n))
             for n in ("check_nan_inf", "benchmark")}

    def set_both(**kw):
        jflags.set_flags(kw)
        tflags.set_flags(kw)

    yield set_both
    for n, (j, t) in saved.items():
        jflags.set_flags({n: j})
        tflags.set_flags({n: t})


def test_check_nan_inf_raises_at_the_offending_step(debug_flags):
    """With ``check_nan_inf`` both steps run two finite steps, then an inf
    planted in one weight makes the third raise ``FloatingPointError``
    with JAX's message; the scheduler is not advanced past it."""
    debug_flags(check_nan_inf=True)
    jmodel, tmodel = _pair(seed=14)
    js = _any_step(jmodel, jopt.AdamW(learning_rate=jlr.StepDecay(
        1e-3, step_size=1)), jopt)
    ts = _any_step(tmodel, topt.AdamW(learning_rate=tlr.StepDecay(
        1e-3, step_size=1)), topt)
    batch = _batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        js.run(jbatch)
        ts.run(batch)
    name = "model.norm.weight"
    js.params[name] = js.params[name].at[3].set(jnp.inf)
    with torch.no_grad():
        dict(tmodel.named_parameters())[name][3] = float("inf")
    with pytest.raises(FloatingPointError) as jerr:
        js.run(jbatch)
    with pytest.raises(FloatingPointError) as terr:
        ts.run(batch)
    assert str(terr.value) == str(jerr.value)
    assert "at step 3" in str(terr.value)
    assert ts.step_count == 3
    assert ts.optimizer._lr_scheduler.last_epoch == 2
    # off: the same step runs on without a check
    debug_flags(check_nan_inf=False)
    assert not np.isfinite(float(ts.run(batch)))


def test_benchmark_prints_the_jax_line(debug_flags, capsys):
    """The step's line with its loss and grad norm (the JAX step emits the
    norm when ``check_nan_inf`` or telemetry is on at build time, so both
    flags are on here); nothing printed with the flag off."""
    debug_flags(benchmark=True, check_nan_inf=True)
    jmodel, tmodel = _pair(seed=15)
    js = _any_step(jmodel, jopt.AdamW(learning_rate=1e-3), jopt)
    ts = _any_step(tmodel, topt.AdamW(learning_rate=1e-3), topt)
    batch = _batch(seed=6)
    pattern = (r"\[pt-benchmark\] step (\d+): (\d+\.\d\d) ms  "
               r"loss=(\S+)  grad_norm=(\S+)")
    for step in (1, 2):
        js.run({k: jnp.asarray(v) for k, v in batch.items()})
        jline = capsys.readouterr().out.strip().splitlines()[-1]
        loss = ts.run(batch)
        tline = capsys.readouterr().out.strip().splitlines()[-1]
        jm, tm = re.fullmatch(pattern, jline), re.fullmatch(pattern, tline)
        assert jm and tm, (jline, tline)
        assert int(tm.group(1)) == int(jm.group(1)) == step
        assert float(tm.group(2)) > 0
        np.testing.assert_allclose(float(tm.group(3)), float(jm.group(3)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm.group(4)), float(jm.group(4)),
                                   rtol=1e-4)
        assert float(tm.group(3)) == pytest.approx(float(loss), rel=1e-5)
    debug_flags(benchmark=False, check_nan_inf=False)
    ts.run(batch)
    assert capsys.readouterr().out == ""
