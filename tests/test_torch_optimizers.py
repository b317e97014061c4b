"""The port's optimizer surface against the JAX package on the CPU: the
twelve optimizers beside Adam/AdamW (``update`` over bf16 parameters with
float32 masters, a float32 parameter, weight decay, global-norm clipping),
all seventeen learning-rate schedulers (``lr_at``, ``step``,
``state_dict``, the host-state ones), the eager API (``apply_gradients``,
``step`` from ``.grad``, ``set_gradients``, ``clear_grad``,
``state_dict``, resuming from a JAX state) and ``LBFGS`` with and without
the strong-Wolfe line search. Inputs come from numpy with a seed.

Tolerances: float32 updates within rtol 1e-6 / atol 1e-7 of JAX over 8
steps (the two sides run the same float32 operations; reductions may sum
in another order); a bf16 parameter is its master rounded to bf16, within
one bf16 step of JAX's; schedulers within rtol 1e-6 / atol 1e-8; LBFGS
iterates within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.core.parameter import Parameter
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------- optimizers
OPTIMIZERS = [
    ("SGD", {}),
    ("Momentum", dict(momentum=0.9)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True)),
    ("Adagrad", dict(initial_accumulator_value=0.1)),
    ("Lamb", dict(lamb_weight_decay=0.1,
                  exclude_from_weight_decay_fn=lambda n: "bias" in n)),
    ("Lars", dict(lars_weight_decay=0.1, lars_coeff=0.01,
                  exclude_from_weight_decay=["bias"])),
    ("RMSProp", dict(momentum=0.9)),
    ("RMSProp", dict(momentum=0.5, centered=True)),
    ("Adamax", {}),
    ("Adadelta", dict(learning_rate=1.0)),
    ("NAdam", {}),
    ("RAdam", {}),
    ("ASGD", dict(batch_num=3)),
    ("Rprop", {}),
]
# the optimizers that take the base class's weight decay (Lamb and Lars
# take their own, Rprop none)
_BASE_DECAY = {"SGD", "Momentum", "Adagrad", "RMSProp", "Adamax", "Adadelta",
               "NAdam", "RAdam", "ASGD"}


def _make(mod, kind, kw, lr=1e-2):
    args = dict(learning_rate=lr, grad_clip=mod.ClipGradByGlobalNorm(1.0),
                multi_precision=True)
    if kind in _BASE_DECAY:
        args.update(weight_decay=0.1, apply_decay_param_fun=lambda n:
                    n != "bias")
    args.update(kw)
    return getattr(mod, kind)(**args)


@pytest.mark.parametrize("kind,kw", OPTIMIZERS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_update_matches_jax_over_steps(kind, kw):
    """Eight updates: bf16 parameters with float32 masters, a float32
    parameter without one, decay skipped for the bias, global-norm
    clipping, a warm-up schedule. Eight steps take RAdam across its
    rectification switch (rho_t > 5 from step 6) and ASGD past its
    window."""
    rng = np.random.default_rng(2)
    params = {"bias": rng.standard_normal((4,)).astype(np.float32),
              "f32": rng.standard_normal((3,)).astype(np.float32),
              "w": rng.standard_normal((6, 4)).astype(np.float32)}
    low = ("bias", "w")
    jo = _make(jopt, kind, kw, jlr.LinearWarmup(1e-2, 2, 0.0, 1e-2))
    to = _make(topt, kind, kw, tlr.LinearWarmup(1e-2, 2, 0.0, 1e-2))
    if kind == "Adadelta":
        jo, to = _make(jopt, kind, kw), _make(topt, kind, kw)
    jp = {n: jnp.asarray(v, jnp.bfloat16 if n in low else jnp.float32)
          for n, v in params.items()}
    tp = {n: torch.tensor(v).to(torch.bfloat16 if n in low
                                else torch.float32)
          for n, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts["master"]) == set(js["master"]) == set(low)
    for n in params:
        assert set(ts["slots"][n]) == set(js["slots"][n])
    for step in range(8):
        g = {n: rng.standard_normal(v.shape).astype(np.float32)
             for n, v in params.items()}
        jp, js = jo.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                           jp)
        tp, ts = to.update({n: torch.tensor(v) for n, v in g.items()}, ts,
                           tp)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for n in low:
            _close(ts["master"][n], js["master"][n])
            assert tp[n].dtype == torch.bfloat16
            _close(tp[n], jp[n], rtol=8e-3, atol=0)
        _close(tp["f32"], jp["f32"])
        for n in params:
            for slot, v in ts["slots"][n].items():
                assert v.dtype == torch.float32
                _close(v, js["slots"][n][slot])


def test_nadam_keeps_its_running_mu_product():
    """NAdam's ``init`` gives every parameter a 0-d ``mu_prod`` of 1; after
    k updates it is the product of the k momentum coefficients, as in
    JAX."""
    p = {"w": np.linspace(-1, 1, 6, dtype=np.float32)}
    jo, to = jopt.NAdam(multi_precision=False), topt.NAdam(
        multi_precision=False)
    js = jo.init({"w": jnp.asarray(p["w"])})
    ts = to.init({"w": torch.tensor(p["w"])})
    assert ts["slots"]["w"]["mu_prod"].shape == () \
        and float(ts["slots"]["w"]["mu_prod"]) == 1.0
    jw, tw = {"w": jnp.asarray(p["w"])}, {"w": torch.tensor(p["w"])}
    for k in range(5):
        g = np.cos(np.arange(6) + k).astype(np.float32)
        jw, js = jo.update({"w": jnp.asarray(g)}, js, jw)
        tw, ts = to.update({"w": torch.tensor(g)}, ts, tw)
    mu = np.prod([0.9 * (1 - 0.5 * 0.96 ** (t * 0.004))
                  for t in range(1, 6)])
    _close(ts["slots"]["w"]["mu_prod"], js["slots"]["w"]["mu_prod"])
    np.testing.assert_allclose(float(ts["slots"]["w"]["mu_prod"]), mu,
                               rtol=1e-6)
    _close(tw["w"], jw["w"])


def test_lars_and_lamb_exclusions_and_zero_gradient():
    """Lars: a name holding an excluded token takes no decay; an all-zero
    gradient falls back to the plain lr. Lamb: an excluded parameter's
    trust ratio is ||w|| / ||adam update||, without the decay term."""
    w = np.linspace(0.5, 1.5, 8, dtype=np.float32).reshape(2, 4)
    cases = [
        ("Lars", dict(lars_weight_decay=0.5, lars_coeff=0.1,
                      exclude_from_weight_decay=["norm"])),
        ("Lamb", dict(lamb_weight_decay=0.5,
                      exclude_from_weight_decay_fn=lambda n: "norm" in n)),
    ]
    for kind, kw in cases:
        jo = getattr(jopt, kind)(learning_rate=0.1, multi_precision=False,
                                 **kw)
        to = getattr(topt, kind)(learning_rate=0.1, multi_precision=False,
                                 **kw)
        names = ("layer.norm.weight", "layer.w", "zero_grad")
        jp = {n: jnp.asarray(w) for n in names}
        tp = {n: torch.tensor(w) for n in names}
        js, ts = jo.init(jp), to.init(tp)
        g = {n: (np.zeros_like(w) if n == "zero_grad" else w[::-1] * 0.3)
             for n in names}
        jp, js = jo.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                           jp)
        tp, ts = to.update({n: torch.tensor(v) for n, v in g.items()}, ts,
                           tp)
        for n in names:
            _close(tp[n], jp[n])
        # the excluded and the decayed parameter moved differently
        assert not torch.equal(tp["layer.norm.weight"], tp["layer.w"])


# -------------------------------------------------------------- schedulers
def _schedulers(m):
    return {
        "ConstantLR": lambda: m.ConstantLR(0.3),
        "NoamDecay": lambda: m.NoamDecay(d_model=64, warmup_steps=10,
                                         learning_rate=2.0),
        "LinearWarmup": lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(0.2, T_max=30), warmup_steps=5,
            start_lr=0.01, end_lr=0.2),
        "CosineAnnealingDecay": lambda: m.CosineAnnealingDecay(
            0.1, T_max=40, eta_min=0.001),
        "ExponentialDecay": lambda: m.ExponentialDecay(0.5, gamma=0.93),
        "StepDecay": lambda: m.StepDecay(0.4, step_size=7, gamma=0.5),
        "PolynomialDecay": lambda: m.PolynomialDecay(
            0.4, decay_steps=45, end_lr=0.01, power=2.0),
        "PiecewiseDecay": lambda: m.PiecewiseDecay([5, 17, 33],
                                                   [0.3, 0.1, 0.03, 0.01]),
        "MultiStepDecay": lambda: m.MultiStepDecay(0.2, milestones=[9, 3,
                                                                    25],
                                                   gamma=0.3),
        "NaturalExpDecay": lambda: m.NaturalExpDecay(0.5, gamma=0.07),
        "InverseTimeDecay": lambda: m.InverseTimeDecay(0.5, gamma=0.2),
        "LambdaDecay": lambda: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: m.MultiplicativeDecay(
            0.5, lambda e: 0.9 if e % 3 else 0.99),
        "OneCycleLR": lambda: m.OneCycleLR(max_learning_rate=1.0,
                                           total_steps=50,
                                           divide_factor=10.0,
                                           phase_pct=0.3),
        "CyclicLR": lambda: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                       step_size_down=9),
        "ReduceOnPlateau": lambda: m.ReduceOnPlateau(0.2, factor=0.5,
                                                     patience=2,
                                                     cooldown=1),
        "CosineAnnealingWarmRestarts": lambda: m.CosineAnnealingWarmRestarts(
            0.3, T_0=5, T_mult=2, eta_min=0.01),
    }


def test_every_jax_scheduler_is_exported_by_the_port():
    jnames = {n for n, v in vars(jlr).items()
              if isinstance(v, type) and issubclass(v, jlr.LRScheduler)
              and v is not jlr.LRScheduler}
    assert jnames == set(_schedulers(tlr)) and len(jnames) == 17
    for n in jnames:
        assert getattr(topt, n) is getattr(tlr, n)
    for n in jopt.__all__:
        if n != "lr":
            assert hasattr(topt, n), n


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_matches_jax(name):
    """``lr_at`` over steps 0..60 (an int, an int32 tensor) within 1e-6 as
    a float32 0-d tensor; then ten ``step()`` calls give the same
    ``get_lr`` and ``state_dict``, which round-trips into a fresh
    scheduler."""
    js, ts = _schedulers(jlr)[name](), _schedulers(tlr)[name]()
    for step in range(61):
        want = js.lr_at(jnp.asarray(step))
        got = ts.lr_at(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        # atol 1e-8: XLA's and torch's float32 cos differ in the last
        # place, which 1 + cos(x) near x = pi turns into relative error
        _close(got, want, rtol=1e-6, atol=1e-8)
        _close(ts.lr_at(torch.tensor(step, dtype=torch.int32)), want,
               rtol=1e-6, atol=1e-8)
    for k in range(10):
        if name == "ReduceOnPlateau":
            js.step(metrics=1.0)
            ts.step(metrics=1.0)
        else:
            js.step()
            ts.step()
        assert ts.get_lr() == pytest.approx(js.get_lr(), rel=1e-6)
    assert ts.state_dict() == pytest.approx(js.state_dict(), rel=1e-6)
    fresh = _schedulers(tlr)[name]()
    fresh.set_state_dict(ts.state_dict())
    assert fresh.get_lr() == ts.get_lr()
    assert fresh.last_epoch == ts.last_epoch == 10


def test_reduce_on_plateau_over_a_fixed_metric_sequence():
    """Both modes and both threshold modes over one sequence: the rate
    each step, and ``lr_at`` reads the current rate whatever the step (an
    optimizer's next update uses it)."""
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0, 2.9,
               2.9, 2.9, 2.9, 2.9, -1.0, -1.0, -0.99, -0.98, -0.97]
    for kw in (dict(mode="min", patience=2), dict(mode="max", patience=2),
               dict(mode="min", patience=2, threshold_mode="abs",
                    threshold=0.05),
               dict(mode="min", patience=1, cooldown=2, min_lr=0.02)):
        js = jlr.ReduceOnPlateau(0.4, factor=0.5, **kw)
        ts = tlr.ReduceOnPlateau(0.4, factor=0.5, **kw)
        seen = []
        for m in metrics:
            js.step(metrics=m)
            ts.step(metrics=np.float32(m))
            assert ts.get_lr() == js.get_lr()
            seen.append(ts.get_lr())
            for step in (0, 7, 1000):
                _close(ts.lr_at(step), js.lr_at(jnp.asarray(step)),
                       rtol=0, atol=0)
        assert len(set(seen)) > 1, kw  # the rate did move
    # an optimizer reads the reduced rate at its next update
    sched = tlr.ReduceOnPlateau(0.4, factor=0.5, patience=0)
    opt = topt.SGD(learning_rate=sched, multi_precision=False)
    p = {"w": torch.ones(3)}
    st = opt.init(p)
    sched.step(metrics=1.0)
    sched.step(metrics=2.0)  # worse: 0.4 -> 0.2
    opt.update({"w": torch.ones(3)}, st, p)
    _close(p["w"], np.full(3, 0.8, np.float32))


def test_multiplicative_decay_keeps_its_product_on_the_host():
    js = jlr.MultiplicativeDecay(1.0, lambda e: 0.9 if e % 2 else 0.5)
    ts = tlr.MultiplicativeDecay(1.0, lambda e: 0.9 if e % 2 else 0.5)
    for k in range(7):
        js.step()
        ts.step()
        assert ts.get_lr() == pytest.approx(js.get_lr(), rel=1e-7)
        # lr_at is the product so far whatever the step it is asked for
        _close(ts.lr_at(0), js.lr_at(jnp.asarray(0)), rtol=0, atol=0)
        _close(ts.lr_at(99), js.lr_at(jnp.asarray(0)), rtol=0, atol=0)
    js.step(epoch=12)
    ts.step(epoch=12)
    assert ts.get_lr() == pytest.approx(js.get_lr(), rel=1e-7)
    assert ts.get_lr() == pytest.approx(0.9 ** 6 * 0.5 ** 6, rel=1e-6)


# --------------------------------------------------------------- eager API
def _eager_pair(kind="Momentum", sched=False, **kw):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    jw = Parameter(jnp.asarray(w), name="w")
    jb = Parameter(jnp.asarray(b, jnp.bfloat16), name="b")
    tw = torch.nn.Parameter(torch.tensor(w))
    tb = torch.nn.Parameter(torch.tensor(b).bfloat16())
    jlrate = jlr.StepDecay(0.1, step_size=2) if sched else 0.1
    tlrate = tlr.StepDecay(0.1, step_size=2) if sched else 0.1
    jo = getattr(jopt, kind)(learning_rate=jlrate, parameters=[jw, jb],
                             **kw)
    to = getattr(topt, kind)(learning_rate=tlrate,
                             parameters=[("w", tw), ("b", tb)], **kw)
    return (jo, jw, jb), (to, tw, tb)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}


def _same(j, t):
    (_, jw, jb), (_, tw, tb) = j, t
    _close(tw, jw.value)
    assert tb.dtype == torch.bfloat16
    _close(tb, jb.value, rtol=8e-3, atol=0)


def test_eager_apply_gradients_step_and_set_gradients_match_jax():
    j, t = _eager_pair(momentum=0.9, weight_decay=0.01)
    jo, to = j[0], t[0]
    # apply_gradients with a dict
    g = _grads(1)
    jo.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})
    to.apply_gradients({n: torch.tensor(v) for n, v in g.items()})
    _same(j, t)
    # step() from each parameter's .grad, as after loss.backward()
    g = _grads(2)
    t[1].grad = torch.tensor(g["w"])
    t[2].grad = torch.tensor(g["b"]).bfloat16()  # a bf16 parameter's grad
    g["b"] = t[2].grad.float().numpy()
    jo.set_gradients({n: jnp.asarray(v) for n, v in g.items()})
    jo.step()
    to.step()
    _same(j, t)
    # set_gradients takes precedence over .grad, once
    g = _grads(3)
    jo.set_gradients({n: jnp.asarray(v) for n, v in g.items()})
    jo.step()
    to.set_gradients({n: torch.tensor(v) for n, v in g.items()})
    to.step()
    _same(j, t)
    assert to._accumulated_grads is None
    # backward through the held parameters, then step
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 4)).astype(np.float32))
    to.clear_grad()
    assert t[1].grad is None and t[2].grad is None
    (x @ t[1] + t[2].float()).square().sum().backward()
    gw, gb = t[1].grad.clone(), t[2].grad.float().clone()
    jo.set_gradients({"w": jnp.asarray(gw.numpy()),
                      "b": jnp.asarray(gb.numpy())})
    jo.step()
    to.step()
    _same(j, t)
    # clear_grad drops both kinds of gradients: a step has none to apply
    to.set_gradients({n: torch.tensor(v) for n, v in g.items()})
    to.clear_grad()
    with pytest.raises(RuntimeError, match="no gradients"):
        to.step()
    assert int(to.state_dict()["state"]["step"]) == 4


def test_eager_state_dict_round_trip_and_resume_from_jax():
    j, t = _eager_pair(kind="AdamW", sched=True, weight_decay=0.05)
    jo, to = j[0], t[0]
    for seed in (1, 2, 3):
        g = _grads(seed)
        jo.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})
        to.apply_gradients({n: torch.tensor(v) for n, v in g.items()})
        jo._lr_scheduler.step()
        to._lr_scheduler.step()
    _same(j, t)
    assert to.get_lr() == pytest.approx(jo.get_lr(), rel=1e-7)
    sd = jo.state_dict()
    assert set(to.state_dict()) == set(sd) == {"base_lr", "state",
                                               "lr_scheduler"}
    # a port optimizer over the JAX parameters' values resumes from the
    # JAX state given as numpy, and both continue alike
    numpy_sd = {"base_lr": sd["base_lr"],
                "lr_scheduler": dict(sd["lr_scheduler"]),
                "state": {"step": np.asarray(sd["state"]["step"]),
                          "slots": {n: {k: np.asarray(v.astype(jnp.float32))
                                        for k, v in s.items()}
                                    for n, s in sd["state"]["slots"].items()},
                          "master": {n: np.asarray(v) for n, v in
                                     sd["state"]["master"].items()}}}
    (_, jw, jb) = j
    rw = torch.nn.Parameter(torch.tensor(np.asarray(jw.value)))
    rb = torch.nn.Parameter(torch.tensor(
        np.asarray(jb.value.astype(jnp.float32))).bfloat16())
    resumed = topt.AdamW(learning_rate=tlr.StepDecay(0.1, step_size=2),
                         parameters=[("w", rw), ("b", rb)],
                         weight_decay=0.05)
    resumed.set_state_dict(numpy_sd)
    assert int(resumed.state_dict()["state"]["step"]) == 3
    assert resumed.get_lr() == to.get_lr()
    # the port's own round trip into a fresh optimizer
    cw = torch.nn.Parameter(t[1].detach().clone())
    cb = torch.nn.Parameter(t[2].detach().clone())
    copy = topt.AdamW(learning_rate=tlr.StepDecay(0.1, step_size=2),
                      parameters=[("w", cw), ("b", cb)], weight_decay=0.05)
    copy.set_state_dict(to.state_dict())
    for seed in (4, 5):
        g = _grads(seed)
        jo.apply_gradients({n: jnp.asarray(v) for n, v in g.items()})
        for o in (to, resumed, copy):
            o.apply_gradients({n: torch.tensor(v) for n, v in g.items()})
    _same(j, t)
    _same(j, (resumed, rw, rb))
    assert torch.equal(cw, t[1]) and torch.equal(cb, t[2])
    # a state of other names or shapes does not load
    bad = dict(numpy_sd, state=dict(numpy_sd["state"], slots={
        "w": numpy_sd["state"]["slots"]["w"]}))
    with pytest.raises(KeyError):
        resumed.set_state_dict(bad)


def test_eager_parameter_naming_rule_and_lr_setters():
    """A bare parameter is ``param_<i>`` by its position; a pair keeps its
    name; a parameter that needs no gradient is not updated; names must
    not repeat."""
    a = torch.nn.Parameter(torch.ones(2))
    b = torch.nn.Parameter(torch.ones(3))
    frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    o = topt.SGD(learning_rate=0.5, parameters=[a, ("named", b), frozen])
    assert [n for n, _ in o._parameter_list] == ["param_0", "named",
                                                 "param_2"]
    o.apply_gradients({"param_0": torch.ones(2), "named": torch.ones(3)})
    assert torch.equal(a, torch.full((2,), 0.5))
    assert torch.equal(b, torch.full((3,), 0.5))
    assert torch.equal(frozen, torch.ones(2))
    model = torch.nn.Linear(2, 2)
    named = topt.SGD(parameters=model.named_parameters())
    assert [n for n, _ in named._parameter_list] == ["weight", "bias"]
    with pytest.raises(ValueError, match="repeat"):
        topt.SGD(parameters=[("x", a), ("x", b)])
    with pytest.raises(ValueError, match="parameters="):
        topt.SGD().step()
    assert o.get_lr() == 0.5
    o.set_lr(0.25)
    o.apply_gradients({"param_0": torch.ones(2)})
    assert o.get_lr() == 0.25 and torch.equal(a, torch.full((2,), 0.25))


# ------------------------------------------------------------------- LBFGS
def _quad():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    A = A @ A.T + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    w0 = rng.normal(size=(6,)).astype(np.float32)
    return A, b, w0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_quadratic_matches_jax(line_search):
    """A quartic-perturbed quadratic: two steps of 6 inner iterations; the
    port's closure calls ``backward()``."""
    A, b, w0 = _quad()
    p = Parameter(jnp.asarray(w0), name="w")
    jo = jopt.LBFGS(learning_rate=1.0, max_iter=6, history_size=4,
                    line_search_fn=line_search, parameters=[p])
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def jclosure():
        w = p.value
        p.grad = Aj @ w - bj + 0.4 * w ** 3
        return 0.5 * w @ Aj @ w - bj @ w + 0.1 * jnp.sum(w ** 4)

    w = torch.nn.Parameter(torch.tensor(w0))
    to = topt.LBFGS(learning_rate=1.0, max_iter=6, history_size=4,
                    line_search_fn=line_search, parameters=[w])
    At, bt = torch.tensor(A), torch.tensor(b)

    def tclosure():
        to.clear_grad()
        loss = 0.5 * w @ At @ w - bt @ w + 0.1 * torch.sum(w ** 4)
        loss.backward()
        return loss

    for _ in range(2):
        want = jo.step(jclosure)
        got = to.step(tclosure)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, want, rtol=1e-5, atol=1e-5)
        _close(w, p.value, rtol=1e-5, atol=1e-5)
    for k in ("func_evals", "n_iter"):
        assert to.state_dict()["state"][k] == jo.state_dict()["state"][k]
    assert len(to.state_dict()["state"]["old_sks"]) == \
        len(jo.state_dict()["state"]["old_sks"])


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_rosenbrock_matches_jax(line_search):
    """The Rosenbrock closure of the JAX package's tests over two
    parameters, gradient by autograd on each side; a few outer steps."""
    import jax

    def rosen(x, y):
        return (1 - x) ** 2 + 100.0 * (y - x ** 2) ** 2

    px = Parameter(jnp.asarray(np.float32(-1.2)), name="x")
    py = Parameter(jnp.asarray(np.float32(1.0)), name="y")
    lr = 1.0 if line_search else 1e-3
    jo = jopt.LBFGS(learning_rate=lr, max_iter=10,
                    line_search_fn=line_search, parameters=[px, py])

    def jclosure():
        loss, (gx, gy) = jax.value_and_grad(rosen, argnums=(0, 1))(
            px.value, py.value)
        px.grad, py.grad = gx, gy
        return loss

    tx = torch.nn.Parameter(torch.tensor(-1.2))
    ty = torch.nn.Parameter(torch.tensor(1.0))
    to = topt.LBFGS(learning_rate=lr, max_iter=10,
                    line_search_fn=line_search, parameters=[tx, ty])

    def tclosure():
        to.clear_grad()
        loss = rosen(tx, ty)
        loss.backward()
        return loss

    for _ in range(3):
        _close(to.step(tclosure), jo.step(jclosure), rtol=1e-5, atol=1e-5)
        _close(tx, px.value, rtol=1e-5, atol=1e-5)
        _close(ty, py.value, rtol=1e-5, atol=1e-5)
    if line_search:
        assert float(rosen(tx, ty).detach()) < float(rosen(torch.tensor(-1.2),
                                                  torch.tensor(1.0)))
