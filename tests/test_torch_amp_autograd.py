"""The port's ``amp`` and ``autograd`` against the JAX package's on the
CPU: ``GradScaler`` over a scripted ``found_inf`` sequence (scale,
counters and ``state_dict`` after every update, ``scale``/``unscale_``/
``found_inf``), ``decorate`` at O1 and O2, ``auto_cast`` changing no
output (as in JAX, where no layer reads it), the functional transforms
(``jacobian``, ``hessian``, ``vjp``, ``jvp``), ``value_and_grad``,
``backward``, ``PyLayer`` and the top-level ``grad``; and a train step
inside ``no_grad()`` / ``set_grad_enabled(False)`` still trains, as the
JAX step does. Inputs come from numpy with a seed.

Tolerances: float32 both ways, 1e-6 for values and first derivatives,
1e-5 for Hessians and train steps."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import amp as jamp
from paddle_tpu import autograd as jag
from paddle_tpu import distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.autograd import functional as jfun
from paddle_tpu.core.functional import extract_params as j_extract
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import autograd as tag
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.autograd import functional as tfun
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.core.functional import extract_params as t_extract
from paddle_tpu_torch.trainer import TrainStep

EW = 1e-6
HESS = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(got, want, tol=EW):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(5, 8)
        self.fc2 = jnn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(jnp.tanh(self.fc1(x)))


class TMLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(5, 8, device="cpu")
        self.fc2 = tnn.Linear(8, 3, device="cpu")

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def mlp_pair():
    jm, tm = JMLP(), TMLP()
    load_numpy_state_dict(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 5)).astype(np.float32),
            rng.standard_normal((4, 3)).astype(np.float32))


def _mse_j(out, y):
    return jnp.mean((out - y) ** 2)


def _mse_t(out, y):
    return torch.mean((out - y) ** 2)


# ------------------------------------------------------------------- amp
def test_grad_scaler_state_machine_matches_jax():
    kw = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    script = [False, False, True, False, True, True, True, False, False,
              False, False, True, True, False, False, False, False]
    for bad in script:
        js.update(bad)
        ts.update(torch.tensor(bad))
        assert ts.state_dict() == js.state_dict()
    # scale, unscale_, found_inf
    loss = np.float32(1.5)
    close(ts.scale(torch.tensor(loss)), js.scale(jnp.asarray(loss)))
    grads = {"a": np.array([1.0, 2.0], np.float32),
             "b": [np.array([[4.0]], np.float32)]}
    tg = {"a": torch.tensor(grads["a"]), "b": [torch.tensor(grads["b"][0])]}
    jg = {"a": jnp.asarray(grads["a"]), "b": [jnp.asarray(grads["b"][0])]}
    close(ts.unscale_(tg)["a"], js.unscale_(jg)["a"])
    close(ts.unscale_(tg)["b"][0], js.unscale_(jg)["b"][0])
    f = ts.found_inf(tg)
    assert isinstance(f, torch.Tensor) and f.dtype == torch.bool
    assert not bool(f) and not bool(js.found_inf(jg))
    tg["b"][0][0, 0] = float("inf")
    jg["b"][0] = jg["b"][0].at[0, 0].set(jnp.inf)
    assert bool(ts.found_inf(tg)) and bool(js.found_inf(jg))
    # state_dict round trip and the disabled scaler
    other = tamp.GradScaler()
    other.load_state_dict(ts.state_dict())
    assert other.state_dict() == ts.state_dict()
    off = tamp.GradScaler(enable=False)
    t = torch.tensor(2.0)
    assert off.scale(t) is t and not off.is_enable()
    off.update(True)
    assert off.state_dict() == jamp.GradScaler(enable=False).state_dict()


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_matches_jax(level):
    jm, tm = mlp_pair()
    jo, to = jopt.AdamW(multi_precision=False), topt.AdamW(
        multi_precision=False)
    jm2, jo2 = jamp.decorate(jm, jo, level=level)
    tm2, to2 = tamp.decorate(tm, to, level=level)
    assert tm2 is tm and to2 is to
    assert to.multi_precision == jo.multi_precision is True
    jd = {k: str(np.asarray(v).dtype) for k, v in jm.state_dict().items()}
    td = {k: str(v.dtype).replace("torch.", "")
          for k, v in tm.state_dict().items()}
    assert td == jd
    if level == "O2":
        assert set(td.values()) == {"bfloat16"}
        close(tm.fc1.weight, jm.fc1.weight.value)
    # lists, and master_weight=False
    models, opts = tamp.decorate([TMLP()], [topt.SGD(0.1)], level="O1",
                                 master_weight=False)
    assert isinstance(models, list) and opts[0].multi_precision is False
    assert tamp.decorate(tm, level="O1") is tm


def test_auto_cast_changes_no_output_as_in_jax():
    jm, tm = mlp_pair()
    x, _ = _inputs()
    plain = tm(torch.tensor(x))
    assert tamp.amp_state() is None and tamp.get_amp_dtype() is None
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        inside = tm(torch.tensor(x))
        assert tamp.get_amp_dtype() == torch.bfloat16
        assert tamp.amp_state()["level"] == "O1"
        with tamp.amp_guard(enable=False):
            assert tamp.get_amp_dtype() is None
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jinside = jm(jnp.asarray(x))
    assert torch.equal(inside, plain) and inside.dtype == torch.float32
    close(inside, jinside)
    assert tamp.amp_state() is None
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()


# -------------------------------------------------------------- autograd
def _f(x, y):
    return jnp.sin(x) * y + x ** 2


def _ft(x, y):
    return torch.sin(x) * y + x ** 2


def _scalar_j(x, y):
    return jnp.sum(jnp.sin(x) * y ** 2) + jnp.sum(x ** 3)


def _scalar_t(x, y):
    return torch.sum(torch.sin(x) * y ** 2) + torch.sum(x ** 3)


def test_functional_transforms_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal(3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.tensor(a), \
        torch.tensor(b)
    close(tfun.jacobian(lambda x: _ft(x, tb), ta),
          jfun.jacobian(lambda x: _f(x, jb), ja))
    close(tfun.jacobian(_ft, (ta, tb)), jfun.jacobian(_f, (ja, jb)))
    close(tfun.hessian(lambda x: _scalar_t(x, tb), ta),
          jfun.hessian(lambda x: _scalar_j(x, jb), ja), HESS)
    th = tfun.hessian(_scalar_t, (ta, tb))
    jh = jfun.hessian(_scalar_j, (ja, jb))
    for i in range(2):
        close(th[i], jh[i], HESS)
    v = rng.standard_normal(3).astype(np.float32)
    close(tfun.vjp(_ft, (ta, tb), torch.tensor(v)),
          jfun.vjp(_f, (ja, jb), jnp.asarray(v)))
    close(tfun.vjp(lambda x: _ft(x, tb), ta),
          jfun.vjp(lambda x: _f(x, jb), ja))
    close(tfun.jvp(_ft, (ta, tb)), jfun.jvp(_f, (ja, jb)))
    close(tfun.jvp(lambda x: _ft(x, tb), ta, torch.tensor(v)),
          jfun.jvp(lambda x: _f(x, jb), ja, jnp.asarray(v)))
    assert tag.jacobian is tfun.jacobian
    # the top-level grad: the callable and its inputs, one gradient each
    close(tpt.grad(_scalar_t, (ta, tb)), jpt.grad(_scalar_j, (ja, jb)))
    close(tpt.grad(lambda x: _scalar_t(x, tb), ta),
          jpt.grad(lambda x: _scalar_j(x, jb), ja))
    with pytest.raises(TypeError):
        tpt.grad(ta, ta)
    with pytest.raises(TypeError):
        jpt.grad(ja, ja)


def test_value_and_grad_and_backward_match_jax():
    jm, tm = mlp_pair()
    x, y = _inputs(3)
    jl, jg = jag.value_and_grad(jm, _mse_j)(j_extract(jm), jnp.asarray(x),
                                            jnp.asarray(y))
    tl, tg = tag.value_and_grad(tm, _mse_t)(t_extract(tm), torch.tensor(x),
                                            torch.tensor(y))
    close(tl, jl)
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k], jg[k])
    # without loss_fn the model's own output is the loss
    class Scalar(tnn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, y):
            return _mse_t(self.inner(x), y)

    sl, sg = tag.value_and_grad(Scalar(tm))(t_extract(Scalar(tm)),
                                            torch.tensor(x), torch.tensor(y))
    close(sl, jl)
    close(sg["inner.fc1.weight"], jg["fc1.weight"])
    bl, bg = tag.backward(tm, _mse_t, torch.tensor(x), torch.tensor(y))
    jbl, jbg = jag.backward(jm, _mse_j, jnp.asarray(x), jnp.asarray(y))
    close(bl, jbl)
    for n, p in tm.named_parameters():
        close(p.grad, jbg[n])
    # no_grad is torch's, as a context and as a decorator
    with tag.no_grad():
        assert not torch.is_grad_enabled()
    assert tpt.no_grad is tag.no_grad
    assert tag.no_grad(lambda: torch.is_grad_enabled())() is False


class _JCube(jag.PyLayer):
    @staticmethod
    def forward(ctx, x, w):
        ctx.saved = (x, w)
        return x ** 3 * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved
        return g * 3 * x ** 2 * w * 0.5, g * x ** 3


class _TCube(tag.PyLayer):
    @staticmethod
    def forward(ctx, x, w):
        ctx.saved = (x, w)
        return x ** 3 * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved
        return g * 3 * x ** 2 * w * 0.5, g * x ** 3


def test_py_layer_matches_jax_custom_vjp():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(5).astype(np.float32)
    w = rng.standard_normal(5).astype(np.float32)
    jout = _JCube.apply(jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(_JCube.apply(a, b)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tout = _TCube.apply(tx, tw)
    tout.sum().backward()
    close(tout, jout)
    close(tx.grad, jgx)  # the custom (halved) rule, not autograd's
    close(tw.grad, jgw)


def test_grad_mode_names():
    assert tpt.is_grad_enabled() and jpt.is_grad_enabled()
    with tpt.set_grad_enabled(False):
        assert not tpt.is_grad_enabled()
    assert tpt.is_grad_enabled()
    tpt.set_grad_enabled(False)
    try:
        assert not tpt.is_grad_enabled()
    finally:
        tpt.set_grad_enabled(True)


@pytest.mark.parametrize("mode", ["no_grad", "set_grad_enabled"])
def test_train_step_inside_no_grad_still_trains(mode):
    jm, tm = mlp_pair()
    rng = np.random.default_rng(5)
    batches = [{"input": rng.standard_normal((4, 5)).astype(np.float32),
                "label": rng.standard_normal((4, 3)).astype(np.float32)}
               ] * 3
    mesh = jdist.build_mesh(devices=jax.devices()[:1])
    jts = JTrainStep(jm, jopt.AdamW(learning_rate=0.05), mesh,
                     loss_fn=_mse_j)
    want = [float(jts.run({k: jnp.asarray(v) for k, v in b.items()}))
            for b in batches]
    ts = TrainStep(tm, topt.AdamW(learning_rate=0.05), loss_fn=_mse_t)
    ctx = tpt.no_grad() if mode == "no_grad" else tpt.set_grad_enabled(False)
    with ctx:
        got = [float(ts.run(b)) for b in batches]
        assert not torch.is_grad_enabled()
    np.testing.assert_allclose(got, want, rtol=HESS, atol=HESS)
    assert got[-1] < got[0]
