"""The port's module system (``paddle_tpu_torch/core/{module,parameter,
functional}.py``, ``nn/layer/{common,activation}.py``, ``nn/utils.py``)
against the JAX package on the CPU. Every case of ``tests/test_module.py``
runs on both packages from the same numpy weights and inputs, then the
points where the JAX ``Layer`` and ``nn.Module`` part: the state dict
with a prefix and non-persistable buffers, ``set_state_dict``'s results
and errors, hooks and ``remove()``, ``apply``'s order, ``to("bfloat16")``,
a float assigned to a buffer; the containers, ``functional_call``, the
activation layers and ``nn.utils``. Every port model is a ``Layer`` whose
``state_dict()`` keys are the JAX model's. Float32 outputs within 1e-6
(1e-5 through a product's sums) unless a case says otherwise."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core import functional as jfunc
from paddle_tpu.nn import utils as jutils
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import functional as tfunc
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.nn import utils as tutils


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's layers built on the CPU; the current device and seed
    restored after each test."""
    from paddle_tpu_torch.core import device as core_device

    saved = core_device._current, trandom.get_seed()
    tdevice.set_device("cpu")
    yield
    core_device.set_current(saved[0])
    trandom.seed(saved[1])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _state(jlayer):
    return {k: np.asarray(v) for k, v in jlayer.state_dict().items()}


def _mlp(nn):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.act = nn.ReLU()
            self.fc2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    return MLP()


def _pair():
    """The JAX MLP and the port's with its weights."""
    jm, tm = _mlp(jnn), _mlp(tnn)
    assert tm.set_state_dict(_state(jm)) == ([], [])
    return jm, tm


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------- the cases of test_module.py
def test_parameter_registration():
    jm, tm = _pair()
    names = dict(tm.named_parameters())
    jnames = dict(jm.named_parameters())
    assert list(names) == list(jnames) == ["fc1.weight", "fc1.bias",
                                           "fc2.weight", "fc2.bias"]
    assert names["fc1.weight"].shape == (8, 16)
    assert len(tm.parameters()) == len(jm.parameters()) == 4
    assert len(tm.sublayers()) == len(jm.sublayers()) == 3
    # a parameter made without a name takes its qualified name
    assert [p.name for p in names.values()] == \
        [p.name for p in jnames.values()] == list(names)
    assert all(isinstance(p, tnn.Parameter) for p in names.values())


def test_forward_matches_numpy_and_jax():
    jm, tm = _pair()
    x = _x(3, 8)
    y = tm(torch.from_numpy(x))
    w1, b1, w2, b2 = (_np(p) for p in tm.parameters())
    _close(y, np.maximum(x @ w1 + b1, 0) @ w2 + b2, 1e-5)
    _close(y, jm(jnp.asarray(x)), 1e-6)


def test_state_dict_roundtrip():
    jm, tm = _pair()
    other = _mlp(tnn)
    sd = tm.state_dict()
    assert list(sd) == list(jm.state_dict())
    assert other.set_state_dict(sd) == ([], [])
    x = torch.ones((2, 8))
    _close(other(x), tm(x), 1e-6)
    # the loaded values are copies: training one leaves the other
    with torch.no_grad():
        other.fc1.weight.add_(1.0)
    assert not torch.equal(other.fc1.weight, tm.fc1.weight)


def test_functional_call_pure():
    """A forward at other values equals the eager one, and the gradients
    by ``torch.func.grad`` equal ``jax.grad``'s."""
    jm, tm = _pair()
    x = _x(2, 8, seed=1)
    params = tfunc.extract_params(tm)
    eager = tm(torch.from_numpy(x))
    _close(tfunc.functional_call(tm, params, torch.from_numpy(x)), eager)
    _close(tfunc.module_fn(tm)(params, torch.from_numpy(x)), eager)
    grads = torch.func.grad(lambda p: tfunc.functional_call(
        tm, p, torch.from_numpy(x)).sum())(params)
    jparams = jfunc.extract_params(jm)
    jgrads = jax.grad(lambda p: jfunc.functional_call(
        jm, p, jnp.asarray(x)).sum())(jparams)
    assert set(grads) == set(jgrads) == set(params)
    for name, g in grads.items():
        _close(g, jgrads[name], 1e-5)
    # bind_params restores the layer's own values on exit
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    with tfunc.bind_params(tm, zeros):
        assert float(tm(torch.from_numpy(x)).abs().sum()) == 0.0
    _close(tm(torch.from_numpy(x)), eager)
    with pytest.raises(KeyError, match="unknown parameter"):
        with tfunc.bind_params(tm, {"fc1.nope": zeros["fc1.weight"]}):
            pass
    assert set(tfunc.extract_param_objs(tm, trainable_only=True)) == \
        set(params)


def test_hooks():
    """Pre- and post-hooks run in order, may replace the input and the
    output, and ``remove()`` takes them off: the same outputs as JAX."""
    jm, tm = _pair()
    x = _x(1, 8, seed=2)
    outs = []
    for m, arr in ((jm, jnp.asarray(x)), (tm, torch.from_numpy(x))):
        calls = []
        h1 = m.register_forward_pre_hook(
            lambda layer, args: calls.append("pre") or args[0] * 2)
        h2 = m.register_forward_post_hook(
            lambda layer, args, out: calls.append("post") or out + 1)
        outs.append(m(arr))
        assert calls == ["pre", "post"]
        h1.remove()
        h2.remove()
        calls.clear()
        outs.append(m(arr))
        assert calls == []
    _close(outs[2], outs[0])
    _close(outs[3], outs[1])


def test_train_eval_mode_dropout():
    """Dropout drops about p of the elements in training (from the port's
    generator, reseeded by ``seed``, or one given to the call) and is the
    identity in eval, as the JAX layer."""
    x = torch.ones((100, 100))
    drop, jdrop = tnn.Dropout(0.5), jnn.Dropout(0.5)
    trandom.seed(0)
    y = drop(x)
    pt.seed(0)
    jy = np.asarray(jdrop(jnp.ones((100, 100))))
    for out in (y.numpy(), jy):
        assert (out == 0).mean() > 0.3
        assert set(np.unique(out)) <= {0.0, 2.0}
    trandom.seed(0)
    assert torch.equal(drop(x), y)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x, generator=g), y)
    drop.eval()
    jdrop.eval()
    assert torch.equal(drop(x), x)
    np.testing.assert_array_equal(np.asarray(jdrop(jnp.ones((100, 100)))),
                                  x.numpy())
    # no generator is held: the layer deep-copies
    assert copy.deepcopy(drop).p == 0.5


def test_to_dtype_cast():
    """``to(bfloat16)`` and ``to("bfloat16")`` cast the floating
    parameters and buffers and the layer's dtype, as JAX; ``to`` a
    torch dtype keeps torch's meaning."""
    jm, tm = _pair()
    jm.to(pt.bfloat16)
    tm.to("bfloat16")
    for (n, p), (jn, jp) in zip(tm.named_parameters(),
                                jm.named_parameters()):
        assert (n, str(p.dtype)) == (jn, "torch." + str(jp.dtype))
    assert tm.fc1._dtype == torch.bfloat16
    x = _x(2, 8, seed=3)
    y = tm(torch.from_numpy(x).to(torch.bfloat16))
    jy = jm(jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y, jy, 2e-2)
    tm.to(torch.float16)
    assert tm.fc2.weight.dtype == torch.float16
    tm.astype("float32")
    assert tm.fc2.weight.dtype == torch.float32 and \
        tm.fc2._dtype == torch.float32
    tm.to("cpu")  # a device string keeps torch's meaning
    assert tm.fc2.weight.device.type == "cpu"
    assert isinstance(tm.fc2.weight, tnn.Parameter)


def test_to_keeps_weight_only_scales_float32():
    """The one place the port leaves JAX's rule: a ``WeightOnlyLinear``'s
    ``scale`` and ``act_scale`` stay float32 through a cast of the layer,
    since row 4 takes its scales in float32 (the JAX layer casts them);
    the bias casts, and the layer still computes at bf16."""
    from paddle_tpu_torch import quantization as tquant

    lin = tnn.Linear(64, 32)
    wol = tquant.WeightOnlyLinear(lin, weight_dtype="int4", group_size=32)
    y32 = wol(torch.ones((2, 64)))
    seq = tnn.Sequential(wol).to("bfloat16")
    assert wol.scale.dtype == torch.float32
    assert wol.act_scale.dtype == torch.float32
    assert wol.qweight.dtype == torch.int8
    assert wol.bias.dtype == torch.bfloat16
    y = seq(torch.ones((2, 64), dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    _close(y, y32, 2e-2)
    wol.half()
    assert wol.scale.dtype == torch.float32


def _with_buffers(nn, array):
    class WithBuf(nn.Layer):
        def __init__(self):
            super().__init__()
            self.register_buffer("running", array(np.zeros(3, np.float32)))
            self.register_buffer("tmp", array(np.ones(2, np.float32)),
                                 persistable=False)
            self.inner = nn.Linear(3, 2)

        def forward(self, x):
            return self.inner(x + self.running[0])

    return WithBuf()


def test_buffers_prefix_and_include_sublayers():
    jm = _with_buffers(jnn, jnp.asarray)
    tm = _with_buffers(tnn, torch.from_numpy)
    for m in (jm, tm):
        sd = m.state_dict()
        assert "running" in sd and "tmp" not in sd
    assert set(tm.state_dict()) == set(jm.state_dict())
    assert set(tm.state_dict(structured_name_prefix="net")) == \
        set(jm.state_dict(structured_name_prefix="net"))
    # include_sublayers=False keeps the layer's own entries; the JAX Layer
    # ignores the flag (ROADMAP Queue C), so its own are the dotless keys
    for pre in ("", "a"):
        got = tm.state_dict(include_sublayers=False,
                            structured_name_prefix=pre)
        own = [k for k in jm.state_dict(structured_name_prefix=pre)
               if "." not in k[len(pre) + 1 if pre else 0:]]
        assert list(got) == own == [f"{pre}.running" if pre else "running"]
    # torch's own keywords still work, as nn.Module's children call them
    assert list(tm.state_dict(prefix="p.", keep_vars=True)) == \
        ["p.running", "p.inner.weight", "p.inner.bias"]
    assert isinstance(tm.state_dict(keep_vars=True)["inner.weight"],
                      tnn.Parameter)
    # buffers() and named_buffers() include the non-persistable one
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()] == ["running", "tmp"]
    assert len(tm.buffers()) == len(jm.buffers()) == 2
    # a number or array becomes a tensor on the current device
    tm.register_buffer("extra", 1.5)
    assert tm.extra.dtype == torch.float32 and tm.extra.device.type == "cpu"


def test_set_state_dict_results_and_errors():
    """``(missing, unexpected)`` as JAX gives them (missing lists
    parameters only); a shape mismatch raises ``ValueError``; values are
    cast to the parameter's dtype; non-persistable buffers load too."""
    jm = _with_buffers(jnn, jnp.asarray)
    tm = _with_buffers(tnn, torch.from_numpy)
    state = {"inner.weight": np.full((3, 2), 0.5, np.float64),
             "tmp": np.array([7.0, 8.0]), "running": np.ones(3),
             "nope": np.zeros(1)}
    got = tm.set_state_dict(state)
    want = jm.set_state_dict(state)
    assert got == (["inner.bias"], ["nope"]) and list(got) == list(want)
    assert tm.inner.weight.dtype == torch.float32
    _close(tm.inner.weight, jm.inner.weight.value)
    _close(tm.tmp, jm._buffers["tmp"])
    _close(tm.running, jm._buffers["running"])
    assert tm.load_dict({"inner.bias": np.ones(2)}) == (
        ["inner.weight"], [])
    for m in (tm, jm):
        with pytest.raises(ValueError, match="shape mismatch"):
            m.set_state_dict({"inner.weight": np.zeros((2, 3))})


def test_apply_visits_the_layer_first():
    """JAX order: the layer itself, then its sublayers depth first (torch's
    ``nn.Module.apply`` visits the children first)."""
    def nested(nn):
        return nn.Sequential(nn.Linear(2, 2), nn.Sequential(
            nn.ReLU(), nn.Linear(2, 2)), nn.Tanh())

    orders = []
    for nn in (jnn, tnn):
        names = []
        nested(nn).apply(lambda layer: names.append(type(layer).__name__))
        orders.append(names)
    assert orders[0] == orders[1] == ["Sequential", "Linear", "Sequential",
                                      "ReLU", "Linear", "Tanh"]


def test_float_assigned_to_a_buffer_becomes_a_tensor():
    jm = _with_buffers(jnn, jnp.asarray)
    tm = _with_buffers(tnn, torch.from_numpy)
    jm.running = 0.25
    tm.running = 0.25
    assert isinstance(tm.running, torch.Tensor)
    assert tm.running.dtype == torch.float32
    _close(tm.running, jm._buffers["running"])
    assert "running" in tm.state_dict()
    tm.tmp = np.arange(2)
    assert tm.tmp.dtype == torch.int64 and "tmp" not in tm.state_dict()
    plain = torch.nn.Module()
    plain.register_buffer("b", torch.zeros(()))
    with pytest.raises(TypeError):
        plain.b = 0.25


def test_containers_match_jax():
    jseq = jnn.Sequential(("a", jnn.Linear(4, 4)), ("b", jnn.ReLU()),
                          ("c", jnn.Linear(4, 2)))
    tseq = tnn.Sequential([("a", tnn.Linear(4, 4)), ("b", tnn.ReLU()),
                           ("c", tnn.Linear(4, 2))])
    assert tseq.set_state_dict(_state(jseq)) == ([], [])
    x = _x(1, 4, seed=4)
    _close(tseq(torch.from_numpy(x)), jseq(jnp.asarray(x)))
    assert len(tseq) == 3 and isinstance(tseq[-1], tnn.Linear)
    assert [type(m).__name__ for m in tseq] == ["Linear", "ReLU", "Linear"]

    ll = tnn.LayerList([tnn.Linear(2, 2) for _ in range(3)])
    jll = jnn.LayerList([jnn.Linear(2, 2) for _ in range(3)])
    for m, new in ((ll, tnn.Tanh()), (jll, jnn.Tanh())):
        m.append(new)
        m.insert(1, type(new)())
    assert len(ll) == len(jll) == 5
    assert [type(m).__name__ for m in ll] == \
        [type(m).__name__ for m in jll]
    assert ll[-1] is list(ll)[-1] and len(ll[1:3]) == 2
    assert len(ll.parameters()) == len(jll.parameters()) == 6
    ll.extend([tnn.ReLU()])
    ll[0] = tnn.Identity()
    assert len(ll) == 6 and isinstance(ll[0], tnn.Identity)

    pl = tnn.ParameterList([tnn.Parameter(torch.ones(2)) for _ in range(2)])
    pl.append(tnn.Parameter(torch.zeros(3)))
    assert len(pl) == 3 and pl[2].shape == (3,)
    assert list(pl.state_dict()) == ["0", "1", "2"]

    ld = tnn.LayerDict({"x": tnn.ReLU(), "y": tnn.Tanh()})
    jld = jnn.LayerDict({"x": jnn.ReLU(), "y": jnn.Tanh()})
    for d, new in ((ld, tnn.Identity()), (jld, jnn.Identity())):
        d["z"] = new
        d.pop("x")
    assert list(ld.keys()) == list(jld.keys()) == ["y", "z"]
    assert "y" in ld and len(ld) == 2
    del ld["y"]
    assert list(ld) == ["z"]
    ld.clear()
    assert len(ld) == 0

    x = _x(2, 3, 4, 5, seed=5)
    for kw in (dict(), dict(start_axis=0, stop_axis=1),
               dict(start_axis=2)):
        _close(tnn.Flatten(**kw)(torch.from_numpy(x)),
               jnn.Flatten(**kw)(jnp.asarray(x)))
    _close(tnn.Identity()(torch.from_numpy(x)), x)


def test_embedding_matches_jax():
    """Weights Normal(0, 1) (the law; the numbers carried across), the
    padding row zero and looking up zeros with no gradient."""
    jemb = jnn.Embedding(10, 4, padding_idx=3)
    temb = tnn.Embedding(10, 4, padding_idx=3)
    assert float(temb.weight[3].detach().abs().sum()) == 0.0
    temb.set_state_dict(_state(jemb))
    ids = np.array([[1, 3, 3, 9], [0, 2, 3, 5]])
    out = temb(torch.from_numpy(ids))
    _close(out, jemb(jnp.asarray(ids)))
    out.sum().backward()
    assert float(temb.weight.grad[3].abs().sum()) == 0.0
    assert float(temb.weight.grad[1].sum()) == 4.0
    big = tnn.Embedding(1000, 64)
    assert abs(float(big.weight.detach().std()) - 1.0) < 0.03


ACTS = [
    ("ReLU", {}), ("ReLU6", {}), ("GELU", {}),
    ("GELU", {"approximate": True}), ("SiLU", {}), ("Swish", {}),
    ("Sigmoid", {}), ("Tanh", {}), ("LeakyReLU", {"negative_slope": 0.2}),
    ("ELU", {"alpha": 0.7}), ("Softmax", {"axis": 1}),
    ("LogSoftmax", {}), ("Hardswish", {}), ("Hardsigmoid", {}),
    ("Mish", {}), ("Softplus", {"beta": 2.0}), ("GLU", {"axis": 1}),
    ("PReLU", {"num_parameters": 6, "init": 0.1}), ("SELU", {}),
    ("CELU", {"alpha": 1.5}), ("LogSigmoid", {}), ("Softsign", {}),
    ("Hardshrink", {"threshold": 0.7}), ("Softshrink", {"threshold": 0.3}),
    ("Tanhshrink", {}), ("ThresholdedReLU", {"threshold": 0.5}),
    ("Hardtanh", {"min": -0.5, "max": 2.0}), ("RReLU", {}),
]


@pytest.mark.parametrize("name,kw", ACTS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(ACTS)])
def test_activation_layers_match_jax(name, kw):
    """All 27 activation layers (Swish is SiLU) on the same input, beyond
    the thresholds and the saturations; RReLU in eval (its training slopes
    are draws: within [lower, upper])."""
    x = np.concatenate([np.linspace(-30, 30, 61), _x(59, seed=6) * 3])
    x = x.astype(np.float32).reshape(4, 6, 5)
    tl, jl = getattr(tnn, name)(**kw), getattr(jnn, name)(**kw)
    tol = 1e-6
    if name == "PReLU":
        tl.set_state_dict(_state(jl))
        assert len(tl.parameters()) == 1
    if name == "RReLU":
        trandom.seed(0)
        y = tl(torch.from_numpy(x)).numpy()
        neg = x < 0
        slope = y[neg] / x[neg]
        assert (slope >= 1 / 8 - 1e-6).all() and (slope <= 1 / 3 + 1e-6).all()
        tl.eval()
        jl.eval()
    if name in ("Softmax", "LogSoftmax", "GELU"):
        tol = 1e-5
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), tol)


def test_every_port_model_is_a_layer_with_the_jax_state_dict_keys():
    """The tiny Llama, Mamba and UNet: the model and every sublayer a
    ``Layer``, every parameter a ``Parameter``, the ``state_dict()`` keys
    and shapes those of the JAX model (built under JAX's meta init:
    shapes only), and a deep copy equal to the model."""
    from paddle_tpu.core.meta import meta_init
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels

    for name, cfg in (("LlamaForCausalLM", "LlamaConfig"),
                      ("MambaForCausalLM", "MambaConfig"),
                      ("UNet2DConditionModel", "UNetConfig")):
        tm = getattr(tmodels, name)(getattr(tmodels, cfg).tiny())
        with meta_init():
            jm = getattr(jmodels, name)(getattr(jmodels, cfg).tiny())
        assert isinstance(tm, tnn.Layer)
        assert all(isinstance(m, tnn.Layer)
                   for m in tm.sublayers(include_self=True)), name
        assert all(isinstance(p, tnn.Parameter) for p in tm.parameters())
        assert set(tm.state_dict()) == set(jm.state_dict()), name
        shapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
            shapes
        # no layer holds a generator: QAT(inplace=False) deep-copies
        twin = copy.deepcopy(tm)
        assert all(torch.equal(a, b) for a, b in zip(
            twin.state_dict().values(), tm.state_dict().values()))


def test_layer_adds_no_call_path():
    """``Layer`` keeps ``nn.Module``'s call: no ``__call__``, no
    ``__getattr__`` of its own."""
    assert tnn.Layer.__call__ is torch.nn.Module.__call__
    assert "__getattr__" not in vars(tnn.Layer)
    assert "forward" not in vars(tnn.Layer)


def test_parameter_deepcopies_and_pickles_with_its_attributes():
    p = tnn.Parameter(torch.arange(4.0), name="w")
    p.optimize_attr["learning_rate"] = 0.5
    p.trainable = False
    for q in (copy.deepcopy(p), _round_trip(p)):
        assert isinstance(q, tnn.Parameter)
        assert (q.name, q.trainable, q.optimize_attr) == \
            ("w", False, {"learning_rate": 0.5})
        assert torch.equal(q, p) and q.data_ptr() != p.data_ptr()


def _round_trip(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=False)


# -------------------------------------------------------------- nn.utils
def test_weight_norm_matches_jax():
    """w = g v / ||v|| over dim 0, 1 and all: the forward and the
    gradients reaching g and v equal JAX's; remove_weight_norm folds
    them back into the same weight."""
    x = _x(3, 6, seed=7)
    for dim in (0, 1, None):
        jl, tl = jnn.Linear(6, 5), tnn.Linear(6, 5)
        tl.set_state_dict(_state(jl))
        jutils.weight_norm(jl, dim=dim)
        tutils.weight_norm(tl, dim=dim)
        assert set(tl.state_dict()) == set(jl.state_dict()) == \
            {"bias", "weight_g", "weight_v"}
        _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), 1e-5)
        params = tfunc.extract_params(tl)
        grads = torch.func.grad(lambda p: (tfunc.functional_call(
            tl, p, torch.from_numpy(x)) ** 2).sum())(params)
        jgrads = jax.grad(lambda p: (jfunc.functional_call(
            jl, p, jnp.asarray(x)) ** 2).sum())(jfunc.extract_params(jl))
        for name in ("weight_g", "weight_v", "bias"):
            _close(grads[name], jgrads[name], 1e-5)
        tutils.remove_weight_norm(tl)
        jutils.remove_weight_norm(jl)
        _close(tl.weight, jl.weight.value, 1e-6)
        assert set(tl.state_dict()) == {"weight", "bias"}
    with pytest.raises(ValueError, match="not weight-normed"):
        tutils.remove_weight_norm(tl)


def test_spectral_norm_matches_jax():
    """The power iteration from the JAX layer's ``u`` (carried across):
    the same normalised weight and the same advanced ``u``, call after
    call."""
    x = _x(2, 6, seed=8)
    jl, tl = jnn.Linear(6, 5), tnn.Linear(6, 5)
    tl.set_state_dict(_state(jl))
    jutils.spectral_norm(jl, n_power_iterations=2)
    tutils.spectral_norm(tl, n_power_iterations=2)
    assert set(tl.state_dict()) == set(jl.state_dict())
    u = tl.weight_u
    assert abs(float(torch.linalg.norm(u)) - 1.0) < 1e-6
    tl.set_state_dict(_state(jl))
    for _ in range(3):
        _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), 1e-5)
        _close(tl.weight_u, jl._buffers["weight_u"], 1e-5)


def test_clip_and_vector_utils_match_jax():
    rng = np.random.default_rng(9)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2))]
    for norm_type, max_norm in ((2.0, 1.0), (1.0, 2.0),
                                (float("inf"), 0.5), (2.0, 100.0)):
        tps = [tnn.Parameter(torch.zeros(g.shape)) for g in grads]
        jps = [pt.Parameter(jnp.zeros(g.shape)) for g in grads]
        for tp, jp, g in zip(tps, jps, grads):
            tp.grad = torch.from_numpy(g.copy())
            jp.grad = jnp.asarray(g)
        total = tutils.clip_grad_norm_(tps, max_norm, norm_type)
        jtotal = jutils.clip_grad_norm_(jps, max_norm, norm_type)
        _close(total, jtotal, 1e-6)
        for tp, jp in zip(tps, jps):
            _close(tp.grad, jp.grad, 1e-6)
    tutils.clip_grad_value_(tps, 0.1)
    jutils.clip_grad_value_(jps, 0.1)
    for tp, jp in zip(tps, jps):
        _close(tp.grad, jp.grad)
    vec = tutils.parameters_to_vector(tps)
    assert vec.shape == (21,)
    tutils.vector_to_parameters(torch.arange(21.0), tps)
    jutils.vector_to_parameters(jnp.arange(21.0), jps)
    for tp, jp in zip(tps, jps):
        _close(tp, jp.value)
    assert float(tutils.clip_grad_norm_([tnn.Parameter(torch.ones(1))],
                                        1.0)) == 0.0
