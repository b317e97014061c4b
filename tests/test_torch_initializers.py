"""The port's initializers, dtypes and devices
(``paddle_tpu_torch/core/{initializer,dtype,device,random}.py``,
``paddle_tpu_torch/device.py``) against the JAX package on the CPU: the
deterministic initializers, ``calculate_gain`` and the fans exactly
equal; the random ones by their bounds and moments (the two frameworks
draw other numbers from one seed); Orthogonal by Q^T Q = I; one seed
giving one draw; ``create_parameter``'s defaults and ``ParamAttr``."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import dtype as jdtype
from paddle_tpu.core import initializer as JI
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core import initializer as TI
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.core.module import Layer
from paddle_tpu_torch.core.parameter import ParamAttr, Parameter


@pytest.fixture
def on_cpu():
    """The port's current device set to the CPU, and its seed and default
    dtype, restored after the test."""
    from paddle_tpu_torch.core import device as core_device

    saved = core_device._current, trandom.get_seed(), \
        tdtype.get_default_dtype()
    tdevice.set_device("cpu")
    yield
    core_device.set_current(saved[0])
    trandom.seed(saved[1])
    tdtype.set_default_dtype(saved[2])


def _jax(init, shape):
    return np.asarray(init(jax.random.PRNGKey(0), shape, jnp.float32))


DETERMINISTIC = [
    ("constant", lambda m: m.Constant(0.37), (3, 5)),
    ("assign", lambda m: m.Assign(np.arange(12.0).reshape(3, 4) / 7), (3, 4)),
    ("dirac", lambda m: m.Dirac(), (6, 4, 3, 3)),
    ("dirac_groups", lambda m: m.Dirac(groups=2), (8, 3, 3, 5)),
    ("dirac_1d", lambda m: m.Dirac(), (4, 4, 5)),
    ("bilinear", lambda m: m.Bilinear(), (2, 3, 4, 4)),
    ("bilinear_odd", lambda m: m.Bilinear(), (1, 2, 5, 3)),
]


@pytest.mark.parametrize("name,make,shape", DETERMINISTIC,
                         ids=[c[0] for c in DETERMINISTIC])
def test_deterministic_initializers_equal_jax(name, make, shape, on_cpu):
    got = make(TI)(shape).numpy()
    np.testing.assert_array_equal(got, _jax(make(JI), shape))


def test_calculate_gain_and_fans_equal_jax():
    for nl in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d",
               "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
               "tanh", "relu", "leaky_relu", "selu"):
        assert TI.calculate_gain(nl) == JI.calculate_gain(nl)
    assert TI.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)
    for shape in ((), (7,), (3, 5), (8, 4, 3, 3), (6, 2, 5)):
        assert TI._fan_in_out(shape) == JI._fan_in_out(shape)
    for bad in (TI, JI):
        with pytest.raises(ValueError, match="unknown nonlinearity"):
            bad.calculate_gain("swish")


R2 = math.sqrt(2.0)
RANDOM = [
    # name, initializer of either package, shape, (low, high) or None,
    # mean, std
    ("normal", lambda m: m.Normal(0.5, 2.0), (256, 256), None, 0.5, 2.0),
    ("truncated", lambda m: m.TruncatedNormal(0.1, 0.5), (256, 256),
     (0.1 - 1.0, 0.1 + 1.0), 0.1, 0.5 * 0.8796),
    ("truncated_ab", lambda m: m.TruncatedNormal(0.0, 1.0, -1.0, 3.0),
     (256, 256), (-1.0, 3.0), None, None),
    ("uniform", lambda m: m.Uniform(-0.3, 0.7), (256, 256), (-0.3, 0.7),
     0.2, 1.0 / math.sqrt(12)),
    ("xavier_normal", lambda m: m.XavierNormal(), (300, 200), None, 0.0,
     math.sqrt(2.0 / 500)),
    ("xavier_uniform", lambda m: m.XavierUniform(gain=2.0), (300, 200),
     (-2 * math.sqrt(6.0 / 500), 2 * math.sqrt(6.0 / 500)), 0.0,
     2 * math.sqrt(6.0 / 500) / math.sqrt(3)),
    ("kaiming_normal", lambda m: m.KaimingNormal(), (64, 32, 3, 3), None,
     0.0, R2 / math.sqrt(32 * 9)),
    ("kaiming_leaky", lambda m: m.KaimingNormal(
        negative_slope=0.2, nonlinearity="leaky_relu"), (400, 300), None,
     0.0, math.sqrt(2.0 / 1.04) / math.sqrt(400)),
    ("kaiming_uniform", lambda m: m.KaimingUniform(), (64, 32, 3, 3),
     (-R2 * math.sqrt(3.0 / 288), R2 * math.sqrt(3.0 / 288)), 0.0,
     R2 / math.sqrt(288)),
    ("kaiming_fan_in", lambda m: m.KaimingUniform(fan_in=50), (300, 300),
     (-R2 * math.sqrt(3.0 / 50), R2 * math.sqrt(3.0 / 50)), 0.0,
     R2 / math.sqrt(50)),
]


@pytest.mark.parametrize("name,make,shape,bounds,mean,std", RANDOM,
                         ids=[c[0] for c in RANDOM])
def test_random_initializers_bounds_and_moments(name, make, shape, bounds,
                                                mean, std, on_cpu):
    """Tens of thousands of draws of either package's initializer: within
    the bounds (a truncated or uniform one), the mean within 4 standard
    errors, the std within 3% (the truncated normal's std is 0.8796 of
    its scale at +-2); the port's moments within 3% of the JAX draw's."""
    x = make(TI)(shape).numpy().astype(np.float64)
    j = _jax(make(JI), shape).astype(np.float64)
    for draw in (x, j):
        if bounds is not None:
            assert bounds[0] - 1e-6 <= draw.min()
            assert draw.max() <= bounds[1] + 1e-6
        if mean is not None:
            assert abs(draw.mean() - mean) <= 4 * std / math.sqrt(draw.size)
            assert abs(draw.std() / std - 1) <= 0.03
    assert abs(x.std() / j.std() - 1) <= 0.03
    assert abs(x.mean() - j.mean()) <= 8 * j.std() / math.sqrt(x.size)


@pytest.mark.parametrize("shape", [(16, 40), (40, 16), (8, 4, 3, 3)])
def test_orthogonal_is_orthonormal(shape, on_cpu):
    q = TI.Orthogonal(gain=1.5)(shape).double().reshape(shape[0], -1)
    rows, cols = q.shape
    gram = q @ q.T if rows <= cols else q.T @ q
    np.testing.assert_allclose(gram.numpy(), 2.25 * np.eye(min(rows, cols)),
                               atol=1e-5)
    jq = _jax(JI.Orthogonal(gain=1.5), shape).reshape(shape[0], -1)
    jgram = jq @ jq.T if rows <= cols else jq.T @ jq
    np.testing.assert_allclose(jgram, 2.25 * np.eye(min(rows, cols)),
                               atol=1e-5)
    with pytest.raises(ValueError, match="2 dims"):
        TI.Orthogonal()((5,))


def test_same_seed_same_draw_and_explicit_generator_wins(on_cpu):
    trandom.seed(11)
    a = TI.Normal()((6, 6))
    b = TI.Normal()((6, 6))
    trandom.seed(11)
    assert trandom.get_seed() == 11
    assert torch.equal(TI.Normal()((6, 6)), a)
    assert torch.equal(TI.Normal()((6, 6)), b)
    assert not torch.equal(a, b)
    g = trandom.make_generator(11, "cpu")
    trandom.seed(12)
    # an explicit generator seeded 11 gives the first draw after seed(11)
    assert torch.equal(TI.Normal()((6, 6), generator=g), a)
    # the draw is made in float32 and then cast
    trandom.seed(11)
    half = TI.Normal()((6, 6), dtype="bfloat16")
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, a.to(torch.bfloat16))
    # in place on an existing tensor (Paddle's init(param))
    p = Parameter(torch.zeros(6, 6))
    trandom.seed(11)
    assert TI.Normal()(p) is p and torch.equal(p.detach(), a)


def test_create_parameter_defaults_and_param_attr(on_cpu):
    """create_parameter: bias zeros, weights XavierNormal (std sqrt(2 /
    (in + out))), the layer's dtype; ParamAttr's initializer, name,
    trainability and learning rate, as the JAX Layer."""
    from paddle_tpu.core.module import Layer as JLayer

    layer, jlayer = Layer(), JLayer()
    trandom.seed(3)
    w = layer.create_parameter((200, 300))
    b = layer.create_parameter((300,), is_bias=True)
    assert isinstance(w, Parameter) and w.trainable and w.dtype == \
        torch.float32 and w.optimize_attr == {"learning_rate": 1.0}
    assert torch.count_nonzero(b) == 0
    assert abs(w.std().item() / math.sqrt(2.0 / 500) - 1) < 0.03
    trandom.seed(3)
    assert torch.equal(w, TI.XavierNormal()((200, 300)))
    attr = dict(name="w_attr", initializer=TI.Constant(2.5),
                learning_rate=0.5, trainable=False)
    p = layer.create_parameter((4, 3), attr=ParamAttr(**attr))
    jattr = dict(attr, initializer=JI.Constant(2.5))
    from paddle_tpu.core.parameter import ParamAttr as JParamAttr

    jp = jlayer.create_parameter((4, 3),
                                 default_initializer=JParamAttr(**jattr))
    assert (p.name, p.trainable, p.stop_gradient, p.optimize_attr) == \
        (jp.name, jp.trainable, jp.stop_gradient, jp.optimize_attr)
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp.value))
    # ParamAttr as default_initializer, as JAX takes it
    q = layer.create_parameter((4, 3), default_initializer=ParamAttr(
        **attr))
    assert q.name == "w_attr" and not q.requires_grad
    # set_value casts and checks the shape
    p.set_value(np.ones((4, 3), np.float64))
    assert p.dtype == torch.float32 and float(p.sum()) == 12.0
    with pytest.raises(ValueError, match="shape"):
        p.set_value(np.ones((3, 4)))
    p.stop_gradient = False
    assert p.requires_grad and p.trainable


def test_default_dtype_and_convert_dtype_match_jax(on_cpu):
    for name in jdtype._STR_TO_DTYPE:
        assert tdtype.dtype_name(tdtype.convert_dtype(name)) == name
        assert tdtype.is_floating_dtype(name) == jdtype.is_floating_dtype(
            jdtype.convert_dtype(name))
    assert tdtype.convert_dtype(np.float16) == torch.float16
    assert tdtype.convert_dtype(np.dtype("int32")) == torch.int32
    with pytest.raises(ValueError, match="unknown dtype"):
        tdtype.convert_dtype("float8")
    # the port's own default; torch's stays float32
    tdtype.set_default_dtype("float64")
    assert tdtype.get_default_dtype() == torch.float64
    assert tdtype.convert_dtype(None) == torch.float64
    assert torch.get_default_dtype() == torch.float32
    assert Layer().create_parameter((2, 2)).dtype == torch.float64


def test_set_device_and_the_default_card(on_cpu):
    from paddle_tpu_torch.core import device as core_device

    assert tdevice.get_device() == "cpu"
    layer = tnn.Linear(3, 2)
    assert layer.weight.device.type == "cpu"
    assert tdevice.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert tdevice.device_count() == (torch.cuda.device_count()
                                      if torch.cuda.is_available() else 0)
    tdevice.synchronize()
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.set_device("xpu")
    # back to the card, the default: parameters need one
    core_device.set_current(None)
    assert tdevice.get_device() == "gpu:0"
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no 'gpu'"):
            tdevice.set_device("gpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Layer().create_parameter((2, 2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.Linear(3, 2)
