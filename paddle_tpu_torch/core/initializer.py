"""Parameter initializers (counterpart of ``paddle_tpu/core/initializer.py``;
parity: ``paddle.nn.initializer``).

An initializer is called as ``init(shape, dtype=None, device=None,
generator=None)`` for a new tensor, or as ``init(tensor, generator=None)``
to fill ``tensor`` in place (Paddle's ``init(param)``). ``dtype`` None is
the default dtype (``core.dtype``) and ``device`` None the current device
(``core.device``: the card unless the caller chose the CPU). A random
initializer draws from ``generator``, or with none from the port's
generator for the device (``core.random.default_generator``, reseeded by
``seed``); it draws in float32 and then casts, as the JAX initializers
do, since drawing straight in bfloat16 loses entropy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import random as random_mod
from .device import current_device
from .dtype import convert_dtype


def _fan_in_out(shape):
    """The fans of a weight: 2-D ``[in, out]`` (the port's linear layout),
    conv ``[out, in, *k]``."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Subclasses implement ``fill_(tensor, generator)``, writing the values
    into ``tensor`` under ``no_grad``; ``generator`` is None unless the
    caller passed one."""

    def fill_(self, tensor: torch.Tensor, generator) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, shape_or_tensor, dtype=None, device=None,
                 generator=None) -> torch.Tensor:
        if isinstance(shape_or_tensor, torch.Tensor):
            tensor = shape_or_tensor
        else:
            tensor = torch.empty(tuple(shape_or_tensor),
                                 dtype=convert_dtype(dtype),
                                 device=current_device(device))
        with torch.no_grad():
            return self.fill_(tensor, generator)


def _gen(generator, tensor):
    return (generator if generator is not None
            else random_mod.default_generator(tensor.device))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def fill_(self, tensor, generator):
        return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def fill_(self, tensor, generator):
        return random_mod.normal_(tensor, self.mean, self.std,
                                  _gen(generator, tensor))


class TruncatedNormal(Initializer):
    """``mean + std * z`` with z a standard normal truncated to ``[a, b]``
    (in units of std, as ``jax.random.truncated_normal``): the inverse
    CDF of a uniform draw over ``[Phi(a), Phi(b)]``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def fill_(self, tensor, generator):
        def cdf(v):
            return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

        z = torch.empty(tensor.shape, dtype=torch.float32,
                        device=tensor.device)
        z.uniform_(2 * cdf(self.a) - 1, 2 * cdf(self.b) - 1,
                   generator=_gen(generator, tensor))
        z = torch.special.erfinv(z).mul_(math.sqrt(2.0))
        z = z.clamp_(self.a, self.b)
        return tensor.copy_(self.mean + self.std * z)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def fill_(self, tensor, generator):
        return random_mod.uniform_(tensor, self.low, self.high,
                                   _gen(generator, tensor))


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def fill_(self, tensor, generator):
        fan_in, fan_out = _fan_in_out(tuple(tensor.shape))
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std).fill_(tensor, generator)


class XavierUniform(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def fill_(self, tensor, generator):
        fan_in, fan_out = _fan_in_out(tuple(tensor.shape))
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return Uniform(-limit, limit).fill_(tensor, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return math.sqrt(2.0)

    def fill_(self, tensor, generator):
        fan_in = self.fan_in or _fan_in_out(tuple(tensor.shape))[0]
        std = self._gain() / math.sqrt(fan_in)
        return Normal(0.0, std).fill_(tensor, generator)


class KaimingUniform(KaimingNormal):
    def fill_(self, tensor, generator):
        fan_in = self.fan_in or _fan_in_out(tuple(tensor.shape))[0]
        limit = self._gain() * math.sqrt(3.0 / fan_in)
        return Uniform(-limit, limit).fill_(tensor, generator)


class Orthogonal(Initializer):
    """QR of a float32 gaussian, sign-fixed by R's diagonal; trailing dims
    flattened for shapes over 2-D."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def fill_(self, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal needs >= 2 dims")
        rows, cols = shape[0], int(math.prod(shape[1:]))
        a = torch.empty((max(rows, cols), min(rows, cols)),
                        dtype=torch.float32, device=tensor.device)
        a.normal_(generator=_gen(generator, tensor))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        return tensor.copy_((self.gain * q).reshape(shape))


class Dirac(Initializer):
    """Identity-preserving conv kernels ``[out, in, *k]``: within each
    group only the first min(out per group, in) channels get a tap at the
    kernel centre."""

    def __init__(self, groups=1):
        self.groups = groups

    def fill_(self, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) < 3:
            raise ValueError("Dirac needs a conv kernel shape")
        out_c, in_c = shape[0], shape[1]
        opg = out_c // self.groups
        outs = np.arange(out_c)
        ds = outs % opg
        sel = ds < in_c
        idx = (outs[sel], ds[sel]) + tuple(
            np.full(sel.sum(), k // 2) for k in shape[2:])
        tensor.zero_()
        tensor[tuple(torch.as_tensor(i, device=tensor.device)
                     for i in idx)] = 1.0
        return tensor


class Assign(Initializer):
    """A fixed array or list value of the parameter's shape."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def fill_(self, tensor, generator):
        if tuple(self.value.shape) != tuple(tensor.shape):
            raise ValueError(f"Assign: value shape {self.value.shape} != "
                             f"{tuple(tensor.shape)}")
        return tensor.copy_(torch.from_numpy(np.array(self.value)))


class Bilinear(Initializer):
    """Upsampling deconv kernels ``[out, in, kh, kw]``: every (out, in)
    filter gets the bilinear ramp."""

    def fill_(self, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear expects [out, in, kh, kw]")

        def ramp(k):
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return 1 - torch.abs(
                torch.arange(k, dtype=torch.float32,
                             device=tensor.device) / f - c)

        kern = ramp(shape[2])[:, None] * ramp(shape[3])[None, :]
        return tensor.copy_(kern.expand(shape))


def calculate_gain(nonlinearity, param=None):
    """Parity: ``paddle.nn.initializer.calculate_gain``."""
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d",
                        "conv_transpose1d", "conv_transpose2d",
                        "conv_transpose3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else float(param)
        return math.sqrt(2.0 / (1 + a * a))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity!r}")


class _Callable(Initializer):
    def __init__(self, fn):
        self.fn = fn

    def fill_(self, tensor, generator):
        return tensor.copy_(self.fn(tuple(tensor.shape), tensor.dtype,
                                    tensor.device, generator))


def resolve(init, default=None) -> Initializer:
    """``init`` as an Initializer: None is ``default`` (XavierNormal
    without one); a plain callable is called as ``fn(shape, dtype,
    device, generator)`` for the values."""
    if init is None:
        return default or XavierNormal()
    if isinstance(init, Initializer):
        return init
    if callable(init):
        return _Callable(init)
    raise TypeError(f"cannot interpret initializer: {init!r}")
