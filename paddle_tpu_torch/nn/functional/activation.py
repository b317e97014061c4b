"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each follows the ``jax.nn`` function the JAX package calls, where torch's
namesake computes another function (``softplus`` above its threshold) or
another formula (``hardsigmoid``, ``log_sigmoid``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as tf


def swiglu(x: torch.Tensor, y=None) -> torch.Tensor:
    """silu(x) * y; with ``y`` None, ``x`` is split in half on its last
    axis (parity: phi fusion swiglu)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return tf.silu(x) * y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x):
    return tf.relu6(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as ``jax.nn.silu``."""
    return tf.silu(x)


swish = silu


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softplus(x: torch.Tensor, beta: float = 1.0,
             threshold: float = 20.0) -> torch.Tensor:
    """``jax.nn.softplus(x * beta) / beta`` with ``jax.nn.softplus(v) =
    logaddexp(v, 0)`` for every v (``torch.nn.functional.softplus``
    returns v itself above its threshold, which is another function);
    ``threshold`` is taken for Paddle's signature and unused, as in JAX."""
    v = x * beta
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device)) / beta


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """``jax.nn.gelu``: the exact erf form, or with ``approximate`` the
    tanh form."""
    return tf.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01):
    return tf.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return tf.elu(x, alpha)


def hardswish(x):
    return tf.hardswish(x)


def hardsigmoid(x):
    """clip(x / 6 + 0.5, 0, 1), the JAX package's formula."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def mish(x):
    """x * tanh(softplus(x)), as ``jax.nn.mish``."""
    return x * torch.tanh(softplus(x))


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def glu(x, axis=-1):
    return tf.glu(x, dim=axis)


def log_sigmoid(x):
    """-softplus(-x), as ``jax.nn.log_sigmoid``."""
    return -softplus(-x)


def softsign(x):
    return x / (torch.abs(x) + 1)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * tf.elu(x, alpha)


def celu(x, alpha=1.0):
    return tf.celu(x, alpha)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x):
    return x - torch.tanh(x)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, _zero(x))


def prelu(x, weight):
    """``weight`` of one element, or one per channel (axis 1 of an input
    over 2-D, Paddle's NCHW rule)."""
    if weight.numel() > 1 and x.dim() > 2:
        weight = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True,
          generator: Optional[torch.Generator] = None):
    """Randomized leaky ReLU: in training each element's slope is drawn
    from U[lower, upper] (in float32, from ``generator``), at inference
    the midpoint."""
    if not training:
        return torch.where(x > 0, x, (lower + upper) / 2.0 * x)
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    slope.uniform_(lower, upper, generator=generator)
    return torch.where(x > 0, x, slope.to(x.dtype) * x)



def maxout(x, groups, axis=1):
    """Parity: paddle.nn.functional.maxout — the max over each block of
    ``groups`` consecutive channels on ``axis``. ``amax``, as ``jnp.max``,
    shares the gradient equally among tied maxima (``max(dim)`` would give
    it to one)."""
    axis = axis % x.dim()
    c = x.shape[axis]
    if c % groups:
        raise ValueError(f"maxout: channels {c} not divisible by "
                         f"groups {groups}")
    shape = list(x.shape)
    shape[axis: axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)
