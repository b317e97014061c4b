"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch


def swiglu(x: torch.Tensor, y=None) -> torch.Tensor:
    """silu(x) * y; with ``y`` None, ``x`` is split in half on its last
    axis (parity: phi fusion swiglu)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), as ``jax.nn.silu``."""
    return torch.nn.functional.silu(x)


def softplus(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """``jax.nn.softplus(x * beta) / beta`` with ``jax.nn.softplus(v) =
    logaddexp(v, 0)`` for every v (``torch.nn.functional.softplus``
    returns v itself above its threshold, which is another function)."""
    v = x * beta
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device)) / beta


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: the exact erf form."""
    return torch.nn.functional.gelu(x)
