"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6):
    """RMSNorm with the JAX package's dtype rules: the statistics are
    taken in at least float32, the normalised value is cast back to
    ``x``'s dtype, and only then multiplied by the weight."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y
