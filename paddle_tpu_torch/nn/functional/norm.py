"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

from ... import flags
from ...kernels import group_norm as gn
from .. import layout


def _f32up(x: torch.Tensor) -> torch.Tensor:
    """At least float32 for the statistics; never a downcast."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6):
    """RMSNorm with the JAX package's dtype rules: the statistics are
    taken in at least float32, the normalised value is cast back to
    ``x``'s dtype, and only then multiplied by the weight."""
    xf = _f32up(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y


def layer_norm(x: torch.Tensor, normalized_shape=None, weight=None,
               bias=None, epsilon: float = 1e-5):
    """LayerNorm over the last axis, as the JAX function: float32
    statistics (population variance), the normalised value cast back to
    ``x``'s dtype before the affine."""
    xf = _f32up(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               activation=None):
    """GroupNorm with an optional fused activation (None | "silu"), with
    the JAX package's dispatch.

    A 4-D tensor declared NCHW resolves to NHWC inside a
    ``layout.channels_last_scope``. 4-D NHWC goes, with the
    ``fused_group_norm`` flag on, to ``kernels/group_norm.py:
    fused_group_norm``: on the card always (rows 12/13, which take any
    shape with ``c % num_groups == 0`` and raise otherwise; the JAX TPU
    VMEM gate does not apply, so there is no dense fall-back on the
    card); on the CPU when the JAX gate ``supports_fused`` holds, as in
    JAX. Otherwise, and with the flag off, the plain NHWC reference.
    NCHW is plain torch, as the JAX ``jnp`` branch."""
    if x.dim() == 4:
        data_format = layout.resolve(data_format)
    if data_format == "NHWC" and x.dim() == 4:
        c = x.shape[-1]
        fused = flags.flag("fused_group_norm") and (
            x.device.type != "cpu" or gn.supports_fused(x.shape, num_groups))
        if fused:
            gamma = weight if weight is not None else torch.ones(
                (c,), dtype=torch.float32, device=x.device)
            beta = bias if bias is not None else torch.zeros(
                (c,), dtype=torch.float32, device=x.device)
            return gn.fused_group_norm(x, gamma, beta, num_groups, epsilon,
                                       activation)
        return gn.group_norm_reference(x, weight, bias, num_groups, epsilon,
                                       activation)
    if data_format == "NHWC":
        # non-4-D channels-last: normalise channels-first, move back
        y = group_norm(x.movedim(-1, 1), num_groups, weight, bias, epsilon,
                       "NCHW", activation)
        return y.movedim(1, -1)
    n, c = x.shape[:2]
    spatial = x.shape[2:]
    g = num_groups
    xf = _f32up(x).reshape(n, g, c // g, *spatial)
    axes = tuple(range(2, xf.dim()))
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(
        n, c, *spatial).to(x.dtype)
    bshape = (1, c) + (1,) * len(spatial)
    if weight is not None:
        y = y * weight.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    if activation == "silu":
        y = y * torch.sigmoid(y.float()).to(y.dtype)
    elif activation is not None:
        raise ValueError(f"group_norm: unknown activation {activation!r}")
    return y
