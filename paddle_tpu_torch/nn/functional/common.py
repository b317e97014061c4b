"""Common functional ops (counterpart of
``paddle_tpu/nn/functional/common.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .. import layout


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """y = x @ W (+ b). The weight keeps the JAX package's layout
    ``[in_features, out_features]``, so parameters carry across 1:1.
    Mixed input dtypes promote as ``jnp.matmul`` promotes them."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        y = y + bias
    return y


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Parity: paddle.nn.functional.dropout, the JAX function's rules: the
    identity when not training or ``p == 0`` (``downscale_in_infer`` scales
    by ``1 - p`` at inference), zeros at ``p == 1``, else each element kept
    with probability ``1 - p`` (one ``torch.rand`` of x's shape from
    ``generator``, kept where it is below ``1 - p``) and, under
    ``upscale_in_train``, divided by ``1 - p`` in x's dtype. The random
    bits are torch's, not JAX's: the two packages draw different masks
    from the same seed."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, zero).to(x.dtype)
    return torch.where(mask, x, zero)


def _out_size(size, scale_factor, spatial):
    """Output spatial sizes from ``size`` or ``scale_factor`` (JAX:
    ``int(in * sf)``)."""
    nd = len(spatial)
    if size is not None:
        return (size,) * nd if isinstance(size, int) else tuple(size)
    sf = (scale_factor,) * nd if not isinstance(
        scale_factor, (tuple, list)) else tuple(scale_factor)
    return tuple(int(n * f) for n, f in zip(spatial, sf))


def _nearest_index(out_len: int, in_len: int, device) -> torch.Tensor:
    """The JAX (paddle/torch) nearest rule: floor(i * in / out), clamped."""
    idx = torch.arange(out_len, device=device) * in_len // out_len
    return idx.clamp(max=in_len - 1)


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest",
                data_format: str = "NCHW") -> torch.Tensor:
    """Parity: paddle.nn.functional.interpolate, the 4-D nearest mode in
    NCHW and NHWC (a declared NCHW resolves to NHWC inside a
    ``layout.channels_last_scope``), indexing H and W directly with no
    transposes. The other modes and ranks are not ported yet (ROADMAP.md
    Queue A)."""
    if mode != "nearest" or x.dim() != 4:
        raise NotImplementedError(
            f"interpolate: only 4-D nearest is ported; got mode {mode!r} "
            f"on a {x.dim()}-D tensor (see ROADMAP.md Queue A)")
    data_format = layout.resolve(data_format)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"interpolate: unknown data_format {data_format!r}")
    hw_axes = (1, 2) if data_format == "NHWC" else (2, 3)
    h, w = (x.shape[a] for a in hw_axes)
    oh, ow = _out_size(size, scale_factor, (h, w))
    iy = _nearest_index(oh, h, x.device)
    ix = _nearest_index(ow, w, x.device)
    return x.index_select(hw_axes[0], iy).index_select(hw_axes[1], ix)
