"""Vision functional ops (counterpart of
``paddle_tpu/nn/functional/vision.py``): ``pixel_shuffle``,
``pixel_unshuffle``, ``grid_sample``, ``affine_grid``."""

from __future__ import annotations

import torch


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        x = x.reshape(b, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, c // (r * r), h * r, w * r)
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    """The inverse of ``pixel_shuffle``."""
    r = downscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, c * r * r, h // r, w // r)
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, c * r * r)


def _unnormalize_coord(g, size, align_corners):
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def _reflect_coord(p, size, align_corners):
    if align_corners:
        if size == 1:
            return torch.zeros_like(p)
        span = 2.0 * (size - 1)
        p = torch.remainder(p, span).abs()
        return torch.where(p > size - 1, span - p, p)
    span = 2.0 * size
    p = torch.remainder(p + 0.5, span).abs()
    p = torch.where(p > size, span - p, p)
    return (p - 0.5).clamp(0.0, size - 1.0)


def _gather(feat, iy, ix):
    """``feat[n, :, iy[n], ix[n]]`` for integer grids ``[N, Hg, Wg]`` ->
    ``[N, C, Hg, Wg]``."""
    n, c, h, w = feat.shape
    idx = (iy * w + ix).reshape(n, 1, -1).expand(n, c, -1)
    return feat.reshape(n, c, h * w).gather(2, idx).reshape(
        n, c, *iy.shape[1:])


def _bilerp(feat, y, x):
    """Bilinear taps of ``feat`` ``[N, C, H, W]`` at float grids ``[N, Hg,
    Wg]`` inside it."""
    h, w = feat.shape[-2:]
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy1 = (y - y0)[:, None]
    wx1 = (x - x0)[:, None]
    return (_gather(feat, y0, x0) * ((1 - wy1) * (1 - wx1))
            + _gather(feat, y0, x1) * ((1 - wy1) * wx1)
            + _gather(feat, y1, x0) * (wy1 * (1 - wx1))
            + _gather(feat, y1, x1) * (wy1 * wx1))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x ``[N, C, H, W]``, grid ``[N, Hg, Wg, 2]`` of normalised (x, y)
    in [-1, 1] -> ``[N, C, Hg, Wg]``; "bilinear" or "nearest" (round half
    to even), padding "zeros" (a ring of zeros, and zeros more than one
    cell outside), "border" or "reflection"; coordinates in at least
    float32, the result in x's dtype. Gathers and products: autograd
    gives the gradients JAX's autodiff gives."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample: unknown mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: unknown padding_mode "
                         f"{padding_mode!r}")
    n, c, h, w = x.shape
    g = grid.to(torch.promote_types(grid.dtype, torch.float32))
    gx = _unnormalize_coord(g[..., 0], w, align_corners)
    gy = _unnormalize_coord(g[..., 1], h, align_corners)
    if padding_mode == "reflection":
        gx = _reflect_coord(gx, w, align_corners)
        gy = _reflect_coord(gy, h, align_corners)
    if padding_mode == "zeros":
        feat = torch.nn.functional.pad(x, (1, 1, 1, 1))
        far = (gy < -1.0) | (gy > h) | (gx < -1.0) | (gx > w)
        yy = (gy + 1.0).clamp(0.0, h + 1.0)
        xx = (gx + 1.0).clamp(0.0, w + 1.0)
    else:
        feat, far = x, None
        yy = gy.clamp(0.0, h - 1.0)
        xx = gx.clamp(0.0, w - 1.0)
    if mode == "nearest":
        vals = _gather(feat, torch.round(yy).to(torch.int64),
                       torch.round(xx).to(torch.int64))
    else:
        vals = _bilerp(feat, yy, xx)
    if far is not None:
        vals = torch.where(far[:, None], 0.0, vals)
    return vals.to(x.dtype)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[n, 2, 3]`` affine parameters -> the ``[n, h, w, 2]`` sampling
    grid in [-1, 1] coordinates that ``grid_sample`` reads."""
    n, h, w = out_shape[0], out_shape[-2], out_shape[-1]
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base.to(theta.dtype), theta)
