"""Common functional ops (counterpart of
``paddle_tpu/nn/functional/common.py``).

The random functions (``dropout``, ``dropout2d``/``3d``,
``alpha_dropout``, ``gumbel_softmax``) draw from the ``generator`` their
caller passes (None: torch's default generator for the device): the two
frameworks draw different numbers from one seed, so only their
statistics and their deterministic limits are the JAX functions'.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF

from ...core import dtype as dtype_mod
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


def _pairs(x, pad_width):
    """Per-axis ``(lo, hi)`` pairs: a flat int list pads the last axis
    first (paddle/torch style), a list of pairs names every axis, an int
    pads every side."""
    if isinstance(pad_width, int):
        return [(pad_width, pad_width)] * x.dim()
    if pad_width and isinstance(pad_width[0], int):
        pairs = list(zip(pad_width[0::2], pad_width[1::2]))
        return [(0, 0)] * (x.dim() - len(pairs)) + pairs[::-1]
    return [tuple(p) for p in pad_width]


def _pad_index(n, lo, hi, mode, device):
    """Source index of each padded position along an axis of length n."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = i % period
        return torch.where(i < n, i, period - i)
    if mode == "symmetric":
        i = i % (2 * n)
        return torch.where(i < n, i, 2 * n - 1 - i)
    raise ValueError(f"pad: unsupported mode {mode!r}")


def pad(x, pad_width, mode="constant", value=0.0):
    """``jnp.pad``'s modes: "constant" (``value``), "edge", "reflect",
    "symmetric", "wrap"."""
    pairs = _pairs(x, pad_width)
    if mode == "constant":
        return tF.pad(x, [p for pair in reversed(pairs) for p in pair],
                      value=value)
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(axis, _pad_index(x.shape[axis], lo, hi, mode,
                                                x.device))
    return x


def cosine_similarity(x1, x2, axis=-1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / (n1 * n2).clamp_min(eps)


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


def _resize_src_index(out_len, in_len, align_corners, align_mode, device):
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    if align_corners:
        if out_len == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return i * (in_len - 1) / (out_len - 1)
    if align_mode == 1:  # paddle's asymmetric mode: src = i in / out
        return (i * in_len / out_len).clamp(0.0, in_len - 1.0)
    return ((i + 0.5) * in_len / out_len - 0.5).clamp(0.0, in_len - 1.0)


def _matrix(out_len, in_len, device, taps):
    """``[out, in]`` float32 matrix summing ``(index, weight)`` taps."""
    m = torch.zeros((out_len, in_len), dtype=torch.float32, device=device)
    rows = torch.arange(out_len, device=device)
    for idx, wgt in taps:
        m.index_put_((rows, idx), wgt, accumulate=True)
    return m


def _lin_weights(out_len, in_len, align_corners, align_mode, device):
    """Separable linear interpolation matrix ``[out, in]``."""
    src = _resize_src_index(out_len, in_len, align_corners, align_mode,
                            device)
    lo = torch.floor(src).to(torch.int64)
    hi = (lo + 1).clamp(max=in_len - 1)
    w_hi = src - lo
    return _matrix(out_len, in_len, device, ((lo, 1.0 - w_hi), (hi, w_hi)))


def _cubic_weights(out_len, in_len, align_corners, device, a=-0.75):
    """Separable cubic-convolution matrix ``[out, in]`` (the torch/paddle
    kernel, a = -0.75) with border-replicated taps."""
    if align_corners:
        src = _resize_src_index(out_len, in_len, True, 0, device)
    else:
        i = torch.arange(out_len, dtype=torch.float32, device=device)
        src = (i + 0.5) * in_len / out_len - 0.5
    base = torch.floor(src).to(torch.int64)
    t = src - base

    def k(x):
        ax = x.abs()
        w1 = (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1
        w2 = a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a
        return torch.where(ax <= 1, w1, torch.where(ax < 2, w2, 0.0))

    return _matrix(out_len, in_len, device, (
        ((base + off).clamp(0, in_len - 1), k(t - off))
        for off in (-1, 0, 1, 2)))


def _f32(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest", align_corners: bool = False,
                align_mode: int = 0,
                data_format: str = "NCHW") -> torch.Tensor:
    """Parity: paddle.nn.functional.interpolate, the JAX function's
    modes: 3-D NCW (nearest, linear), 4-D NCHW/NHWC (nearest, bilinear,
    bicubic, area), 5-D NCDHW (nearest, trilinear); channels-last
    formats (NWC, NHWC, NDHWC) move the channels first and back, except
    the 4-D nearest, which indexes H and W in place. A declared NCHW
    resolves to NHWC inside a ``layout.channels_last_scope``. Nearest
    takes ``floor(i * in / out)``; the linear and cubic modes are
    separable float32 ``[out, in]`` matrices (``align_corners``,
    ``align_mode`` 1 = paddle's asymmetric source index), cast back to
    x's dtype; area is ``adaptive_avg_pool2d``."""
    if x.dim() == 4:
        data_format = layout.resolve(data_format)
    if data_format == "NHWC" and x.dim() == 4 and mode == "nearest":
        h, w = x.shape[1], x.shape[2]
        oh, ow = _out_size(size, scale_factor, (h, w))
        return (x.index_select(1, _nearest_index(oh, h, x.device))
                .index_select(2, _nearest_index(ow, w, x.device)))
    if data_format in ("NWC", "NHWC", "NDHWC"):
        first = {"NWC": "NCW", "NHWC": "NCHW", "NDHWC": "NCDHW"}
        with layout.declared_scope():
            y = interpolate(x.movedim(-1, 1), size, scale_factor, mode,
                            align_corners, align_mode, first[data_format])
        return y.movedim(1, -1)
    spatial = tuple(x.shape[2:])
    out = _out_size(size, scale_factor, spatial)
    if mode == "nearest":
        for axis, (o, n) in enumerate(zip(out, spatial), start=2):
            x = x.index_select(axis, _nearest_index(o, n, x.device))
        return x
    linear = {3: "linear", 4: "bilinear", 5: "trilinear"}[x.dim()]
    if mode == linear:
        mats = [_lin_weights(o, n, align_corners, align_mode, x.device)
                for o, n in zip(out, spatial)]
    elif mode == "bicubic" and x.dim() == 4:
        mats = [_cubic_weights(o, n, align_corners, x.device)
                for o, n in zip(out, spatial)]
    elif mode == "area" and x.dim() == 4:
        from .pooling import adaptive_avg_pool2d

        return adaptive_avg_pool2d(x, out)
    else:
        raise ValueError(f"interpolate {x.dim()}-D: unknown mode {mode!r}")
    eq = {3: "Ow,ncw->ncO", 4: "Oh,nchw,Pw->ncOP",
          5: "Dd,Hh,Ww,ncdhw->ncDHW"}[x.dim()]
    if x.dim() == 4:
        return torch.einsum(eq, mats[0], _f32(x), mats[1]).to(x.dtype)
    return torch.einsum(eq, *mats, _f32(x)).to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _unfold_pads(paddings):
    """``(h_lo, h_hi, w_lo, w_hi)`` from an int, ``(ph, pw)`` or the JAX
    function's 4-form ``(h_lo, h_hi, w_lo, w_hi)``."""
    pad = _pair(paddings)
    if len(pad) == 2:
        return pad[0], pad[0], pad[1], pad[1]
    return tuple(pad)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: x ``[N, C, H, W]`` -> ``[N, C kh kw, L]`` columns in the
    channel-major ``(c, kh, kw)`` order ``lax.conv_general_dilated_patches``
    gives (torch's ``unfold`` order)."""
    hl, hh, wl, wh = _unfold_pads(paddings)
    if hl != hh or wl != wh:
        x = tF.pad(x, (wl, wh, hl, hh))
        hl = wl = 0
    return tF.unfold(x, _pair(kernel_sizes), _pair(dilations), (hl, wl),
                     _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1, name=None):
    """col2im, the exact adjoint of ``unfold`` (overlapping windows add):
    x ``[N, C kh kw, L]`` -> ``[N, C, oh, ow]``."""
    oh, ow = _pair(output_sizes)
    hl, hh, wl, wh = _unfold_pads(paddings)
    if hl == hh and wl == wh:
        return tF.fold(x, (oh, ow), _pair(kernel_sizes), _pair(dilations),
                       (hl, wl), _pair(strides))
    y = tF.fold(x, (oh + hl + hh, ow + wl + wh), _pair(kernel_sizes),
                _pair(dilations), 0, _pair(strides))
    return y[:, :, hl:hl + oh, wl:wl + ow]


def _keep(shape, p, like, generator):
    return torch.rand(shape, generator=generator, device=like.device) \
        < 1.0 - p


def alpha_dropout(x, p=0.5, training=True, name=None, *,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: dropped units take SELU's negative
    saturation and an affine correction keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    alpha_p = -1.7580993408473766  # -scale * alpha of SELU
    q = 1.0 - p
    a = (q + alpha_p * alpha_p * p * q) ** -0.5
    b = -a * alpha_p * p
    keep = _keep(x.shape, p, x, generator)
    sat = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a * torch.where(keep, x, sat) + b).to(x.dtype)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """``padding`` = [left, right, top, bottom]."""
    left, right, top, bottom = padding
    if data_format == "NCHW":
        return tF.pad(x, (left, right, top, bottom))
    return tF.pad(x, (0, 0, left, right, top, bottom))


def _channel_dropout(x, p, training, channels_first, generator):
    """Whole channels kept with probability 1 - p and divided by it."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    spatial = range(2, x.dim()) if channels_first else range(1, x.dim() - 1)
    for i in spatial:
        shape[i] = 1
    keep = _keep(shape, p, x, generator)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    return _channel_dropout(x, p, training, data_format == "NCDHW",
                            generator)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    return _channel_dropout(x, p, training, data_format == "NCHW",
                            generator)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ W[o] @ x2[b] (+ bias)``; weight ``[out, in1,
    in2]``."""
    y = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        y = y + bias
    return y


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis (inf and -inf too)."""
    d = (x - y + epsilon).abs()
    if p == float("inf"):
        return d.amax(dim=-1, keepdim=keepdim)
    if p == float("-inf"):
        return d.amin(dim=-1, keepdim=keepdim)
    return (d ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]`` mask of the positions below each length."""
    if maxlen is None:
        maxlen = int(lengths.max())
    pos = torch.arange(maxlen, device=lengths.device)
    mask = pos[None, :] < lengths.reshape(-1, 1)
    return mask.reshape(*lengths.shape, maxlen).to(
        dtype_mod.convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: within each segment of ``seg_num`` frames the first
    ``shift_ratio`` of the channels shift one frame back, the next
    ``shift_ratio`` one frame forward, the rest stay."""
    if data_format == "NHWC":
        return temporal_shift(x.permute(0, 3, 1, 2), seg_num,
                              shift_ratio).permute(0, 2, 3, 1)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([x5[:, 1:, :c1], torch.zeros_like(x5[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(x5[:, :1, c1:c2]),
                     x5[:, :-1, c1:c2]], 1)
    return torch.cat([back, fwd, x5[:, :, c2:]], 2).reshape(nt, c, h, w)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """ShuffleNet's channel shuffle."""
    if data_format == "NHWC":
        return channel_shuffle(x.permute(0, 3, 1, 2), groups).permute(
            0, 2, 3, 1)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon prior`` (uniform over the last axis
    by default)."""
    prior = 1.0 / label.shape[-1] if prior_dist is None else prior_dist
    return (1.0 - epsilon) * label + epsilon * prior


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator: Optional[torch.Generator] = None):
    """Softmax of ``(x + Gumbel noise) / temperature`` in float32 (the
    noise ``-log(-log(U))``, U uniform in (0, 1)); ``hard`` gives one-hot
    values with the soft gradients (straight-through)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))
    y = torch.softmax((x.float() + g) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = y + (onehot - y).detach()
    return y.to(x.dtype)
