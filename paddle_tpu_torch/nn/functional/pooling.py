"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The JAX package pools with ``lax.reduce_window``; the port with torch's
pooling operators (cuDNN or ATen kernels on the card), which take
channels-first tensors: a channels-last input runs on its channels-first
``permute`` view and is permuted back, with no copy of the activations.
The JAX semantics kept:

- ``padding`` is an int or a list of per-axis ``(lo, hi)`` pairs, and
  there is no ``ceil_mode``; max pools pad with -inf;
- average pools divide by the count of unpadded cells (torch's
  ``count_include_pad=False``);
- adaptive pools take a window pool where the output divides the input,
  else float32 ``[out, in]`` bin matrices (the reference's bin edges
  ``floor(i in / out)`` .. ``ceil((i + 1) in / out)``), cast back to x's
  dtype;
- ``max_pool2d``, ``avg_pool2d``, ``adaptive_avg_pool2d`` and
  ``adaptive_max_pool2d`` resolve a declared NCHW to NHWC inside a
  ``layout.channels_last_scope``; the 1-D and 3-D pools take their
  format as given.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import layout

_CHANNELS_FIRST = ("NCHW", "NCL", "NCDHW")


def _tuple(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _pairs(padding, nd):
    """Per-axis ``(lo, hi)`` pairs from an int or a list of pairs (an int
    entry pads both sides)."""
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def _flat(pairs):
    """``tF.pad``'s flat order: the last axis first."""
    return [p for pair in reversed(pairs) for p in pair]


def _lowest(dtype):
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _window_cf(x, nd, kernel, stride, pads, kind):
    """A window pool over the trailing ``nd`` axes of channels-first
    ``x``. Symmetric paddings of at most half the window go to torch's
    operator; others are padded explicitly (-inf for max; zeros for avg,
    divided by the pooled count of real cells)."""
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel))
    if kind == "max":
        if native:
            return _MAX[nd](x, kernel, stride, [lo for lo, _ in pads])
        xp = tF.pad(x, _flat(pads), value=_lowest(x.dtype))
        return _MAX[nd](xp, kernel, stride)
    if not any(lo or hi for lo, hi in pads):
        return _AVG[nd](x, kernel, stride)
    if native:
        return _AVG[nd](x, kernel, stride, [lo for lo, _ in pads],
                        count_include_pad=False)
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    frac = _AVG[nd](tF.pad(ones, _flat(pads)), kernel, stride)
    return _AVG[nd](tF.pad(x, _flat(pads)), kernel, stride) / frac


def _pool_nd(x, nd, kernel_size, stride, padding, data_format, kind):
    """Shared N-D window pool in ``data_format`` (channels first: NCHW,
    NCL, NCDHW; else channels last)."""
    kernel = _tuple(kernel_size, nd)
    stride = _tuple(stride or kernel, nd)
    pads = _pairs(padding, nd)
    if data_format in _CHANNELS_FIRST:
        return _window_cf(x, nd, kernel, stride, pads, kind)
    y = _window_cf(x.movedim(-1, 1), nd, kernel, stride, pads, kind)
    return y.movedim(1, -1)


def max_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    return _pool_nd(x, 2, kernel_size, stride, padding,
                    layout.resolve(data_format), "max")


def avg_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    return _pool_nd(x, 2, kernel_size, stride, padding,
                    layout.resolve(data_format), "avg")


def _adaptive_avg_matrix(out_len, in_len, device):
    """``[out, in]`` row-stochastic float32 bin-average matrix."""
    i = torch.arange(out_len, device=device)
    start = torch.floor(i * in_len / out_len).to(torch.int64)
    end = torch.ceil((i + 1) * in_len / out_len).to(torch.int64)
    j = torch.arange(in_len, device=device)
    m = ((j[None, :] >= start[:, None])
         & (j[None, :] < end[:, None])).to(torch.float32)
    return m / m.sum(dim=1, keepdim=True).clamp_min(1.0)


def _f32(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    data_format = layout.resolve(data_format)
    oh, ow = _tuple(output_size, 2)
    hw = (1, 2) if data_format == "NHWC" else (2, 3)
    h, w = x.shape[hw[0]], x.shape[hw[1]]
    if h % oh == 0 and w % ow == 0:
        k = (h // oh, w // ow)
        return _pool_nd(x, 2, k, k, 0, data_format, "avg")
    my = _adaptive_avg_matrix(oh, h, x.device)
    mx = _adaptive_avg_matrix(ow, w, x.device)
    eq = "Oh,nhwc,Pw->nOPc" if data_format == "NHWC" else "Oh,nchw,Pw->ncOP"
    return torch.einsum(eq, my, _f32(x), mx).to(x.dtype)


def max_pool3d(x, kernel_size, stride=None, padding=0, data_format="NCDHW"):
    return _pool_nd(x, 3, kernel_size, stride, padding, data_format, "max")


def avg_pool3d(x, kernel_size, stride=None, padding=0, data_format="NCDHW"):
    return _pool_nd(x, 3, kernel_size, stride, padding, data_format, "avg")


def adaptive_avg_pool1d(x, output_size):
    """x ``[N, C, L]``."""
    length = x.shape[2]
    if isinstance(output_size, (tuple, list)):
        output_size = output_size[0]
    if length % output_size == 0:
        k = length // output_size
        return _pool_nd(x, 1, (k,), (k,), 0, "NCL", "avg")
    m = _adaptive_avg_matrix(output_size, length, x.device)
    return torch.einsum("Ol,ncl->ncO", m, _f32(x)).to(x.dtype)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    out = _tuple(output_size, 3)
    if data_format == "NDHWC":
        return adaptive_avg_pool3d(x.movedim(-1, 1), out).movedim(1, -1)
    d, h, w = x.shape[2:]
    if all(s % o == 0 for s, o in zip((d, h, w), out)):
        k = tuple(s // o for s, o in zip((d, h, w), out))
        return _pool_nd(x, 3, k, k, 0, "NCDHW", "avg")
    md, mh, mw = (_adaptive_avg_matrix(o, s, x.device)
                  for o, s in zip(out, (d, h, w)))
    y = torch.einsum("Dd,ncdhw->ncDhw", md, _f32(x))
    y = torch.einsum("Hh,ncDhw->ncDHw", mh, y)
    return torch.einsum("Ww,ncDHw->ncDHW", mw, y).to(x.dtype)


def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    """Adaptive max pool with the reference's bin edges. Sizes that do
    not divide take separable masked maxima over the bin masks;
    ``return_mask`` also returns each bin's argmax as a flattened
    ``h * w`` index (the first maximum, as ``jnp.argmax`` picks)."""
    data_format = layout.resolve(data_format)
    oh, ow = _tuple(output_size, 2)
    if data_format == "NHWC":
        with layout.declared_scope():
            y = adaptive_max_pool2d(x.movedim(-1, 1), (oh, ow), return_mask)
        if return_mask:
            return y[0].movedim(1, -1), y[1].movedim(1, -1)
        return y.movedim(1, -1)
    h, w = x.shape[2], x.shape[3]
    if h % oh == 0 and w % ow == 0 and not return_mask:
        k = (h // oh, w // ow)
        return _pool_nd(x, 2, k, k, 0, "NCHW", "max")
    my = _adaptive_avg_matrix(oh, h, x.device) > 0  # [Oh, h]
    mx = _adaptive_avg_matrix(ow, w, x.device) > 0  # [Ow, w]
    neg = torch.tensor(_lowest(x.dtype), dtype=x.dtype, device=x.device)
    y1 = torch.where(my[None, None, :, :, None], x[:, :, None, :, :], neg)
    ih = y1.argmax(dim=3)  # [n, c, Oh, w]
    y1 = y1.amax(dim=3)
    y2 = torch.where(mx[None, None, None, :, :], y1[:, :, :, None, :], neg)
    iw = y2.argmax(dim=-1)  # [n, c, Oh, Ow]
    out = y2.amax(dim=-1)
    if not return_mask:
        return out
    return out, ih.gather(-1, iw) * w + iw


def max_pool1d(x, kernel_size, stride=None, padding=0, data_format="NCL"):
    return _pool_nd(x, 1, kernel_size, stride, padding, data_format, "max")


def avg_pool1d(x, kernel_size, stride=None, padding=0, data_format="NCL"):
    return _pool_nd(x, 1, kernel_size, stride, padding, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False):
    """x ``[N, C, L]``."""
    y = adaptive_max_pool2d(x[:, :, None, :], (1, output_size),
                            return_mask=return_mask)
    if return_mask:
        return y[0][:, :, 0], y[1][:, :, 0]
    return y[:, :, 0]
