"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The JAX package leaves the convolutions to XLA outside any Pallas
kernel; the port leaves them to ``torch.nn.functional.conv*d`` and
``conv_transpose*d`` (cuDNN on the card). Weights keep the JAX layouts,
which are PyTorch's own, so parameters carry across 1:1: ``[out,
in/groups, *k]`` for the convolutions and ``[in, out/groups, *k]`` for the
transposed ones (the JAX ``_conv_transpose_nd`` flips and swaps that
layout into a dilated forward convolution: torch's ``conv_transpose``
computes the same function from the same layout).

Channels-last inputs run on the channels-first ``permute`` view, which
cuDNN takes as channels-last memory, and are permuted back: no copies of
the activations. Biases are added after the product in x's dtype, as
the JAX functions add them. ``padding`` takes an int, a per-axis int
list, per-axis ``(lo, hi)`` pairs, or ``"SAME"``/``"VALID"`` (any case;
XLA's rule: SAME pads ``max((ceil(n / s) - 1) s + (k - 1) d + 1 - n, 0)``
in all, the extra cell at the end); symmetric paddings go to the
operator, others are padded with zeros first. ``conv2d`` and
``conv2d_transpose`` resolve a declared NCHW to NHWC inside a
``layout.channels_last_scope``; the 1-D and 3-D forms take their format
as given.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import layout

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}
_CHANNELS_FIRST = ("NCL", "NCHW", "NCDHW")
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _tuple(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _conv_pads(padding, spatial, kernel, stride, dilation):
    """Per-axis ``(lo, hi)`` pairs of a forward convolution's padding."""
    nd = len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nd
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for n, k, s, d in zip(spatial, kernel, stride, dilation):
            total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, nd):
    if data_format not in _FORMATS[nd]:
        raise ValueError(f"conv{nd}d: unknown data_format {data_format!r}")
    first = data_format in _CHANNELS_FIRST
    xin = x if first else x.movedim(-1, 1)
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    pads = _conv_pads(padding, xin.shape[2:], weight.shape[2:], stride,
                      dilation)
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        xin = tF.pad(xin, [p for pair in reversed(pads) for p in pair])
        sym = 0
    y = _CONV[nd](xin, weight, None, stride, sym, dilation,
                  groups).to(x.dtype)
    return _bias(y if first else y.movedim(1, -1), bias, first)


def _bias(y, bias, channels_first):
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[1 if channels_first else -1] = -1
    return y + bias.reshape(shape)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCL"):
    """Weight ``[out, in/groups, k]``; x NCL or NLC."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, dilation=1, groups: int = 1,
           data_format: str = "NCHW") -> torch.Tensor:
    """2-D convolution over NCHW or NHWC ``x``; weight ``[out, in/groups,
    kh, kw]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    layout.resolve(data_format), 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCDHW"):
    """Weight ``[out, in/groups, kd, kh, kw]``; x NCDHW or NDHWC."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd, channels_first):
    """Shared N-D transposed (fractionally strided) convolution; weight
    ``[in, out/groups, *k]``; ``padding`` an int or a per-axis int list,
    as in JAX."""
    xin = x if channels_first else x.movedim(-1, 1)
    y = _CONV_T[nd](xin, weight, None, _tuple(stride, nd),
                    _tuple(padding, nd), _tuple(output_padding, nd),
                    groups, _tuple(dilation, nd)).to(x.dtype)
    return _bias(y if channels_first else y.movedim(1, -1), bias,
                 channels_first)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups: int = 1,
                     data_format: str = "NCHW"):
    """Weight ``[in, out/groups, kh, kw]``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              layout.resolve(data_format) == "NCHW")


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups: int = 1, dilation=1,
                     data_format: str = "NCL"):
    """Weight ``[in, out/groups, k]``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format == "NCL")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups: int = 1, dilation=1,
                     data_format: str = "NCDHW"):
    """Weight ``[in, out/groups, kd, kh, kw]``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format == "NCDHW")
