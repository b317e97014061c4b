"""Convolution (counterpart of ``paddle_tpu/nn/functional/conv.py:
conv2d``).

The JAX package leaves the convolution to XLA outside any Pallas
kernel; the port leaves it to ``torch.nn.functional.conv2d`` (cuDNN on
the card). The weight keeps the JAX layout ``[out, in/groups, kh, kw]``
(OIHW, PyTorch's own), so parameters carry across 1:1.
"""

from __future__ import annotations

import torch

from .. import layout


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, dilation=1, groups: int = 1,
           data_format: str = "NCHW") -> torch.Tensor:
    """2-D convolution over NCHW or NHWC ``x`` (a declared NCHW resolves
    to NHWC inside a ``layout.channels_last_scope``). NHWC runs on the
    ``permute(0, 3, 1, 2)`` view of the channels-last tensor, which cuDNN
    takes as channels-last memory, and is permuted back: no copies of the
    activations. The bias is added after the product in ``x``'s dtype, as
    the JAX function adds it."""
    data_format = layout.resolve(data_format)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: unknown data_format {data_format!r}")
    if not (isinstance(padding, int) or (
            isinstance(padding, (list, tuple)) and len(padding) == 2
            and all(isinstance(p, int) for p in padding))):
        raise NotImplementedError(
            f"conv2d padding {padding!r}: an int or an (ph, pw) pair is "
            "ported; per-side pairs and strings are not (ROADMAP.md Queue A)")
    xin = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    y = torch.nn.functional.conv2d(xin, weight, None, stride, padding,
                                   dilation, groups).to(x.dtype)
    if data_format == "NHWC":
        y = y.permute(0, 2, 3, 1)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        y = y + bias.reshape(shape)
    return y
