"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py:
Conv2D``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.random import fan_in_out, make_generator, uniform_
from ..functional.conv import conv2d


class Conv2D(nn.Module):
    """Weight ``[out_channels, in_channels / groups, kh, kw]`` (OIHW, as in
    the JAX layer), drawn from the JAX default KaimingUniform (limit =
    sqrt(2) sqrt(3 / fan_in)); the bias starts at zeros. ``device``
    defaults to the card (raises without one unless ``"cpu"`` is
    passed); ``generator`` (on that device) defaults to a fresh one seeded
    0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 has_bias: bool = True, data_format: str = "NCHW",
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else make_generator(
            0, device)
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        shape = (out_channels, in_channels // groups, *self.kernel_size)
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in_out(shape)[0])
        w = torch.empty(shape, dtype=dtype, device=device)
        self.weight = nn.Parameter(uniform_(w, -limit, limit, gen))
        self.bias = (nn.Parameter(torch.zeros((out_channels,), dtype=dtype,
                                              device=device))
                     if has_bias else None)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.data_format)
