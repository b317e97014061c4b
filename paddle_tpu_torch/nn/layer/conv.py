"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py:
Conv2D``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...core.random import default_generator
from ..functional.conv import conv2d


class Conv2D(Layer):
    """Weight ``[out_channels, in_channels / groups, kh, kw]`` (OIHW, as in
    the JAX layer), drawn from the JAX default KaimingUniform (limit =
    sqrt(2) sqrt(3 / fan_in)); the bias starts at zeros. ``device``
    defaults to the current device (the card unless ``set_device("cpu")``
    chose the host; without a card that raises); ``generator`` (on that
    device) to the port's generator for it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 has_bias: bool = True, data_format: str = "NCHW",
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
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
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, *self.kernel_size),
            default_initializer=I.KaimingUniform(), device=device,
            generator=gen)
        self.bias = (self.create_parameter((out_channels,), is_bias=True,
                                           device=device)
                     if has_bias else None)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.data_format)
