"""Convolution and pooling layers (counterpart of
``paddle_tpu/nn/layer/conv.py``).

The convolutions draw their weights from ``weight_attr`` (an initializer
or a ``ParamAttr``), else from the JAX default KaimingUniform (limit =
sqrt(2) sqrt(3 / fan_in)); the bias starts at zeros, and
``bias_attr=False`` (or ``has_bias=False``) leaves it out. ``device``
defaults to the current device (the card unless ``set_device("cpu")``
chose the host; without a card that raises); ``generator`` (on that
device) to the port's generator for it. The pools hold no state.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...core.random import default_generator
from ..functional import conv as FC
from ..functional import pooling as FP
from .common import _attr_and_init


class _ConvBase(Layer):
    """Weight ``[a, b // groups, *kernel_size]`` (``(a, b)`` = (out, in)
    for a convolution, (in, out) for a transposed one) and a bias of
    ``bias_size``."""

    def _make(self, a, b, groups, kernel_size, nd, bias_size, weight_attr,
              bias_attr, has_bias, device, generator):
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
        self.kernel_size = (kernel_size,) * nd if isinstance(
            kernel_size, int) else tuple(kernel_size)
        attr, init = _attr_and_init(weight_attr, I.KaimingUniform())
        self.weight = self.create_parameter(
            (a, b // groups, *self.kernel_size), default_initializer=init,
            attr=attr, device=device, generator=gen)
        if bias_attr is False or not has_bias:
            self.bias = None
        else:
            attr, init = _attr_and_init(bias_attr, None)
            self.bias = self.create_parameter(
                (bias_size,), default_initializer=init, is_bias=True,
                attr=attr, device=device, generator=gen)


class _ConvNd(_ConvBase):
    """Conv1D/2D/3D: weight ``[out, in / groups, *k]``."""

    NDIM = 2
    FN = staticmethod(FC.conv2d)

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 has_bias: bool = True, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._make(out_channels, in_channels, groups, kernel_size,
                   self.NDIM, out_channels, weight_attr, bias_attr,
                   has_bias, device, generator)

    def forward(self, x):
        return self.FN(x, self.weight, self.bias, self.stride, self.padding,
                       self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv2D(_ConvNd):
    """Weight ``[out_channels, in_channels / groups, kh, kw]`` (OIHW, as
    in the JAX layer)."""

    NDIM = 2
    FN = staticmethod(FC.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, **kw)


class Conv1D(_ConvNd):
    NDIM = 1
    FN = staticmethod(FC.conv1d)

    def __init__(self, *a, data_format="NCL", **kw):
        super().__init__(*a, data_format=data_format, **kw)


class Conv3D(_ConvNd):
    NDIM = 3
    FN = staticmethod(FC.conv3d)

    def __init__(self, *a, data_format="NCDHW", **kw):
        super().__init__(*a, data_format=data_format, **kw)


class _ConvTransposeNd(_ConvBase):
    """Weight ``[in, out / groups, *k]``."""

    NDIM = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, output_padding, dilation, groups, weight_attr,
                 bias_attr, data_format, has_bias=True, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__(dtype=dtype)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._make(in_channels, out_channels, groups, kernel_size,
                   self.NDIM, out_channels, weight_attr, bias_attr,
                   has_bias, device, generator)


class Conv2DTranspose(_ConvTransposeNd):
    """Weight ``[in_channels, out_channels / groups, kh, kw]``."""

    NDIM = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return FC.conv2d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.dilation, self.groups,
            self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    """Weight ``[in_channels, out_channels / groups, k]``."""

    NDIM = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return FC.conv1d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
            self.data_format)


class Conv3DTranspose(_ConvTransposeNd):
    """Weight ``[in_channels, out_channels / groups, kd, kh, kw]``."""

    NDIM = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)

    def forward(self, x):
        return FC.conv3d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
            self.data_format)


class _Pool(Layer):
    """A window pool: ``FN(x, kernel_size, stride, padding, data_format)``
    (``stride`` None: the kernel size)."""

    FN = staticmethod(FP.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return self.FN(x, self.kernel_size, self.stride, self.padding,
                       self.data_format)


class MaxPool2D(_Pool):
    FN = staticmethod(FP.max_pool2d)


class AvgPool2D(_Pool):
    FN = staticmethod(FP.avg_pool2d)


class MaxPool3D(_Pool):
    FN = staticmethod(FP.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW"):
        super().__init__(kernel_size, stride or kernel_size, padding,
                         data_format)


class AvgPool3D(MaxPool3D):
    FN = staticmethod(FP.avg_pool3d)


class MaxPool1D(_Pool):
    """``[N, C, L]``; int kernel, stride and padding (the JAX layer's
    window reduce over the trailing axis)."""

    FN = staticmethod(FP.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__(kernel_size, stride or kernel_size, padding, "NCL")


class AvgPool1D(MaxPool1D):
    """``[N, C, L]``, divided by the count of unpadded cells."""

    FN = staticmethod(FP.avg_pool1d)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return FP.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return FP.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return FP.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return FP.adaptive_max_pool2d(x, self.output_size, self.return_mask,
                                      self.data_format)
