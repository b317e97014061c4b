"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``:
``Linear``, ``Upsample``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.random import fan_in_out, make_generator, normal_
from ..functional.common import interpolate, linear


class Linear(nn.Module):
    """y = x W + b with the weight ``[in_features, out_features]`` as in
    the JAX layer. The weight is drawn from Normal(0, ``std``), or with
    ``std`` None from the JAX default XavierNormal (std = sqrt(2 / (in +
    out))); the bias starts at zeros, and ``has_bias=False`` is the JAX
    ``bias_attr=False``. ``device`` defaults to the card (raises without
    one unless ``"cpu"`` is passed); ``generator`` (on that device)
    defaults to a fresh one seeded 0."""

    def __init__(self, in_features: int, out_features: int,
                 std: Optional[float] = None, has_bias: bool = True,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else make_generator(
            0, device)
        self.in_features = in_features
        self.out_features = out_features
        shape = (in_features, out_features)
        if std is None:
            std = math.sqrt(2.0 / sum(fan_in_out(shape)))
        w = torch.empty(shape, dtype=dtype, device=device)
        self.weight = nn.Parameter(normal_(w, 0.0, std, gen))
        self.bias = (nn.Parameter(torch.zeros((out_features,), dtype=dtype,
                                              device=device))
                     if has_bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Upsample(nn.Module):
    """Parity: paddle.nn.Upsample over ``F.interpolate`` (4-D nearest is
    ported)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 data_format: str = "NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.data_format = data_format

    def forward(self, x):
        return interpolate(x, self.size, self.scale_factor, self.mode,
                           self.data_format)
