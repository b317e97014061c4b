"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import initializer as I
from ...core.module import Layer
from ...core.random import default_generator
from .. import functional as F


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class GELU(Layer):
    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class SiLU(Layer):
    def forward(self, x):
        return F.silu(x)


Swish = SiLU


class Sigmoid(Layer):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Hardswish(Layer):
    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(Layer):
    def forward(self, x):
        return F.hardsigmoid(x)


class Mish(Layer):
    def forward(self, x):
        return F.mish(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class GLU(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class PReLU(Layer):
    """Learnable leaky slope, ``num_parameters`` of them starting at
    ``init``; ``device`` None is the current device."""

    def __init__(self, num_parameters=1, init=0.25, *, device=None):
        super().__init__()
        self.weight = self.create_parameter(
            (num_parameters,), default_initializer=I.Constant(init),
            device=device)

    def forward(self, x):
        return F.prelu(x, self.weight)


class SELU(Layer):
    def forward(self, x):
        return F.selu(x)


class CELU(Layer):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Softsign(Layer):
    def forward(self, x):
        return F.softsign(x)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Tanhshrink(Layer):
    def forward(self, x):
        return F.tanhshrink(x)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class RReLU(Layer):
    """Randomized leaky ReLU: the slopes are drawn in training from
    ``generator`` given to the call, else from the port's generator for
    the input's device; the mean slope in eval."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.training and generator is None:
            generator = default_generator(x.device)
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=generator)
