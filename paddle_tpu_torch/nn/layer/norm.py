"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``:
``RMSNorm``, ``LayerNorm``, ``GroupNorm``). Each takes ``device``, which
defaults to the current device (the card unless ``set_device("cpu")``
chose the host; without a card that raises); weights start at ones and biases at zeros, as in the JAX layers, and are
trainable."""

from __future__ import annotations

import torch

from ...core.device import current_device
from ...core.module import Layer
from ...core.parameter import Parameter
from ..functional.norm import group_norm, layer_norm, rms_norm


class RMSNorm(Layer):
    """Parity: phi fusion rms_norm / PaddleNLP LlamaRMSNorm."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__(dtype=dtype)
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = Parameter(
            torch.ones((hidden_size,), dtype=dtype,
                       device=current_device(device)))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"hidden_size={self.hidden_size}, epsilon={self.epsilon}"


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` (the last axis is
    what the functional normalises, as in JAX)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        device = current_device(device)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = Parameter(torch.ones(self.normalized_shape,
                                              dtype=dtype, device=device))
        self.bias = Parameter(torch.zeros(self.normalized_shape,
                                             dtype=dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


class GroupNorm(Layer):
    """GroupNorm over ``num_channels`` in ``num_groups``; ``activation``
    ("silu" | None) fuses the following nonlinearity into the norm: under
    NHWC the fused kernels (rows 12/13) apply it in the same pass, and on
    the NCHW path it is applied functionally, so the layer means the same
    in both layouts."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, data_format: str = "NCHW",
                 activation=None, dtype=torch.float32, device=None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.activation = activation
        self.weight = Parameter(torch.ones((num_channels,), dtype=dtype,
                                              device=device))
        self.bias = Parameter(torch.zeros((num_channels,), dtype=dtype,
                                             device=device))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.epsilon, self.data_format,
                          activation=self.activation)

    def extra_repr(self):
        return (f"num_groups={self.num_groups}, "
                f"num_channels={self.num_channels}, "
                f"activation={self.activation}")
