"""Sparse layers (counterpart of ``paddle_tpu/sparse/nn.py``): ReLU,
LeakyReLU, a row softmax over the stored entries and BatchNorm over a
hybrid COO tensor's dense channel, all over the values."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer

__all__ = ["ReLU", "LeakyReLU", "Softmax", "BatchNorm"]


class ReLU(Layer):
    def forward(self, x):
        from . import map_values

        return map_values(x, torch.relu)


class LeakyReLU(Layer):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        from . import map_values

        return map_values(x, lambda v: F.leaky_relu(v, self.negative_slope))


class Softmax(Layer):
    """Softmax over the last axis, among each row's stored entries
    (unstored entries are not part of the row, as in the reference)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        if axis != -1:
            raise ValueError("sparse softmax supports axis=-1 only")

    def forward(self, x):
        from . import _as_coo

        x = _as_coo(x, coalesce=True)
        if x.dense_dim():
            raise ValueError("sparse Softmax expects scalar stored values "
                             f"(no dense dims); got {x.dense_dim()}")
        return torch.sparse.softmax(x, dim=x.dim() - 1).coalesce()


class BatchNorm(Layer):
    """BatchNorm over the trailing dense channel of a hybrid COO tensor
    (values ``[nnz, ..., C]``, the reference's point-cloud layout), with
    running statistics; eval normalizes with them. The statistics move
    on every training call (the JAX layer moves them when called
    eagerly, which is how it is called)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        device = current_device(device)
        self.num_features = num_features
        self.epsilon = epsilon
        self.momentum = momentum
        self.weight = self.create_parameter(
            (num_features,), dtype=torch.float32,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            (num_features,), dtype=torch.float32, is_bias=True,
            device=device)
        self.register_buffer("_mean", torch.zeros(
            (num_features,), dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            (num_features,), dtype=torch.float32, device=device))

    def forward(self, x):
        from . import _as_coo

        x = _as_coo(x, coalesce=True)
        v = x.values()
        if x.dense_dim() < 1 or v.shape[-1] != self.num_features:
            raise ValueError(
                "sparse BatchNorm needs values with a trailing dense "
                f"channel of size {self.num_features}; got values of "
                f"shape {tuple(v.shape)} with {x.dense_dim()} dense dims. "
                "Build the input with to_sparse_coo(dense, sparse_dim=k) "
                "so the channel dim stays dense.")
        axes = tuple(range(v.dim() - 1))
        if self.training:
            mean = v.mean(dim=axes)
            var = ((v - mean) ** 2).mean(dim=axes)
            with torch.no_grad():
                m = self.momentum
                self._mean.mul_(m).add_((1 - m) * mean.detach())
                self._variance.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self._mean, self._variance
        out = (v - mean) / torch.sqrt(var + self.epsilon)
        out = out * self.weight + self.bias
        return torch.sparse_coo_tensor(x.indices(), out, x.shape)
