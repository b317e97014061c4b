"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``:
``RMSNorm``, ``LayerNorm``, ``GroupNorm``, the BatchNorms, ``InstanceNorm2D``,
``LocalResponseNorm``, ``SpectralNorm``). Each takes ``device``, which
defaults to the current device (the card unless ``set_device("cpu")``
chose the host; without a card that raises); weights start at ones and
biases at zeros, as in the JAX layers, and are trainable."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...core.random import default_generator
from .. import layout
from ..functional.norm import (group_norm, layer_norm, local_response_norm,
                               rms_norm)


class RMSNorm(Layer):
    """Parity: phi fusion rms_norm / PaddleNLP LlamaRMSNorm."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__(dtype=dtype)
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), dtype=dtype, default_initializer=I.Constant(1.0),
            device=current_device(device))

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
        self.weight = self.create_parameter(
            self.normalized_shape, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self.normalized_shape, dtype=dtype, is_bias=True, device=device)

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
        self.weight = self.create_parameter(
            (num_channels,), dtype=dtype, default_initializer=I.Constant(1.0),
            device=device)
        self.bias = self.create_parameter(
            (num_channels,), dtype=dtype, is_bias=True, device=device)

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.epsilon, self.data_format,
                          activation=self.activation)

    def extra_repr(self):
        return (f"num_groups={self.num_groups}, "
                f"num_channels={self.num_channels}, "
                f"activation={self.activation}")


class BatchNorm2D(Layer):
    """Batch normalisation with running statistics in the float32 buffers
    ``_mean`` (zeros) and ``_variance`` (ones).

    The channel axis is 1 under "NCHW" (which a 4-D input resolves to
    NHWC inside a ``layout.channels_last_scope``) and the last axis
    otherwise; the statistics reduce over every other axis. The JAX
    cast order: a training forward takes float32 batch statistics (the
    biased variance), normalises in float32 with them, casts to x's dtype
    and then applies the affine in x's dtype; an eval forward normalises
    with the running statistics. A training forward also moves the
    running statistics, in place and outside autograd: ``running =
    momentum * running + (1 - momentum) * batch``, computed in float32
    and stored in the buffers' dtype. The JAX layer does that only when
    called eagerly, and never inside a jitted step (ROADMAP.md Queue C);
    the port does it in every training forward. After ``to(bfloat16)``
    the buffers are bf16 in both packages; a JAX update then leaves
    float32 buffers (and rounds the momentum to bf16 first), the port's
    stay bf16."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", *, dtype=torch.float32,
                 device=None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_features,), default_initializer=I.Constant(1.0),
            device=device)
        self.bias = self.create_parameter((num_features,), is_bias=True,
                                          device=device)
        self.register_buffer("_mean", torch.zeros(
            (num_features,), dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            (num_features,), dtype=torch.float32, device=device))

    def forward(self, x):
        df = layout.resolve(self.data_format) if x.dim() == 4 \
            else self.data_format
        c_axis = (1 if df == "NCHW" else -1) % x.dim()
        axes = tuple(i for i in range(x.dim()) if i != c_axis)
        shape = [1] * x.dim()
        shape[c_axis] = self.num_features
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=axes)
            var = (xf - mean.reshape(shape)).square().mean(dim=axes)
            with torch.no_grad():
                m = self.momentum
                self._mean.copy_(m * self._mean.float() + (1 - m) * mean)
                self._variance.copy_(m * self._variance.float()
                                     + (1 - m) * var)
        else:
            mean, var = self._mean, self._variance
        y = ((xf - mean.reshape(shape))
             / torch.sqrt(var.reshape(shape) + self.epsilon)).to(x.dtype)
        return (y * self.weight.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))

    def extra_repr(self):
        return (f"num_features={self.num_features}, "
                f"momentum={self.momentum}, epsilon={self.epsilon}")


BatchNorm = BatchNorm2D


class BatchNorm1D(BatchNorm2D):
    """``[N, C]`` or ``[N, C, L]`` input; "NCL"/"NC" put the channels on
    axis 1, "NLC" last."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format in (
                             "NCL", "NC", "NCHW") else "NHWC", **kw)

    def forward(self, x):
        if x.dim() not in (2, 3):
            raise ValueError(
                f"BatchNorm1D expects 2-D/3-D input, got {x.dim()}-D")
        return super().forward(x)


class BatchNorm3D(BatchNorm2D):
    """``[N, C, D, H, W]`` input ("NCDHW") or ``[N, D, H, W, C]``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format in (
                             "NCDHW", "NCHW") else "NHWC", **kw)

    def forward(self, x):
        if x.dim() != 5:
            raise ValueError(
                f"BatchNorm3D expects 5-D input, got {x.dim()}-D")
        return super().forward(x)


class SyncBatchNorm(BatchNorm2D):
    """Cross-replica batch norm. On one card the batch is whole, so this
    is ``BatchNorm2D``; ``convert_sync_batchnorm`` swaps the class of
    every ``BatchNorm2D`` sublayer in place, as the JAX layer does."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for parent in layer.sublayers(include_self=True):
            for sub in parent.children():
                if type(sub) is BatchNorm2D:
                    sub.__class__ = cls
        return layer


class InstanceNorm2D(Layer):
    """Per-sample, per-channel normalisation over H and W, stateless.
    float32 statistics (the biased variance) and affine (``scale``,
    ``bias``; ``weight_attr=False`` / ``bias_attr=False`` leave them
    out), cast to x's dtype at the end."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", *, dtype=torch.float32,
                 device=None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        self.scale = None if weight_attr is False else \
            self.create_parameter((num_features,),
                                  default_initializer=I.Constant(1.0),
                                  device=device)
        self.bias = None if bias_attr is False else \
            self.create_parameter((num_features,), is_bias=True,
                                  device=device)

    def forward(self, x):
        nchw = layout.resolve(self.data_format) == "NCHW"
        axes, c_axis = ((2, 3), 1) if nchw else ((1, 2), 3)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.epsilon)
        shape = [1] * x.dim()
        shape[c_axis] = self.num_features
        if self.scale is not None:
            y = y * self.scale.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


class LocalResponseNorm(Layer):
    """AlexNet's LRN (``functional.local_response_norm``)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        size, alpha, beta, k, df = self._args
        return local_response_norm(x, size, alpha=alpha, beta=beta, k=k,
                                   data_format=df)


class SpectralNorm(Layer):
    """Spectral normalisation of a weight passed to ``forward``: power
    iteration on the weight reshaped to ``[shape[dim], -1]`` in float32,
    from the float32 buffers ``weight_u`` ``[h]`` and ``weight_v`` ``[w]``
    (drawn from Normal(0, 1)), returning ``weight / sigma``. The gradient
    runs through the iteration, as JAX differentiates it; the new vectors
    are kept in the buffers at every call (the JAX layer keeps them when
    called eagerly), so a carried-across state continues the same
    iteration."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.register_buffer("weight_u", torch.empty(
            (h,), dtype=torch.float32, device=device).normal_(generator=gen))
        self.register_buffer("weight_v", torch.empty(
            (w,), dtype=torch.float32, device=device).normal_(generator=gen))

    def forward(self, weight):
        mat = weight.movedim(self.dim, 0).reshape(
            weight.shape[self.dim], -1).float()
        # copies: the buffers are written below, after autograd saved u
        u, v = self.weight_u.clone(), self.weight_v.clone()

        def l2(t):
            return t / (torch.linalg.vector_norm(t) + self.eps)

        for _ in range(self.power_iters):
            v = l2(mat.T @ u)
            u = l2(mat @ v)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ mat @ v
        return (weight / sigma.to(weight.dtype)).to(weight.dtype)
