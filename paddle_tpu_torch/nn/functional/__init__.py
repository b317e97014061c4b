"""Functional ops on the port's paths (counterparts of
``paddle_tpu/nn/functional``)."""

from .activation import (
    celu,
    elu,
    gelu,
    glu,
    hardshrink,
    hardsigmoid,
    hardswish,
    hardtanh,
    leaky_relu,
    log_sigmoid,
    log_softmax,
    mish,
    prelu,
    relu,
    relu6,
    rrelu,
    selu,
    sigmoid,
    silu,
    softmax,
    softplus,
    softshrink,
    softsign,
    swiglu,
    tanh,
    tanhshrink,
    thresholded_relu,
)
from .common import dropout, interpolate, linear
from .conv import conv2d
from .flash_attention import flash_attention, scaled_dot_product_attention
from .input import embedding
from .loss import cross_entropy
from .norm import group_norm, layer_norm, rms_norm

__all__ = ["celu", "conv2d", "cross_entropy", "dropout", "elu", "embedding",
           "flash_attention", "gelu", "glu", "group_norm", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "interpolate",
           "layer_norm", "leaky_relu", "linear", "log_sigmoid",
           "log_softmax", "mish", "prelu", "relu", "relu6",
           "rms_norm", "rrelu", "scaled_dot_product_attention", "selu",
           "sigmoid", "silu", "softmax", "softplus", "softshrink",
           "softsign", "swiglu", "tanh", "tanhshrink",
           "thresholded_relu"]
