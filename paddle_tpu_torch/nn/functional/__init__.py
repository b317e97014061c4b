"""Functional ops on the port's paths (counterparts of
``paddle_tpu/nn/functional``)."""

from .activation import gelu, relu, silu, softplus, swiglu
from .common import dropout, interpolate, linear
from .conv import conv2d
from .flash_attention import flash_attention, scaled_dot_product_attention
from .input import embedding
from .loss import cross_entropy
from .norm import group_norm, layer_norm, rms_norm

__all__ = ["conv2d", "cross_entropy", "dropout", "embedding",
           "flash_attention", "gelu", "group_norm", "interpolate",
           "layer_norm", "linear", "relu", "rms_norm",
           "scaled_dot_product_attention", "silu", "softplus", "swiglu"]
