"""Functional ops on the Llama serving path (counterparts of
``paddle_tpu/nn/functional``)."""

from .activation import swiglu
from .common import linear
from .flash_attention import scaled_dot_product_attention
from .input import embedding
from .norm import rms_norm

__all__ = ["embedding", "linear", "rms_norm",
           "scaled_dot_product_attention", "swiglu"]
