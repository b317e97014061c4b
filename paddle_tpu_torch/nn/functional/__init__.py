"""Functional ops on the Llama serving and training paths (counterparts of
``paddle_tpu/nn/functional``)."""

from .activation import swiglu
from .common import linear
from .flash_attention import flash_attention, scaled_dot_product_attention
from .input import embedding
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cross_entropy", "embedding", "flash_attention", "linear",
           "rms_norm", "scaled_dot_product_attention", "swiglu"]
