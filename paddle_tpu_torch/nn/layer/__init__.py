"""Layers of the PyTorch port."""

from .common import Linear, Upsample
from .conv import Conv2D
from .norm import GroupNorm, LayerNorm, RMSNorm

__all__ = ["Conv2D", "GroupNorm", "LayerNorm", "Linear", "RMSNorm",
           "Upsample"]
