"""Neural-network building blocks of the PyTorch port."""

from . import functional, layout
from .layer import Conv2D, GroupNorm, LayerNorm, Linear, RMSNorm, Upsample

__all__ = ["Conv2D", "GroupNorm", "LayerNorm", "Linear", "RMSNorm",
           "Upsample", "functional", "layout"]
