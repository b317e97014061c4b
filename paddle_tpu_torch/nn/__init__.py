"""Neural-network building blocks of the PyTorch port."""

from . import functional
from .layer.norm import RMSNorm

__all__ = ["functional", "RMSNorm"]
