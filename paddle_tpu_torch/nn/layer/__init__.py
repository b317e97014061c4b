"""Layers of the PyTorch port."""

from .norm import RMSNorm

__all__ = ["RMSNorm"]
