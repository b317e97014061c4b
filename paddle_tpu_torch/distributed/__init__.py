"""Distributed layers and strategy of the PyTorch port (one device for
now)."""

from .strategy import DistributedStrategy, HybridConfig

__all__ = ["DistributedStrategy", "HybridConfig"]
