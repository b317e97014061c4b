"""Distributed layers and strategy of the PyTorch port (one device for
now)."""

from .moe import DroplessMoELayer, MoELayer
from .strategy import DistributedStrategy, HybridConfig

__all__ = ["DistributedStrategy", "DroplessMoELayer", "HybridConfig",
           "MoELayer"]
