"""Serving of the PyTorch port."""

from .prefix_cache import ContigPrefixStore, PagedPrefixStore, block_hashes
from .serving import ContinuousBatchingEngine, EngineConfig, Request
from .spec_decode import Drafter, NgramDrafter

__all__ = ["ContigPrefixStore", "ContinuousBatchingEngine", "Drafter",
           "EngineConfig", "NgramDrafter", "PagedPrefixStore", "Request",
           "block_hashes"]
