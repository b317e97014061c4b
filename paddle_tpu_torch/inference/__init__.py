"""Serving and inference of the PyTorch port: the continuous-batching
engine and the Paddle Inference predictor API."""

from .predictor import Config, Predictor, create_predictor
from .prefix_cache import ContigPrefixStore, PagedPrefixStore, block_hashes
from .serving import ContinuousBatchingEngine, EngineConfig, Request
from .spec_decode import Drafter, NgramDrafter

__all__ = ["Config", "ContigPrefixStore", "ContinuousBatchingEngine",
           "Drafter", "EngineConfig", "NgramDrafter", "PagedPrefixStore",
           "Predictor", "Request", "block_hashes", "create_predictor"]
