"""Serving and inference of the PyTorch port: the continuous-batching
engine, its SLO classes and requests, and the Paddle Inference predictor
API. The HTTP front door is ``paddle_tpu_torch.serving_api``."""

from .predictor import Config, Predictor, create_predictor
from .prefix_cache import ContigPrefixStore, PagedPrefixStore, block_hashes
from .serving import (
    SLO_CLASSES,
    ContinuousBatchingEngine,
    EngineConfig,
    Request,
    build_request,
    new_slo_bucket,
    request_namespace,
)
from .spec_decode import Drafter, NgramDrafter

__all__ = ["Config", "ContigPrefixStore", "ContinuousBatchingEngine",
           "Drafter", "EngineConfig", "NgramDrafter", "PagedPrefixStore",
           "Predictor", "Request", "SLO_CLASSES", "block_hashes",
           "build_request", "create_predictor", "new_slo_bucket",
           "request_namespace"]
