"""Serving and inference of the PyTorch port: the continuous-batching
engine, its SLO classes and requests, the resilience layer (fault
injection, the degradation ladder), the multi-engine router with circuit
breakers and failover, the observability endpoints
(``start_metrics_server``: ``/metrics``, ``/healthz``, ``/trace``,
``/timeline``) and the Paddle Inference predictor API. The HTTP front
door is ``paddle_tpu_torch.serving_api``."""

from .predictor import Config, Predictor, create_predictor
from .prefix_cache import ContigPrefixStore, PagedPrefixStore, block_hashes
from .resilience import DegradationController, FaultInjector, InjectedFault
from .router import CircuitBreaker, EngineRouter
from .serving import (
    SLO_CLASSES,
    ContinuousBatchingEngine,
    EngineConfig,
    MetricsServer,
    Request,
    build_request,
    metrics_http_get,
    new_slo_bucket,
    request_ledger,
    request_namespace,
    start_metrics_server,
)
from .spec_decode import Drafter, NgramDrafter

__all__ = ["CircuitBreaker", "Config", "ContigPrefixStore",
           "ContinuousBatchingEngine", "DegradationController", "Drafter",
           "EngineConfig", "EngineRouter", "FaultInjector", "InjectedFault",
           "MetricsServer", "NgramDrafter", "PagedPrefixStore", "Predictor",
           "Request", "SLO_CLASSES", "block_hashes", "build_request",
           "create_predictor", "metrics_http_get", "new_slo_bucket",
           "request_ledger", "request_namespace", "start_metrics_server"]
