"""Streaming serving front door of the port: an OpenAI-style SSE HTTP API
with the SLO-aware multi-tenant admission scheduler, over one
continuous-batching engine or an ``EngineRouter`` fleet (counterpart of
``paddle_tpu/serving_api``).

Quickstart::

    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.serving_api import (SLOFairScheduler,
                                              TenantQuota, start_api_server)

    eng = ContinuousBatchingEngine(model, EngineConfig(paged=True))
    srv = start_api_server(eng, scheduler=SLOFairScheduler(
        tenants={"acme": TenantQuota(weight=2.0, max_slots=3)}))
    # POST {srv.url}/v1/completions  {"prompt": [3, 7, 11], "stream": true}
    srv.shutdown()

A fleet is served the same way: ``start_api_server(EngineRouter(model,
EngineConfig(paged=True), n_replicas=2))``.
"""

from .protocol import (
    CompletionRequest,
    ProtocolError,
    parse_completion_request,
)
from .scheduler import SLOFairScheduler, TenantQuota, default_scheduler
from .server import ServingAPIServer, ServingFrontDoor, start_api_server

__all__ = [
    "CompletionRequest",
    "ProtocolError",
    "parse_completion_request",
    "SLOFairScheduler",
    "TenantQuota",
    "default_scheduler",
    "ServingAPIServer",
    "ServingFrontDoor",
    "start_api_server",
]
