"""Always-on runtime telemetry (counterpart of
``paddle_tpu/observability``, with its exports).

One process-wide ``MetricsRegistry`` (Counter / Gauge / Histogram with
Prometheus text exposition and JSON snapshot) that the trainer and the
continuous-batching engine publish through — the port's own, never the
JAX package's; a flight recorder + anomaly watchdog for postmortems; the
serving engine's lifecycle tracer, program profiler (CUDA events on the
card), recompile watchdog, time series, alerts and cost attribution; and
a one-shot dump CLI (``python -m paddle_tpu_torch.observability.dump``).

``PT_FLAGS_telemetry=off`` turns every instrumented path into a true
no-op (shared null objects, no dict churn).
"""

from . import alerts, profiling, timeseries, tracing  # noqa: F401
from .alerts import ALERT_RULES, AlertManager, AlertRule  # noqa: F401
from .comm import comm_log, record as record_collective, reset_comm_log  # noqa: F401
from .timeseries import TimeSeriesStore  # noqa: F401
from .profiling import (  # noqa: F401
    PROGRAM_LABELS,
    ProgramProfiler,
    ProgramSignatures,
    RecompileWatchdog,
    hbm_accounting,
)
from .recorder import AnomalyWatchdog, FlightRecorder  # noqa: F401
from .tracing import Tracer  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    DEFAULT_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    enabled,
    exp_buckets,
    get_registry,
    global_registry,
)
from .serve import RouterTelemetry, ServingTelemetry  # noqa: F401
from .train import TrainTelemetry, record_scalars  # noqa: F401
