"""Process-wide metrics registry — labeled Counter / Gauge / Histogram
with Prometheus text exposition and JSON snapshot (counterpart of
``paddle_tpu/observability/registry.py``, with its metric names, labels
and bucket edges).

The single always-on registry the trainer and the serving engine publish
through, so one ``/metrics`` scrape or ``observability.dump`` sees the
whole process. The port's registry is its own: it never shares the JAX
package's.

Design rules:
  * ``PT_FLAGS_telemetry=off`` makes every instrumented call a true
    no-op: ``get_registry()`` hands back a shared null registry whose
    metric objects have empty-body methods — no label-dict churn, no
    locks, no allocation on the hot path.
  * Histograms use FIXED exponential bucket edges (Prometheus
    cumulative-``le`` convention) plus a small bounded window of raw
    observations for accurate local percentiles (p50/p90 in
    ``metrics_snapshot()`` without bucket interpolation error).
  * Thread-safe: one registry-wide rlock guards series creation and
    updates (admission threads, HTTP scrape thread, train loop).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from .. import flags


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` exponentially spaced upper edges: start * factor**i."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exp_buckets needs start>0, factor>1, count>=1; got "
            f"({start}, {factor}, {count})")
    return tuple(start * factor ** i for i in range(count))


# default edges suit millisecond-scale latencies: 1ms .. ~65s
DEFAULT_BUCKETS = exp_buckets(1.0, 2.0, 17)

# raw-observation window per histogram series (for exact percentiles)
_WINDOW = 2048


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral floats print as ints."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = lock
        self._series: Dict[Tuple, object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{self.label_names}, got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _label_str(self, key: Tuple) -> str:
        if not self.label_names:
            return ""
        pairs = ",".join(
            f'{n}="{_escape(v)}"' for n, v in zip(self.label_names, key))
        return "{" + pairs + "}"

    def series(self):
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def expose(self, lines):
        for k, v in sorted(self.series().items()):
            lines.append(f"{self.name}{self._label_str(k)} {_fmt(v)}")

    def snap(self):
        return [{"labels": dict(zip(self.label_names, k)), "value": v}
                for k, v in sorted(self.series().items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def set_max(self, value: float, **labels):
        """Peak-tracking write: keeps the running maximum."""
        k = self._key(labels)
        with self._lock:
            cur = self._series.get(k)
            if cur is None or value > cur:
                self._series[k] = float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    expose = Counter.expose
    snap = Counter.snap


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "window")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.window = deque(maxlen=_WINDOW)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names, lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_, label_names, lock)
        edges = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(
                f"histogram {name!r} bucket edges must be strictly "
                f"increasing: {edges}")
        self.buckets = edges

    def _get(self, labels) -> _HistSeries:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series.setdefault(k, _HistSeries(len(self.buckets)))
        return s

    def observe(self, value: float, **labels):
        v = float(value)
        with self._lock:
            s = self._get(labels)
            i = len(self.buckets)
            for j, edge in enumerate(self.buckets):
                if v <= edge:
                    i = j
                    break
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            s.window.append(v)

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s.count if s else 0

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Exact percentile over the recent raw-observation window
        (q in [0, 100]); None with no observations."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if not s or not s.window:
                return None
            vals = sorted(s.window)
        idx = min(len(vals) - 1, max(0, int(round(
            q / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    def window_len(self, **labels) -> int:
        """Observations currently in the raw percentile window."""
        with self._lock:
            s = self._series.get(self._key(labels))
            return len(s.window) if s else 0

    def reset_window(self, **labels):
        """Clear the raw percentile window for one series; cumulative
        bucket counts / sum / count are untouched (Prometheus totals
        must never go backwards)."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if s:
                s.window.clear()

    def expose(self, lines):
        for k, s in sorted(self.series().items()):
            cum = 0
            for edge, c in zip(self.buckets, s.counts):
                cum += c
                labels = list(zip(self.label_names, k)) + [("le", _fmt(edge))]
                pairs = ",".join(
                    f'{n}="{_escape(v)}"' for n, v in labels)
                lines.append(f"{self.name}_bucket{{{pairs}}} {cum}")
            cum += s.counts[-1]
            pairs = ",".join(
                f'{n}="{_escape(v)}"'
                for n, v in list(zip(self.label_names, k)) + [("le", "+Inf")])
            lines.append(f"{self.name}_bucket{{{pairs}}} {cum}")
            ls = self._label_str(k)
            lines.append(f"{self.name}_sum{ls} {_fmt(s.sum)}")
            lines.append(f"{self.name}_count{ls} {s.count}")

    def snap(self):
        out = []
        for k, s in sorted(self.series().items()):
            out.append({
                "labels": dict(zip(self.label_names, k)),
                "count": s.count,
                "sum": s.sum,
                "buckets": {_fmt(e): c
                            for e, c in zip(self.buckets, s.counts)},
                "inf": s.counts[-1],
                "p50": self.percentile(50, **dict(zip(self.label_names, k))),
                "p90": self.percentile(90, **dict(zip(self.label_names, k))),
            })
        return out


class MetricsRegistry:
    """Named metrics with get-or-create semantics (idempotent across the
    many modules that instrument the same process)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} "
                        f"labels={tuple(labels)}; existing is {m.kind} "
                        f"labels={m.label_names}")
                # buckets=None on re-registration means "fetch whatever
                # exists" (the common re-fetch idiom); only an EXPLICIT
                # conflicting edge set is an error
                want = kw.get("buckets")
                if want is not None and \
                        tuple(want) != tuple(getattr(m, "buckets", ())):
                    raise ValueError(
                        f"histogram {name!r} re-registered with "
                        f"different buckets {tuple(want)}; existing "
                        f"{tuple(m.buckets)} — observations would land "
                        "in the first caller's edges")
                return m
            m = cls(name, help_, labels, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_: str = "", labels: Sequence[str] = ()):
        return self._get_or_create(Counter, name, help_, labels)

    def gauge(self, name, help_: str = "", labels: Sequence[str] = ()):
        return self._get_or_create(Gauge, name, help_, labels)

    def histogram(self, name, help_: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None):
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    # ---------------- exposition ----------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            m.expose(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-ready snapshot of every metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {
            m.name: {"type": m.kind, "help": m.help, "series": m.snap()}
            for m in metrics
        }


# ---------------------------------------------------------------------------
# null objects — what instrumented code holds when telemetry is off
# ---------------------------------------------------------------------------
class _NullMetric:
    """Shared do-nothing stand-in for every metric kind."""

    def inc(self, *a, **k):
        pass

    dec = set = set_max = observe = inc

    def value(self, **k):
        return 0.0

    def count(self, **k):
        return 0

    window_len = count

    def percentile(self, q, **k):
        return None

    def reset_window(self, **k):
        pass

    def series(self):
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    def counter(self, *a, **k):
        return _NULL_METRIC

    gauge = histogram = counter

    def get(self, name):
        return None

    def reset(self):
        pass

    def prometheus_text(self):
        return ""

    def snapshot(self):
        return {}


_GLOBAL = MetricsRegistry()
_NULL = NullRegistry()


def enabled() -> bool:
    return bool(flags.flag("telemetry"))


def get_registry():
    """The process-wide registry, or the shared null registry when
    ``PT_FLAGS_telemetry=off`` (instrumented paths become no-ops)."""
    return _GLOBAL if enabled() else _NULL


def global_registry() -> MetricsRegistry:
    """The real registry regardless of the flag (exposition/tests)."""
    return _GLOBAL
