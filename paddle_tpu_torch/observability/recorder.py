"""Flight recorder + anomaly watchdog — the postmortem artifact
(counterpart of ``paddle_tpu/observability/recorder.py``).

A ring buffer holds the last K step records (step index, wall time,
loss / grad-norm / memory when sampled). When the watchdog sees a
NaN/Inf loss or a grad-norm spike it dumps the whole window to a JSON
file, so a blown-up run leaves evidence of the steps that led into the
anomaly instead of just a stack trace. Dumps also attach the tail of
every live lifecycle tracer (``tracing.recent_events``) — when a
serving engine shares the process, the dump shows what the engine was
DOING around the anomaly (which programs ran, which requests moved),
not just metric values.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Optional

from .registry import get_registry


class FlightRecorder:
    """Ring buffer of the last ``capacity`` step records, dumpable to
    JSON. Records are plain dicts of JSON-serializable host values —
    recording never touches device state. ``trace_tail`` bounds how
    many lifecycle-tracer events a dump attaches (0 disables)."""

    def __init__(self, capacity: int = 64,
                 dump_dir: str = "flight_records",
                 trace_tail: int = 64):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.trace_tail = int(trace_tail)
        self._buf: deque = deque(maxlen=self.capacity)
        self._n_dumps = 0

    def record(self, **fields):
        self._buf.append(fields)

    def records(self):
        return list(self._buf)

    def __len__(self):
        return len(self._buf)

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Write the current window to ``dump_dir`` and return the
        path. Never raises — a failing dump must not take down the
        training loop it is documenting."""
        os.makedirs(self.dump_dir, exist_ok=True)
        self._n_dumps += 1
        path = os.path.join(
            self.dump_dir,
            f"flight_{int(time.time())}_{self._n_dumps:03d}.json")
        payload = {
            "reason": reason,
            "unix_time": time.time(),
            "n_records": len(self._buf),
            "capacity": self.capacity,
            "records": list(self._buf),
        }
        if extra:
            payload["extra"] = extra
        if self.trace_tail > 0:
            # last N request spans / step events across every live
            # tracer: the anomaly dump shows what the engine was doing,
            # not just metric values (empty when no tracer exists —
            # training-only processes pay nothing)
            from .tracing import recent_events

            tail = recent_events(self.trace_tail)
            if tail:
                payload["trace_tail"] = tail
        try:
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        except OSError:
            return ""
        get_registry().counter(
            "pt_flight_dumps_total",
            "flight-recorder JSON dumps written").inc()
        return path


class AnomalyWatchdog:
    """Checks sampled step stats and triggers a flight-recorder dump on
    NaN/Inf loss or a grad-norm spike (> ``spike_factor`` x the running
    median of recent finite grad norms)."""

    def __init__(self, recorder: FlightRecorder,
                 spike_factor: float = 10.0,
                 history: int = 32, min_history: int = 5):
        self.recorder = recorder
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self._norms: deque = deque(maxlen=int(history))
        self.tripped: list = []  # (step, reason, dump_path)

    def _median(self) -> Optional[float]:
        if len(self._norms) < self.min_history:
            return None
        vals = sorted(self._norms)
        return vals[len(vals) // 2]

    def check(self, step: int, loss: Optional[float],
              grad_norm: Optional[float]) -> Optional[str]:
        """Returns the dump path when an anomaly fired, else None."""
        reason = None
        if loss is not None and not math.isfinite(loss):
            reason = f"non-finite loss {loss} at step {step}"
        elif grad_norm is not None and not math.isfinite(grad_norm):
            reason = f"non-finite grad norm {grad_norm} at step {step}"
        elif grad_norm is not None:
            med = self._median()
            if med is not None and med > 0 and \
                    grad_norm > self.spike_factor * med:
                reason = (f"grad-norm spike {grad_norm:.4g} > "
                          f"{self.spike_factor:g}x median {med:.4g} "
                          f"at step {step}")
        if grad_norm is not None and math.isfinite(grad_norm):
            self._norms.append(grad_norm)
        if reason is None:
            return None
        get_registry().counter(
            "pt_train_anomalies_total",
            "anomaly-watchdog trips (NaN/Inf loss, grad spikes)").inc()
        path = self.recorder.dump(reason)
        self.tripped.append((step, reason, path))
        return path
