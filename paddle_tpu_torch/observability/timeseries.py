"""Bounded fixed-cadence time-series history over serving metrics
(counterpart of ``paddle_tpu/observability/timeseries.py``).

Registry snapshots, lifecycle traces and measured per-program device
time are point-in-time views; this module remembers *history*, so an
operator (or the degradation ladder) can ask "is TTFT attainment burning
down?" or "did the prefix hit-rate collapse when that tenant arrived?".
It is the flight-data recorder those questions read:

* :class:`TimeSeriesStore` — a bounded ring of WINDOWED samples. The
  owning engine (or router) calls :meth:`on_tick` once per scheduler
  tick with a collector callable; every ``cadence``-th tick the window
  closes: the collector's cumulative counters become per-window DELTAS
  and per-tick RATES, gauges are point-sampled, and (telemetry on)
  histogram window-percentiles ride along. The ring keeps the last
  ``retention`` windows — host memory is bounded no matter how long the
  engine runs.

* **Tick-driven, wall-clock-free in all decisions**: window boundaries,
  deltas and rates are functions of tick counts only (the same
  determinism contract as the breaker/ladder state machines — replaying
  the same tick sequence reproduces the same series, which is what
  makes the alert layer's firings deterministic under seeded fault
  storms). ``perf_counter`` stamps ride along on each sample for
  display/correlation only; nothing decides on them.

* **Scrape-thread-safe copy-on-read**: samples are built fully before
  being appended under a lock and never mutated afterwards; readers
  (:meth:`series` / :meth:`snapshot`) take the lock and return fresh
  lists — the CC001/SAFE_READS contract every other serving reader
  follows. ``engine.timeline_snapshot()`` / the ``/timeline`` endpoint /
  ``dump --timeline`` all read through here.

Gating: ``PT_FLAGS_timeseries`` (off = the engine holds ``None`` — one
identity check per tick, zero allocation, no device work,
outputs bit-identical; pinned by test), with ``timeseries_cadence`` /
``timeseries_retention`` sizing the windows.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

from .. import flags

# live stores (weak: an engine dropping its store drops it here too) —
# the `dump --timeline` CLI reads the process-wide view, mirroring the
# tracer registry in tracing.py
_STORES: "weakref.WeakSet[TimeSeriesStore]" = weakref.WeakSet()

_LABEL_SEQ = itertools.count()


def stores() -> List["TimeSeriesStore"]:
    """Every live store in the process (weak registry) — the
    ``dump --timeline`` export path."""
    return list(_STORES)


class TimeSeriesStore:
    """Fixed-cadence windowed metric history for ONE engine or router.

    ``collect`` (passed to :meth:`on_tick`) returns the current
    cumulative view::

        {"counters": {name: cumulative float},   # deltas/rates derived
         "gauges":   {name: current float},      # point-sampled
         "percentiles": {name: float | None}}    # histogram windows

    Counter keys may carry a per-class suffix (``"slo_met:interactive"``)
    — the alert rules parse the prefix. Each closed window appends one
    immutable sample dict::

        {"tick", "window_ticks", "t", "wall_s",
         "counters", "deltas", "rates", "gauges", "percentiles"}

    where ``rates`` are per-TICK (delta / window_ticks — deterministic;
    divide by ``wall_s`` for a per-second display rate, which nothing in
    the alert layer does).
    """

    def __init__(self, label: Optional[str] = None,
                 cadence: Optional[int] = None,
                 retention: Optional[int] = None):
        if label is None:
            label = f"ts{next(_LABEL_SEQ)}"
        self.label = str(label)
        if cadence is None:
            cadence = int(flags.flag("timeseries_cadence"))
        if retention is None:
            retention = int(flags.flag("timeseries_retention"))
        self.cadence = max(int(cadence), 1)
        self.retention = max(int(retention), 1)
        self._ring: deque = deque(maxlen=self.retention)
        self._lock = threading.Lock()
        self._tick = 0
        # previous window's cumulative counters ({} at start: the first
        # window's deltas are the full counts — counters start at zero
        # when the engine that owns this store is constructed)
        self._last: Dict[str, float] = {}
        self._t_last: Optional[float] = None
        _STORES.add(self)

    # ---------------- write side (scheduler thread) ----------------
    def on_tick(self, collect: Callable[[], dict]) -> Optional[dict]:
        """Advance one scheduler tick; every ``cadence``-th tick closes
        a window (calls ``collect`` and appends the windowed sample).
        Returns the new sample, or None between window boundaries —
        the tick count is the ONLY input to that decision."""
        self._tick += 1
        if self._tick % self.cadence:
            return None
        doc = collect()
        counters = {k: float(v)
                    for k, v in doc.get("counters", {}).items()}
        # Prometheus counter-reset convention: a value BELOW the
        # previous sample means the source was reset between windows
        # (bench window resets clear slo_stats/_finished mid-run) —
        # the delta restarts from the post-reset count instead of
        # going negative and poisoning every window-aggregating rule
        deltas = {}
        for k, v in counters.items():
            last = self._last.get(k, 0.0)
            deltas[k] = v - last if v >= last else v
        rates = {k: d / self.cadence for k, d in deltas.items()}
        now = time.perf_counter()
        sample = {
            "tick": self._tick,
            "window_ticks": self.cadence,
            # display-only stamps: correlation with the tracer/registry,
            # never an input to windowing or alert decisions
            "t": now,
            "wall_s": (now - self._t_last
                       if self._t_last is not None else None),
            "counters": counters,
            "deltas": deltas,
            "rates": rates,
            "gauges": {k: float(v)
                       for k, v in doc.get("gauges", {}).items()},
            "percentiles": dict(doc.get("percentiles", {})),
        }
        self._last = counters
        self._t_last = now
        with self._lock:
            self._ring.append(sample)
        return sample

    # ---------------- read side (any thread) ----------------
    def series(self) -> List[dict]:
        """Snapshot copy of the ring, oldest first. Samples are
        immutable after append, so handing them out by reference is
        torn-window-free; only the ring itself needs the lock."""
        with self._lock:
            return list(self._ring)

    def last(self, n: int) -> List[dict]:
        with self._lock:
            k = len(self._ring)
            return list(itertools.islice(self._ring, max(k - n, 0), k))

    def __len__(self):
        return len(self._ring)

    def snapshot(self) -> dict:
        """JSON-ready view: config + the full retained series. One
        critical section for tick/window/series, so a scrape racing a
        window close can never return a doc whose ``windows`` count
        disagrees with ``len(series)``."""
        with self._lock:
            series = list(self._ring)
            tick = self._tick
        return {
            "label": self.label,
            "cadence": self.cadence,
            "retention": self.retention,
            "ticks": tick,
            "windows": len(series),
            "series": series,
        }
