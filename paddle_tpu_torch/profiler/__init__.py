"""The profiler (counterpart of ``paddle_tpu/profiler/__init__.py``;
parity: ``paddle.profiler``) on ``torch.profiler``.

``Profiler(targets, scheduler, on_trace_ready)`` steps through the same
states as JAX's (``make_scheduler``: closed, ready, record, the last
record step ``RECORD_AND_RETURN``). A record window runs one
``torch.profiler.profile`` over the targets' activities (``CPU``, and
``GPU`` as CUDA: the device tracer is CUPTI's, where JAX's is XLA's);
when it closes, its chrome trace is written into ``log_dir``
(``trace_<first step>.json``) and ``on_trace_ready`` is called.
``RecordEvent`` is ``torch.profiler.record_function``. ``summary()``
gives the step times and a table of operations over the recorded
windows: calls, host time and device time, the ``paddle_tpu::*`` kernel
ops and the CUDA kernels among them.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List

import torch


class ProfilerTarget(Enum):
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"  # taken for parity; no device of that kind here


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int = 0, ready: int = 0, record: int = 1,
                   repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Parity: ``paddle.profiler.make_scheduler(closed, ready, record)``;
    the same states step by step as the JAX package's."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


@dataclass
class _StepRecord:
    step: int
    ms: float
    annotations: List[str] = field(default_factory=list)


class RecordEvent:
    """Parity: ``paddle.profiler.RecordEvent``: a named host range on the
    trace (``torch.profiler.record_function``)."""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)

    begin = __enter__

    def end(self):
        self.__exit__(None, None, None)


def _activities(targets):
    acts = [torch.profiler.ProfilerActivity.CPU]
    want_gpu = targets is None or any(
        t in (ProfilerTarget.GPU, "gpu") for t in targets)
    if want_gpu and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 log_dir: str = "./profiler_log", timer_only: bool = False):
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        if isinstance(self.scheduler, tuple):
            lo, hi = self.scheduler
            self.scheduler = make_scheduler(closed=lo, ready=0,
                                            record=hi - lo)
        self.log_dir = log_dir
        self.timer_only = timer_only
        self.on_trace_ready = on_trace_ready
        export_dir = getattr(on_trace_ready, "_export_dir", None)
        if export_dir:
            self.log_dir = export_dir
        self.activities = _activities(targets)
        self.step_num = 0
        self.traces: List[str] = []
        self._prof = None
        self._window_start = 0
        self._events: List = []
        self._records: List[_StepRecord] = []
        self._t0 = None

    # ------------------------------------------------------------------
    def start(self):
        self._maybe_transition()
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self._records.append(_StepRecord(
                self.step_num, (time.perf_counter() - self._t0) * 1e3))
            self._t0 = None
        if self._prof is not None:
            self._close_window()

    def step(self):
        if self._t0 is not None:
            self._records.append(_StepRecord(
                self.step_num, (time.perf_counter() - self._t0) * 1e3))
        self.step_num += 1
        self._maybe_transition()
        self._t0 = time.perf_counter()

    def _open_window(self):
        self._prof = torch.profiler.profile(activities=self.activities)
        self._prof.__enter__()
        self._window_start = self.step_num

    def _close_window(self):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        self._events.append(prof.key_averages())
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"trace_{self._window_start}.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)
        if self.on_trace_ready:
            self.on_trace_ready(self)

    def _maybe_transition(self):
        state = self.scheduler(self.step_num)
        want = state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)
        if want and self._prof is None and not self.timer_only:
            self._open_window()
        elif not want and self._prof is not None:
            self._close_window()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    def op_summary(self) -> Dict[str, Dict[str, float]]:
        """Per operation over the recorded windows: ``calls``, ``cpu_ms``
        (host time, self) and ``device_ms`` (device time, self)."""
        out: Dict[str, Dict[str, float]] = {}
        for events in self._events:
            for e in events:
                row = out.setdefault(e.key, {"calls": 0, "cpu_ms": 0.0,
                                             "device_ms": 0.0})
                row["calls"] += e.count
                row["cpu_ms"] += e.self_cpu_time_total / 1e3
                row["device_ms"] += getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        return out

    def summary(self, sorted_by: str = "ms", op_top: int = 20) -> str:
        """The step-time table and the top operations by device time (by
        host time where no device time was recorded)."""
        lines = []
        if not self._records:
            lines.append("no steps recorded")
        else:
            import numpy as np

            times = [r.ms for r in self._records]
            lines += [
                "step time summary (ms)",
                f"  steps: {len(times)}",
                f"  mean:  {np.mean(times):.2f}",
                f"  p50:   {np.percentile(times, 50):.2f}",
                f"  p90:   {np.percentile(times, 90):.2f}",
                f"  min:   {np.min(times):.2f}",
                f"  max:   {np.max(times):.2f}",
                f"  trace dir: {self.log_dir}",
            ]
        ops = self.op_summary()
        if ops:
            key = "device_ms" if any(r["device_ms"] for r in ops.values()) \
                else "cpu_ms"
            rows = sorted(ops.items(), key=lambda kv: -kv[1][key])[:op_top]
            lines.append(f"{'operation':<60} {'calls':>8} {'cpu ms':>10} "
                         f"{'device ms':>10}")
            for name, r in rows:
                lines.append(f"{name[:60]:<60} {int(r['calls']):>8} "
                             f"{r['cpu_ms']:>10.3f} {r['device_ms']:>10.3f}")
        return "\n".join(lines)


def export_chrome_tracing(dir_name: str):
    """An ``on_trace_ready`` callback naming the directory the chrome
    traces go to (the ``Profiler`` writes them there from the start)."""

    def cb(prof: Profiler):
        prof.log_dir = dir_name

    cb._export_dir = dir_name
    return cb
