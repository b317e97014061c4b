"""Trainer telemetry: per-step instrumentation for ``TrainStep.run``
(counterpart of ``paddle_tpu/observability/train.py``).

Sampling discipline: every step records only host-side wall time into
the ring buffer — cheap python, no device traffic. On a sample-every-N
cadence the loss / grad-norm device scalars (which the step already
produced) are fetched, gauges update, ``torch.cuda.memory_stats()`` is
read, and the anomaly watchdog runs. Non-sampled steps perform NO host
sync beyond what the caller does with the returned loss.

Rate metrics (tokens/s, MFU) are averaged over the SAMPLING INTERVAL,
measured between post-fetch sync points: per-step wall clock only times
the asynchronous launch of the step's kernels, which can run far ahead
of the device. The interval endpoints sit right after ``float(loss)`` —
a real completion fence — so the rate is device-true in steady state.

MFU needs the card's peak and the step's FLOPs. The peak is keyed by the
card's name (``_PEAK_BF16_FLOPS``: H100 bf16 dense, 989 TFLOP/s) and is
None on the CPU, so no MFU is reported there. The FLOPs come from the
trainer's probe (``torch.utils.flop_counter.FlopCounterMode`` over one
step), which runs once, and only where a peak is known.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .. import flags
from .recorder import AnomalyWatchdog, FlightRecorder
from .registry import exp_buckets, get_registry

# card name -> peak dense bf16 FLOP/s per card (public spec sheets);
# the MFU estimate is best-effort — unknown cards and the CPU report no
# MFU
_PEAK_BF16_FLOPS = {
    "H100": 989e12,
}


def _peak_flops() -> Optional[float]:
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(torch.cuda.current_device())
    for k, v in _PEAK_BF16_FLOPS.items():
        if k.lower() in name.lower():
            return v
    return None


def _memory_stats() -> Optional[dict]:
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        stats = torch.cuda.memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    out = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        if src in stats:
            out[key] = stats[src]
    return out or None


class TrainTelemetry:
    """One instance per TrainStep; holds its metrics, flight recorder
    and watchdog. Construct only when telemetry is enabled — callers
    keep ``None`` otherwise so the off path is a single identity
    check."""

    def __init__(self, sample_every: Optional[int] = None,
                 flight_window: Optional[int] = None,
                 dump_dir: Optional[str] = None,
                 spike_factor: Optional[float] = None):
        self.sample_every = max(1, int(
            sample_every if sample_every is not None
            else flags.flag("telemetry_sample_every")))
        reg = get_registry()
        self.recorder = FlightRecorder(
            capacity=(flight_window if flight_window is not None
                      else flags.flag("telemetry_flight_window")),
            dump_dir=(dump_dir if dump_dir is not None
                      else flags.flag("telemetry_dump_dir")))
        self.watchdog = AnomalyWatchdog(
            self.recorder,
            spike_factor=(spike_factor if spike_factor is not None
                          else flags.flag("telemetry_grad_spike_factor")))
        self._steps = reg.counter(
            "pt_train_steps_total", "optimizer steps executed")
        self._tokens = reg.counter(
            "pt_train_tokens_total", "tokens consumed by training")
        self._step_ms = reg.histogram(
            "pt_train_step_ms", "host wall-clock per train step (ms)",
            buckets=exp_buckets(0.5, 2.0, 20))
        self._loss = reg.gauge("pt_train_loss", "last sampled loss")
        self._gnorm = reg.gauge(
            "pt_train_grad_norm", "last sampled global gradient norm")
        self._tps = reg.gauge(
            "pt_train_tokens_per_sec", "sampled-step token throughput")
        self._mfu = reg.gauge(
            "pt_train_mfu", "estimated model FLOPs utilization (0-1)")
        self._mem = reg.gauge(
            "pt_device_memory_bytes", "device memory_stats()",
            labels=("stat",))
        self._flops_per_step: Optional[float] = None
        self._flops_known = False
        self._peak = None
        self._peak_known = False
        # sampling-interval accumulators (rates are computed between
        # post-fetch sync points, not from per-step dispatch wall time)
        self._interval_t0 = time.perf_counter()
        self._interval_tokens = 0
        self._interval_steps = 0
        self.samples = 0
        self.last_sample: dict = {}

    # ------------------------------------------------------------------
    def should_sample(self, step: int) -> bool:
        return step % self.sample_every == 0

    def on_step(self, step: int, loss, grad_norm, tokens: int,
                wall_s: float,
                flops_getter: Optional[Callable[[], Optional[float]]] = None):
        """``loss``/``grad_norm`` are device scalars (async futures) —
        they are fetched ONLY on sampled steps."""
        wall_ms = wall_s * 1e3
        self._steps.inc()
        if tokens:
            self._tokens.inc(tokens)
        self._step_ms.observe(wall_ms)
        self._interval_tokens += int(tokens)
        self._interval_steps += 1
        rec = {"step": step, "wall_ms": round(wall_ms, 3),
               "tokens": int(tokens)}
        if not self.should_sample(step):
            self.recorder.record(**rec)
            return None
        # ---- sampled step: host sync on the two scalars ----
        loss_f = float(loss) if loss is not None else None
        gnorm_f = float(grad_norm) if grad_norm is not None else None
        # the float() above fenced this step's completion: NOW is a
        # device-true interval endpoint for the rate metrics
        now = time.perf_counter()
        interval_s = now - self._interval_t0
        if loss_f is not None:
            self._loss.set(loss_f)
            rec["loss"] = loss_f
        if gnorm_f is not None:
            self._gnorm.set(gnorm_f)
            rec["grad_norm"] = gnorm_f
        if self._interval_tokens and interval_s > 0:
            tps = self._interval_tokens / interval_s
            self._tps.set(tps)
            rec["tokens_per_sec"] = round(tps, 1)
        mfu = self._mfu_estimate(
            interval_s / max(self._interval_steps, 1), flops_getter)
        if mfu is not None:
            self._mfu.set(mfu)
            rec["mfu_est"] = round(mfu, 4)
        self._interval_t0 = now
        self._interval_tokens = 0
        self._interval_steps = 0
        if flags.flag("log_memory_stats"):
            mem = _memory_stats()
            if mem:
                for k, v in mem.items():
                    self._mem.set(v, stat=k)
                rec["memory"] = mem
        self.recorder.record(**rec)
        self.samples += 1
        self.last_sample = rec
        return self.watchdog.check(step, loss_f, gnorm_f)

    def _mfu_estimate(self, wall_s: float, flops_getter) -> Optional[float]:
        # peak first: on devices with no spec-sheet entry (the CPU) MFU
        # is undefined, so never pay the FLOPs probe (one counted
        # step) there
        if not self._peak_known:
            self._peak_known = True
            try:
                self._peak = _peak_flops()
            except Exception:
                self._peak = None
        if not self._peak:
            return None
        if not self._flops_known:
            self._flops_known = True
            if flops_getter is not None:
                try:
                    self._flops_per_step = flops_getter()
                except Exception:
                    self._flops_per_step = None
        if not self._flops_per_step or wall_s <= 0:
            return None
        return self._flops_per_step / wall_s / self._peak


def record_scalars(prefix: str, logs: Optional[dict], step=None):
    """Publish a dict of scalar logs as ``pt_<prefix>_<key>`` gauges —
    the shared funnel the JAX package's hapi callbacks emit through (the
    port's hapi is still to come). Non-numeric values are skipped."""
    if not logs:
        return
    reg = get_registry()
    for k, v in logs.items():
        try:
            f = float(v[0] if isinstance(v, (list, tuple)) else v)
        except (TypeError, ValueError, IndexError):
            continue
        name = "pt_" + "".join(
            c if c.isalnum() or c == "_" else "_"
            for c in f"{prefix}_{k}".lower())
        reg.gauge(name, f"hapi scalar {prefix}/{k}").set(f)
