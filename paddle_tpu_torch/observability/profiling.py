"""Measured per-program device-time attribution for the serving engine
(counterpart of ``paddle_tpu/observability/profiling.py``).

* :class:`ProgramProfiler` — cadence-sampled timing around every serving
  dispatch. A SAMPLED dispatch records the three-way decomposition

      schedule_ms  host work before the forward is launched (copy-on-
                   write checks, sampling vectors, staging)
      dispatch_ms  the launch itself (the host enqueueing the forward's
                   kernels)
      device_ms    the device time of the forward: the elapsed time
                   between two ``torch.cuda.Event(enable_timing=True)``
                   recorded on the engine's stream around the launch,
                   read after one synchronisation on the end event. On
                   the CPU, where a forward runs as it is called,
                   ``time.perf_counter`` stamps around the launch take
                   their place (device_ms and dispatch_ms then read the
                   same span)

  into ``pt_serve_program_ms{engine,program}`` (plus dispatch/schedule
  histograms) and host-side stats that survive telemetry=off.
  UNSAMPLED dispatches record no event and never synchronise: the
  engine's seams consult ``want()`` (one int increment). With
  ``PT_FLAGS_profile_programs`` off the engine holds no profiler at all
  (one identity check per seam).

* :class:`RecompileWatchdog` — seals the expected program set after
  warmup and, on any post-seal growth of the engine's program
  signatures during one of the OWNING engine's own ticks, counts
  ``pt_serve_recompiles_total{engine,program}`` and dumps a
  FlightRecorder artifact carrying the offending signature's arg shapes.
  PyTorch compiles no program per shape, so the engine keeps the record
  the watchdog reads (:class:`ProgramSignatures`): each dispatch's
  program label and signature (argument shapes, dtypes and static
  arguments, what makes a JAX jit retrace). A signature an engine has
  not dispatched before counts where the JAX engine's ``TRACE_COUNTS``
  counts a trace.

* :func:`hbm_accounting` — live device-memory residency derived from the
  pools the engine already owns (tensor ``nbytes`` metadata — no device
  traffic): KV pool bytes including int8 scale rows, weight/buffer bytes
  by dtype, contiguous prefix-store bytes.

``PROGRAM_LABELS`` is the attribution registry: every program label the
engine dispatches must carry a timing label here.
"""

from __future__ import annotations

import collections
from collections import deque
from typing import Dict, List, Optional

import torch

from .. import flags
from .registry import exp_buckets, get_registry

# the attribution registry: every program label the engine's signature
# record names must appear here (tests/test_torch_profiling.py holds the
# engine's labels against it)
PROGRAM_LABELS: Dict[str, str] = {
    "prefill_chunk": "fixed [slots, C] chunked prefill (THE prefill "
                     "program; one call per suffix chunk of a wave)",
    "prefill_bucket": "legacy per-bucket whole-prompt prefill (the "
                      "parity oracle; one specialization per bucket)",
    "prefill_insert": "legacy contiguous prefill cache insert "
                      "(a copy into the slot rows)",
    "prefill_scatter": "legacy paged prefill page scatter (bucket "
                       "cache -> the slot's pages)",
    "prefix_insert": "contiguous prefix-cache block insert (cached "
                     "K/V block -> a slot's rows)",
    "prefix_read": "contiguous prefix-cache block read (a slot's "
                   "rows -> the store's materialized block)",
    "page_copy": "copy-on-write page duplication across every "
                 "layer's pool (src -> dst, scales ride along)",
    "decode_step": "one-token decode over all slots ([slots, 1])",
    "decode_chunk": "K-step decode chunk (the sampled token fed back "
                    "on the device; one host sync per K tokens)",
    "spec_verify": "speculative [slots, spec_k+1] multi-token verify "
                   "pass with on-device greedy acceptance",
}

class ProgramProfiler:
    """Per-engine cadence-sampled program timer.

    ``want(program)`` increments that program's dispatch counter and
    returns True on the sampling cadence (every Nth dispatch per
    program — deterministic, like the tracer's request thinning). The
    engine then takes ``t0``/``t_call`` stamps, calls :meth:`mark` just
    before the launch, ``t_disp`` after it, and :meth:`observe`, which
    waits for the end mark and records the measured decomposition.

    Host-side stats (:meth:`snapshot`) survive ``PT_FLAGS_telemetry=
    off``; the registry histograms no-op through the null registry
    then, same contract as every other serving counter.
    """

    _SEQ = 0  # fallback engine ids when telemetry is off

    def __init__(self, engine_id: Optional[str] = None,
                 sample_every: Optional[int] = None,
                 window: int = 256):
        if engine_id is None:
            engine_id = f"p{ProgramProfiler._SEQ}"
            ProgramProfiler._SEQ += 1
        self.engine_id = str(engine_id)
        if sample_every is None:
            sample_every = int(flags.flag("profile_sample_every"))
        self.sample_every = max(int(sample_every), 1)
        self._window = max(int(window), 1)
        # program -> {"dispatches", "sampled", totals, deques}
        self._stats: Dict[str, dict] = {}
        reg = get_registry()
        L = ("engine", "program")
        self._h_device = reg.histogram(
            "pt_serve_program_ms",
            "MEASURED device wall per sampled compiled-serving-program "
            "dispatch (block_until_ready on the program's own outputs "
            "— not the dispatch-to-token-sync estimate)",
            labels=L, buckets=exp_buckets(0.05, 2.0, 20))
        self._h_dispatch = reg.histogram(
            "pt_serve_program_dispatch_ms",
            "host dispatch wall per sampled dispatch (jit cache "
            "lookup + async dispatch; compiles land here)",
            labels=L, buckets=exp_buckets(0.05, 2.0, 18))
        self._h_schedule = reg.histogram(
            "pt_serve_program_schedule_ms",
            "host scheduling wall before the jit call per sampled "
            "dispatch (COW checks, sampling vectors, array staging)",
            labels=L, buckets=exp_buckets(0.05, 2.0, 18))

    def _prog(self, program: str) -> dict:
        st = self._stats.get(program)
        if st is None:
            if program not in PROGRAM_LABELS:
                raise ValueError(
                    f"unknown program {program!r} — register a timing "
                    "label in observability.profiling.PROGRAM_LABELS")
            st = self._stats[program] = {
                "dispatches": 0, "sampled": 0,
                "device_ms_total": 0.0, "device_ms_max": 0.0,
                "dispatch_ms_total": 0.0, "schedule_ms_total": 0.0,
                "win": deque(maxlen=self._window),
            }
        return st

    # ---------------- sampling ----------------
    def want(self, program: str) -> bool:
        """One dispatch of ``program``; True when THIS dispatch is on
        the sampling cadence. Cadence N samples dispatches N, 2N, ...
        — a program's first dispatch is only sampled at cadence 1."""
        st = self._prog(program)
        st["dispatches"] += 1
        return st["dispatches"] % self.sample_every == 0

    # ---------------- measurement ----------------
    @staticmethod
    def mark(device: torch.device):
        """The start mark of a sampled dispatch, taken just before the
        launch: an event recorded on ``device``'s current stream, or
        None on the CPU (the caller's ``t_call`` stamp stands in)."""
        if device.type != "cuda":
            return None
        stream = torch.cuda.current_stream(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev, stream

    def observe(self, program: str, t0: float, t_call: float,
                t_disp: float, start) -> dict:
        """Close a sampled dispatch: record the end mark after the
        launch, wait for it (the one synchronisation a sampled dispatch
        makes) and record the measured decomposition. ``start`` is
        :meth:`mark`'s result. Returns the decomposition dict so the
        caller can embed it in the tracer's step event."""
        if start is not None:
            ev, stream = start
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            end.synchronize()
            device_ms = float(ev.elapsed_time(end))
        else:
            device_ms = (t_disp - t_call) * 1e3
        dec = {
            "schedule_ms": (t_call - t0) * 1e3,
            "dispatch_ms": (t_disp - t_call) * 1e3,
            "device_ms": device_ms,
        }
        st = self._prog(program)
        st["sampled"] += 1
        st["device_ms_total"] += dec["device_ms"]
        st["device_ms_max"] = max(st["device_ms_max"], dec["device_ms"])
        st["dispatch_ms_total"] += dec["dispatch_ms"]
        st["schedule_ms_total"] += dec["schedule_ms"]
        st["win"].append(dec["device_ms"])
        lab = {"engine": self.engine_id, "program": program}
        self._h_device.observe(dec["device_ms"], **lab)
        self._h_dispatch.observe(dec["dispatch_ms"], **lab)
        self._h_schedule.observe(dec["schedule_ms"], **lab)
        return dec

    # ---------------- read side ----------------
    def snapshot(self) -> dict:
        """Per-program measured stats (copy-on-read: the scrape thread
        calls this through ``engine.profile_snapshot()``)."""
        programs = {}
        for name, st in list(self._stats.items()):
            win = sorted(st["win"])  # deque snapshot -> new list
            sampled = st["sampled"]
            programs[name] = {
                "dispatches": st["dispatches"],
                "sampled": sampled,
                "device_ms_p50": (win[len(win) // 2] if win else None),
                "device_ms_mean": (st["device_ms_total"] / sampled
                                   if sampled else None),
                "device_ms_max": (st["device_ms_max"] if sampled
                                  else None),
                "dispatch_ms_mean": (st["dispatch_ms_total"] / sampled
                                     if sampled else None),
                "schedule_ms_mean": (st["schedule_ms_total"] / sampled
                                     if sampled else None),
            }
        return {
            "engine": self.engine_id,
            "sample_every": self.sample_every,
            "programs": programs,
        }

    def window_reset(self):
        """Zero the host-side stats — one measurement window per bench
        sweep (registry histogram totals keep running, same contract
        as ``metrics_window_reset``)."""
        self._stats = {}


def _meta(v):
    """Shape and dtype of a tensor or array (of each member of a tuple
    such as ``QuantizedKV``); None for anything else."""
    if hasattr(v, "shape"):
        return tuple(v.shape), str(v.dtype)
    if isinstance(v, tuple):
        return tuple(_meta(x) for x in v)
    return None


class ProgramSignatures:
    """One engine's record of what it dispatched: per program label, the
    distinct signatures (argument shapes, dtypes and static arguments)
    seen so far. ``counts[program]`` is how many there were and
    ``shapes[program]`` the newest one's arg shapes — the two mappings
    :class:`RecompileWatchdog` reads, where the JAX engine hands it its
    trace-time ``TRACE_COUNTS`` / ``TRACE_SHAPES``."""

    def __init__(self):
        self._seen: Dict[str, set] = {}
        self.counts: collections.Counter = collections.Counter()
        self.shapes: Dict[str, dict] = {}

    def note(self, program: str, static=(), **args):
        """Record one dispatch of ``program``: ``args`` are its tensor
        (or None) arguments, read for shape and dtype only — metadata,
        no device traffic; ``static`` what else would specialize it."""
        sig = (tuple(static),) + tuple((k, _meta(v))
                                       for k, v in args.items())
        seen = self._seen.setdefault(program, set())
        if sig in seen:
            return
        seen.add(sig)
        self.counts[program] += 1
        self.shapes[program] = {
            k: tuple(getattr(v, "shape", ())) for k, v in args.items()}


class RecompileWatchdog:
    """Seal-then-watch guard over the engine's program signatures.

    The owning engine calls ``tick_begin()``/``tick_end()`` around each
    scheduler tick. Pre-seal, ticks just count toward ``warmup_ticks``
    (new signatures are expected while programs warm up); once sealed —
    by the tick budget or an explicit :meth:`seal` — every tick
    snapshots the counters at entry and diffs at exit. A detected
    re-specialization increments host + registry counters and
    (telemetry on) dumps a FlightRecorder artifact with the offending
    program's arg shapes. It never raises: production keeps serving.
    """

    def __init__(self, counts, shapes, engine_id: str = "0",
                 warmup_ticks: Optional[int] = None,
                 dump: bool = True):
        """``counts``/``shapes``: the engine's
        :class:`ProgramSignatures` mappings (passed in — observability
        must not import the inference package)."""
        self._counts = counts
        self._shapes = shapes
        self.engine_id = str(engine_id)
        if warmup_ticks is None:
            warmup_ticks = int(flags.flag("recompile_warmup_ticks"))
        self.warmup_ticks = max(int(warmup_ticks), 0)
        self._dump = bool(dump)
        self._ticks = 0
        self.sealed = False
        self._base: Optional[Dict[str, int]] = None
        self.recompiles: Dict[str, int] = {}
        self._recorder = None
        self._counter = get_registry().counter(
            "pt_serve_recompiles_total",
            "post-seal jit re-specializations of a compiled serving "
            "program detected by the runtime recompile watchdog "
            "(TRACE_COUNTS growth during one of the owning engine's "
            "own ticks) — each one also leaves a FlightRecorder "
            "artifact naming the offending arg shapes",
            ("engine", "program"))

    def seal(self):
        """Seal the expected program set NOW (e.g. right after a bench
        warmup) — later new signatures are recompiles."""
        self.sealed = True

    # ---------------- tick hooks ----------------
    def tick_begin(self):
        if not self.sealed:
            self._ticks += 1
            if self._ticks >= self.warmup_ticks:
                self.sealed = True
            return
        self._base = dict(self._counts)

    def tick_end(self) -> List[str]:
        """Diff this tick's signature counters; returns the programs
        that re-specialized (empty pre-seal)."""
        base = self._base
        if base is None:
            return []
        self._base = None
        grown = {k: v - base.get(k, 0)
                 for k, v in list(self._counts.items())
                 if v > base.get(k, 0)}
        for program, n in grown.items():
            # count by the DELTA; one artifact per program per watchdog
            first = program not in self.recompiles
            self.recompiles[program] = \
                self.recompiles.get(program, 0) + n
            self._counter.inc(n, engine=self.engine_id,
                              program=program)
            if first:
                self._dump_artifact(program)
        return list(grown)

    def _dump_artifact(self, program: str):
        """FlightRecorder postmortem: which program re-specialized,
        with its newest signature's arg shapes. Telemetry off =
        counters only (same gate as the engine's NaN dumps)."""
        from .registry import enabled

        if not self._dump or not enabled():
            return
        if self._recorder is None:
            from .recorder import FlightRecorder

            self._recorder = FlightRecorder(
                capacity=int(flags.flag("telemetry_flight_window")),
                dump_dir=str(flags.flag("telemetry_dump_dir")))
        self._recorder.record(
            kind="serve_recompile", program=program,
            engine=self.engine_id,
            count=int(self._counts.get(program, 0)),
            arg_shapes=dict(self._shapes.get(program) or {}))
        self._recorder.dump(
            f"post-seal recompile of serving program {program!r} "
            f"(engine {self.engine_id}) — arg shapes attached")

    # ---------------- read side ----------------
    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "sealed": self.sealed,
            "warmup_ticks": self.warmup_ticks,
            "ticks": self._ticks,
            "recompiles": {k: v for k, v
                           in list(self.recompiles.items())},
        }


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------
def _nbytes(t) -> int:
    """A tensor's bytes from its metadata (no device traffic)."""
    if t is None:
        return 0
    return int(t.nelement() * t.element_size())


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the JAX package's names."""
    return str(dtype).removeprefix("torch.")


def weight_bytes_by_dtype(*sources) -> Dict[str, int]:
    """``weights_<dtype>`` → bytes over tensor iterables (a model's
    parameters and buffers). The model is fixed after engine init, so
    the engine computes this ONCE and caches it
    (``engine._hbm_weights``)."""
    out: Dict[str, int] = {}
    for src in sources:
        for v in list(src):
            key = f"weights_{_dtype_name(v.dtype)}"
            out[key] = out.get(key, 0) + _nbytes(v)
    return out


def hbm_accounting(engine) -> Dict[str, int]:
    """Component → bytes for the device memory the engine owns, from
    tensor ``nbytes`` METADATA only (no device traffic, scrape-thread
    safe):

      * ``kv_pool`` — the KV cache payload (paged pools or contiguous
        caches; int8 quantized payloads count at their int8 width);
      * ``kv_scales`` — the int8 caches' per-row float32 dequant scales
        (0 for float caches);
      * ``weights_<dtype>`` — model parameters + buffers grouped by
        dtype (int8/int4 weights and their group scales land in their
        own rows);
      * ``prefix_store`` — the CONTIGUOUS prefix store's materialized
        blocks (the paged store refcounts pool pages and owns no extra
        bytes).
    """
    out: Dict[str, int] = {"kv_pool": 0, "kv_scales": 0,
                           "prefix_store": 0}

    def kv_leaf(x, key="kv_pool"):
        if hasattr(x, "q") and hasattr(x, "scale"):  # QuantizedKV
            out[key] += _nbytes(x.q)
            out["kv_scales" if key == "kv_pool" else key] += \
                _nbytes(x.scale)
        else:
            out[key] += _nbytes(x)

    caches = list(engine.caches or ())
    if engine.cfg.paged:
        for c in caches:
            out["kv_pool"] += _nbytes(c.k_pages) + _nbytes(c.v_pages)
            out["kv_scales"] += _nbytes(c.k_scale) + _nbytes(c.v_scale)
    else:
        for k, v in caches:
            kv_leaf(k)
            kv_leaf(v)
        store = engine._prefix
        if store is not None:
            # entries are (k, v, namespace) — the namespace is
            # bookkeeping, not device memory
            for kb, vb, *_ns in list(
                    getattr(store, "_blocks", {}).values()):
                kv_leaf(kb, "prefix_store")
                kv_leaf(vb, "prefix_store")
    static = getattr(engine, "_hbm_weights", None)
    if static is None:
        static = weight_bytes_by_dtype(engine.model.parameters(),
                                       engine.model.buffers())
    out.update(static)
    return out
