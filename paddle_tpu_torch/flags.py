"""Process-level flag registry of the PyTorch port.

Counterpart of ``paddle_tpu/flags.py``: the same ``define_flag`` /
``flag`` / ``set_flags`` surface and the same
``PT_FLAGS_<name>`` environment prefix. It holds only the flags the
serving and training slices read, under the JAX package's names and
defaults, so an environment that configures one package configures the
other alike.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def define_flag(name: str, default, help_: str = ""):
    env = os.environ.get(f"PT_FLAGS_{name}")
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = {"value": value, "default": default, "help": help_}
    return value


def set_flags(flags: Dict[str, Any]):
    """Parity: paddle.set_flags({"FLAGS_x": v})."""
    for name, value in flags.items():
        key = name.removeprefix("FLAGS_")
        if key not in _REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        _REGISTRY[key]["value"] = value


def flag(name: str):
    return _REGISTRY[name]["value"]


define_flag("benchmark", False,
            "print per-step wall timing + loss from TrainStep.run "
            "(blocks on the step's outputs each step — a debug/bench "
            "knob, not a production setting)")
define_flag("check_nan_inf", False,
            "debug-check each TrainStep's loss/grad-norm for NaN/Inf "
            "and raise FloatingPointError at the offending step "
            "(forces a per-step host sync; read at every run, since the "
            "port's step always computes the grad norm)")
define_flag("fused_decode", "auto",
            "fused single-pass decode attention (RoPE + KV append + "
            "length-pruned attention in one kernel): auto and on = the "
            "Hopper kernel for CUDA tensors, its plain version for CPU "
            "tensors; off = the unfused llama branch")
define_flag("prefill_chunk", 256,
            "serving prefill chunk length: one fixed [slots, C] chunk "
            "forward driven in a host loop, clamped to [2, max_len] (a "
            "1-token chunk would enter the decode branch). 0 selects the "
            "legacy bucketed prefill: each request prefilled alone as a "
            "[1, bucket] forward, without the prefix cache")
define_flag("prefix_cache", True,
            "serving prefix KV reuse: admission looks up the longest "
            "cached block-aligned prompt prefix and prefills only the "
            "suffix (paged mode shares pages copy-on-write; contiguous "
            "mode copies cached token blocks into the slot). off = "
            "every request recomputes its full prompt")
define_flag("spec_decode", "off",
            "speculative decoding in the serving engine: draft up to "
            "spec_k candidate tokens per slot per step (host-side n-gram "
            "prompt lookup, no draft model) and score them in one "
            "[slots, spec_k+1] target-model pass with greedy acceptance, "
            "so one weight stream buys accepted+1 tokens. ngram = draft "
            "whenever the slot's history matches; auto = ngram with a "
            "per-request throttle that stops drafting traffic that never "
            "accepts; off = one token per decode pass (greedy outputs are "
            "identical in every mode)")
define_flag("kv_cache_dtype", "auto",
            "serving KV-cache dtype when EngineConfig.cache_dtype is "
            "'auto': auto = bfloat16 on the card, float32 on the CPU; or "
            "explicit bfloat16|float16|float32|int8 (int8: per-row float32 "
            "scales beside the cache, quantize on append, dequantize in "
            "the decode kernels)")
define_flag("serve_weight_dtype", "bf16",
            "serving weight stream when EngineConfig.weight_dtype is "
            "'auto': bf16 = serve the model's own weights; int8|int4 = "
            "group-wise weight-only quantization at engine init "
            "(quantization.quantize_model_weight_only); every grouped "
            "quantized linear runs the Hopper weight-only matmul kernel "
            "on the card")
define_flag("fault_inject", "",
            "serving fault injector (chaos testing): comma-separated "
            "site:rate entries over the engine's dispatch seams — "
            "step (dispatch exception), nan (NaN-logits storm), "
            "latency (stall before dispatch), pool (simulated KV-pool "
            "exhaustion at admission) — plus seed:<int> and "
            "latency_ms:<float>, e.g. 'step:0.1,nan:0.05,seed:7'. "
            "Each site draws from its own seeded RNG stream, so chaos "
            "runs are deterministic and CPU-runnable. Empty = off "
            "(zero overhead)")
define_flag("serve_recovery", "auto",
            "step-level crash recovery in the serving engine: catch a "
            "failed decode/verify/prefill forward, quarantine the step and "
            "re-queue its in-flight requests for deterministic replay "
            "(prompt + history re-prefilled through the chunked prefill; "
            "greedy outputs stay bit-identical), with bounded per-request "
            "retries (EngineConfig.max_retries). auto = recover injected "
            "faults and the torch errors of a failed device call "
            "(torch.OutOfMemoryError, torch.AcceleratorError), propagate "
            "every other error, a kernel wrapper's plain RuntimeError "
            "included; all = recover any Exception; off = every fault "
            "propagates. A sticky CUDA error (an illegal address) leaves "
            "the context dead: its cache rebuild fails and propagates")
define_flag("degradation", True,
            "graceful-degradation ladder in the serving engine: "
            "sustained admission saturation sheds batch-class "
            "admissions then throttles admission; repeated step "
            "faults additionally disable speculative decoding and "
            "prefix-cache adoption (min_service). Surfaced through "
            "backpressure()/healthz; never changes greedy outputs. off = "
            "the controller is not constructed")
define_flag("sanitize", False,
            "serving-engine runtime invariant sanitizer "
            "(analysis/sanitizer.py): once per scheduler tick, check "
            "page/refcount conservation, slot-heap + block-table + "
            "int8-scale agreement and seq_len bounds against the host "
            "token ledger, plus thread-ownership of foreign-thread reads "
            "(only the registered copy-on-read snapshot methods may be "
            "called from another thread). Host state and tensor shapes "
            "only: no check synchronizes with the device. Violations "
            "raise SanitizerError naming the invariant and site. off = "
            "every hook is a single identity check")
define_flag("slo_degradation", False,
            "let the degradation ladder consume the SLO burn-rate alert "
            "(read-only AlertManager.is_active hook): an active "
            "slo_burn_rate counts as saturation pressure, so sustained "
            "burn climbs the capacity rungs (shed batch-class admissions, "
            "throttle) even before the queue backs up — never the fault "
            "jump. Needs timeseries and alerts on (the rule reads the "
            "series)")
define_flag("log_memory_stats", False,
            "record the card's bytes_in_use/peak_bytes_in_use "
            "(torch.cuda.memory_stats) through the telemetry registry on "
            "sampled train steps")
define_flag("io_prefetch_depth", 2,
            "host-to-device prefetch buffers (io.prefetch_to_device "
            "default queue depth)")
define_flag("telemetry", True,
            "always-on runtime telemetry (observability.MetricsRegistry); "
            "off = every instrumented path is a no-op")
define_flag("telemetry_sample_every", 10,
            "fetch loss/grad-norm/memory host-side every N train steps "
            "(non-sampled steps never force a device sync)")
define_flag("telemetry_flight_window", 64,
            "flight-recorder ring buffer size (last K step records)")
define_flag("telemetry_dump_dir", "flight_records",
            "directory for flight-recorder JSON dumps")
define_flag("telemetry_grad_spike_factor", 10.0,
            "anomaly watchdog trips when grad norm exceeds this factor "
            "times the running median")
define_flag("trace_sample", 1.0,
            "serving lifecycle tracer sample rate in (0, 1]: the "
            "fraction of requests and engine steps recorded "
            "(deterministic — every round(1/rate)-th request id / step "
            "sequence number, so a sampled request's events are "
            "complete, never a torn subset). 0 disables the tracer "
            "entirely; PT_FLAGS_telemetry=off disables it regardless")
define_flag("trace_buffer", 8192,
            "ring capacity (events) of each serving tracer — old events "
            "fall off; bounds host memory no matter how long the engine "
            "runs")
define_flag("profile_programs", False,
            "serving per-program device-time profiler "
            "(observability/profiling.py): cadence-sampled timing around "
            "every serving dispatch (prefill_chunk/prefill_bucket/"
            "decode_step/decode_chunk/spec_verify/page_copy). A sampled "
            "dispatch records two CUDA events on the engine's stream "
            "around the launch and waits for the second: MEASURED device "
            "ms into pt_serve_program_ms{engine,program} plus a "
            "schedule/dispatch/device decomposition on the tracer's step "
            "events; unsampled dispatches record no event and never "
            "synchronise. off = the engine holds no profiler, one "
            "identity check per seam")
define_flag("profile_sample_every", 16,
            "profile_programs sample cadence: measure every Nth dispatch "
            "of each program (per-program counters, deterministic). 1 = "
            "measure every dispatch, at the cost of one device sync per "
            "dispatch")
define_flag("recompile_watchdog", True,
            "runtime recompile watchdog: after recompile_warmup_ticks "
            "scheduler ticks (or an explicit engine.seal_programs()) the "
            "engine's program set is SEALED; a dispatch signature "
            "(program label, argument shapes, dtypes, static arguments) "
            "the engine has not dispatched before, seen during one of "
            "its own later ticks, counts pt_serve_recompiles_total"
            "{engine,program} and (telemetry on) dumps a FlightRecorder "
            "artifact carrying its arg shapes. One artifact per program "
            "per engine; counters keep counting. Never raises; off = no "
            "watchdog, one identity check per tick")
define_flag("recompile_warmup_ticks", 64,
            "scheduler ticks before the recompile watchdog auto-seals "
            "the program set (engine.seal_programs() seals at once)")
define_flag("timeseries", False,
            "serving flight-data recorder (observability/timeseries.py): "
            "a bounded ring of fixed-cadence windowed samples over the "
            "engine's/router's metrics — counter deltas become "
            "per-window rates, gauges are point-sampled, histogram "
            "window-percentiles ride along (telemetry on). Tick-driven "
            "and wall-clock-free in every decision, copy-on-read; read "
            "via engine.timeline_snapshot(), /timeline and `dump "
            "--timeline`. off = no store is constructed")
define_flag("timeseries_cadence", 16,
            "scheduler ticks per time-series window: every Nth tick "
            "closes a window and appends one sample")
define_flag("timeseries_retention", 256,
            "time-series ring capacity (windows): old samples fall off")
define_flag("alerts", True,
            "rule-based detectors over the serving time-series "
            "(observability/alerts.py): multi-window SLO burn-rate, "
            "queue-depth growth, prefix-hit / spec-acceptance collapse, "
            "post-seal recompiles, KV residency — each with hysteresis, "
            "firing `alert` tracer events and a FlightRecorder artifact. "
            "Evaluated only when PT_FLAGS_timeseries is on; off = no "
            "detectors constructed")
define_flag("cost_attribution", True,
            "per-request device-cost attribution: each step's measured "
            "program-ms (profiler-sampled; sync-wall estimate on "
            "unsampled steps) is split across the requests the step "
            "advanced, proportional to tokens advanced, accumulated on "
            "the request and recorded at finish into "
            "pt_serve_request_device_ms{engine,slo,tenant} and the "
            "request ledger; read via engine.cost_snapshot(). Pure host "
            "arithmetic; off = requests carry device_ms 0")
define_flag("router_breaker_window", 16,
            "multi-engine router: sliding window (fleet ticks) the "
            "per-replica circuit breaker counts faults over — "
            "router_breaker_trip faults inside it open the breaker "
            "(the replica stops receiving traffic and its in-flight "
            "requests fail over to survivors)")
define_flag("router_breaker_trip", 3,
            "multi-engine router: replica faults (failed ticks, hung "
            "health probes, flaky probe verdicts) within the breaker "
            "window that OPEN a replica's circuit breaker; a whole-"
            "replica crash opens it immediately regardless")
define_flag("router_breaker_cooldown", 8,
            "multi-engine router: base open-state duration (fleet "
            "ticks) before an open breaker admits a half-open canary "
            "probe; successive opens multiply it by the "
            "router_retry_schedule entries plus a seeded jitter "
            "(deterministic per router seed + replica)")
define_flag("router_retry_schedule", "1,2,4",
            "multi-engine router: comma-separated cooldown "
            "multipliers for successive breaker opens (the last entry "
            "repeats) — with cooldown 8 the default backs off "
            "8/16/32/32/... ticks. Deterministic: the only randomness "
            "is a per-replica jitter drawn from a stream seeded on "
            "(router seed, replica index)")
define_flag("flash_attention_block_k", 1024,
            "flash-attention k/v block length of the JAX package, clamped "
            "to the sequence (fit_block). In the port it chooses the "
            "backward pass as on the TPU: the fused pass when "
            "ceil(sk / block_k) <= 4 (one float32 dq partial per block_k "
            "kv rows), else the dq and dk/dv passes")
define_flag("moe_capacity_factor", 1.25,
            "default MoE expert capacity factor when a layer doesn't "
            "pass one explicitly (capacity = factor * tokens * top_k "
            "/ num_experts)")
define_flag("fused_group_norm", True,
            "NHWC GroupNorm(+SiLU) through the fused kernels: on = rows "
            "12/13 (the Hopper kernels for CUDA tensors, whatever the "
            "shape; their plain versions for CPU tensors within the JAX "
            "package's VMEM budget); off = the plain reference")
define_flag("default_matmul_precision", "",
            "process-wide float32 matmul precision, applied at import of "
            "paddle_tpu_torch (apply_matmul_precision re-applies it): "
            "float32|highest = exact float32 (TF32 off for matmuls and "
            "cuDNN); tensorfloat32 = TF32 tensor cores for both; bfloat16 "
            "= torch's 'medium' (bf16 passes) with cuDNN TF32; empty = "
            "torch's own defaults")
define_flag("tenant_prefix_namespace", True,
            "multi-tenant prefix-cache isolation: tenant-tagged requests "
            "hash their prompt blocks under a per-tenant namespace seed, "
            "so tenants can neither probe for nor borrow each other's "
            "cached KV, and pool-pressure eviction spends the requesting "
            "tenant's own cold entries first. Untagged requests always "
            "share the default chain. off = all tenants share one "
            "namespace")
define_flag("sched_policy", "fifo",
            "serving front door's default admission scheduler when none "
            "is passed to start_api_server: fifo = the engine's "
            "submission-order admission; slo_fair = "
            "serving_api.SLOFairScheduler (weighted fair share per tenant "
            "and TTFT urgency decide admission order, chunk split and "
            "preemption). An explicit scheduler= argument always wins")
define_flag("api_max_tenants", 256,
            "serving front door: the most DISTINCT tenant ids accepted "
            "over the server's lifetime (each mints accounting buckets "
            "and fair-share entries); past the cap a request carrying a "
            "new tenant is rejected with HTTP 429 (known tenants and "
            "untagged requests always pass; 0 rejects every tenant-tagged "
            "request)")
define_flag("sched_preempt", True,
            "let the SLO-fair scheduler preempt an active batch-class "
            "slot (release its slot and pages, re-queue it with its "
            "history for replay through the chunked prefill) when an "
            "interactive request is about to miss its TTFT target and no "
            "slot is free; bounded per request. off = admission order and "
            "quotas only")

_PRECISIONS = {"float32": "highest", "highest": "highest",
               "tensorfloat32": "high", "bfloat16": "medium"}


def apply_matmul_precision(value=None):
    """Apply ``PT_FLAGS_default_matmul_precision`` (or ``value``) to
    torch: ``torch.set_float32_matmul_precision`` and
    ``torch.backends.cudnn.allow_tf32``. ``float32``/``highest`` are
    exact float32, ``tensorfloat32`` TF32, ``bfloat16`` torch's
    ``medium``; empty leaves torch as it is. An unknown value raises the
    JAX package's ``ValueError``."""
    val = flag("default_matmul_precision") if value is None else value
    if not val:
        return
    mode = _PRECISIONS.get(str(val))
    if mode is None:
        raise ValueError(
            f"PT_FLAGS_default_matmul_precision={val!r} is not a valid "
            "matmul precision (use bfloat16|tensorfloat32|float32|highest, "
            "or empty for the default)")
    import torch

    torch.set_float32_matmul_precision(mode)
    torch.backends.cudnn.allow_tf32 = mode != "highest"
