"""Serving telemetry for the continuous-batching engine (counterpart of
``paddle_tpu/observability/serve.py``: the same series, labels and
bucket edges).

Aggregates TTFT/TPOT histograms, queue-depth and batch-occupancy
gauges, KV-pool utilization and request/token counters. The engine
calls the ``on_*`` hooks from its scheduling loop; everything here is
host-side bookkeeping over values the scheduler already holds — no
extra device traffic.

Every metric carries an ``engine`` label (a process-monotonic id), so
two engines in one process — bench sweeps, multi-model serving — keep
distinct series on the same ``/metrics`` scrape, and one engine's
``window_reset()`` cannot clobber another's peaks.

``window_reset()`` clears the raw percentile windows (histogram-side)
and peak trackers without touching the cumulative Prometheus totals,
so a benchmark sweep reads per-window percentiles from the same registry a live scrape sees.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .registry import exp_buckets, get_registry

_ENGINE_SEQ = itertools.count()


class ServingTelemetry:
    def __init__(self):
        reg = get_registry()
        self.engine_id = str(next(_ENGINE_SEQ))
        L = ("engine",)
        self._ttft = reg.histogram(
            "pt_serve_ttft_ms", "time to first token (ms)", labels=L,
            buckets=exp_buckets(1.0, 2.0, 18))
        self._tpot = reg.histogram(
            "pt_serve_tpot_ms", "time per output token (ms)", labels=L,
            buckets=exp_buckets(0.25, 2.0, 16))
        self._queue = reg.gauge(
            "pt_serve_queue_depth", "requests waiting for a slot", L)
        self._queue_peak = reg.gauge(
            "pt_serve_queue_depth_peak", "peak queue depth this window",
            L)
        self._occ = reg.gauge(
            "pt_serve_batch_occupancy", "active slots / max_slots", L)
        self._occ_peak = reg.gauge(
            "pt_serve_batch_occupancy_peak",
            "peak occupancy this window", L)
        self._kv = reg.gauge(
            "pt_serve_kv_pool_utilization",
            "KV pool occupancy (pages or cache rows in use, 0-1)", L)
        self._kv_peak = reg.gauge(
            "pt_serve_kv_pool_utilization_peak",
            "peak KV pool occupancy this window", L)
        self._kv_used = reg.gauge(
            "pt_serve_kv_pool_used", "KV pool units in use",
            ("engine", "unit"))
        self._submitted = reg.counter(
            "pt_serve_requests_submitted_total", "requests enqueued", L)
        self._admitted = reg.counter(
            "pt_serve_requests_admitted_total",
            "requests given a decode slot", L)
        self._finished = reg.counter(
            "pt_serve_requests_finished_total", "requests completed", L)
        self._tokens = reg.counter(
            "pt_serve_tokens_generated_total", "output tokens produced",
            L)
        # tenant-labeled (tenant "-" = untagged traffic): per-tenant
        # hit rates are the isolation evidence — one tenant's eviction
        # storm showing up as ANOTHER tenant's hit-rate collapse is
        # exactly what the namespace quotas exist to prevent
        LT = ("engine", "tenant")
        self._pfx_hits = reg.counter(
            "pt_serve_prefix_cache_hits_total",
            "admissions that reused a cached prompt prefix", LT)
        self._pfx_misses = reg.counter(
            "pt_serve_prefix_cache_misses_total",
            "admissions with no cached prefix", LT)
        self._pfx_hit_tokens = reg.counter(
            "pt_serve_prefix_cache_hit_tokens_total",
            "prompt tokens served from the prefix cache", LT)
        self._pfx_prompt_tokens = reg.counter(
            "pt_serve_prefix_cache_prompt_tokens_total",
            "prompt tokens submitted through prefix lookup", LT)
        self._pfx_evict = reg.counter(
            "pt_serve_prefix_cache_evictions_total",
            "prefix blocks/pages evicted (LRU)", L)
        self._pfx_cached = reg.gauge(
            "pt_serve_prefix_cached_pages",
            "prefix blocks/pages currently resident in the store", L)
        self._spec_proposed = reg.counter(
            "pt_serve_spec_proposed_tokens_total",
            "draft tokens submitted to the multi-token verify pass", L)
        self._spec_accepted = reg.counter(
            "pt_serve_spec_accepted_tokens_total",
            "draft tokens accepted by greedy verification", L)
        self._spec_verify = reg.counter(
            "pt_serve_spec_verify_calls_total",
            "batched [slots, K+1] verify dispatches", L)
        self._spec_fallback = reg.counter(
            "pt_serve_spec_fallback_steps_total",
            "spec-enabled steps where no verify pass dispatched (no "
            "slot drafted, or the chunk scheduler's drafting-share "
            "gate kept the plain chunk) — plain decode ran", L)
        self._spec_accept_hist = reg.histogram(
            "pt_serve_spec_acceptance_rate",
            "per-slot per-verify accepted/proposed fraction",
            labels=L,
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._spec_rate = reg.gauge(
            "pt_serve_spec_acceptance_rate_cum",
            "cumulative accepted/proposed draft-token ratio", L)
        self._req_tpot = reg.histogram(
            "pt_serve_request_tpot_ms",
            "per-request mean time per output token, computed at "
            "finish over the request's whole decode (admit -> last "
            "token) — the per-REQUEST latency SLOs are written "
            "against, vs pt_serve_tpot_ms's per-dispatch view",
            labels=L, buckets=exp_buckets(0.25, 2.0, 18))
        self._cancelled = reg.counter(
            "pt_serve_requests_cancelled_total",
            "requests cancelled (queued or mid-flight) — their slots "
            "and KV pages were released without finishing", L)
        self._timeouts = reg.counter(
            "pt_serve_requests_timeout_total",
            "requests expired by their deadline (queued or mid-"
            "flight) — slots, KV pages and prefix refs were released",
            L)
        self._failed = reg.counter(
            "pt_serve_requests_failed_total",
            "requests finished as failed after exhausting crash-"
            "recovery replay retries", L)
        self._recoveries = reg.counter(
            "pt_serve_recoveries_total",
            "quarantined steps: a decode/verify/prefill fault was "
            "caught, the step's device effects were discarded and the "
            "affected in-flight requests were re-queued for "
            "deterministic replay", L)
        self._retries = reg.counter(
            "pt_serve_retries_total",
            "request replay re-queues charged by quarantined steps "
            "(bounded per request by max_retries)", L)
        self._faults = reg.counter(
            "pt_serve_faults_injected_total",
            "fault-injector fires observed at the engine's dispatch "
            "seams, by site (PT_FLAGS_fault_inject)",
            ("engine", "site"))
        self._deg_level = reg.gauge(
            "pt_serve_degradation_level",
            "graceful-degradation ladder level: 0 normal, 1 shed "
            "batch-class admissions, 2 + admission throttled, 3 + "
            "spec decode and prefix-cache adoption disabled "
            "(min_service)", L)
        self._draining = reg.gauge(
            "pt_serve_draining",
            "1 while the engine drains (admission stopped, in-flight "
            "running to completion)", L)
        self._hbm = reg.gauge(
            "pt_serve_hbm_bytes",
            "live HBM residency by component, from array-metadata "
            "nbytes (kv_pool, kv_scales [int8 dequant rows], "
            "weights_<dtype>, prefix_store [contiguous materialized "
            "blocks]) — observability/profiling.hbm_accounting",
            ("engine", "component"))
        self._hbm_peak = reg.gauge(
            "pt_serve_hbm_bytes_peak",
            "high-watermark of pt_serve_hbm_bytes per component this "
            "window", ("engine", "component"))
        # component labels seen so far — window_reset must zero each
        # peak series this engine created (labels aren't enumerable
        # from the gauge side)
        self._hbm_components: set = set()
        self._preempted = reg.counter(
            "pt_serve_preemptions_total",
            "active requests preempted by the scheduler policy "
            "(slot/pages released, request re-queued at the front for "
            "deterministic prompt+history replay — the SLO-fair "
            "scheduler's anti-starvation lever)", L)
        LS = ("engine", "slo", "tenant")
        self._req_device = reg.histogram(
            "pt_serve_request_device_ms",
            "per-request ATTRIBUTED device time (ms), recorded at "
            "finish: each step's measured program-ms (ProgramProfiler "
            "sample; sync-wall estimate on unsampled steps) split "
            "across the requests the step advanced, proportional to "
            "tokens advanced — the measured per-token cost the "
            "Tensix-style bytes-per-token models are laid against. "
            "slo='untracked' for SLO-less requests; tenant='-' for "
            "untagged traffic",
            labels=LS, buckets=exp_buckets(0.05, 2.0, 22))
        # (slo, tenant) label pairs this engine recorded costs under —
        # window_reset must clear each series' percentile window
        # (labels aren't enumerable from the histogram side; the hbm
        # pattern)
        self._cost_slos: set = set()
        self._slo_met = reg.counter(
            "pt_serve_slo_met_total",
            "finished requests that met every SLO target of their "
            "class (TTFT and per-request TPOT)", LS)
        self._slo_violated = reg.counter(
            "pt_serve_slo_violated_total",
            "finished requests that missed an SLO target", LS)
        self._slo_goodput = reg.gauge(
            "pt_serve_slo_goodput",
            "met / (met + violated) for SLO-tracked finishes — the "
            "fraction of traffic the engine is serving within target",
            LS)

    def _lab(self) -> dict:
        return {"engine": self.engine_id}

    def _sum_engine(self, metric) -> float:
        """Total over this engine's series of a tenant-labeled metric
        (``series()`` copies under the registry lock — safe from any
        thread); the snapshot keeps its engine-level aggregate while
        the per-tenant series stay scrapeable."""
        i = metric.label_names.index("engine")
        return sum(v for k, v in metric.series().items()
                   if k[i] == self.engine_id)

    # ---------------- hooks ----------------
    def on_submit(self, queue_depth: int):
        self._submitted.inc(**self._lab())
        self._note_queue(queue_depth)

    def on_admit(self, ttft_ms: Optional[float]):
        lab = self._lab()
        self._admitted.inc(**lab)
        self._tokens.inc(**lab)  # prefill samples the first output token
        if ttft_ms is not None:
            self._ttft.observe(ttft_ms, **lab)

    def on_finish(self, tpot_ms: Optional[float] = None):
        lab = self._lab()
        self._finished.inc(**lab)
        if tpot_ms is not None:
            self._req_tpot.observe(tpot_ms, **lab)

    def on_cancel(self):
        self._cancelled.inc(**self._lab())

    def on_timeout(self):
        self._timeouts.inc(**self._lab())

    def on_failed(self):
        self._failed.inc(**self._lab())

    def on_recovery(self, requeued: int):
        """One quarantined step (``requeued`` requests re-queued for
        replay; per-request retries counted via ``on_retry``)."""
        self._recoveries.inc(**self._lab())

    def on_retry(self):
        self._retries.inc(**self._lab())

    def on_readmit(self):
        """A replayed request re-admitted: its re-prefill sampled one
        fresh output token (TTFT/admitted counted only at the FIRST
        admission)."""
        self._tokens.inc(**self._lab())

    def on_fault(self, site: str):
        self._faults.inc(**dict(self._lab(), site=site))

    def on_degradation(self, level: int):
        self._deg_level.set(level, **self._lab())

    def on_drain(self, active: bool):
        self._draining.set(1 if active else 0, **self._lab())

    def on_slo(self, slo: str, met: bool, tenant: str = "-"):
        """One SLO-tracked request finished: ``met`` is its
        attainment. The goodput gauge is derived from THIS series' own
        met/violated counters, so every (class, tenant) pair reports
        its own fraction — per-tenant attainment is the starvation
        evidence the SLO-fair scheduler is ranked on, and a starved
        tenant must never read the healthy tenant's blended number."""
        lab = dict(self._lab(), slo=slo, tenant=tenant)
        (self._slo_met if met else self._slo_violated).inc(**lab)
        m = self._slo_met.value(**lab)
        v = self._slo_violated.value(**lab)
        self._slo_goodput.set(m / (m + v), **lab)

    def on_preempt(self):
        self._preempted.inc(**self._lab())

    def on_prefix(self, hit_tokens: int, prompt_tokens: int,
                  cached_blocks: int, tenant: str = "-"):
        lab = self._lab()
        labt = dict(lab, tenant=tenant)
        (self._pfx_hits if hit_tokens > 0
         else self._pfx_misses).inc(**labt)
        if hit_tokens > 0:
            self._pfx_hit_tokens.inc(hit_tokens, **labt)
        self._pfx_prompt_tokens.inc(prompt_tokens, **labt)
        self._pfx_cached.set(cached_blocks, **lab)

    def on_prefix_evict(self, n: int = 1,
                        cached_blocks: Optional[int] = None):
        lab = self._lab()
        self._pfx_evict.inc(n, **lab)
        if cached_blocks is not None:
            # keep the residency gauge honest between admissions —
            # evictions under pure decode pressure must show up too
            self._pfx_cached.set(cached_blocks, **lab)

    def on_hbm(self, components: dict):
        """Refresh the HBM residency gauges + watermarks (component →
        bytes, from ``profiling.hbm_accounting``)."""
        for comp, nbytes in list(components.items()):
            lab = dict(self._lab(), component=comp)
            self._hbm.set(nbytes, **lab)
            self._hbm_peak.set_max(nbytes, **lab)
            self._hbm_components.add(comp)

    def on_request_cost(self, slo: str, device_ms: float,
                        tenant: str = "-"):
        """One finished request's attributed device cost (ms)."""
        self._req_device.observe(device_ms, slo=slo, tenant=tenant,
                                 **self._lab())
        self._cost_slos.add((slo, tenant))

    def on_spec_slot(self, proposed: int, accepted: int):
        """One slot's outcome in one verify pass — feeds the
        acceptance-rate histogram (per-slot granularity: a 100%-accept
        slot and a 0%-accept slot must not average into one bland
        mid-bucket observation)."""
        if proposed > 0:
            self._spec_accept_hist.observe(accepted / proposed,
                                           **self._lab())

    def on_spec_verify(self, proposed: int, accepted: int,
                       cum_accepted: int, cum_proposed: int):
        lab = self._lab()
        self._spec_verify.inc(**lab)
        if proposed > 0:
            self._spec_proposed.inc(proposed, **lab)
        if accepted > 0:
            self._spec_accepted.inc(accepted, **lab)
        if cum_proposed > 0:
            self._spec_rate.set(cum_accepted / cum_proposed, **lab)

    def on_spec_fallback(self):
        self._spec_fallback.inc(**self._lab())

    def on_tokens(self, n_tokens: int, wall_ms: float):
        if n_tokens <= 0:
            return
        lab = self._lab()
        self._tokens.inc(n_tokens, **lab)
        self._tpot.observe(wall_ms / n_tokens, **lab)

    def _note_queue(self, depth: int):
        lab = self._lab()
        self._queue.set(depth, **lab)
        self._queue_peak.set_max(depth, **lab)

    def on_state(self, queue_depth: int, occupancy: float,
                 kv_used: float, kv_total: float):
        lab = self._lab()
        self._note_queue(queue_depth)
        self._occ.set(occupancy, **lab)
        self._occ_peak.set_max(occupancy, **lab)
        self._kv_used.set(kv_used, unit="used", **lab)
        self._kv_used.set(kv_total, unit="total", **lab)
        util = kv_used / kv_total if kv_total else 0.0
        self._kv.set(util, **lab)
        self._kv_peak.set_max(util, **lab)

    # ---------------- read side ----------------
    def window_percentiles(self) -> dict:
        """Current histogram window-percentiles for the time-series
        collector (None entries while a window has no observations —
        the sample records the absence honestly)."""
        lab = self._lab()
        return {
            "ttft_ms_p50": self._ttft.percentile(50, **lab),
            "ttft_ms_p99": self._ttft.percentile(99, **lab),
            "tpot_ms_p50": self._tpot.percentile(50, **lab),
            "request_tpot_ms_p99": self._req_tpot.percentile(99, **lab),
        }

    def snapshot(self) -> dict:
        lab = self._lab()
        return {
            "engine": self.engine_id,
            "ttft_ms": {
                "p50": self._ttft.percentile(50, **lab),
                "p90": self._ttft.percentile(90, **lab),
                "p99": self._ttft.percentile(99, **lab),
                "count": self._ttft.window_len(**lab),
            },
            "tpot_ms": {
                "p50": self._tpot.percentile(50, **lab),
                "p90": self._tpot.percentile(90, **lab),
            },
            "request_tpot_ms": {
                "p50": self._req_tpot.percentile(50, **lab),
                "p99": self._req_tpot.percentile(99, **lab),
                "count": self._req_tpot.window_len(**lab),
            },
            "queue_depth": {
                "current": self._queue.value(**lab),
                "peak": self._queue_peak.value(**lab),
            },
            "batch_occupancy": {
                "current": self._occ.value(**lab),
                "peak": self._occ_peak.value(**lab),
            },
            "kv_pool": {
                "used": self._kv_used.value(unit="used", **lab),
                "total": self._kv_used.value(unit="total", **lab),
                "utilization": self._kv.value(**lab),
                "peak_utilization": self._kv_peak.value(**lab),
            },
            "requests": {
                "submitted": self._submitted.value(**lab),
                "admitted": self._admitted.value(**lab),
                "finished": self._finished.value(**lab),
                "cancelled": self._cancelled.value(**lab),
            },
            "tokens_generated": self._tokens.value(**lab),
            "prefix_cache": {
                "hits": self._sum_engine(self._pfx_hits),
                "misses": self._sum_engine(self._pfx_misses),
                "hit_tokens": self._sum_engine(self._pfx_hit_tokens),
                "prompt_tokens": self._sum_engine(
                    self._pfx_prompt_tokens),
                "evictions": self._pfx_evict.value(**lab),
                "cached_blocks": self._pfx_cached.value(**lab),
            },
            "spec_decode": {
                "proposed_tokens": self._spec_proposed.value(**lab),
                "accepted_tokens": self._spec_accepted.value(**lab),
                "verify_calls": self._spec_verify.value(**lab),
                "fallback_steps": self._spec_fallback.value(**lab),
                "acceptance_rate": self._spec_rate.value(**lab),
            },
            # resilience counters are NOT duplicated here: the
            # engine's metrics_snapshot() attaches its host-side
            # resilience_snapshot() (one source, telemetry-off-safe)
        }

    def window_reset(self):
        """Clear percentile windows + this engine's peaks (cumulative
        counters and the Prometheus bucket totals keep running)."""
        lab = self._lab()
        self._ttft.reset_window(**lab)
        self._tpot.reset_window(**lab)
        self._req_tpot.reset_window(**lab)
        self._spec_accept_hist.reset_window(**lab)
        for slo, tenant in list(self._cost_slos):
            self._req_device.reset_window(slo=slo, tenant=tenant,
                                          **lab)
        self._queue_peak.set(0, **lab)
        self._occ_peak.set(0.0, **lab)
        self._kv_peak.set(0.0, **lab)
        for comp in list(self._hbm_components):
            self._hbm_peak.set(0, component=comp, **lab)


_ROUTER_SEQ = itertools.count()


class RouterTelemetry:
    """Fleet front-door telemetry for the multi-engine router
    (``inference/router.py``): per-replica routing/failover counters
    and breaker-state gauges, correlated to each replica engine's own
    ``pt_serve_*`` series by the shared process registry. All hooks
    are host bookkeeping the router already holds — zero device
    traffic."""

    def __init__(self):
        reg = get_registry()
        self.router_id = str(next(_ROUTER_SEQ))
        L = ("router",)
        LR = ("router", "replica")
        self._routed = reg.counter(
            "pt_router_requests_routed_total",
            "requests placed on a replica by the front door", LR)
        self._affinity = reg.counter(
            "pt_router_affinity_routed_total",
            "placements steered by prefix affinity (the chosen "
            "replica's store already held >= 1 prompt block)", L)
        self._sheds = reg.counter(
            "pt_router_requests_held_total",
            "admissions the router held in its own queue because no "
            "replica was routable (all saturated, draining, or "
            "breaker-open) — fleet-level shedding, deferral not drop",
            L)
        self._failovers = reg.counter(
            "pt_router_failovers_total",
            "whole-replica failure events (crash, hang-opened "
            "breaker, fault-opened breaker) that triggered "
            "cross-replica failover", LR)
        self._reclaimed = reg.counter(
            "pt_router_reclaimed_requests_total",
            "in-flight + queued requests reclaimed from a failed "
            "replica's host token ledger", LR)
        self._replayed = reg.counter(
            "pt_router_replayed_requests_total",
            "reclaimed requests re-admitted onto a surviving replica "
            "for deterministic ledger replay", L)
        self._held_timeouts = reg.counter(
            "pt_router_requests_timeout_total",
            "router-held requests whose deadline expired before any "
            "replica could take them (engine-side timeouts count "
            "under pt_serve_requests_timeout_total)", L)
        self._held_cancels = reg.counter(
            "pt_router_requests_cancelled_total",
            "router-held requests cancelled before placement "
            "(engine-side cancels count under "
            "pt_serve_requests_cancelled_total)", L)
        self._breaker_opens = reg.counter(
            "pt_router_breaker_opens_total",
            "circuit-breaker open transitions per replica", LR)
        self._breaker_state = reg.gauge(
            "pt_router_breaker_state",
            "per-replica breaker state: 0 closed, 1 open, 2 half-open "
            "(canary)", LR)
        self._routable = reg.gauge(
            "pt_router_replicas_routable",
            "replicas currently accepting new traffic (breaker "
            "closed, not draining)", L)
        self._qdepth = reg.gauge(
            "pt_router_queue_depth",
            "requests held at the router awaiting a routable replica",
            L)

    def _lab(self) -> dict:
        return {"router": self.router_id}

    def on_route(self, replica: int, affinity: bool):
        self._routed.inc(router=self.router_id, replica=str(replica))
        if affinity:
            self._affinity.inc(**self._lab())

    def on_hold(self, queue_depth: int):
        self._sheds.inc(**self._lab())
        self._qdepth.set(queue_depth, **self._lab())

    def on_failover(self, replica: int, reclaimed: int):
        lab = dict(self._lab(), replica=str(replica))
        self._failovers.inc(**lab)
        if reclaimed > 0:
            self._reclaimed.inc(reclaimed, **lab)

    def on_replay(self, n: int = 1):
        self._replayed.inc(n, **self._lab())

    def on_held_timeout(self):
        self._held_timeouts.inc(**self._lab())

    def on_held_cancel(self):
        self._held_cancels.inc(**self._lab())

    def on_breaker(self, replica: int, state: int, opened: bool):
        lab = dict(self._lab(), replica=str(replica))
        self._breaker_state.set(state, **lab)
        if opened:
            self._breaker_opens.inc(**lab)

    def on_fleet_state(self, routable: int, queue_depth: int):
        lab = self._lab()
        self._routable.set(routable, **lab)
        self._qdepth.set(queue_depth, **lab)

    def _sum(self, metric) -> float:
        """Total over this router's per-replica series (``series()``
        copies under the registry lock — safe from any thread)."""
        i = metric.label_names.index("router")
        return sum(v for k, v in metric.series().items()
                   if k[i] == self.router_id)

    def snapshot(self) -> dict:
        lab = self._lab()
        return {
            "router": self.router_id,
            "routed": self._sum(self._routed),
            "affinity_routed": self._affinity.value(**lab),
            "held": self._sheds.value(**lab),
            "failovers": self._sum(self._failovers),
            "reclaimed": self._sum(self._reclaimed),
            "replayed": self._replayed.value(**lab),
            "held_timeouts": self._held_timeouts.value(**lab),
            "held_cancels": self._held_cancels.value(**lab),
            "breaker_opens": self._sum(self._breaker_opens),
            "replicas_routable": self._routable.value(**lab),
            "queue_depth": self._qdepth.value(**lab),
        }
