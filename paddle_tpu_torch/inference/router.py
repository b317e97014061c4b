"""Multi-engine front door (counterpart of
``paddle_tpu/inference/router.py``): health-routed replicated serving with
cross-replica failover by deterministic ledger replay.

An :class:`EngineRouter` owns N :class:`ContinuousBatchingEngine`
replicas in one process. They share one model (one set of weights on the
card); each owns its caches, prefix store and scheduler state. Three
mechanisms, composed:

* **Health-weighted prefix-affinity routing.** Admission hashes the
  prompt with the prefix cache's block-hash chain and probes every
  routable replica's store read-only (``engine.prefix_affinity_tokens``,
  no LRU refresh): traffic sharing a system prompt lands where its pages
  live, else on the least-loaded replica by ``backpressure()``
  (saturation, degradation rung, queue depth). When no replica is
  routable (all saturated, draining or breaker-open) the router holds the
  request in its own queue: deferral, never a drop.

* **Per-replica circuit breakers.** closed -> open on repeated faults in
  a sliding tick window (or at once on a whole-replica crash) ->
  half-open after a cooldown counted in ticks (schedule multiplier x base
  cooldown + a jitter drawn from a stream seeded on (router seed, replica
  index)) -> one canary tick -> closed on success, re-opened with the
  next backoff on failure. Open replicas get no traffic and no ticks.

* **Cross-replica failover by ledger replay.** Every token a replica
  emitted lives in the host token ledger. When a replica fails (the
  seeded ``replica_crash`` / ``replica_hang`` / ``probe_flaky`` sites at
  the router's tick seam, or a device error escaping the engine's own
  recovery), its in-flight and queued requests are reclaimed and
  re-admitted on survivors through ``request_ledger``/``admit_ledger``:
  the survivor replays prompt + history through its chunked prefill, so
  greedy tokens are unchanged and the original submit/admit instants keep
  TTFT and SLO accounting honest. A hard failure rebuilds the failed
  replica's caches so a later canary returns it to service empty.

One scheduler thread drives ``step``/``run``/``drain``; ``add_request``
is safe from producer threads (placement is serialized by an admission
lock). ``backpressure``, ``metrics_snapshot``, ``fleet_snapshot``,
``slo_snapshot`` and ``tenant_snapshot`` are copy-on-read readers
(``analysis.sanitizer.SAFE_READS``). With ``PT_FLAGS_sanitize`` the fleet
invariant (every rid owned by exactly one replica or one queue) is
checked once a tick. Observability, as in JAX: ``RouterTelemetry``'s
``pt_router_*`` series, a router tracer of route/hold/failover/breaker
events, a fleet time series (``PT_FLAGS_timeseries``), the replicas'
alerts aggregated in ``fleet_snapshot``, and ``fleet_chrome_trace``: one
merged Perfetto trace in which a failed-over rid's spans on both
replicas are joined by flow events.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import flags, observability
from .prefix_cache import block_hashes
from .resilience import (
    FaultInjector,
    InjectedFault,
    RUNTIME_ERRORS,
)
from .serving import (
    ContinuousBatchingEngine,
    EngineConfig,
    Request,
    build_request,
    new_slo_bucket,
    request_ledger,
    request_namespace,
)

# breaker states
BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2
BREAKER_NAMES = ("closed", "open", "half_open")


def _parse_schedule(spec) -> List[int]:
    """``PT_FLAGS_router_retry_schedule`` → cooldown multipliers for
    successive breaker opens (last entry repeats)."""
    if isinstance(spec, (list, tuple)):
        vals = [int(v) for v in spec]
    else:
        vals = [int(p) for p in str(spec).split(",") if p.strip()]
    if not vals or any(v < 1 for v in vals):
        raise ValueError(
            f"router retry schedule needs positive multipliers; got "
            f"{spec!r}")
    return vals


class CircuitBreaker:
    """Per-replica breaker, TICK-based for determinism (wall clocks
    would make chaos runs irreproducible).

    closed: faults accumulate in a sliding ``window``-tick log;
    ``trip`` of them open the breaker. ``trip_now`` opens it
    unconditionally (whole-replica crash). open: no traffic, no
    ticks, until ``cooldown × schedule[attempt] + jitter`` ticks pass
    (jitter drawn per-open from a stream seeded on (router seed,
    replica index) — deterministic, mutually isolated). half_open:
    the next tick is a canary probe — ``note_ok`` closes (attempt
    resets), any fault re-opens with the NEXT schedule entry.
    """

    def __init__(self, window: int, trip: int, cooldown: int,
                 schedule: Sequence[int], rng: np.random.Generator):
        for name, v in (("window", window), ("trip", trip),
                        ("cooldown", cooldown)):
            if int(v) < 1:
                raise ValueError(f"breaker {name} must be >= 1; got {v}")
        self.window = int(window)
        self.trip = int(trip)
        self.cooldown = int(cooldown)
        self.schedule = _parse_schedule(schedule)
        self._rng = rng
        self._state = BREAKER_CLOSED
        self._faults: List[int] = []  # tick stamps, window-trimmed
        self._attempt = 0  # consecutive opens (schedule index)
        self.opens = 0  # cumulative (stats)
        self.reopen_at = 0

    # ---------------- views ----------------
    def state(self, tick: int) -> int:
        """Read-only state at ``tick`` (an open breaker READS as
        half-open once its cooldown passed; the transition COMMITS in
        ``advance`` on the scheduler thread — producer-thread routing
        peeks must never mutate)."""
        if self._state == BREAKER_OPEN and tick >= self.reopen_at:
            return BREAKER_HALF_OPEN
        return self._state

    @property
    def name(self) -> str:
        return BREAKER_NAMES[self._state]

    # ---------------- transitions (scheduler thread only) ----------
    def advance(self, tick: int) -> int:
        """Commit the open→half_open transition; returns the state."""
        if self._state == BREAKER_OPEN and tick >= self.reopen_at:
            self._state = BREAKER_HALF_OPEN
        return self._state

    def _open(self, tick: int):
        mult = self.schedule[min(self._attempt, len(self.schedule) - 1)]
        jitter = int(self._rng.integers(0, max(self.cooldown // 2, 1)))
        self.reopen_at = tick + self.cooldown * mult + jitter
        self._state = BREAKER_OPEN
        self._attempt += 1
        self.opens += 1
        self._faults.clear()

    def note_fault(self, tick: int) -> bool:
        """Record one replica fault at ``tick``; True when THIS fault
        opened the breaker (closed with a full window, or a failed
        half-open canary)."""
        if self._state == BREAKER_OPEN:
            return False
        if self._state == BREAKER_HALF_OPEN:
            self._open(tick)  # canary failed: next backoff rung
            return True
        self._faults.append(tick)
        horizon = tick - self.window
        while self._faults and self._faults[0] <= horizon:
            del self._faults[0]
        if len(self._faults) >= self.trip:
            self._open(tick)
            return True
        return False

    def trip_now(self, tick: int) -> bool:
        """Unconditional open (whole-replica crash); True if it was
        not already open."""
        if self._state == BREAKER_OPEN:
            return False
        self._open(tick)
        return True

    def note_ok(self, tick: int):
        """A clean tick: a half-open canary success CLOSES the breaker
        (backoff schedule resets — the replica earned a fresh start);
        closed-state successes just age the fault window."""
        del tick
        if self._state == BREAKER_HALF_OPEN:
            self._state = BREAKER_CLOSED
            self._attempt = 0
            self._faults.clear()

    def snapshot(self, tick: Optional[int] = None) -> dict:
        """Pass the fleet ``tick`` to report the tick-EFFECTIVE state
        (an open breaker past its cooldown reads half-open, matching
        ``backpressure()``'s routing verdict); without it the raw
        committed state could contradict the ``state(tick)`` view in
        the same /healthz document."""
        st = self._state if tick is None else self.state(tick)
        return {
            "state": st,
            "name": BREAKER_NAMES[st],
            "opens": self.opens,
            "attempt": self._attempt,
            "reopen_at": self.reopen_at,
            "window_faults": len(list(self._faults)),
        }


class _Replica:
    """One replica's router-side bookkeeping (the engine itself stays
    oblivious to the fleet)."""

    __slots__ = ("idx", "engine", "breaker", "hung_until", "failovers")

    def __init__(self, idx: int, engine: ContinuousBatchingEngine,
                 breaker: CircuitBreaker):
        self.idx = idx
        self.engine = engine
        self.breaker = breaker
        self.hung_until = 0  # fleet tick a simulated hang ends at
        self.failovers = 0


class EngineRouter:
    """Fleet front door over N continuous-batching replicas.

    ``model`` is shared by every replica (one set of weights on the
    card; each replica owns its caches, prefix store and scheduler
    state; with int8/int4 ``weight_dtype`` each replica quantizes its own
    copy, as the JAX replicas do). ``config`` applies to all replicas: the fleet is
    homogeneous, which makes failover's ledger replay
    placement-invariant. ``device`` (default the card) is passed to
    every replica. ``fault_injector`` (default: built from
    ``PT_FLAGS_fault_inject``) drives the router's chaos sites
    ``replica_crash`` / ``replica_hang`` / ``probe_flaky``; engine-level
    sites fire inside each replica's own injector (built from the
    flag).
    """

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 n_replicas: int = 2, *, device="cuda", drafter=None,
                 fault_injector: Optional[FaultInjector] = None,
                 seed: int = 0,
                 breaker_window: Optional[int] = None,
                 breaker_trip: Optional[int] = None,
                 breaker_cooldown: Optional[int] = None,
                 retry_schedule=None,
                 hang_ticks: int = 4):
        if n_replicas < 1:
            raise ValueError(
                f"n_replicas must be >= 1; got {n_replicas}")
        if hang_ticks < 1:
            raise ValueError(
                f"hang_ticks must be >= 1; got {hang_ticks}")
        cfg = config or EngineConfig()
        self.cfg = cfg
        self._hang_ticks = int(hang_ticks)
        window = int(breaker_window
                     if breaker_window is not None
                     else flags.flag("router_breaker_window"))
        trip = int(breaker_trip if breaker_trip is not None
                   else flags.flag("router_breaker_trip"))
        cooldown = int(breaker_cooldown
                       if breaker_cooldown is not None
                       else flags.flag("router_breaker_cooldown"))
        schedule = _parse_schedule(
            retry_schedule if retry_schedule is not None
            else flags.flag("router_retry_schedule"))
        for name, v in (("window", window), ("trip", trip),
                        ("cooldown", cooldown)):
            if int(v) < 1:
                # validate BEFORE any replica builds its device caches
                raise ValueError(f"breaker {name} must be >= 1; got {v}")
        self._replicas: List[_Replica] = []
        for i in range(n_replicas):
            eng = ContinuousBatchingEngine(model, cfg, device=device,
                                           drafter=drafter)
            br = CircuitBreaker(
                window, trip, cooldown, schedule,
                np.random.default_rng((0xB4EA, int(seed), i)))
            self._replicas.append(_Replica(i, eng, br))
        self._injector = (fault_injector if fault_injector is not None
                          else FaultInjector.from_flag())
        self._tick = 0
        # fleet-unique rid mint: next() on a C-level count iterator is
        # atomic under the GIL, so concurrent producer-thread
        # add_request calls can never mint the same rid (a plain
        # int += 1 read-modify-write could)
        self._rid_counter = itertools.count()
        # fleet-level admission queue: requests held while no replica
        # is routable (all saturated / draining / breaker-open) —
        # "one queue" in the sanitizer's rid-ownership invariant
        self._queue: collections.deque = collections.deque()
        # serializes placement (submit-to-replica + owner-map write)
        # across producer-thread add_request, the scheduler's
        # held-queue re-place, and failover's reclaim-and-re-place:
        # without it a producer preempted between submit and the owner
        # write could re-point a rid at a replica that just died (the
        # failover already moved it), or a fresh arrival could steal a
        # slot from an older held request mid-pop
        self._admit_lock = threading.Lock()
        # rid -> replica idx CURRENTLY responsible (live or finished
        # there); router-queued rids are absent by design
        self._owner: Dict[int, int] = {}
        # router-local terminal records (cancelled / expired while
        # held — they never reached an engine)
        self._finished: Dict[int, Request] = {}
        # SLO attainment for those router-local terminals (engine
        # timeouts/cancels account on their engine; a held request
        # that expires must not vanish from fleet goodput) — same
        # bucket shape as the engine's slo_stats, merged by
        # slo_snapshot()
        self.slo_stats: Dict[str, Dict[str, int]] = {}
        self._draining = False
        # host counters (available with telemetry off, like the
        # engine's prefix/spec/slo/resilience stats)
        self.fleet_stats = {
            "routed": 0, "affinity_routed": 0, "held": 0,
            "failovers": 0, "reclaimed": 0, "replayed": 0,
            "cancelled": 0, "timeouts": 0, "breaker_opens": 0,
        }
        self._tel = (observability.RouterTelemetry()
                     if observability.enabled() else None)
        self._tracer = None
        if self._tel is not None \
                and float(flags.flag("trace_sample")) > 0:
            self._tracer = observability.Tracer(
                engine_id=f"router{self._tel.router_id}")
        # the fleet's own windowed history of its counters, beside each
        # replica engine's store
        self._ts = None
        if bool(flags.flag("timeseries")):
            label = (f"router{self._tel.router_id}"
                     if self._tel is not None else None)
            self._ts = observability.TimeSeriesStore(label=label)
        self._san = None
        if bool(flags.flag("sanitize")):
            from ..analysis.sanitizer import EngineSanitizer

            self._san = EngineSanitizer(self)
        # process-wide fleet registry (weak): `dump --fleet` and the
        # merged-trace export find this router without a handle
        observability.tracing.register_fleet(self)

    # ---------------- admission / routing ----------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    **kwargs) -> int:
        """Validate (the engine's exact ``add_request`` checks, via
        the shared ``build_request``), assign a FLEET-unique rid, and
        place on the best replica — prefix affinity first, least
        loaded second — or hold at the router when none is routable.
        Accepts every ``ContinuousBatchingEngine.add_request`` keyword
        (sampling params, SLO class/targets, deadline, max_retries)."""
        req = build_request(
            next(self._rid_counter), prompt, max_new_tokens,
            eos_token_id, max_len=self.cfg.max_len, **kwargs)
        self._submit(req)
        return req.rid

    def _affinity_hashes(self, req: Request) -> List[bytes]:
        """Block-hash chain over the request's prefill ids, cached on
        the Request like the engine's own pool-block re-match cache —
        a router-held request is re-placed every fleet tick and must
        not re-hash each time (``_bump_retry`` already resets the
        cache when replay grows the ids)."""
        if req._hashes is None:
            ids = (np.concatenate([req.prompt,
                                   np.asarray(req.output, np.int64)])
                   if req.output else req.prompt)
            # the TENANT-aware chain (request_namespace): affinity must
            # hash exactly like the target engine's admission match,
            # or it would steer traffic at pages the replica can never
            # share across the namespace boundary
            req._hashes = block_hashes(
                ids, self.cfg.page_size,
                namespace=request_namespace(req))
        return req._hashes

    def _routable(self, rep: _Replica, bp: dict) -> bool:
        return (rep.breaker.state(self._tick) == BREAKER_CLOSED
                and self._tick >= rep.hung_until
                and not bp["draining"])

    def _pick(self, hashes: List[bytes]):
        """Best replica for this request, or ``(None, 0)`` when the
        fleet must hold it. Ranking (min): saturation first (a replica
        with room always beats one shedding), then PREFIX AFFINITY
        (tokens already resident — the block-hash chain routes shared-
        prefix traffic at its pages), then the degradation rung, then
        load (queue + active slots), then index for determinism. A
        failed replica needs no explicit exclusion: its breaker is
        open by the time failover re-submits, so ``_routable`` already
        filters it."""
        best = None
        best_key = None
        best_aff = 0
        for rep in self._replicas:
            bp = rep.engine.backpressure()
            if not self._routable(rep, bp):
                continue
            aff = rep.engine.prefix_affinity_tokens(hashes)
            load = bp["queue_depth"] \
                + bp["occupancy"] * rep.engine.cfg.max_slots
            key = (bool(bp["saturated"]), -aff,
                   bp["degradation_level"], load, rep.idx)
            if best_key is None or key < best_key:
                best, best_key, best_aff = rep, key, aff
        if best is not None and best_key[0]:
            # every routable replica is saturated: fleet-level shed —
            # hold at the router (composes with the replicas' own
            # shed_batch/throttle rungs instead of deepening their
            # queues), re-attempted each tick as finishers free slots
            return None, 0
        return best, best_aff

    def _place(self, req: Request) -> bool:
        """Route one request onto a replica; False when none is
        routable (caller holds it)."""
        hashes = self._affinity_hashes(req)
        rep, aff = self._pick(hashes)
        if rep is None:
            return False
        if req.output or req._retries:
            # a replay/handoff carries history: the target rebuilds it
            # from the token ledger (original instants preserved,
            # prompt+history re-prefilled) — the cross-engine move
            # contract
            rep.engine.admit_ledger(request_ledger(req))
        else:
            # first placement: this Request was built fleet-validated
            # with a fleet-unique rid — hand the object over directly,
            # no serialize/re-validate/duplicate-rid-scan round trip
            rep.engine.submit_request(req)
        self._owner[req.rid] = rep.idx
        self.fleet_stats["routed"] += 1
        if aff > 0:
            self.fleet_stats["affinity_routed"] += 1
        if self._tel is not None:
            self._tel.on_route(rep.idx, aff > 0)
        if self._tracer is not None:
            self._tracer.engine_event(
                "route", rid=int(req.rid), replica=rep.idx,
                affinity_tokens=int(aff), replayed_tokens=len(req.output))
        return True

    def _submit(self, req: Request) -> bool:
        # FIFO fairness: while OLDER requests sit held, a fresh
        # arrival must not steal capacity a finisher just freed —
        # it queues behind them and _place_queued places in order.
        # The lock covers _place_queued's pop window too: a held
        # request is OUTSIDE the queue while being placed, so the
        # emptiness check alone could let a fresh arrival jump it.
        with self._admit_lock:
            if not self._queue and self._place(req):
                return True
            self._queue.append(req)
            self._note_hold(req)
        return False

    def _note_hold(self, req: Request):
        self.fleet_stats["held"] += 1
        if self._tel is not None:
            self._tel.on_hold(len(self._queue))
        if self._tracer is not None:
            self._tracer.engine_event("hold", rid=int(req.rid),
                                      queued=len(self._queue))

    def _place_queued(self):
        """FIFO re-attempt for router-held requests (head-of-line: a
        request that still can't place keeps everything behind it,
        preserving submission order like the engines' own queues).
        Pop-BEFORE-place, like the engine's own claim loop: placing
        first would leave a window where a producer-thread ``cancel``
        still finds the request in this queue and marks it terminal
        while a replica decodes it — the dual ownership the fleet
        sanitizer forbids. While popped, a racing cancel simply
        returns False for one call (the same transient the engine's
        admission claim window has)."""
        while True:
            with self._admit_lock:
                try:
                    req = self._queue.popleft()
                except IndexError:
                    break  # a racing cancel/expiry emptied the queue
                if not self._place(req):
                    self._queue.appendleft(req)
                    break

    def _slo_bucket(self, slo: str) -> Dict[str, int]:
        st = self.slo_stats.get(slo)
        if st is None:
            st = self.slo_stats[slo] = new_slo_bucket()
        return st

    def _expire_queue(self):
        """Deadline expiry for router-held requests — the fleet-level
        twin of the engines' per-tick ``_expire_deadlines``. An
        SLO-tracked request that expired while HELD is a real
        violation: it counts against fleet goodput exactly like an
        engine-side timeout would (the goodput-inflation dishonesty
        the engine's accounting exists to prevent).

        Runs under the admission lock: expiry moves a rid from the
        queue to the finish registry and bumps shared counters — the
        same mutation set producer-thread ``cancel`` makes under the
        lock; interleaving them could double-remove a request or
        lose stats updates."""
        now = time.perf_counter()
        with self._admit_lock:
            for req in list(self._queue):
                if req._deadline_t and now >= req._deadline_t:
                    self._queue.remove(req)
                    req.done = True
                    req.finish_reason = "timeout"
                    self._finished[req.rid] = req
                    self.fleet_stats["timeouts"] += 1
                    if req.slo is not None:
                        req.slo_met = False
                        st = self._slo_bucket(req.slo)
                        st["violated"] += 1
                        st["timeouts"] += 1
                    if self._tel is not None:
                        self._tel.on_held_timeout()
                    if self._tracer is not None:
                        self._tracer.engine_event(
                            "held_timeout", rid=int(req.rid),
                            queued=len(self._queue))

    # ---------------- fleet tick ----------------
    def step(self, max_chunk: int = 8) -> bool:
        """One FLEET tick: expire/place held requests, then tick every
        replica through its breaker + chaos seams. Returns False when
        no work remains anywhere."""
        san = self._san
        if san is not None:
            san.note_tick("router_step")
        self._tick += 1
        self._expire_queue()
        self._place_queued()
        for rep in self._replicas:
            self._tick_replica(rep, max_chunk)
        if self._tel is not None:
            # the routability verdict _pick and backpressure() use
            routable = sum(
                1 for r in self._replicas
                if self._routable(r, r.engine.backpressure()))
            self._tel.on_fleet_state(routable, len(self._queue))
        if self._ts is not None:
            self._ts.on_tick(self._flight_collect)
        if san is not None:
            # under the admission lock: placement writes queue + owner
            # map as one atomic unit, so an unlocked read could catch a
            # producer thread mid-_place and report phantom dual
            # ownership
            with self._admit_lock:
                san.check_fleet(self, "router_step")
        return bool(self._queue) or any(
            self._has_work(r) for r in self._replicas)

    @staticmethod
    def _has_work(rep: _Replica) -> bool:
        return bool(rep.engine.active.any()) or bool(rep.engine._queue)

    def _recoverable(self, exc: BaseException) -> bool:
        """Router-level recovery policy: injected faults and failed
        device calls (``RUNTIME_ERRORS``) that ESCAPED the engine's own
        recovery become whole-replica faults; host logic errors, a
        kernel wrapper's plain ``RuntimeError`` among them, always
        propagate."""
        if isinstance(exc, InjectedFault):
            return True
        return isinstance(exc, RUNTIME_ERRORS)

    def _tick_replica(self, rep: _Replica, max_chunk: int):
        br = rep.breaker
        was_open = br._state == BREAKER_OPEN
        st = br.advance(self._tick)
        if st == BREAKER_OPEN:
            return
        if was_open and st == BREAKER_HALF_OPEN:
            # the open -> half-open commit is a reportable transition
            self._note_breaker(rep, opened=False)
            if self._tracer is not None:
                self._tracer.engine_event("breaker_half_open",
                                          replica=rep.idx, tick=self._tick)
        inj = self._injector
        if inj is not None and inj.fire("replica_crash"):
            # whole-replica death: breaker opens immediately, the host
            # ledger is the ONLY survivor — reclaim + replay elsewhere,
            # rebuild the caches so a later canary returns it empty
            if br.trip_now(self._tick):
                self._note_breaker(rep, opened=True)
            self._reclaim(rep, hard=True, site="replica_crash")
            return
        if inj is not None and inj.fire("replica_hang"):
            rep.hung_until = self._tick + self._hang_ticks
        if self._tick < rep.hung_until:
            # stalled replica: a tick with pending work is a failed
            # health probe (no-progress); enough of them in the window
            # open the breaker and fail its work over
            if self._has_work(rep) and br.note_fault(self._tick):
                self._note_breaker(rep, opened=True)
                self._reclaim(rep, hard=False, site="replica_hang")
            return
        if inj is not None and inj.fire("probe_flaky"):
            # one flaky health-probe verdict: a FAULT in the window,
            # never an immediate failover — the breaker's trip
            # threshold is exactly the flap damping. The probe is
            # control-plane only: unless the breaker opens, the
            # replica keeps serving this tick (data plane unaffected)
            if br.note_fault(self._tick):
                self._note_breaker(rep, opened=True)
                self._reclaim(rep, hard=False, site="probe_flaky")
                return
        try:
            rep.engine.step_chunk(max_chunk)
        except BaseException as e:  # noqa: BLE001
            if not self._recoverable(e):
                raise
            if not isinstance(e, InjectedFault):
                # a REAL device error that escaped the engine's own
                # recovery (serve_recovery=off, or beyond its scope)
                # leaves the replica's caches untrusted NOW, not after
                # `trip` more faults: immediate open + reclaim +
                # rebuild, the engine's hard-recovery contract at fleet
                # level. The traceback's frames hold the old caches:
                # clear them so the rebuild never holds two sets
                traceback.clear_frames(e.__traceback__)
                if br.trip_now(self._tick):
                    self._note_breaker(rep, opened=True)
                self._reclaim(rep, hard=True, site=type(e).__name__)
                return
            # an escaped INJECTED fault fired pre-dispatch (caches
            # intact): a windowed replica fault, like a flaky probe
            if br.note_fault(self._tick):
                self._note_breaker(rep, opened=True)
                self._reclaim(rep, hard=False, site=type(e).__name__)
            return
        if st == BREAKER_HALF_OPEN:
            # canary passed: back in rotation
            br.note_ok(self._tick)
            self._note_breaker(rep, opened=False)
            if self._tracer is not None:
                self._tracer.engine_event("breaker_close", replica=rep.idx,
                                          tick=self._tick)

    def _note_breaker(self, rep: _Replica, opened: bool):
        if opened:
            self.fleet_stats["breaker_opens"] += 1
        if self._tel is not None:
            self._tel.on_breaker(rep.idx, rep.breaker._state, opened)
        if opened and self._tracer is not None:
            self._tracer.engine_event("breaker_open", replica=rep.idx,
                                      tick=self._tick,
                                      reopen_at=rep.breaker.reopen_at)

    # ---------------- failover ----------------
    def _reclaim(self, rep: _Replica, hard: bool, site: str):
        """THE failover: pull every in-flight and queued request off a
        failed replica via the host token ledger and re-admit each on
        a survivor for deterministic replay. Expired requests time out
        (never replayed — their budget is spent), each survivor is
        charged one replay retry (the engine's bound: past it, reason
        ``"failed"``), and ``hard`` failures rebuild the replica's
        caches (untrusted device state; same shapes).

        Runs under the admission lock (same wrapper idiom as the
        engine's sanitized ``step``/``_step_impl``): a producer-thread
        placement completes or waits — it can never interleave with
        the drain-and-re-place, so no request lands on the dead
        replica after the drain and no owner-map write goes stale."""
        with self._admit_lock:
            self._reclaim_impl(rep, hard, site)

    def _reclaim_impl(self, rep: _Replica, hard: bool, site: str):
        eng = rep.engine
        now = time.perf_counter()
        victims: List[Request] = []
        for slot in range(eng.cfg.max_slots):
            if eng.active[slot]:
                req = eng._slot_req[slot]
                eng._release_slot(slot)
                victims.append(req)
        while eng._queue:
            victims.append(eng._queue.popleft())
        if hard:
            eng.resilience_stats["rebuilds"] += 1
            eng._rebuild_caches()
        replayed = 0
        unplaced: List[Request] = []
        for req in victims:
            req.slot = None
            if req._deadline_t and now >= req._deadline_t:
                # a deadline that expired in flight must not buy a
                # fresh run on another replica — finish it here, with
                # the failed replica keeping the accounting
                eng.resilience_stats["timeouts"] += 1
                eng._finish(req, "timeout")
                continue
            if not eng._bump_retry(req):
                continue  # retries exhausted: finished "failed" here
            self._owner.pop(req.rid, None)
            if self._place(req):
                replayed += 1
                if self._tel is not None:
                    self._tel.on_replay()
            else:
                unplaced.append(req)
        if unplaced:
            # victims are the OLDEST traffic: they hold at the queue
            # FRONT, ahead of younger arrivals (the engine's own
            # quarantine-requeue order), original order preserved
            self._queue.extendleft(reversed(unplaced))
            for req in unplaced:
                self._note_hold(req)
        if not victims:
            # a re-open with nothing to move (e.g. a flaky canary on
            # a replica its original failover already emptied) is a
            # breaker event, not a failover — counting it would let a
            # vacuous re-open satisfy "failovers >= 1" determinism
            # checks without a single request ever moving
            return
        rep.failovers += 1
        self.fleet_stats["failovers"] += 1
        self.fleet_stats["reclaimed"] += len(victims)
        self.fleet_stats["replayed"] += replayed
        if self._tel is not None:
            self._tel.on_failover(rep.idx, len(victims))
        if self._tracer is not None:
            self._tracer.engine_event(
                "failover", replica=rep.idx, site=site, hard=hard,
                reclaimed=len(victims), replayed=replayed)

    # ---------------- request lifecycle ----------------
    def cancel(self, rid: int) -> bool:
        """Cancel anywhere in the fleet: router-held requests leave
        the hold queue; placed ones cancel on their owner replica
        (slot/pages/prefix refs released there). A cancelled rid can
        never be replayed by a later failover — it is in a terminal
        registry, not a queue or slot.

        Thread contract: the router-held path is producer-safe — it
        runs under the admission lock, so it cannot interleave with
        placement, expiry, or a sanitized step()'s fleet snapshot
        (which holds the same lock), and concurrent cancels cannot
        lose ``fleet_stats`` updates; the PLACED path delegates to
        ``engine.cancel``, which frees slots and pages and so must
        run on the scheduler thread — same contract as the engine
        documents."""
        with self._admit_lock:
            req = next((r for r in self._queue if r.rid == rid), None)
            if req is not None:
                self._queue.remove(req)
                req.done = True
                req.cancelled = True
                req.finish_reason = "cancel"
                self._finished[rid] = req
                self.fleet_stats["cancelled"] += 1
                if req.slo is not None:
                    # cancelled, never a violation — same split the
                    # engine's accounting makes
                    self._slo_bucket(req.slo)["cancelled"] += 1
                if self._tel is not None:
                    self._tel.on_held_cancel()
                if self._tracer is not None:
                    self._tracer.engine_event("held_cancel",
                                              rid=int(req.rid),
                                              queued=len(self._queue))
                return True
        ridx = self._owner.get(rid)
        if ridx is None:
            return False
        return self._replicas[ridx].engine.cancel(rid)

    def result(self, rid: int) -> Optional[Request]:
        """The finished :class:`Request` for ``rid`` (None while in
        flight): router-local terminals first, then the owner
        replica's finish registry."""
        req = self._finished.get(rid)
        if req is not None:
            return req
        ridx = self._owner.get(rid)
        if ridx is None:
            return None
        return self._replicas[ridx].engine._finished.get(rid)

    def run(self, prompts: Sequence, max_new_tokens: int = 32,
            eos_token_id: Optional[int] = None,
            max_chunk: int = 8) -> List[Request]:
        """Submit all prompts and drive the fleet to completion;
        returns finished Requests in submission order."""
        rids = [self.add_request(p, max_new_tokens, eos_token_id)
                for p in prompts]
        while self.step(max_chunk):
            pass
        out = []
        for rid in rids:
            req = self.result(rid)
            if req is not None:
                out.append(req)
        return out

    # ---------------- drain / resume ----------------
    def drain(self, deadline_ms: Optional[float] = None,
              max_chunk: int = 8) -> dict:
        """Fleet drain: every replica drains (sharing one absolute
        deadline), and the aggregate ``"unfinished"`` handoff payload
        carries each replica's leftover ledgers PLUS the router-held
        requests — everything a successor fleet would need to
        ``admit_ledger`` and continue bit-identically."""
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0; got {deadline_ms}")
        self._draining = True
        t_end = (None if deadline_ms is None
                 else time.perf_counter() + deadline_ms / 1e3)
        unfinished: List[dict] = []
        per_replica = []
        expired = 0
        for rep in self._replicas:
            remaining = None
            if t_end is not None:
                remaining = max((t_end - time.perf_counter()) * 1e3,
                                1.0)
            s = rep.engine.drain(deadline_ms=remaining,
                                 max_chunk=max_chunk)
            expired += s["expired"]
            unfinished.extend(s["unfinished"])
            per_replica.append({"replica": rep.idx,
                                "expired": s["expired"],
                                "queued": s["queued"]})
        unfinished.extend(request_ledger(r) for r in list(self._queue))
        if self._tracer is not None:
            self._tracer.engine_event("fleet_drain", expired=expired,
                                      unfinished=len(unfinished))
        return {"drained": True, "expired": expired,
                "queued": len(self._queue),
                "replicas": per_replica,
                "unfinished": unfinished}

    def resume(self):
        self._draining = False
        for rep in self._replicas:
            rep.engine.resume()

    # ---------------- scrape readers (copy-on-read) ----------------
    def backpressure(self) -> dict:
        """Fleet-aggregate admission readiness, shaped like the
        engine's: ``saturated`` only when NO replica can take traffic
        (the healthz 503 condition for the front door), the WORST
        degradation rung, plus a per-replica breakdown a dashboard or
        an outer load balancer can steer on."""
        if self._san is not None:
            self._san.check_read("backpressure")
        reps = []
        total_q = len(self._queue)
        free = 0
        routable = 0
        unsaturated = 0
        active = 0.0
        slots = 0.0
        level = 0
        degraded = False
        for rep in list(self._replicas):
            bp = rep.engine.backpressure()
            rt = self._routable(rep, bp)
            if rt:
                routable += 1
                free += bp["free_slots"]
                if not bp["saturated"]:
                    unsaturated += 1
            total_q += bp["queue_depth"]
            n = rep.engine.cfg.max_slots
            active += bp["occupancy"] * n
            slots += n
            level = max(level, bp["degradation_level"])
            degraded = degraded or bp["degraded"]
            reps.append({
                "replica": rep.idx,
                "breaker": BREAKER_NAMES[
                    rep.breaker.state(self._tick)],
                "routable": rt,
                "saturated": bp["saturated"],
                "queue_depth": bp["queue_depth"],
                "free_slots": bp["free_slots"],
                "degradation_level": bp["degradation_level"],
                "draining": bp["draining"],
            })
        return {
            "queue_depth": total_q,
            "free_slots": free,
            "occupancy": active / slots if slots else 0.0,
            "saturated": unsaturated == 0,
            "draining": self._draining,
            "degraded": degraded,
            "degradation_level": level,
            "routable_replicas": routable,
            "replicas": reps,
        }

    def _flight_collect(self) -> dict:
        """Fleet counters + gauges for one router time-series window
        (scheduler-thread only; the replicas keep their own engine-
        labeled stores)."""
        counters = {k: float(v)
                    for k, v in list(self.fleet_stats.items())}
        routable = sum(
            1 for rep in self._replicas
            if self._routable(rep, rep.engine.backpressure()))
        gauges = {
            "queue_depth": float(len(self._queue)),
            "routable_replicas": float(routable),
            "n_replicas": float(len(self._replicas)),
        }
        return {"counters": counters, "gauges": gauges,
                "percentiles": {}}

    def timeline_snapshot(self) -> dict:
        """The fleet time series: the router's own windowed history of
        its fleet counters plus every replica engine's timeline
        (``{"enabled": False}`` with ``PT_FLAGS_timeseries`` off).
        Copy-on-read; served at ``/timeline``."""
        if self._san is not None:
            self._san.check_read("timeline_snapshot")
        if self._ts is None:
            return {"enabled": False}
        return {"enabled": True, "router": self._ts.snapshot(),
                "replicas": [rep.engine.timeline_snapshot()
                             for rep in list(self._replicas)]}

    def fleet_snapshot(self) -> dict:
        """Host-side router counters + breaker states (available with
        telemetry off, like every engine snapshot). ``alerts`` aggregates
        every replica's alert-rule state: which replica is burning its
        SLO budget."""
        if self._san is not None:
            self._san.check_read("fleet_snapshot")
        st = {k: v for k, v in list(self.fleet_stats.items())}
        st["tick"] = self._tick
        st["n_replicas"] = len(self._replicas)
        st["queue_depth"] = len(self._queue)
        st["draining"] = self._draining
        st["breakers"] = [
            dict(rep.breaker.snapshot(self._tick), replica=rep.idx,
                 failovers=rep.failovers)
            for rep in list(self._replicas)]
        st["injector"] = (self._injector.snapshot()
                          if self._injector is not None
                          else {"enabled": False})
        alerts = {"enabled": False, "fired": 0, "active": []}
        for rep in list(self._replicas):
            asn = rep.engine.alerts_snapshot()
            if not asn.get("enabled"):
                continue
            alerts["enabled"] = True
            alerts["fired"] += asn["fired_total"]
            for rule in list(asn["active"]):
                alerts["active"].append({"replica": rep.idx, "rule": rule})
        st["alerts"] = alerts
        return st

    def slo_snapshot(self) -> dict:
        """FLEET-level SLO attainment: every replica's per-class
        counters merged with the router's own terminal records (held
        requests that expired or were cancelled before placement) —
        the goodput a single replica's snapshot cannot see. Same
        shape as ``engine.slo_snapshot()``."""
        if self._san is not None:
            self._san.check_read("slo_snapshot")
        classes: Dict[str, Dict[str, float]] = {}

        def merge(cls, st):
            agg = classes.setdefault(cls, {})
            for k, v in list(st.items()):
                if k == "goodput" or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v

        for rep in list(self._replicas):
            for cls, st in list(
                    rep.engine.slo_snapshot()["classes"].items()):
                merge(cls, st)
        for cls, st in list(self.slo_stats.items()):
            merge(cls, st)
        met = violated = 0
        for st in classes.values():
            tracked = st.get("met", 0) + st.get("violated", 0)
            st["goodput"] = st["met"] / tracked if tracked else None
            met += st.get("met", 0)
            violated += st.get("violated", 0)
        tracked = met + violated
        return {"classes": classes, "met": met, "violated": violated,
                "goodput": met / tracked if tracked else None}

    def tenant_snapshot(self) -> dict:
        """FLEET-level per-tenant accounting: every replica's
        ``tenant_snapshot`` merged key-by-key (counts sum; the
        scheduler sub-doc reports each replica's policy). Same
        copy-on-read contract as the engine reader."""
        if self._san is not None:
            self._san.check_read("tenant_snapshot")
        tenants: Dict[str, Dict[str, float]] = {}
        preemptions = 0
        policies = []
        for rep in list(self._replicas):
            snap = rep.engine.tenant_snapshot()
            sched = snap.get("scheduler") or {}
            policies.append(sched.get("policy"))
            preemptions += int(sched.get("preemptions", 0) or 0)
            for key, st in list(snap["tenants"].items()):
                agg = tenants.setdefault(key, {})
                for k, v in list(st.items()):
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
        # router-held requests count as queued against their tenant
        for req in list(self._queue):
            agg = tenants.setdefault(req.tenant or "-", {})
            agg["queued"] = agg.get("queued", 0) + 1
        return {
            "tenants": tenants,
            "scheduler": {
                "policy": (policies[0] if policies
                           and all(p == policies[0]
                                   for p in policies)
                           else policies),
                "preemptions": preemptions,
            },
        }

    def fleet_chrome_trace(self) -> dict:
        """ONE merged Perfetto-loadable trace for the whole fleet: the
        router's event stream plus every replica's request and step
        tracks, a failed-over rid's spans on both replicas joined by
        flow events. Served at ``/trace?fleet=1``."""
        return observability.tracing.fleet_chrome_trace(self)

    def metrics_snapshot(self) -> dict:
        """ONE fleet document: the router's registry aggregates (when
        telemetry is on), the host-side fleet snapshot, the merged fleet
        SLO and tenant views, and every replica's own
        ``metrics_snapshot`` — what the aggregate ``/healthz`` embeds."""
        if self._san is not None:
            self._san.check_read("metrics_snapshot")
        snap = ({"telemetry": "off"} if self._tel is None
                else self._tel.snapshot())
        snap["fleet"] = self.fleet_snapshot()
        snap["slo"] = self.slo_snapshot()
        snap["tenants"] = self.tenant_snapshot()
        snap["replicas"] = [rep.engine.metrics_snapshot()
                            for rep in list(self._replicas)]
        return snap
