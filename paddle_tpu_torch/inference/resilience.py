"""Resilience layer of the serving engine (counterpart of
``paddle_tpu/inference/resilience.py``): deterministic fault injection
and the graceful-degradation ladder.

Every token the engine has emitted lives on the host, so a failed step
can be quarantined (its requests leave their slots) and the affected
requests replayed through the chunked prefill with greedy tokens
unchanged. This module holds the two host-side pieces the engine
composes:

* ``FaultInjector``: a seeded, per-site schedule that makes chaos tests
  deterministic and CPU-runnable. Sites are the engine's dispatch seams
  (``step`` = exception before a forward, ``nan`` = NaN-logits storm,
  ``latency`` = stall before a forward, ``pool`` = simulated KV-pool
  exhaustion at admission), the state-corruption sites the sanitizer is
  tested with, and the router's replica sites. Each site draws from its
  own numpy Generator stream seeded on the site's index, as the JAX
  package's does, so the same spec and seed fire at the same draws in
  both packages.

* ``DegradationController``: the ladder. Sustained admission saturation
  climbs ``shed_batch`` then ``throttle``; repeated step faults in a
  sliding window jump to ``min_service``, which also switches
  speculative decoding and prefix-cache adoption off. Neither switch
  changes greedy tokens. Good ticks walk the level down one rung at a
  time.

``RUNTIME_ERRORS`` are the torch errors a failed device call raises:
``torch.OutOfMemoryError`` and, where the installed torch has it,
``torch.AcceleratorError`` (a CUDA error). Never a plain
``RuntimeError``: the kernel wrappers raise one when a launch fails, and
under ``PT_FLAGS_serve_recovery=auto`` that must propagate, as a host
error does in the JAX package. A sticky CUDA error (an illegal address)
kills the context: the rebuild after it fails too, and that second
failure propagates.

Plain host bookkeeping: no tensors, importable without a card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# injection sites, in the order the engine consults them at a seam.
# APPEND-ONLY: each site's RNG stream is seeded on its index, so
# inserting a site would shift every later site's schedule and break
# seeded-chaos reproducibility across versions.
SITES = ("step", "nan", "latency", "pool",
         # state-corruption sites (sanitizer chaos): consulted once
         # per tick AFTER the step's host integration — a fire mangles
         # the engine's own bookkeeping (leaked page ref / desynced
         # scale pool / shrunk seq_len) so PT_FLAGS_sanitize runs can
         # prove the invariant checker catches real damage
         "leak_ref", "scale_desync", "seq_shrink",
         # replica-level sites (router chaos): consulted by the
         # multi-engine router's per-replica tick seam, never by the
         # engine itself — replica_crash kills the whole replica
         # (device state untrusted: slots reclaimed for cross-replica
         # failover, caches rebuilt), replica_hang stalls it (the
         # breaker opens on repeated no-progress health probes),
         # probe_flaky flips one health-probe verdict (a single flake
         # must NOT flap the breaker)
         "replica_crash", "replica_hang", "probe_flaky")

# the subset above that corrupts engine state instead of failing a
# dispatch (the engine's _corrupt_point consults exactly these)
CORRUPT_SITES = ("leak_ref", "scale_desync", "seq_shrink")

# the subset the multi-engine router consults at its per-replica tick
# seam (router.py); the engine never draws from these streams, so a
# fleet spec like "replica_crash:0.05" leaves every engine-level
# schedule untouched
ROUTER_SITES = ("replica_crash", "replica_hang", "probe_flaky")

# exception classes "auto" recovery treats as failures of a device call
# (recoverable by quarantine + replay) as opposed to host logic errors
# (which must propagate). Both subclass RuntimeError, so the isinstance
# check stays strict: a plain RuntimeError (a kernel wrapper's failed
# launch, scheduler code) is NOT swallowed.
RUNTIME_ERRORS: tuple = (torch.OutOfMemoryError,)
if hasattr(torch, "AcceleratorError"):
    RUNTIME_ERRORS += (torch.AcceleratorError,)


class InjectedFault(RuntimeError):
    """A fault fired by the :class:`FaultInjector` at a dispatch seam.

    Raised BEFORE the forward is launched, so the device cache
    state is untouched — recovery can requeue the step's requests
    without rebuilding the pools. ``site`` is the injection site
    (``"step"`` | ``"nan"``); ``program`` names the seam it fired at.
    """

    def __init__(self, site: str, program: str = ""):
        self.site = site
        self.program = program
        super().__init__(
            f"injected {site!r} fault at {program or 'dispatch'}")


class FaultInjector:
    """Seeded per-site fault schedule for chaos tests.

    ``spec`` is the ``PT_FLAGS_fault_inject`` string: comma-separated
    ``site:rate`` entries plus optional ``seed:<int>`` /
    ``latency_ms:<float>``, e.g. ``"step:0.1,nan:0.05,seed:7"``.
    Rates are per-consultation probabilities in ``[0, 1]``; a site
    with rate 0 never draws, so adding a site to the spec never shifts
    another site's stream.
    """

    def __init__(self, spec: str = "", seed: int = 0,
                 latency_ms: float = 25.0,
                 rates: Optional[Dict[str, float]] = None):
        self.rates = {s: 0.0 for s in SITES}
        self.seed = int(seed)
        self.latency_ms = float(latency_ms)
        if rates:
            for site, rate in rates.items():
                self._set_rate(site, rate)
        for part in filter(None,
                           (p.strip() for p in str(spec).split(","))):
            key, sep, val = part.partition(":")
            key = key.strip().lower()
            if not sep:
                raise ValueError(
                    f"fault_inject entry {part!r} is not 'key:value'")
            if key == "seed":
                self.seed = int(val)
            elif key == "latency_ms":
                self.latency_ms = float(val)
                if self.latency_ms <= 0:
                    raise ValueError(
                        f"latency_ms must be > 0; got {val}")
            else:
                self._set_rate(key, val)
        # independent, seed-derived stream per site: deterministic and
        # mutually isolated (numpy seeds on the whole tuple)
        self._rngs = {
            s: np.random.default_rng((0x5EED, self.seed, i))
            for i, s in enumerate(SITES)
        }
        self.draws = {s: 0 for s in SITES}
        self.fires = {s: 0 for s in SITES}

    def _set_rate(self, site: str, rate):
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; valid sites: {SITES} "
                f"(plus seed:<int>, latency_ms:<float>)")
        r = float(rate)
        if not 0.0 <= r <= 1.0:
            raise ValueError(
                f"fault rate for {site!r} must be in [0, 1]; got {r}")
        self.rates[site] = r

    @classmethod
    def from_flag(cls) -> Optional["FaultInjector"]:
        """Build from ``PT_FLAGS_fault_inject``; None when the flag is
        empty (the production default — zero overhead)."""
        from .. import flags

        spec = str(flags.flag("fault_inject")).strip()
        return cls(spec) if spec else None

    @property
    def enabled(self) -> bool:
        return any(r > 0 for r in self.rates.values())

    def fire(self, site: str) -> bool:
        """One consultation of ``site``'s schedule. Deterministic:
        the k-th call for a given (seed, site) always returns the same
        verdict, regardless of what other sites are configured."""
        rate = self.rates[site]
        if rate <= 0.0:
            return False
        self.draws[site] += 1
        hit = bool(self._rngs[site].random() < rate)
        if hit:
            self.fires[site] += 1
        return hit

    def snapshot(self) -> dict:
        # copy-on-read: the /healthz scrape thread reads
        # this through resilience_snapshot while the scheduler fires
        return {
            "enabled": self.enabled,
            "seed": self.seed,
            "latency_ms": self.latency_ms,
            "rates": {k: v for k, v in list(self.rates.items())},
            "draws": {k: v for k, v in list(self.draws.items())},
            "fires": {k: v for k, v in list(self.fires.items())},
        }


# degradation ladder levels, mildest first
LEVEL_NAMES = ("normal", "shed_batch", "throttle", "min_service")


class DegradationController:
    """Ladder state machine for graceful degradation.

    Called once per scheduler tick with the tick's health verdict.
    Escalation is cause-split:

    * **saturation** (requests waiting, no slot/pages to admit them)
      is a CAPACITY problem: ``trip_after`` consecutive saturated
      ticks climb one rung, capped at ``sat_max_level`` (default 2 =
      ``throttle``). Shedding batch-class admissions and throttling
      admission keeps interactive traffic alive; disabling correct
      machinery would not add capacity.
    * **faults** (quarantined steps, NaN storms) are a MACHINERY
      problem: ``fault_trip`` faults inside a sliding
      ``fault_window``-tick window jump straight to ``max_level``
      (``min_service``), which additionally switches off speculative
      decoding and prefix-cache adoption — the two subsystems whose
      failure modes ("repeated spec-verify failures", poisoned shared
      pages) the jump exists for. Neither switch changes greedy
      outputs, only throughput.

    ``recover_after`` consecutive healthy ticks walk one rung back
    down (never past a still-hot fault window), so recovery is
    deliberately slower than escalation.
    """

    def __init__(self, trip_after: int = 4, recover_after: int = 6,
                 fault_window: int = 32, fault_trip: int = 3,
                 sat_max_level: int = 2, max_level: int = 3):
        for name, v, lo in (("trip_after", trip_after, 1),
                            ("recover_after", recover_after, 1),
                            ("fault_window", fault_window, 1),
                            ("fault_trip", fault_trip, 1),
                            ("sat_max_level", sat_max_level, 0),
                            ("max_level", max_level, 0)):
            if int(v) < lo:
                raise ValueError(f"{name} must be >= {lo}; got {v}")
        if sat_max_level > max_level:
            raise ValueError("sat_max_level cannot exceed max_level")
        self.trip_after = int(trip_after)
        self.recover_after = int(recover_after)
        self.fault_window = int(fault_window)
        self.fault_trip = int(fault_trip)
        self.sat_max_level = int(sat_max_level)
        self.max_level = int(max_level)
        self.level = 0
        self._tick = 0
        self._sat_streak = 0
        self._good_streak = 0
        # both scrape-read structures are plain lists, NOT deques: the
        # scrape thread copies them via list(...) in snapshot(), and
        # list-of-list is atomic under the GIL while deque iteration
        # raises on concurrent append. _fault_log stays tiny (trimmed
        # to the sliding window each observe()), so del-from-front is
        # O(window), not a cost.
        self._fault_log: list = []  # (tick, count)
        self.transitions: list = []
        self._max_transitions = 64

    # ---------------- per-tick update ----------------
    def _window_faults(self) -> int:
        horizon = self._tick - self.fault_window
        while self._fault_log and self._fault_log[0][0] <= horizon:
            del self._fault_log[0]
        return sum(c for _, c in self._fault_log)

    def observe(self, *, saturated: bool, faults: int = 0) -> int:
        """One scheduler tick's health report; returns the new level."""
        self._tick += 1
        if faults > 0:
            self._fault_log.append((self._tick, int(faults)))
        wf = self._window_faults()
        if saturated:
            self._sat_streak += 1
        else:
            self._sat_streak = 0
        if not saturated and faults == 0:
            self._good_streak += 1
        else:
            self._good_streak = 0
        new = self.level
        if self._sat_streak >= self.trip_after and new < self.sat_max_level:
            new += 1
            self._sat_streak = 0
        if wf >= self.fault_trip and new < self.max_level:
            new = self.max_level
        if self._good_streak >= self.recover_after and new > 0 \
                and wf < self.fault_trip:
            new -= 1
            self._good_streak = 0
        if new != self.level:
            self.transitions.append({
                "tick": self._tick, "from": self.level, "to": new,
                "saturated": bool(saturated), "window_faults": wf,
            })
            if len(self.transitions) > self._max_transitions:
                del self.transitions[
                    :len(self.transitions) - self._max_transitions]
            self.level = new
        return new

    # ---------------- action bits ----------------
    @property
    def degraded(self) -> bool:
        return self.level > 0

    @property
    def shed_batch(self) -> bool:
        """Defer (never drop) batch-class admissions."""
        return self.level >= 1

    @property
    def throttle(self) -> bool:
        """Cap admission to one request per wave; ``step_adaptive``
        drops to its probe chunk."""
        return self.level >= 2

    @property
    def disable_spec(self) -> bool:
        return self.level >= 3

    @property
    def disable_prefix(self) -> bool:
        return self.level >= 3

    @property
    def name(self) -> str:
        return LEVEL_NAMES[min(self.level, len(LEVEL_NAMES) - 1)]

    def snapshot(self) -> dict:
        # pure read: recount the fault window WITHOUT
        # the trim _window_faults performs — the scrape thread must
        # never mutate the scheduler-owned log, and the trim races
        # observe()'s own popleft
        horizon = self._tick - self.fault_window
        wf = sum(c for t, c in list(self._fault_log) if t > horizon)
        return {
            "enabled": True,
            "level": self.level,
            "name": self.name,
            "degraded": self.degraded,
            "shed_batch": self.shed_batch,
            "throttle": self.throttle,
            "disable_spec": self.disable_spec,
            "disable_prefix": self.disable_prefix,
            "sat_streak": self._sat_streak,
            "good_streak": self._good_streak,
            "window_faults": wf,
            "transitions": list(self.transitions),
        }
