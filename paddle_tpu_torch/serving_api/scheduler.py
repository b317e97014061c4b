"""SLO-aware multi-tenant admission scheduler of the serving engine
(counterpart of ``paddle_tpu/serving_api/scheduler.py``).

It replaces FIFO admission with three tiers:

1. **Deadline urgency.** A queued SLO-tracked request whose remaining
   TTFT budget is under the margin goes first, the most urgent first.
2. **Weighted fair share.** Otherwise tenants are served in order of
   their virtual service (admitted tokens / weight): a tenant flooding
   the queue raises only its own virtual time. A new tenant joins at the
   current minimum.
3. **Target tightness, then FIFO** within a tenant.

Per-tenant quotas (``TenantQuota``: slots, KV pages) bound what a tenant
occupies; preemption (``PT_FLAGS_sched_preempt``) lets an at-risk request
evict a batch-class slot, whose request re-queues with its output and
replays through the chunked prefill (``engine.preempt``), so its greedy
tokens are unchanged. ``chunk_len`` shortens the decode chunk while
admission can come soon, and ``slot_caps`` bounds what batch slots
commit a chunk while urgent work waits.

Host policy only, consulted on the engine's scheduler thread
(``engine.set_scheduler``): it changes which request claims a slot and
when, never a token.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .. import flags

# the most recent preempted rids remembered (SLOFairScheduler._preempts)
_PREEMPT_LEDGER_CAP = 4096


@dataclass
class TenantQuota:
    """A tenant's scheduling settings: ``weight`` is its fair-share ratio
    (2.0 = twice the service of a weight-1 tenant); ``max_slots`` /
    ``max_pages`` cap what it may occupy at once (None = uncapped).
    Quotas gate admission only."""

    weight: float = 1.0
    max_slots: Optional[int] = None
    max_pages: Optional[int] = None

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(
                f"TenantQuota.weight must be > 0; got {self.weight}")
        for name in ("max_slots", "max_pages"):
            v = getattr(self, name)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 1):
                raise ValueError(
                    f"TenantQuota.{name} must be a positive int or "
                    f"None; got {v!r}")


class SLOFairScheduler:
    """The scheduler policy of the module docstring. Install it with
    ``engine.set_scheduler(SLOFairScheduler(...))``, or let the front door
    build one from ``PT_FLAGS_sched_policy=slo_fair``."""

    name = "slo_fair"

    def __init__(self, tenants: Optional[Dict[str, TenantQuota]] = None,
                 default_weight: float = 1.0,
                 ttft_margin_ms: float = 50.0,
                 probe_chunk: int = 2,
                 preempt: Optional[bool] = None,
                 max_preemptions_per_request: int = 1):
        if not default_weight > 0:
            raise ValueError(
                f"default_weight must be > 0; got {default_weight}")
        if ttft_margin_ms < 0:
            raise ValueError(
                f"ttft_margin_ms must be >= 0; got {ttft_margin_ms}")
        if probe_chunk < 1:
            raise ValueError(
                f"probe_chunk must be >= 1; got {probe_chunk}")
        self.tenants: Dict[str, TenantQuota] = dict(tenants or {})
        self.default_weight = float(default_weight)
        self.ttft_margin_ms = float(ttft_margin_ms)
        self.probe_chunk = int(probe_chunk)
        self.max_preemptions_per_request = int(max_preemptions_per_request)
        self.preempt_enabled = (bool(flags.flag("sched_preempt"))
                                if preempt is None else bool(preempt))
        # tenant -> virtual service (admitted tokens / weight)
        self._service: Dict[str, float] = {}
        # rid -> preemptions taken, the most recent _PREEMPT_LEDGER_CAP
        self._preempts: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()

    # ---------------- fair share ----------------
    def _weight(self, tenant: Optional[str]) -> float:
        q = self.tenants.get(tenant or "-")
        return q.weight if q is not None else self.default_weight

    def _service_of(self, tenant: Optional[str]) -> float:
        key = tenant or "-"
        svc = self._service.get(key)
        if svc is None:
            # join at the current minimum: no banked credit
            svc = self._service[key] = min(self._service.values(),
                                           default=0.0)
        return svc

    def note_admit(self, engine, req):
        """A claim committed: charge the tenant prompt + budget tokens
        over its weight. A re-admission (a preempted request carries
        output) was paid for once already."""
        del engine
        if req.output or req._retries:
            return
        key = req.tenant or "-"
        cost = (int(req.prompt.size) + int(req.max_new_tokens)) \
            / self._weight(req.tenant)
        self._service[key] = self._service_of(req.tenant) + cost

    # ---------------- urgency ----------------
    @staticmethod
    def _ttft_slack_ms(req, now: float) -> Optional[float]:
        """The TTFT budget left (ms) from the first submission; None for
        a request without a target or already admitted once."""
        if req.ttft_target_ms is None or req.ttft_ms is not None:
            return None
        return req.ttft_target_ms - (now - req._submit_t) * 1e3

    def _at_risk(self, req, now: float) -> bool:
        slack = self._ttft_slack_ms(req, now)
        return slack is not None and slack <= self.ttft_margin_ms

    def _queued_at_risk(self, engine, now: float) -> bool:
        """An at-risk request that quotas let in waits (quota-blocked
        urgency must not tax the other tenants)."""
        usage = self._usage_map(engine)
        return any(self._at_risk(r, now)
                   and self.quota_ok(engine, r, usage)
                   for r in list(engine._queue))

    # ---------------- quotas ----------------
    def _usage_map(self, engine) -> Dict[str, list]:
        """tenant -> [active slots, held pages], once a hook call."""
        usage: Dict[str, list] = {}
        for slot, req in list(engine._slot_req.items()):
            u = usage.setdefault(req.tenant or "-", [0, 0])
            u[0] += 1
            if engine.pool is not None:
                u[1] += len(engine.pool.pages_of[slot])
        return usage

    def quota_ok(self, engine, req, usage=None) -> bool:
        q = self.tenants.get(req.tenant or "-")
        if q is None or (q.max_slots is None and q.max_pages is None):
            return True
        if usage is None:
            usage = self._usage_map(engine)
        slots, pages = usage.get(req.tenant or "-", (0, 0))
        if q.max_slots is not None and slots >= q.max_slots:
            return False
        if q.max_pages is not None and engine.pool is not None \
                and pages >= q.max_pages:
            return False
        return True

    # ---------------- the engine's hooks ----------------
    def pick(self, engine, candidates):
        """The best admissible candidate, or None when quotas block them
        all."""
        now = time.perf_counter()
        usage = self._usage_map(engine)
        best = None
        best_key = None
        for i, req in enumerate(candidates):
            if not self.quota_ok(engine, req, usage):
                continue
            slack = self._ttft_slack_ms(req, now)
            if slack is not None and slack <= self.ttft_margin_ms:
                key = (0, slack, i)
            else:
                key = (1, self._service_of(req.tenant),
                       req.ttft_target_ms
                       if req.ttft_target_ms is not None
                       else float("inf"), i)
            if best_key is None or key < best_key:
                best, best_key = req, key
        return best

    def before_admission(self, engine):
        """The preemption window: with no free slot (or the last pass
        blocked on pages) and an admissible at-risk request waiting,
        preempt the batch-class slot with the fewest tokens made (the
        cheapest replay). Returns the preempted rids, which the engine
        keeps out of this wave."""
        if not self.preempt_enabled:
            return ()
        if engine._free_heap and not engine._pool_blocked_prev:
            return ()
        now = time.perf_counter()
        usage = self._usage_map(engine)
        urgent = next((r for r in list(engine._queue)
                       if self._at_risk(r, now)
                       and self.quota_ok(engine, r, usage)), None)
        if urgent is None:
            return ()
        victim_slot = None
        victim_key = None
        for slot, req in list(engine._slot_req.items()):
            if req.slo != "batch":
                continue
            if self._preempts.get(req.rid, 0) \
                    >= self.max_preemptions_per_request:
                continue
            key = (len(req.output), slot)
            if victim_key is None or key < victim_key:
                victim_slot, victim_key = slot, key
        if victim_slot is None:
            return ()
        victim = engine._slot_req[victim_slot]
        if not engine.preempt(victim_slot):
            return ()
        self._preempts[victim.rid] = self._preempts.get(victim.rid, 0) + 1
        self._preempts.move_to_end(victim.rid)
        while len(self._preempts) > _PREEMPT_LEDGER_CAP:
            self._preempts.popitem(last=False)
        return (victim.rid,)

    def slot_caps(self, engine) -> Optional[np.ndarray]:
        """While an admissible at-risk request waits, batch-class slots
        commit at most ``probe_chunk`` tokens a chunk; None otherwise."""
        if not engine._queue:
            return None
        now = time.perf_counter()
        if not self._queued_at_risk(engine, now):
            return None
        caps = np.full((engine.cfg.max_slots,), np.iinfo(np.int32).max,
                       np.int32)
        for slot, req in list(engine._slot_req.items()):
            if req.slo == "batch":
                caps[slot] = self.probe_chunk
        return caps

    def chunk_len(self, engine, max_chunk: int) -> int:
        """The next decode chunk's length: ``probe_chunk`` while requests
        wait and admission can come soon (a free slot, or a slot whose
        remaining budget ends inside a full chunk), ``max_chunk``
        otherwise (``step_adaptive``'s rule)."""
        if not engine._queue:
            return max_chunk
        if not engine.active.all():
            return min(self.probe_chunk, max_chunk)
        # the raw budgets: slot_caps would make capped slots look done
        soonest = min(
            (min(req.max_new_tokens - len(req.output),
                 engine.cfg.max_len - 1 - int(engine.seq_lens[slot]))
             for slot, req in list(engine._slot_req.items())),
            default=max_chunk + 1)
        if soonest <= max_chunk:
            return min(self.probe_chunk, max_chunk)
        return max_chunk

    def snapshot(self) -> dict:
        """The policy's state (copies): fair-share ledger, preempted
        requests remembered, quotas."""
        return {
            "policy": self.name,
            "preempt_enabled": self.preempt_enabled,
            "service": dict(self._service),
            "preempted_requests": len(self._preempts),
            "tenants": {
                k: {"weight": q.weight, "max_slots": q.max_slots,
                    "max_pages": q.max_pages}
                for k, q in list(self.tenants.items())},
        }


def default_scheduler():
    """The front door's default policy from ``PT_FLAGS_sched_policy``:
    ``"fifo"`` -> None (the engine's submission order), ``"slo_fair"`` ->
    a default :class:`SLOFairScheduler`."""
    policy = str(flags.flag("sched_policy")).lower()
    if policy == "fifo":
        return None
    if policy == "slo_fair":
        return SLOFairScheduler()
    raise ValueError(
        f"PT_FLAGS_sched_policy must be fifo|slo_fair; got {policy!r}")
