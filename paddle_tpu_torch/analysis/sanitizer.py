"""Runtime invariant sanitizer of the serving engine and the router
(counterpart of ``paddle_tpu/analysis/sanitizer.py``), behind
``PT_FLAGS_sanitize``. Once per tick it checks the state the scheduler
built:

* **page/refcount conservation** (paged mode): every pool page is
  exactly one of {free, referenced}; each page's refcount equals its
  recounted owners (slots holding it + the prefix store's retain); the
  free list has no duplicates; the sink page stays out of circulation;
  ``shared_pages`` agrees with a recount.
* **slot-heap agreement**: the free heap and the active mask partition
  the slots; ``_slot_req`` holds exactly the active slots.
* **seq_len bounds + host-truth agreement**: inactive slots sit at 0;
  active slots fit ``max_len`` (paged: their pages) and match the host
  token ledger, ``prompt + output - 1``: the state replay rebuilds from.
* **scale shapes** (int8 caches): paged ``k_scale``/``v_scale`` are
  ``[kv_heads, n_pages, page_size, 1]`` beside ``[kv_heads, n_pages,
  page_size, head_dim]`` pools; a contiguous ``QuantizedKV``'s ``scale``
  is ``q.shape[:-1]``.
* **thread ownership**: ticks belong to ONE scheduler thread, and a
  foreign thread may only enter the readers in ``SAFE_READS``.
* **fleet ownership** (``check_fleet``): every request id lives in
  exactly one place of a router's fleet.

Every check reads host state only: numpy arrays (``seq_lens``,
``active``, the block tables), the ``PagePool``, the heap, and tensor
``.shape`` metadata. No check calls ``.item()``, ``.cpu()`` or
``.tolist()`` on a tensor: on the card that would add a host sync to
every tick. Violations raise :class:`SanitizerError` naming the
invariant and the site.
"""

from __future__ import annotations

import threading
from typing import Optional

# reader methods registered copy-on-read-safe: a foreign thread may
# call these (and ONLY these) while the scheduler runs; each copies what
# it reads (list()/dict() of every structure the scheduler mutates). The
# JAX package's set, less ``audit_snapshot`` (the seal-time program
# audit is still to come).
SAFE_READS = frozenset({
    "metrics_snapshot", "prefix_snapshot", "spec_snapshot",
    "slo_snapshot", "resilience_snapshot", "backpressure", "_tel_state",
    # multi-engine router readers (router.py)
    "fleet_snapshot",
    # program-time attribution readers: profiler stats, recompile-
    # watchdog state and device-memory residency are copy-on-read host
    # metadata
    "profile_snapshot", "recompile_snapshot", "hbm_snapshot",
    # flight-data readers: time-series windows are immutable once
    # appended (the ring copies under its lock), alert/cost snapshots
    # copy every nested structure
    "timeline_snapshot", "alerts_snapshot", "cost_snapshot",
    # multi-tenant accounting: cumulative tenant counters + live
    # slot/page usage, copied per call
    "tenant_snapshot",
})


class SanitizerError(AssertionError):
    """An engine invariant does not hold. ``invariant`` names the
    violated invariant class, ``site`` the hook that caught it."""

    def __init__(self, invariant: str, site: str, detail: str):
        self.invariant = invariant
        self.site = site
        super().__init__(
            f"[sanitize] invariant {invariant!r} violated at "
            f"{site!r}: {detail}")


class EngineSanitizer:
    """Per-engine invariant checker (constructed only when
    ``PT_FLAGS_sanitize`` is on — the engine holds None otherwise)."""

    def __init__(self, engine=None):
        del engine  # checks read the engine per-call; no cycle held
        self._owner: Optional[int] = None
        # failover count at the last full owner-map sweep (fleet
        # checks only; terminal-entry resolution is failover-gated)
        self._fleet_failovers_swept = -1

    # ---------------- thread ownership ----------------
    def note_tick(self, site: str):
        """Called at every scheduler-tick entry: the first ticking
        thread owns the engine; a second thread ticking it is exactly
        the race the scheduler contract forbids."""
        tid = threading.get_ident()
        if self._owner is None:
            self._owner = tid
        elif tid != self._owner:
            raise SanitizerError(
                "scheduler-ownership", site,
                f"tick from thread {tid} but the engine is owned by "
                f"scheduler thread {self._owner} — one thread drives "
                "step()/step_chunk()/drain()")

    def check_read(self, name: str):
        """Called at reader entries: a foreign thread may only use the
        registered copy-on-read-safe readers."""
        if self._owner is None:
            return
        tid = threading.get_ident()
        if tid != self._owner and name not in SAFE_READS:
            raise SanitizerError(
                "thread-ownership", name,
                f"read of unlocked scheduler state from foreign thread "
                f"{tid} (owner {self._owner}); register the method in "
                "analysis.sanitizer.SAFE_READS only once it follows "
                "the copy-on-read pattern")

    # ---------------- per-tick state invariants ----------------
    def check_tick(self, engine, site: str = "tick"):
        self._check_slots(engine, site)
        if engine.pool is not None:
            self._check_pool(engine, site)
            self._check_block_tables(engine, site)
        self._check_scale_shapes(engine, site)

    # -- slot heap / active mask / request map / seq_len bounds --
    def _check_slots(self, engine, site):
        cfg = engine.cfg
        heap = list(engine._free_heap)
        free = set(heap)
        if len(free) != len(heap):
            raise SanitizerError(
                "slot-heap", site,
                f"duplicate slots in the free heap: {sorted(heap)}")
        active = {s for s in range(cfg.max_slots) if engine.active[s]}
        if free & active:
            raise SanitizerError(
                "slot-heap", site,
                f"slots {sorted(free & active)} are both free and "
                "active")
        if free | active != set(range(cfg.max_slots)):
            missing = set(range(cfg.max_slots)) - free - active
            raise SanitizerError(
                "slot-heap", site,
                f"slots {sorted(missing)} are neither free nor active "
                "(leaked from the heap)")
        if set(engine._slot_req) != active:
            raise SanitizerError(
                "slot-heap", site,
                f"_slot_req keys {sorted(engine._slot_req)} != active "
                f"slots {sorted(active)}")
        for s in range(cfg.max_slots):
            L = int(engine.seq_lens[s])
            if s not in active:
                if L != 0:
                    raise SanitizerError(
                        "seq-len", site,
                        f"inactive slot {s} has seq_len {L} (expect 0)")
                continue
            if not 0 <= L <= cfg.max_len:
                raise SanitizerError(
                    "seq-len", site,
                    f"slot {s} seq_len {L} outside [0, {cfg.max_len}]")
            if engine.pool is not None:
                cap = len(engine.pool.pages_of[s]) * cfg.page_size
                if L > cap:
                    raise SanitizerError(
                        "seq-len", site,
                        f"slot {s} seq_len {L} exceeds its "
                        f"{len(engine.pool.pages_of[s])} allocated "
                        f"page(s) = {cap} tokens")
            req = engine._slot_req[s]
            expect = req.prompt.size + len(req.output) - 1
            if req.output and L != expect:
                raise SanitizerError(
                    "seq-len", site,
                    f"slot {s} (rid {req.rid}) seq_len {L} != host "
                    f"token ledger prompt({req.prompt.size}) + "
                    f"output({len(req.output)}) - 1 = {expect} — the "
                    "cache and the replay source of truth disagree")

    # -- page/refcount conservation --
    def _check_pool(self, engine, site):
        pool = engine.pool
        sink = 1 if getattr(pool, "reserve_sink", False) else 0
        free = list(pool._free)
        if len(set(free)) != len(free):
            raise SanitizerError(
                "page-conservation", site,
                "duplicate page ids on the free list")
        if sink and (0 in set(free) or pool.ref.get(0, 0) > 0):
            raise SanitizerError(
                "page-conservation", site,
                "reserved sink page 0 re-entered circulation")
        owners = {}
        for s, pages in list(pool.pages_of.items()):
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        store = engine._prefix
        if engine.cfg.paged and store is not None:
            # entries are (page id, namespace) — the retain is on the
            # page regardless of which tenant published it
            for p, _ns in list(getattr(store, "_blocks", {}).values()):
                owners[p] = owners.get(p, 0) + 1
        for p, n in sorted(owners.items()):
            if pool.ref.get(p, 0) != n:
                raise SanitizerError(
                    "page-conservation", site,
                    f"page {p} refcount {pool.ref.get(p, 0)} != "
                    f"recounted owners {n} (slots holding it + prefix-"
                    "store retain) — a leak or double-free in the "
                    "making")
        for p, n in sorted(pool.ref.items()):
            if n <= 0:
                raise SanitizerError(
                    "page-conservation", site,
                    f"page {p} carries non-positive refcount {n}")
            if owners.get(p, 0) != n:
                raise SanitizerError(
                    "page-conservation", site,
                    f"page {p} refcount {n} has only "
                    f"{owners.get(p, 0)} recounted owner(s)")
        freeset = set(free)
        if freeset & set(pool.ref):
            both = sorted(freeset & set(pool.ref))
            raise SanitizerError(
                "page-conservation", site,
                f"pages {both} are both free and referenced")
        if len(free) + len(pool.ref) != pool.n_pages - sink:
            raise SanitizerError(
                "page-conservation", site,
                f"free({len(free)}) + referenced({len(pool.ref)}) != "
                f"n_pages({pool.n_pages}) - sink({sink}) — pages "
                "leaked out of both ledgers")
        shared = sum(1 for n in pool.ref.values() if n > 1)
        if shared != pool.shared_pages:
            raise SanitizerError(
                "page-conservation", site,
                f"shared_pages fast-path counter {pool.shared_pages} "
                f"!= recount {shared} — the decode COW guard would "
                "skip its scan while pages are shared")

    # -- block table mirrors pages_of --
    def _check_block_tables(self, engine, site):
        pool = engine.pool
        for s in range(pool.slots):
            pages = pool.pages_of[s]
            row = pool.block_tables[s]
            for i, p in enumerate(pages):
                if int(row[i]) != int(p):
                    raise SanitizerError(
                        "block-table", site,
                        f"slot {s} block_tables[{i}] = {int(row[i])} "
                        f"but pages_of lists page {p}")
            for i in range(len(pages), pool.max_pages_per_slot):
                if int(row[i]) != 0:
                    raise SanitizerError(
                        "block-table", site,
                        f"slot {s} block_tables[{i}] = {int(row[i])} "
                        "past its allocation (expect the sink id 0)")

    # ---------------- fleet invariants (router) ----------------
    def check_fleet(self, router, site: str = "fleet-tick"):
        """The ROUTER-level invariant cross-replica failover must
        preserve: every request id is owned by EXACTLY one place —
        the router's own admission queue, ONE replica's queue, or ONE
        replica's active slot — and a finished rid is never
        simultaneously live anywhere. Dual ownership is precisely
        what a buggy failover produces (the dead replica keeps a rid
        its reclaim also re-admitted elsewhere: two engines then
        decode the same request and its ledger forks). Also checks
        the router's owner map: every LIVE rid's entry points at the
        replica that actually holds it (per tick, O(live)), and —
        after any failover mutated the map — every TERMINAL entry
        resolves to a finish registry on the replica it names."""
        owners: dict = {}
        held_by: dict = {}  # rid -> replica idx actually holding it

        def note(rid, where, idx=None):
            owners.setdefault(rid, []).append(where)
            if idx is not None:
                held_by[rid] = idx

        for req in list(router._queue):
            note(req.rid, "router-queue")
        for rep in list(router._replicas):
            eng = rep.engine
            for req in list(eng._queue):
                note(req.rid, f"replica{rep.idx}-queue", rep.idx)
            for req in list(eng._slot_req.values()):
                note(req.rid, f"replica{rep.idx}-slot", rep.idx)
        for rid, places in sorted(owners.items()):
            if len(places) > 1:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"rid {rid} is owned by {len(places)} places at "
                    f"once: {places} — failover must MOVE a request, "
                    "never copy it")
        # finished-vs-live and owner-map resolution run as O(1) dict
        # membership probes against the finish registries: rebuilding
        # a set of every rid the fleet EVER finished would cost
        # O(total completed) per tick — quadratic over a sanitized
        # soak — to answer questions about the handful of live rids
        replicas = list(router._replicas)

        def finished_at(rid):
            if rid in router._finished:
                return "router"
            for rep in replicas:
                if rid in rep.engine._finished:
                    return f"replica{rep.idx}"
            return None

        for rid, places in sorted(owners.items()):
            where = finished_at(rid)
            if where is not None:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"rid {rid} is finished ({where}) AND still live "
                    f"({places}) — a finished request must have left "
                    "every queue and slot")
        # live owner agreement, O(live): a replica-held rid must have
        # an owner entry pointing at the replica that holds it; a
        # router-held rid must have NONE (queued rids are absent from
        # the map by design — _reclaim pops before re-queueing)
        for rid, holder in sorted(held_by.items()):
            ridx = router._owner.get(rid)
            if ridx is None:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"rid {rid} is held by replica {holder} but "
                    "absent from the router owner map — "
                    "result()/cancel() cannot find it")
            if ridx != holder:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"router owner map routes rid {rid} to "
                    f"replica {ridx} but replica {holder} holds "
                    "it — result()/cancel() would misroute")
        for rid in owners:
            if rid not in held_by and rid in router._owner:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"rid {rid} sits in the router hold queue but the "
                    f"owner map routes it to replica "
                    f"{router._owner[rid]} — cancel() would misroute")
        # full owner-map resolution sweep (every TERMINAL entry
        # resolves to a finish registry on the replica the map names)
        # only after a FAILOVER mutated the map: placement only
        # appends live entries (vetted above) and finish registries
        # never shrink, so between failovers the sweep is a no-op —
        # running it per tick would cost O(total completed) per tick,
        # quadratic over a sanitized soak
        n_failovers = router.fleet_stats["failovers"]
        if n_failovers == self._fleet_failovers_swept:
            return
        self._fleet_failovers_swept = n_failovers
        for rid in list(router._finished):
            fin = next((rep.idx for rep in replicas
                        if rid in rep.engine._finished), None)
            if fin is not None:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"rid {rid} is finished at the router AND on "
                    f"replica {fin} — a request must reach exactly "
                    "one terminal registry")
        for rid, ridx in list(router._owner.items()):
            if rid in held_by:
                continue  # live: vetted against its holder above
            if rid in replicas[ridx].engine._finished:
                # terminal exactly where the map says — but it must
                # be terminal exactly ONCE: a second registry holding
                # the same rid is double accounting (a reclaim that
                # timed a victim out on the dead replica while the
                # survivor also finished its replay)
                dup = next(
                    (f"replica{rep.idx}" for rep in replicas
                     if rep.idx != ridx and rid in rep.engine._finished),
                    "router" if rid in router._finished else None)
                if dup is not None:
                    raise SanitizerError(
                        "rid-ownership", site,
                        f"rid {rid} is finished on replica {ridx} "
                        f"AND on {dup} — a request must reach exactly "
                        "one terminal registry")
                continue
            fin = next((rep.idx for rep in replicas
                        if rid in rep.engine._finished), None)
            if fin is None:
                raise SanitizerError(
                    "rid-ownership", site,
                    f"router owner map routes rid {rid} to replica "
                    f"{ridx}, but no replica holds or finished it — "
                    "the request leaked out of the fleet")
            raise SanitizerError(
                "rid-ownership", site,
                f"rid {rid} finished on replica {fin} but the "
                f"owner map says replica {ridx} — result() would "
                "return None forever")

    # -- int8 scale pools mirror their payload --
    def _check_scale_shapes(self, engine, site):
        """Shape metadata only: ``.shape`` of a device tensor needs no
        sync."""
        from ..inference.paged import QuantizedKV

        if engine.pool is not None:
            for li, c in enumerate(engine.caches):
                if (c.k_scale is None) != (c.v_scale is None):
                    raise SanitizerError(
                        "scale-pool", site,
                        f"layer {li}: k_scale/v_scale presence differs")
                if c.k_scale is None:
                    continue
                want = tuple(c.k_pages.shape[:3]) + (1,)
                for nm, scale, pages in (("k", c.k_scale, c.k_pages),
                                         ("v", c.v_scale, c.v_pages)):
                    if tuple(scale.shape) != want:
                        raise SanitizerError(
                            "scale-pool", site,
                            f"layer {li} {nm}_scale shape "
                            f"{tuple(scale.shape)} desynced from pool "
                            f"{tuple(pages.shape)} (want {want}) — "
                            "dequant state no longer travels with the "
                            "page")
            return
        for li, (k, v) in enumerate(engine.caches):
            for nm, c in (("k", k), ("v", v)):
                if isinstance(c, QuantizedKV):
                    want = tuple(c.q.shape[:-1])
                    if tuple(c.scale.shape) != want:
                        raise SanitizerError(
                            "scale-pool", site,
                            f"layer {li} contiguous {nm} scale shape "
                            f"{tuple(c.scale.shape)} != q rows {want}")
