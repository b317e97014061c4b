"""Per-request lifecycle tracing for the serving engine (counterpart of
``paddle_tpu/observability/tracing.py``: the same events, names and
exports).

A thread-safe, ring-buffered span/event tracer: the engine records each
request's full lifecycle (queued → admitted → prefill chunk(s) →
decode/verify participation → prefix-cache hit/COW/evict → finish or
cancel) and each engine step's composition (which serving program ran,
batch occupancy, chunk budget spent, tokens advanced per request, host
dispatch time vs the estimated device wall between dispatch-done and
token sync). Everything here is host-side bookkeeping over values the
scheduler already holds — tracing adds no device work and no device
sync (pinned by test).

Correlation with the ``MetricsRegistry``: every event carries the same
``engine`` id the registry labels its serve series with, plus the
request id / step sequence number — a registry anomaly (a TTFT p99
spike at step ~N) is looked up here by ``seq``.

Exports:
  * Chrome trace-event JSON (``chrome_trace``) — loadable in Perfetto /
    ``chrome://tracing``: engine steps on tid 0, each request on its
    own tid, spans as ``ph:"X"`` complete events, instants as
    ``ph:"i"``;
  * JSON-lines (``jsonl``) — one raw event per line for grepping.

Cost model: ``PT_FLAGS_telemetry=off`` means no tracer is constructed
at all (the engine holds ``None`` — the hot path pays one identity
check, no allocation). With telemetry on, ``PT_FLAGS_trace_sample``
thins the stream deterministically: rate ``r`` records every
``round(1/r)``-th request id and step sequence number, so a sampled
request's events are complete (never a torn subset) and the ring holds
``PT_FLAGS_trace_buffer`` events at most.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

from .. import flags

# live tracers (weak: an engine dropping its tracer drops it here too) —
# the dump CLI and the flight recorder read the process-wide view
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()

# live fleets (EngineRouter registers itself at construction; weak so a
# dropped router drops here too) — `dump --fleet` and the merged-trace
# export read the process-wide view
_FLEETS: "weakref.WeakSet" = weakref.WeakSet()


def register_fleet(fleet):
    """Record a multi-engine front door (``inference/router.py``'s
    ``EngineRouter``) for process-wide fleet exports: ``dump --fleet``
    and :func:`fleet_chrome_trace`."""
    _FLEETS.add(fleet)


def fleets() -> List[object]:
    return list(_FLEETS)


def sample_period(rate: float) -> int:
    """rate → keep-every-Nth period: 1.0 → 1, 0.5 → 2, 0.1 → 10."""
    if rate >= 1.0:
        return 1
    return max(1, int(round(1.0 / max(float(rate), 1e-9))))


class Tracer:
    """Ring-buffered lifecycle tracer for one engine.

    Events are plain dicts of JSON-serializable host values:
    ``{"kind": "step"|"request"|"engine", "name", "t0", "t1"|None,
    "engine", "rid"|"seq", "args": {...}}``. Times are
    ``time.perf_counter()`` seconds (monotonic; ``epoch_unix`` anchors
    them to wall clock for log correlation). ``t1 is None`` marks an
    instant event; otherwise [t0, t1] is a span.
    """

    def __init__(self, engine_id: str = "0",
                 capacity: Optional[int] = None,
                 sample: Optional[float] = None):
        if capacity is None:
            capacity = int(flags.flag("trace_buffer"))
        if sample is None:
            sample = float(flags.flag("trace_sample"))
        self.engine_id = str(engine_id)
        self.period = sample_period(sample)
        self._buf: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._eng_n = itertools.count()
        self.epoch_unix = time.time()
        self.epoch_perf = time.perf_counter()
        _TRACERS.add(self)

    # ---------------- sampling ----------------
    def want_request(self, rid: int) -> bool:
        return rid % self.period == 0

    def next_step(self) -> int:
        """Monotonic step sequence number (always advances, sampled or
        not, so ``seq`` stays a stable correlation key)."""
        return next(self._seq)

    def want_step(self, seq: int) -> bool:
        return seq % self.period == 0

    # ---------------- writes ----------------
    def _push(self, ev: dict):
        with self._lock:
            self._buf.append(ev)

    def step(self, seq: int, program: str, t0: float, t1: float, **args):
        """One engine step's composition: ``program`` is the serving
        program that ran (prefill_chunk / prefill_bucket / decode /
        decode_chunk / verify); args carry occupancy, budget, per-rid
        tokens advanced, dispatch vs sync wall."""
        self._push({"kind": "step", "seq": seq, "name": program,
                    "t0": t0, "t1": t1, "engine": self.engine_id,
                    "args": args})

    def request(self, rid: int, name: str, t0: Optional[float] = None,
                t1: Optional[float] = None, **args):
        """A request lifecycle event: instant (``t1=None``) or span."""
        if t0 is None:
            t0 = time.perf_counter()
        self._push({"kind": "request", "rid": int(rid), "name": name,
                    "t0": t0, "t1": t1, "engine": self.engine_id,
                    "args": args})

    def engine_event(self, name: str, _force: bool = False, **args):
        """Engine-scoped instant (e.g. a prefix-cache eviction storm).
        Rate-gated by the same sample period as requests/steps: an
        unsampled flood of COW/evict instants must not cycle the ring
        and evict the rare request spans a low ``trace_sample`` was
        set to preserve. ``_force`` bypasses the thinning for rare
        MUST-RECORD events (alert transitions): dropping one of those
        to rate-gating would hide the incident the tracer exists to
        explain."""
        if not _force and next(self._eng_n) % self.period != 0:
            return
        self._push({"kind": "engine", "name": name,
                    "t0": time.perf_counter(), "t1": None,
                    "engine": self.engine_id, "args": args})

    # ---------------- reads ----------------
    def events(self) -> List[dict]:
        """Snapshot copy, oldest first."""
        with self._lock:
            return list(self._buf)

    def recent(self, n: int) -> List[dict]:
        with self._lock:
            k = len(self._buf)
            return list(itertools.islice(self._buf, max(k - n, 0), k))

    def __len__(self):
        return len(self._buf)


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------
def all_tracers() -> List[Tracer]:
    return list(_TRACERS)


def recent_events(n: int = 64) -> List[dict]:
    """Last ``n`` events across every live tracer, oldest first — what
    the flight recorder attaches to an anomaly dump."""
    evs: List[dict] = []
    for tr in all_tracers():
        evs.extend(tr.recent(n))
    evs.sort(key=lambda e: e["t0"])
    return evs[-n:]


def _pid(tr: Tracer) -> int:
    eid = tr.engine_id
    return int(eid) + 1 if eid.isdigit() else (abs(hash(eid)) % 9973) + 1


def chrome_events(tracers: Optional[List[Tracer]] = None) -> List[dict]:
    """Flatten tracer rings into Chrome trace-event dicts (``ts``/
    ``dur`` in microseconds; engine steps on tid 0, request rid r on
    tid r+1 — tid 0 is reserved so a request id of 0 cannot collide
    with the step track)."""
    if tracers is None:
        tracers = all_tracers()
    out: List[dict] = []
    for tr in tracers:
        pid = _pid(tr)
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0,
                    "args": {"name": f"paddle_tpu engine {tr.engine_id}"}})
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": "engine steps"}})
        named_tids = set()
        for ev in tr.events():
            if ev["kind"] == "step":
                tid = 0
                args = dict(ev["args"], seq=ev["seq"])
            elif ev["kind"] == "request":
                tid = ev["rid"] + 1
                args = dict(ev["args"], rid=ev["rid"])
                if tid not in named_tids:
                    named_tids.add(tid)
                    out.append({"name": "thread_name", "ph": "M",
                                "pid": pid, "tid": tid,
                                "args": {"name": f"request {ev['rid']}"}})
            else:
                tid = 0
                args = dict(ev["args"])
            ts = ev["t0"] * 1e6
            if ev["t1"] is not None:
                out.append({"name": ev["name"], "ph": "X", "ts": ts,
                            "dur": max((ev["t1"] - ev["t0"]) * 1e6, 0.0),
                            "pid": pid, "tid": tid, "cat": ev["kind"],
                            "args": args})
            else:
                out.append({"name": ev["name"], "ph": "i", "ts": ts,
                            "s": "t", "pid": pid, "tid": tid,
                            "cat": ev["kind"], "args": args})
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out


def chrome_trace(tracers: Optional[List[Tracer]] = None) -> dict:
    """Perfetto/chrome://tracing-loadable document."""
    return {"traceEvents": chrome_events(tracers),
            "displayTimeUnit": "ms"}


def _rid_hops(tracers: List[Tracer]):
    """Per-tracer per-rid request activity: ``[(tracer, {rid: {first,
    last, spans}})]`` — the raw material for cross-replica flow
    correlation. Spans are (t0, t1) pairs; instants only move the
    first/last stamps."""
    per = []
    for tr in tracers:
        rids: dict = {}
        for ev in tr.events():
            if ev["kind"] != "request":
                continue
            d = rids.setdefault(
                ev["rid"], {"first": ev["t0"], "last": ev["t0"],
                            "spans": []})
            d["first"] = min(d["first"], ev["t0"])
            d["last"] = max(d["last"], ev["t0"])
            if ev["t1"] is not None:
                d["spans"].append((ev["t0"], ev["t1"]))
        per.append((tr, rids))
    return per


def _flow_anchor(d: dict, last: bool):
    """(ts_us inside an X slice, synthesized_event_or_None) for one
    hop end. Flow events bind to the slice ENCLOSING their ts on that
    pid/tid, so when the hop's rid has no span there (all instants — a
    reclaimed victim that re-queued but never finished, say) a 1 µs
    ``handoff`` slice is synthesized at the boundary instant."""
    if d["spans"]:
        spans = sorted(d["spans"])
        t0, t1 = spans[-1] if last else spans[0]
        return (t0 + max(t1 - t0, 0) / 2) * 1e6, None
    t = (d["last"] if last else d["first"]) * 1e6
    return t + 0.5, {"name": "handoff", "ph": "X", "ts": t, "dur": 1.0,
                     "cat": "request"}


def fleet_flow_events(tracers: List[Tracer]) -> List[dict]:
    """Chrome flow events (``ph`` ``s``/``f``, ``id`` = rid) joining a
    request's spans across every tracer it visited — the line Perfetto
    draws from a failed-over rid's life on the dead replica to its
    replayed life on the survivor. Consecutive hops are ordered by the
    rid's first event time per tracer."""
    per = _rid_hops(tracers)
    all_rids = set()
    for _tr, rids in per:
        all_rids.update(rids)
    out: List[dict] = []
    # a span-less MIDDLE hop of a 3+ hop chain anchors both its
    # incoming flow finish and its outgoing flow start — synthesize
    # its handoff slice once, not per adjacent pair
    seen_syn = set()
    for rid in sorted(all_rids):
        hops = sorted(
            ((d[rid]["first"], tr, d[rid]) for tr, d in per
             if rid in d), key=lambda h: h[0])
        if len(hops) < 2:
            continue
        for (_, tr_a, d_a), (_, tr_b, d_b) in zip(hops, hops[1:]):
            ts_a, syn_a = _flow_anchor(d_a, last=True)
            ts_b, syn_b = _flow_anchor(d_b, last=False)
            pid_a, pid_b = _pid(tr_a), _pid(tr_b)
            tid = rid + 1
            for syn, pid in ((syn_a, pid_a), (syn_b, pid_b)):
                if syn is not None:
                    key = (pid, tid, syn["ts"])
                    if key not in seen_syn:
                        seen_syn.add(key)
                        out.append(dict(syn, pid=pid, tid=tid,
                                        args={"rid": rid}))
            flow = {"name": f"rid {rid}", "cat": "failover",
                    "id": int(rid), "tid": tid}
            out.append(dict(flow, ph="s", ts=ts_a, pid=pid_a))
            # bp:"e" binds the finish to its ENCLOSING slice (the
            # replayed life's first span), not the next slice to start
            out.append(dict(flow, ph="f", bp="e", ts=ts_b, pid=pid_b))
    return out


def fleet_chrome_trace(fleet=None) -> dict:
    """ONE Perfetto-loadable document for a whole fleet: the router's
    tracer and every replica engine's tracer merged, with a
    failed-over rid's spans appearing on BOTH replicas' request tracks
    joined by flow events (:func:`fleet_flow_events`). ``fleet`` is an
    ``EngineRouter`` (duck-typed: ``_tracer`` + ``_replicas``); None
    merges every live tracer in the process — the ``dump --fleet`` /
    ``/trace?fleet=1`` export path."""
    if fleet is None:
        tracers = all_tracers()
        # deterministic merge order regardless of weakset iteration
        tracers.sort(key=lambda t: t.engine_id)
        flow_from = tracers
    else:
        tracers = []
        rt = getattr(fleet, "_tracer", None)
        if rt is not None:
            tracers.append(rt)
        flow_from = []
        for rep in list(getattr(fleet, "_replicas", ())):
            tr = getattr(rep.engine, "_tracer", None)
            if tr is not None:
                tracers.append(tr)
                flow_from.append(tr)
    events = chrome_events(tracers)
    events.extend(fleet_flow_events(flow_from))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def jsonl(tracers: Optional[List[Tracer]] = None) -> str:
    """Raw events, one JSON object per line, oldest first."""
    if tracers is None:
        tracers = all_tracers()
    evs: List[dict] = []
    for tr in tracers:
        evs.extend(tr.events())
    evs.sort(key=lambda e: e["t0"])
    return "\n".join(json.dumps(e, default=str) for e in evs)
