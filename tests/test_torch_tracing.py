"""The port's lifecycle tracer and fleet trace against the JAX package on
the CPU (the port's counterpart of ``tests/test_tracing.py`` and
``tests/test_fleet_trace.py``).

The JAX engine and the port's run the same arrivals on the tiny Llama
(weights carried across in float32): paged with ``step`` and spec decode
off, contiguous with ``step_chunk`` and n-gram drafting. Every request's
event names are equal in order, every step event's name and non-time
arguments (tokens advanced per rid, occupancy, chunk budget, packed
tokens, drafts proposed and accepted) are equal, and the prefill's first
token plus the advances reconstruct each request's output length. A
2-replica router whose replica 0 crashes at a scripted draw gives the
same router events, the same failed-over rids and the same flow events
in ``fleet_chrome_trace`` as the JAX router. Times (``t0``, ``t1``,
``ts``, ``dur``, ``*_ms``) are not compared. Sampling, the ring bound,
the off switches, cancel events, the ``/trace`` endpoint (404 exactly
where JAX answers 404) and the flight recorder's trace tail are checked
on the port."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import contextlib
import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_obs_utils as O
import torch_resilience_utils as U
from paddle_tpu.inference.resilience import FaultInjector as JInjector
from paddle_tpu.inference.router import EngineRouter as JRouter
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import EngineRouter, start_metrics_server
from paddle_tpu_torch.observability import dump as tdump
from paddle_tpu_torch.observability import tracing

pytestmark = pytest.mark.usefixtures("fresh_registries")
fresh_registries = O.fresh_registries


@pytest.fixture
def flags():
    f = O.ObsFlags()
    f.set()
    yield f
    f.restore()


def validate_chrome(doc):
    """Chrome trace-event schema (what Perfetto loads), flows included."""
    assert isinstance(doc, dict) and isinstance(doc["traceEvents"], list)
    json.loads(json.dumps(doc, default=str))
    for e in doc["traceEvents"]:
        assert isinstance(e["name"], str) and e["name"]
        assert e["ph"] in ("X", "i", "M", "s", "f")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] != "M":
            assert isinstance(e["ts"], float) and e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] == "i":
            assert e["s"] in ("t", "p", "g")
        if e["ph"] in ("s", "f"):
            assert isinstance(e["id"], int)
        if e["ph"] == "f":
            assert e["bp"] == "e"


def _prompts():
    rng = np.random.default_rng(2)
    unit = rng.integers(1, 256, 4)
    return [np.concatenate([unit] * 5), rng.integers(1, 256, 9),
            rng.integers(1, 256, 17)]


CASES = {"paged_step": (True, "off"), "contig_chunk_ngram": (False, "ngram")}


@pytest.fixture(scope="module")
def trace_runs():
    """Per case: (JAX engine, port engine, rids)."""
    f = O.ObsFlags()
    out = {}
    try:
        for case, (paged, spec) in CASES.items():
            f.set(spec_decode=spec)
            pair = O.engines(paged)
            for eng in pair:
                rids = [eng.add_request(p, 10) for p in _prompts()]
                step = (eng.step if case == "paged_step"
                        else lambda e=eng: e.step_chunk(4))
                while step() or eng._queue or eng.active.any():
                    pass
            out[case] = (*pair, rids)
    finally:
        f.restore()
    # the engines read their flags at construction: the rest of the
    # module runs with the flags it sets itself
    return out


def _steps(tracer):
    return [(e["name"], O.event_args(e)) for e in tracer.events()
            if e["kind"] == "step"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_lifecycle_trace_matches_jax(trace_runs, case):
    jeng, teng, rids = trace_runs[case]
    assert [teng._finished[r].output for r in rids] \
        == [jeng._finished[r].output for r in rids]
    jtr, ttr = jeng._tracer, teng._tracer
    assert O.request_events(ttr) == O.request_events(jtr)
    assert _steps(ttr) == _steps(jtr)
    for kind in ("request", "engine"):
        assert [(e["name"], O.event_args(e)) for e in ttr.events()
                if e["kind"] == kind] \
            == [(e["name"], O.event_args(e)) for e in jtr.events()
                if e["kind"] == kind]
    validate_chrome(tracing.chrome_trace([ttr]))
    raw = ttr.events()
    steps = [e for e in raw if e["kind"] == "step"]
    names = {e["name"] for e in steps}
    assert names >= ({"prefill_chunk", "decode"} if case == "paged_step"
                     else {"prefill_chunk", "verify"})
    for rid in rids:
        req = teng._finished[rid]
        mine = [e for e in raw if e.get("rid") == rid]
        admitted = next(e for e in mine if e["name"] == "admitted")
        active = next(e for e in mine if e["name"] == "active")
        assert admitted["t0"] <= admitted["t1"] <= active["t0"] \
            <= active["t1"]
        advanced = sum(e["args"]["advanced"].get(rid, 0) for e in steps
                       if "advanced" in e["args"])
        assert 1 + advanced == len(req.output) == active["args"]["tokens"]
    for e in steps:
        if e["name"] in ("decode", "decode_chunk", "verify"):
            # profiler off: the sync-wall fallback, never a device_ms
            assert e["args"]["sync_wall_ms"] >= 0
            assert "device_ms" not in e["args"]
    if case != "paged_step":
        verifies = [e for e in steps if e["name"] == "verify"]
        assert len(verifies) == teng.spec_stats["verify_calls"] > 0
        assert sum(e["args"]["proposed"] for e in verifies) \
            == teng.spec_stats["proposed"]
    lines = tracing.jsonl([ttr]).splitlines()
    assert len(lines) == len(raw)
    stamps = [json.loads(ln)["t0"] for ln in lines]
    assert stamps == sorted(stamps)


def test_off_switches(flags):
    _, tmodel = U.tiny_models()
    flags.set(trace_sample=0.0)
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
    assert eng._tel is not None and eng._tracer is None
    flags.set(telemetry=False)
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
    assert eng._tel is None and eng._tracer is None
    router = EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                          device="cpu")
    assert router._tracer is None and router._tel is None
    assert router.fleet_chrome_trace()["traceEvents"] == []
    assert router.fleet_snapshot()["n_replicas"] == 2


def test_trace_sample_thins_deterministically(flags):
    for rate in (1.0, 0.5, 0.3, 0.1, 1e-12):
        assert tracing.sample_period(rate) == jtracing.sample_period(rate)
    flags.set(trace_sample=0.5)
    _, tmodel = U.tiny_models()
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
    rids = [eng.add_request(p, 4) for p in O.prompts(4)]
    U.drive(eng)
    events = O.request_events(eng._tracer)
    assert sorted(events) == [r for r in rids if r % 2 == 0]
    for rid in events:  # complete, never a torn subset
        assert events[rid][0] == "queued" and events[rid][-1] == "active"
        assert "admitted" in events[rid]
    seqs = [e["seq"] for e in eng._tracer.events() if e["kind"] == "step"]
    assert seqs and all(s % 2 == 0 for s in seqs)


def test_trace_ring_bounded(flags):
    flags.set(trace_buffer=16)
    _, tmodel = U.tiny_models()
    eng = O.TEngine(tmodel, U.port_ecfg(False), device="cpu")
    eng.run(O.prompts(4), 6, max_chunk=2)
    assert len(eng._tracer) == 16
    assert eng._tracer.recent(4) == eng._tracer.events()[-4:]


def test_cancel_events(flags):
    _, tmodel = U.tiny_models()
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
    rids = [eng.add_request(p, 20) for p in O.prompts(3)]
    eng.step()  # two admitted, one queued
    assert eng.cancel(rids[2]) and eng.cancel(rids[0])
    U.drive(eng)
    cancels = [e for e in eng._tracer.events() if e["name"] == "cancel"]
    assert {e["rid"]: e["args"]["stage"] for e in cancels} \
        == {rids[2]: "queued", rids[0]: "active"}
    assert eng.metrics_snapshot()["requests"]["cancelled"] == 2
    U.assert_no_leaks(eng)


class JScripted(JInjector):
    """The JAX side's scripted injector (``U.ScriptedInjector``'s twin)."""

    def __init__(self, plan):
        super().__init__("")
        self._plan = {s: set(v) for s, v in plan.items()}

    def fire(self, site):
        n = self.draws[site]
        self.draws[site] = n + 1
        hit = n in self._plan.get(site, ())
        if hit:
            self.fires[site] += 1
        return hit


def _crash_fleet(router):
    rng = np.random.default_rng(3)
    for _ in range(4):
        router.add_request(rng.integers(1, 256, int(rng.integers(6, 20))), 8)
    router.step(2)
    router.step(2)
    victims = sorted(r.rid for r
                     in router._replicas[0].engine._slot_req.values())
    while router.step(2):
        pass
    return victims


@pytest.fixture(scope="module")
def fleets():
    """(JAX router, port router, victims) of a 2-replica fleet whose
    replica 0 crashes mid-flight at its fifth crash-site draw."""
    f = O.ObsFlags()
    f.set()
    try:
        jmodel, tmodel = U.tiny_models()
        jr = JRouter(jmodel, U.jax_ecfg(True), n_replicas=2,
                     fault_injector=JScripted({"replica_crash": {4}}))
        tr = EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                          device="cpu", fault_injector=U.ScriptedInjector(
                              {"replica_crash": {4}}))
        jv, tv = _crash_fleet(jr), _crash_fleet(tr)
    finally:
        f.restore()
    # the engines read their flags at construction: the rest of the
    # module runs with the flags it sets itself
    return jr, tr, jv, tv


def _flows(doc):
    return sorted((e["ph"], e["id"], e["tid"], e.get("cat"))
                  for e in doc["traceEvents"] if e["ph"] in ("s", "f"))


def test_fleet_trace_failover_flows_match_jax(fleets):
    jr, tr, jv, tv = fleets
    assert tv == jv and tv, "replica 0 held nothing: the case is vacuous"
    assert tr.fleet_stats == jr.fleet_stats
    assert tr.fleet_stats["failovers"] == 1
    assert [(e["name"], O.event_args(e)) for e in tr._tracer.events()] \
        == [(e["name"], O.event_args(e)) for e in jr._tracer.events()]
    assert tr.metrics_snapshot()["fleet"] == jr.metrics_snapshot()["fleet"]
    tdoc, jdoc = tr.fleet_chrome_trace(), jtracing.fleet_chrome_trace(jr)
    validate_chrome(tdoc)
    assert _flows(tdoc) == _flows(jdoc)
    evs = tdoc["traceEvents"]
    replica_pids = {tracing._pid(rep.engine._tracer)
                    for rep in tr._replicas}
    for rid in tv:
        span_pids = {e["pid"] for e in evs if e["ph"] == "X"
                     and e.get("args", {}).get("rid") == rid}
        assert span_pids >= replica_pids
        start = [e for e in evs if e["ph"] == "s" and e["id"] == rid]
        end = [e for e in evs if e["ph"] == "f" and e["id"] == rid]
        assert len(start) == len(end) == 1
        assert {start[0]["pid"], end[0]["pid"]} == replica_pids
        assert start[0]["ts"] <= end[0]["ts"]
    assert {e["id"] for e in evs if e["ph"] in ("s", "f")} == set(tv)
    assert {"failover", "route"} <= {e["name"] for e in evs}
    assert tr in tracing.fleets()


def test_trace_endpoints(fleets, flags):
    _, tr, _, _ = fleets
    srv = start_metrics_server(tr)
    try:
        with urllib.request.urlopen(srv.url + "/trace?fleet=1") as r:
            doc = json.loads(r.read())
        validate_chrome(doc)
        assert any(e["ph"] in ("s", "f") for e in doc["traceEvents"])
        with urllib.request.urlopen(srv.url + "/trace") as r:
            solo = json.loads(r.read())
        # the router's own control-plane stream: no request spans
        assert solo["traceEvents"]
        assert not any(e.get("cat") == "request"
                       for e in solo["traceEvents"])
    finally:
        srv.shutdown()
    # tracing off: 404, as the JAX endpoint answers
    flags.set(trace_sample=0.0)
    _, tmodel = U.tiny_models()
    eng = O.TEngine(tmodel, U.port_ecfg(False), device="cpu")
    srv = start_metrics_server(eng)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/trace")
        assert ei.value.code == 404
    finally:
        srv.shutdown()


def test_dump_cli_fleet_and_trace(fleets):
    _, tr, _, _ = fleets
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tdump.main(["--fleet"]) == 0
    mine = [o for o in json.loads(buf.getvalue())
            if o["fleet_snapshot"]["failovers"] == 1
            and o["fleet_snapshot"]["n_replicas"] == 2]
    assert mine
    validate_chrome(mine[0]["trace"])


def test_flight_recorder_attaches_trace_tail(tmp_path, flags):
    tr = tracing.Tracer(engine_id="fr-test")
    # later than any event of a still-live tracer: the tail keeps the
    # newest events process-wide
    base = time.perf_counter() + 3600.0
    for i in range(5):
        tr.step(tr.next_step(), "decode", base + i, base + i + 0.5,
                tokens_advanced=1)
    rec = tobs.FlightRecorder(capacity=4, dump_dir=str(tmp_path),
                              trace_tail=3)
    rec.record(step=1, loss=float("nan"))
    tail = json.load(open(rec.dump("nan loss")))["trace_tail"]
    assert [e["t0"] for e in tail] == [base + 2, base + 3, base + 4]
    rec2 = tobs.FlightRecorder(capacity=4, dump_dir=str(tmp_path),
                               trace_tail=0)
    rec2.record(step=1)
    assert "trace_tail" not in json.load(open(rec2.dump("x")))


def test_nan_storm_dumps_a_flight_record(tmp_path, flags):
    """A NaN-site fault writes the engine's flight record (kind
    ``serve_nan``, the program, the requeued count), with the tracer's
    events in its tail; with telemetry off nothing is written."""
    flags.set(telemetry_dump_dir=str(tmp_path))
    _, tmodel = U.tiny_models()
    inj = U.ScriptedInjector({"nan": {3}})
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu",
                    fault_injector=inj)
    eng.run(O.prompts(2), 6, max_chunk=2)
    dumps = sorted(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    rec = doc["records"][-1]
    assert rec["kind"] == "serve_nan" and rec["engine"] == eng._tel.engine_id
    assert rec["program"] in ("decode_chunk", "prefill_chunk")
    # the tail shows what this engine was doing
    assert any(e["engine"] == eng._tel.engine_id and e["name"] == "queued"
               for e in doc["trace_tail"])
    flags.set(telemetry=False, telemetry_dump_dir=str(tmp_path / "off"))
    eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu",
                    fault_injector=U.ScriptedInjector({"nan": {3}}))
    eng.run(O.prompts(2), 6, max_chunk=2)
    assert eng.resilience_stats["nan_steps"] == 1
    assert not (tmp_path / "off").exists()
