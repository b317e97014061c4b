"""The port's time series, alert rules and per-request cost attribution
against the JAX package on the CPU (the port's counterpart of
``tests/test_flight_data.py``).

``TimeSeriesStore`` and every alert rule get the same scripted inputs on
both sides and must give the same windows (deltas, rates, gauges) and
the same transitions. The JAX engine and the port's run one seeded storm
on the tiny Llama (weights carried across in float32): eight interactive
requests whose 1 us TTFT target every finish misses, seeded step faults
(``step:0.08,seed:11``), the time series at a cadence of 2 and the
degradation ladder reading the burn-rate alert
(``PT_FLAGS_slo_degradation``). Tokens, every window's counters (the
attributed ``device_ms`` aside: a time) and gauges, every alert
transition with its tick, the alert snapshot and the ladder's level are
equal, and the firing leaves its flight record. A request's attributed
cost rides its ledger across a drain handoff; cancels and timeouts
record theirs; ``/timeline``, ``dump --timeline`` and the router's fleet
timeline and alert aggregation answer."""

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
from paddle_tpu.observability import alerts as JA
from paddle_tpu.observability import timeseries as JTS
from paddle_tpu_torch.inference import (EngineRouter, FaultInjector,
                                        start_metrics_server)
from paddle_tpu_torch.observability import alerts as TA
from paddle_tpu_torch.observability import dump as tdump
from paddle_tpu_torch.observability import timeseries as TTS

pytestmark = pytest.mark.usefixtures("fresh_registries")
fresh_registries = O.fresh_registries


def _untimed(sample):
    return {k: v for k, v in sample.items() if k not in ("t", "wall_s")}


# ------------------------------------------------------------ the store
def _store_script(ts):
    st = ts.TimeSeriesStore(label="u", cadence=2, retention=3)
    vals = {"c": 0.0}
    marks = []
    for i in range(9):
        vals["c"] = 2.0 if i == 5 else vals["c"] + 3.0  # a reset at 5
        marks.append(st.on_tick(lambda: {
            "counters": dict(vals), "gauges": {"g": vals["c"]},
            "percentiles": {"p": None}}) is not None)
    return st, marks


def test_store_windows_match_jax():
    tst, tmarks = _store_script(TTS)
    jst, jmarks = _store_script(JTS)
    assert tmarks == jmarks == [False, True] * 4 + [False]
    got, want = tst.series(), jst.series()
    assert [_untimed(s) for s in got] == [_untimed(s) for s in want]
    assert [s["tick"] for s in got] == [4, 6, 8]  # retention 3
    # the reset restarts the delta from the post-reset count
    assert all(s["deltas"]["c"] >= 0 for s in got)
    snap = tst.snapshot()
    assert snap["windows"] == 3 and snap["ticks"] == 9
    got.clear()  # the reader owns its list
    assert len(tst.series()) == 3 and tst in TTS.stores()


# ------------------------------------------------------------ the rules
def _sample(tick, deltas=None, gauges=None):
    return {"tick": tick, "window_ticks": 1, "t": 0.0, "wall_s": None,
            "counters": {}, "deltas": deltas or {},
            "gauges": gauges or {}, "percentiles": {}}


def _rule_script(A):
    """Every rule over one scripted series: burn (with hysteresis),
    queue growth, KV residency, a post-seal recompile, and hit-rate and
    acceptance collapses after a healthy baseline."""
    burn = [(4, 0), (0, 4), (0, 4), (4, 0), (4, 0), (4, 0), (0, 4),
            (4, 0), (0, 4), (0, 4)]
    series = []
    for i, (met, vio) in enumerate(burn):
        t = i + 1
        deltas = {"slo_met:interactive": float(met),
                  "slo_violated:interactive": float(vio),
                  "recompiles": 1.0 if t == 4 else 0.0,
                  "prefix_hit_tokens": 6.0 if t < 6 else 0.0,
                  "prefix_prompt_tokens": 10.0,
                  "spec_accepted": 6.0 if t < 8 else 0.0,
                  "spec_proposed": 10.0}
        gauges = {"queue_depth": float(t if t < 5 else 1),
                  "kv_utilization": 0.99 if t in (7, 8) else 0.5}
        series.append(_sample(t, deltas, gauges))
    class Store:  # what the manager reads of a store
        def __init__(self):
            self.samples = []

        def last(self, n):
            return self.samples[-n:]

    st = Store()
    mgr = A.AlertManager(label="x", rules=[
        A.SLOBurnRate(budget=0.1, threshold=2.0, fire_for=2, clear_for=3),
        A.QueueDepthGrowth(windows=3, min_depth=2, fire_for=1),
        A.PrefixHitCollapse(floor=0.25, healthy=0.5, baseline_windows=2,
                            min_den=4.0, fire_for=1),
        A.SpecAcceptCollapse(floor=0.25, healthy=0.5, baseline_windows=2,
                             min_den=4.0, fire_for=1),
        A.RecompilePostSeal(), A.HbmResidency(threshold=0.9, fire_for=1)])
    log = []
    for s in series:
        st.samples.append(s)
        log.extend(mgr.evaluate(st))
    return log, mgr.snapshot()


def test_alert_rules_fire_like_jax():
    got, gsnap = _rule_script(TA)
    want, wsnap = _rule_script(JA)
    assert got == want
    assert gsnap == wsnap
    fired = {t["rule"] for t in got if t["event"] == "fire"}
    assert fired == set(TA.ALERT_RULES)
    # hysteresis: the burn fired once, after two bad windows, and cleared
    # only after three good ones
    burn = [(t["event"], t["tick"]) for t in got
            if t["rule"] == "slo_burn_rate"]
    assert burn[:2] == [("fire", 3), ("clear", 6)]


def test_rule_registry_and_refusals():
    assert TA.ALERT_RULES == JA.ALERT_RULES
    assert [type(r).__name__ for r in TA.default_rules()] \
        == [type(r).__name__ for r in JA.default_rules()]

    class Rogue(TA.AlertRule):
        name = "not_in_registry"

        def check(self, samples):
            return False, {}

    with pytest.raises(ValueError, match="ALERT_RULES"):
        TA.AlertManager(rules=[Rogue()])
    with pytest.raises(ValueError, match="duplicate"):
        TA.AlertManager(rules=[TA.SLOBurnRate(), TA.SLOBurnRate()])
    with pytest.raises(ValueError, match="fire_for"):
        TA.SLOBurnRate(fire_for=0)


# ------------------------------------------------------------ the storm
def _storm(eng):
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.add_request(rng.integers(1, 256, 10), 6, slo="interactive",
                        ttft_target_ms=0.001)
    U.drive(eng, 2)
    return eng


@pytest.fixture(scope="module")
def storms(tmp_path_factory):
    """Per cache mode: (JAX engine, port engine, their dump dirs)."""
    f = O.ObsFlags()
    out = {}
    try:
        for paged in (True, False):
            jmodel, tmodel = U.tiny_models()
            dirs = [tmp_path_factory.mktemp(f"storm_{side}_{paged}")
                    for side in ("jax", "port")]
            spec = "step:0.08,seed:11"
            f.set(timeseries=True, timeseries_cadence=2,
                  slo_degradation=True, telemetry_dump_dir=str(dirs[0]))
            jeng = _storm(O.JEngine(jmodel, U.jax_ecfg(paged),
                                    fault_injector=JInjector(spec)))
            f.set(timeseries=True, timeseries_cadence=2,
                  slo_degradation=True, telemetry_dump_dir=str(dirs[1]))
            teng = _storm(O.TEngine(tmodel, U.port_ecfg(paged),
                                    device="cpu",
                                    fault_injector=FaultInjector(spec)))
            out[paged] = (jeng, teng, dirs)
    finally:
        f.restore()
    # the engines read their flags at construction: the rest of the
    # module runs with the flags it sets itself
    return out


def _window(sample):
    s = _untimed(sample)
    s["counters"] = {k: v for k, v in s["counters"].items()
                     if k != "device_ms"}
    s["deltas"] = {k: v for k, v in s["deltas"].items() if k != "device_ms"}
    s["rates"] = {k: v for k, v in s["rates"].items() if k != "device_ms"}
    s["percentiles"] = sorted(s["percentiles"])  # names; values are times
    return s


@pytest.mark.parametrize("paged", [True, False])
def test_storm_timeline_and_alerts_match_jax(storms, paged):
    jeng, teng, dirs = storms[paged]
    assert sorted((r, q.output) for r, q in teng._finished.items()) \
        == sorted((r, q.output) for r, q in jeng._finished.items())
    tl, jl = teng.timeline_snapshot(), jeng.timeline_snapshot()
    assert tl["enabled"] and tl["windows"] == jl["windows"] > 3
    assert [_window(s) for s in tl["series"]] \
        == [_window(s) for s in jl["series"]]
    ta, ja = teng.alerts_snapshot(), jeng.alerts_snapshot()
    assert [(t["rule"], t["event"], t["tick"], t["detail"])
            for t in ta["transitions"]] \
        == [(t["rule"], t["event"], t["tick"], t["detail"])
            for t in ja["transitions"]]
    # the label is the engine id, process-wide on each side
    assert {k: v for k, v in ta.items() if k != "label"} \
        == {k: v for k, v in ja.items() if k != "label"}
    assert "slo_burn_rate" in ta["active"]
    assert ta["rules"]["slo_burn_rate"]["peak"] >= 2.0
    # the burn climbed the ladder's capacity rungs, as in JAX
    assert teng.resilience_snapshot() == jeng.resilience_snapshot()
    assert teng.backpressure()["degradation_level"] >= 1
    # the firing's flight record carries the triggering window
    for d in dirs:
        recs = [r for p in sorted(d.glob("flight_*.json"))
                for r in json.load(open(p))["records"]
                if r.get("kind") == "alert"]
        assert [r["rule"] for r in recs][:1] == ["slo_burn_rate"]
        assert recs[0]["window"] and all("deltas" in s
                                         for s in recs[0]["window"])
    # the alert's tracer event is never thinned away
    assert any(e["name"] == "alert" and e["args"]["rule"] == "slo_burn_rate"
               for e in teng._tracer.events())
    fired = O.tobs.global_registry().get("pt_serve_alerts_fired_total")
    assert fired.value(engine=teng._tel.engine_id,
                       rule="slo_burn_rate") >= 1
    # cost: every finish recorded, with JAX's counts per SLO class
    tc, jc = teng.cost_snapshot(), jeng.cost_snapshot()
    assert tc["requests_finished"] == jc["requests_finished"] == 8
    assert tc["by_slo"]["interactive"]["requests"] \
        == jc["by_slo"]["interactive"]["requests"]


def test_slo_degradation_off_leaves_the_ladder(storms):
    """The same storm with the hook off: the ladder sees the faults and
    the saturation only (JAX's level again)."""
    jeng_on, teng_on, _ = storms[True]
    f = O.ObsFlags()
    f.set(timeseries=True, timeseries_cadence=2, slo_degradation=False)
    try:
        jmodel, tmodel = U.tiny_models()
        spec = "step:0.08,seed:11"
        teng = _storm(O.TEngine(tmodel, U.port_ecfg(True), device="cpu",
                                fault_injector=FaultInjector(spec)))
    finally:
        f.restore()
    assert teng.alerts_snapshot()["rules"]["slo_burn_rate"]["fired"] >= 1
    on = teng_on.resilience_snapshot()["degradation"]
    off = teng.resilience_snapshot()["degradation"]
    assert off["transitions"] != on["transitions"]


# ------------------------------------------------------------ cost
def test_cost_rides_ledger_across_drain_handoff():
    f = O.ObsFlags()
    f.set()
    try:
        _, tmodel = U.tiny_models()
        src = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        rid = src.add_request(np.arange(1, 11), 24)
        for _ in range(3):
            src.step_chunk(2)
        summary = src.drain(deadline_ms=1.0, max_chunk=2)
        led = next(x for x in summary["unfinished"] if x["rid"] == rid)
        assert led["device_ms"] > 0
        dst = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        dst.admit_ledger(led)
        U.drive(dst, 2)
    finally:
        f.restore()
    req = dst._finished[rid]
    assert req.device_ms > led["device_ms"]  # the prior life and its own
    assert dst.cost_snapshot()["request_device_ms_total"] \
        == pytest.approx(req.device_ms)
    # the ledger's keys are the JAX engine's
    from paddle_tpu.inference.serving import request_ledger as jledger
    from paddle_tpu.inference.serving import Request as JRequest

    assert set(led) == set(jledger(JRequest(0, np.arange(3), 4)))


def test_cancel_and_timeout_record_cost():
    f = O.ObsFlags()
    f.set()
    try:
        _, tmodel = U.tiny_models()
        eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        r1 = eng.add_request(np.arange(1, 11), 24)
        r2 = eng.add_request(np.arange(2, 12), 24, deadline_ms=30.0)
        for _ in range(3):
            eng.step_chunk(2)
        assert eng.cancel(r1)
        time.sleep(0.04)
        eng.step_chunk(2)
    finally:
        f.restore()
    cs = eng.cost_snapshot()
    assert eng._finished[r1].finish_reason == "cancel"
    assert eng._finished[r2].finish_reason == "timeout"
    assert cs["requests_finished"] == 2 and eng._finished[r1].device_ms > 0
    assert cs["request_device_ms_total"] == pytest.approx(
        eng._finished[r1].device_ms + eng._finished[r2].device_ms)
    assert eng.tenant_snapshot()["tenants"]["-"]["device_ms"] \
        == pytest.approx(cs["request_device_ms_total"])


# ------------------------------------------------- endpoints and fleet
def test_timeline_endpoint_and_dump(storms):
    _, teng, _ = storms[True]
    srv = start_metrics_server(teng)
    try:
        with urllib.request.urlopen(srv.url + "/timeline") as r:
            doc = json.loads(r.read())
        assert doc["enabled"] and doc["windows"] \
            == teng.timeline_snapshot()["windows"]
    finally:
        srv.shutdown()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tdump.main(["--timeline"]) == 0
    labels = [s["label"] for s in json.loads(buf.getvalue())]
    assert teng._ts.label in labels and labels == sorted(labels)
    # off: 404, as the JAX endpoint answers
    _, tmodel = U.tiny_models()
    eng = O.TEngine(tmodel, U.port_ecfg(False), device="cpu")
    srv = start_metrics_server(eng)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/timeline")
        assert ei.value.code == 404
    finally:
        srv.shutdown()


def test_router_fleet_timeline_and_alert_aggregation():
    f = O.ObsFlags()
    f.set(timeseries=True, timeseries_cadence=2)
    try:
        _, tmodel = U.tiny_models()
        router = EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                              device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(8):
            router.add_request(rng.integers(1, 256, 10), 6,
                               slo="interactive", ttft_target_ms=0.001)
        while router.step(2):
            pass
    finally:
        f.restore()
    tl = router.timeline_snapshot()
    assert tl["enabled"] and len(tl["replicas"]) == 2
    assert tl["router"]["windows"] >= 1
    last = tl["router"]["series"][-1]
    assert last["counters"]["routed"] == 8.0
    assert last["gauges"]["n_replicas"] == 2.0
    fleet = router.fleet_snapshot()["alerts"]
    per = [rep.engine.alerts_snapshot() for rep in router._replicas]
    assert fleet["enabled"]
    assert fleet["fired"] == sum(a["fired_total"] for a in per) >= 1
    assert fleet["active"] == [{"replica": i, "rule": r}
                               for i, a in enumerate(per)
                               for r in a["active"]]
    snap = router.metrics_snapshot()
    assert snap["routed"] == 8 and snap["router"] == router._tel.router_id
