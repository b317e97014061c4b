"""The port's metrics registry, serving and train telemetry, flight
recorder and dump CLI against the JAX package on the CPU (the port's
counterpart of ``tests/test_observability.py``).

The registries get the same operations and must expose the same text and
snapshot. The JAX engine and the port's run the same seeded arrivals on
the tiny Llama (weights carried across in float32), paged and contiguous,
with JAX's default observability flags: every sample name and label set,
every counter, every histogram count, ``hbm_snapshot()``,
``recompile_snapshot()``, ``cost_snapshot()``'s request counts and the
``metrics_snapshot()`` keys are equal (times are not compared). With
``telemetry`` off the port's document is the host sub-documents alone
and no series is made. A tick with telemetry, tracing, the time series
and alerts on calls no more tensor sync methods than a tick with them
off. ``TrainStep(telemetry=...)``'s sampled loss and grad norm match the
JAX step's within rtol 1e-5."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import io
import json
import re
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_obs_utils as O
import torch_resilience_utils as U
from paddle_tpu import distributed as jdist
from paddle_tpu import observability as jobs
from paddle_tpu import optimizer as jopt
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.inference import EngineRouter, start_metrics_server
from paddle_tpu_torch.observability import dump as tdump
from paddle_tpu_torch.serving_api import start_api_server
from paddle_tpu_torch.trainer import TrainStep

pytestmark = pytest.mark.usefixtures("fresh_registries")
fresh_registries = O.fresh_registries


@pytest.fixture(scope="module")
def obs_runs():
    """Per cache mode: (JAX engine, port engine, their requests and the
    exposition texts after the run), observability as in JAX's defaults
    plus the time series, alerts and the profiler on."""
    flags = O.ObsFlags()
    flags.set(profile_programs=True, profile_sample_every=2,
              timeseries=True, timeseries_cadence=2)
    try:
        out = {}
        for paged in (True, False):
            jeng, teng = O.engines(paged)
            jreqs = O.run(jeng, O.mixed_prompts())
            treqs = O.run(teng, O.mixed_prompts())
            out[paged] = (jeng, teng, jreqs, treqs,
                          jobs.global_registry().prometheus_text(),
                          tobs.global_registry().prometheus_text())
    finally:
        flags.restore()
    # the engines read their flags at construction: the rest of the
    # module runs with the flags it sets itself
    return out


@pytest.fixture
def telemetry_on():
    flags = O.ObsFlags()
    flags.set()
    yield flags
    flags.restore()


# ---------------------------------------------------------------- registry
def _drive_registry(reg):
    c = reg.counter("pt_test_total", "a counter", labels=("k",))
    c.inc(k="a")
    c.inc(2.5, k="b")
    g = reg.gauge("pt_test_gauge", "a gauge")
    g.set(3)
    g.set_max(1)
    g.set_max(7.25)
    g.dec(0.25)
    h = reg.histogram("pt_test_ms", 'a "histogram"\nwith a newline',
                      labels=("engine",), buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 9.0, 2.0):
        h.observe(v, engine="e\\1")
    reg.histogram("pt_default_ms", "default edges").observe(33.0)
    return c, g, h


def test_registry_exposition_and_snapshot_match_jax():
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _drive_registry(jreg)
    c, g, h = _drive_registry(treg)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert tobs.exp_buckets(0.05, 2.0, 20) == jobs.exp_buckets(0.05, 2.0, 20)
    assert c.value(k="b") == 2.5 and g.value() == 7.0
    assert h.percentile(50, engine="e\\1") == 2.0
    h.reset_window(engine="e\\1")
    assert h.percentile(50, engine="e\\1") is None
    assert h.count(engine="e\\1") == 5  # totals survive a window reset
    # the same refusals as JAX's
    for reg in (jreg, treg):
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.get("pt_test_total").inc(-1, k="a")
        with pytest.raises(ValueError, match="declared labels"):
            reg.get("pt_test_total").inc(q="a")
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("pt_test_total")
        with pytest.raises(ValueError, match="different buckets"):
            reg.histogram("pt_test_ms", labels=("engine",), buckets=(1.0,))
        with pytest.raises(ValueError, match="strictly"):
            reg.histogram("pt_bad_ms", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        tobs.exp_buckets(0, 2, 3)
    # the port's registry is its own
    assert tobs.global_registry() is not jobs.global_registry()


def test_null_registry_when_disabled():
    saved = tflags.flag("telemetry")
    tflags.set_flags({"telemetry": False})
    try:
        reg = tobs.get_registry()
        assert isinstance(reg, tobs.NullRegistry)
        c = reg.counter("nope_total", "x")
        c.inc(100)
        assert c.value() == 0.0 and reg.gauge("other") is c
        reg.histogram("nope_ms").observe(5.0)
        assert reg.prometheus_text() == "" and reg.snapshot() == {}
    finally:
        tflags.set_flags({"telemetry": saved})


# ------------------------------------------------------- serving parity
@pytest.mark.parametrize("paged", [True, False])
def test_engine_exposition_matches_jax(obs_runs, paged):
    """Sample names, label sets, counter values and histogram counts of
    one engine's series: exact."""
    jeng, teng, jreqs, treqs, jtext, ttext = obs_runs[paged]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    jkeys, jvals = O.untimed(jtext, "engine", jeng._tel.engine_id)
    tkeys, tvals = O.untimed(ttext, "engine", teng._tel.engine_id)
    assert tkeys == jkeys
    assert tvals == jvals
    names = {k[0] for k in tkeys}
    for want in ("pt_serve_ttft_ms_bucket", "pt_serve_tokens_generated_total",
                 "pt_serve_prefix_cache_hits_total", "pt_serve_hbm_bytes",
                 "pt_serve_program_ms_count",
                 "pt_serve_request_device_ms_count"):
        assert want in names, want
    # the types and help lines of the series this engine made
    jt, tt = O.types(jtext), O.types(ttext)
    assert {n: tt[n] for n in tt if n in jt} == {n: jt[n] for n in tt
                                                 if n in jt}
    assert tvals[("pt_serve_requests_finished_total",
                  (("engine", "*"),))] == 5


@pytest.mark.parametrize("paged", [True, False])
def test_engine_snapshots_match_jax(obs_runs, paged):
    jeng, teng, *_ = obs_runs[paged]
    jm, tm = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert set(tm) == set(jm)
    assert set(tm["hbm"]) == set(jm["hbm"])
    for key in ("slots", "prefix_cache", "spec_decode", "slo",
                "resilience", "recompile", "hbm"):
        assert tm[key] == jm[key], key
    assert tm["requests"] == jm["requests"]
    assert tm["tokens_generated"] == jm["tokens_generated"]
    assert tm["ttft_ms"]["count"] == jm["ttft_ms"]["count"] == 5
    for key in ("queue_depth", "batch_occupancy", "kv_pool"):
        assert tm[key] == jm[key], key
    assert tm["audit"] == jm["audit"] == {"enabled": False}
    assert teng.hbm_snapshot() == jeng.hbm_snapshot()
    assert teng.recompile_snapshot() == jeng.recompile_snapshot()
    tc, jc = teng.cost_snapshot(), jeng.cost_snapshot()
    assert set(tc) == set(jc)
    assert tc["requests_finished"] == jc["requests_finished"] == 5
    assert {k: v["requests"] for k, v in tc["by_slo"].items()} \
        == {k: v["requests"] for k, v in jc["by_slo"].items()}
    assert set(tc["attributed_ms"]) == set(jc["attributed_ms"])
    # every finished request carries its attributed cost
    assert all(r.device_ms > 0 for r in teng._finished.values())
    # the tenant buckets: every counter equal, device_ms a time
    for name, bucket in tm["tenants"]["tenants"].items():
        want = jm["tenants"]["tenants"][name]
        assert set(bucket) == set(want)
        assert {k: v for k, v in bucket.items() if k != "device_ms"} \
            == {k: v for k, v in want.items() if k != "device_ms"}


def test_telemetry_off_is_todays_document(telemetry_on):
    """Off: no telemetry, tracer or registry series; the document is the
    host sub-documents, each equal to JAX's."""
    telemetry_on.set(telemetry=False)
    before = tobs.global_registry().prometheus_text()
    jeng, teng = O.engines(True)
    jreqs = O.run(jeng, O.prompts(3))
    treqs = O.run(teng, O.prompts(3))
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng._tel is None and teng._tracer is None
    assert tobs.global_registry().prometheus_text() == before
    tm, jm = teng.metrics_snapshot(), jeng.metrics_snapshot()
    assert set(tm) == {"telemetry", "slots", "prefix_cache",
                       "spec_decode", "slo", "tenants", "resilience"}
    assert tm["telemetry"] == jm["telemetry"] == "off"
    for key in ("slots", "prefix_cache", "spec_decode", "slo",
                "resilience"):
        assert tm[key] == jm[key], key
    # the readers stay callable one by one, with JAX's telemetry-off
    # values
    assert teng.hbm_snapshot() == jeng.hbm_snapshot()
    assert teng.recompile_snapshot() == jeng.recompile_snapshot()
    assert teng.profile_snapshot() == jeng.profile_snapshot() \
        == {"enabled": False}
    assert teng.alerts_snapshot() == jeng.alerts_snapshot()
    assert teng.timeline_snapshot() == jeng.timeline_snapshot()


def test_serving_telemetry_per_engine_isolation(telemetry_on):
    a, b = tobs.ServingTelemetry(), tobs.ServingTelemetry()
    a.on_submit(3)
    a.on_admit(10.0)
    b.on_submit(1)
    assert a.snapshot()["queue_depth"]["peak"] == 3
    assert b.snapshot()["queue_depth"]["peak"] == 1
    a.window_reset()
    assert a.snapshot()["ttft_ms"]["count"] == 0
    assert a.snapshot()["queue_depth"]["peak"] == 0
    assert b.snapshot()["queue_depth"]["peak"] == 1
    assert a.snapshot()["requests"]["submitted"] == 1
    assert tobs.global_registry().get("pt_serve_ttft_ms").count(
        engine=a.engine_id) == 1


SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
         "__float__", "__index__")


def _sync_counts(monkeypatch, paged, **flags):
    """Tensor sync-method calls of each tick of one seeded run."""
    f = O.ObsFlags()
    f.set(**flags)
    try:
        _, tmodel = U.tiny_models()
        eng = O.TEngine(tmodel, U.port_ecfg(paged), device="cpu")
        for p in O.mixed_prompts():
            eng.add_request(p, 6)
        calls = []
        with monkeypatch.context() as m:
            for name in SYNCS:
                real = getattr(torch.Tensor, name)

                def spy(self, *a, _name=name, _real=real, **k):
                    calls.append(_name)
                    return _real(self, *a, **k)

                m.setattr(torch.Tensor, name, spy)
            ticks = []
            while True:
                n = len(calls)
                more = eng.step_chunk(4)
                ticks.append(len(calls) - n)
                if not (more or eng._queue or eng.active.any()):
                    break
        return ticks, eng
    finally:
        f.restore()


@pytest.mark.parametrize("paged", [True, False])
def test_observability_adds_no_device_sync(monkeypatch, paged):
    """Every tensor method that would sync the host with the card is
    counted each tick: telemetry, tracing, the time series, alerts, cost
    attribution and an unsampled profiler call none of them."""
    off, _ = _sync_counts(monkeypatch, paged, telemetry=False,
                          cost_attribution=False, recompile_watchdog=False)
    on, eng = _sync_counts(monkeypatch, paged, timeseries=True,
                           timeseries_cadence=1, profile_programs=True,
                           profile_sample_every=10 ** 6)
    assert on == off
    assert eng._tracer is not None and len(eng.timeline_snapshot()
                                           ["series"]) == len(on)
    # sampled on every dispatch: the CPU's host stamps sync nothing either
    sampled, eng = _sync_counts(monkeypatch, paged, timeseries=True,
                                profile_programs=True,
                                profile_sample_every=1)
    assert sampled == off
    assert all(p["sampled"] == p["dispatches"] for p in
               eng.profile_snapshot()["programs"].values())


def test_metrics_endpoint_and_front_door(obs_runs, telemetry_on):
    jeng, teng, *_ = obs_runs[True]
    srv = start_metrics_server(teng, port=0)
    try:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        assert re.search(r'pt_serve_requests_finished_total\{engine="'
                         + teng._tel.engine_id + r'"\} 5', text)
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            hz = json.loads(r.read())
        assert hz["status"] == "ok" and hz["telemetry"] is True
        assert hz["engine"]["requests"]["finished"] == 5
        with urllib.request.urlopen(srv.url + "/timeline", timeout=10) as r:
            assert json.loads(r.read())["windows"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.shutdown()
        srv.shutdown()  # idempotent


def _status(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("fleet", [False, True])
def test_front_door_serves_metrics_trace_timeline(fleet):
    """The front door over an engine and over a 2-replica router, JAX's
    defaults plus the time series: ``/metrics`` (the served requests
    counted), ``/trace`` (``?fleet=1`` on the router: their spans) and
    ``/timeline`` answer 200; with tracing and the time series off,
    ``/trace`` and ``/timeline`` answer 404 where JAX's do (a router's
    merged ``?fleet=1`` document stays 200, empty, as in JAX)."""
    f = O.ObsFlags()
    _, tmodel = U.tiny_models()
    try:
        for on in (True, False):
            f.set(timeseries=on, timeseries_cadence=2,
                  trace_sample=1.0 if on else 0.0)
            target = (EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                                   device="cpu") if fleet
                      else O.TEngine(tmodel, U.port_ecfg(True),
                                     device="cpu"))
            engines = ([rep.engine for rep in target._replicas] if fleet
                       else [target])
            with start_api_server(target, max_chunk=4) as srv:
                for p in O.prompts(2):
                    req = urllib.request.Request(
                        srv.url + "/v1/completions",
                        data=json.dumps({"prompt": p.tolist(),
                                         "max_tokens": 4}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        assert len(json.loads(r.read())["choices"][0]
                                   ["token_ids"]) == 4
                got = {path: _status(srv.url, path) for path in (
                    "/metrics", "/trace", "/trace?fleet=1", "/timeline")}
            assert got["/metrics"][0] == 200
            finished = sum(
                v for eng in engines for (name, _), v in O.untimed(
                    got["/metrics"][1].decode(), "engine",
                    eng._tel.engine_id)[1].items()
                if name == "pt_serve_requests_finished_total")
            assert finished == 2
            trace_path = "/trace?fleet=1" if fleet else "/trace"
            if on:
                assert {p: c for p, (c, _) in got.items()} == dict.fromkeys(
                    got, 200)
                spans = [e for e in json.loads(got[trace_path][1])
                         ["traceEvents"] if e["name"] == "active"]
                assert len(spans) == 2
                assert json.loads(got["/timeline"][1])["enabled"]
            else:
                assert got["/trace"][0] == got["/timeline"][0] == 404
                assert got["/trace?fleet=1"][0] == (200 if fleet else 404)
    finally:
        f.restore()


# ------------------------------------------------------- train telemetry
def _train_pair(tmp_path):
    import paddle_tpu as pt
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JModel
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    pt.seed(3)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(tmodel, {k: np.asarray(v) for k, v
                                   in jmodel.state_dict().items()})
    opt = dict(learning_rate=3e-3, weight_decay=0.01, multi_precision=True)
    kw = dict(sample_every=2, flight_window=8, dump_dir=str(tmp_path))
    js = JTrainStep(jmodel, jopt.AdamW(**opt),
                    jdist.build_mesh(devices=jax.devices()[:1]),
                    telemetry=jobs.TrainTelemetry(**kw))
    ts = TrainStep(tmodel, topt.AdamW(**opt),
                   telemetry=tobs.TrainTelemetry(**kw))
    return js, ts


def test_train_telemetry_matches_jax(telemetry_on, tmp_path):
    """Four steps, sampled every second: the sampled loss and grad norm
    within rtol 1e-5 of the JAX step's, the same record fields, counters
    and step histogram count; no MFU on the CPU (no peak)."""
    js, ts = _train_pair(tmp_path)
    treg, jreg = tobs.global_registry(), jobs.global_registry()
    before = {name: (treg.get(name).value() if treg.get(name) else 0.0,
                     jreg.get(name).value() if jreg.get(name) else 0.0)
              for name in ("pt_train_steps_total", "pt_train_tokens_total")}
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    batch = {"input_ids": ids, "labels": ids}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(4):
        js.run(jbatch)
        ts.run(batch)
    jt, tt = js.telemetry, ts.telemetry
    assert tt.samples == jt.samples == 2
    assert [sorted(r) for r in tt.recorder.records()] \
        == [sorted(r) for r in jt.recorder.records()]
    for got, want in zip(tt.recorder.records(), jt.recorder.records()):
        assert got["step"] == want["step"] and got["tokens"] == 32
        if "loss" in want:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
    assert "mfu_est" not in tt.last_sample
    for name, want in (("pt_train_steps_total", 4),
                       ("pt_train_tokens_total", 4 * 32)):
        assert treg.get(name).value() - before[name][0] \
            == jreg.get(name).value() - before[name][1] == want
    assert treg.get("pt_train_step_ms").count() >= 4
    np.testing.assert_allclose(treg.get("pt_train_loss").value(),
                               jreg.get("pt_train_loss").value(), rtol=1e-5)
    assert ts.last_grad_norm is not None


def test_train_step_telemetry_default_and_off(telemetry_on):
    _, tmodel = U.tiny_models()
    import copy

    model = copy.deepcopy(tmodel)
    ts = TrainStep(model, topt.AdamW(learning_rate=1e-3))
    assert isinstance(ts.telemetry, tobs.TrainTelemetry)
    off = TrainStep(model, topt.AdamW(learning_rate=1e-3), telemetry=False)
    ids = np.arange(32).reshape(2, 16)
    off.run({"input_ids": ids, "labels": ids})
    # no telemetry, no debug flag: the step keeps no norm
    assert off.telemetry is None and off.last_grad_norm is None
    telemetry_on.set(telemetry=False)
    assert TrainStep(model, topt.AdamW()).telemetry is None


def test_flight_recorder_and_anomaly_watchdog(tmp_path, telemetry_on):
    rec = tobs.FlightRecorder(capacity=3, dump_dir=str(tmp_path))
    wd = tobs.AnomalyWatchdog(rec, spike_factor=5.0, min_history=3)
    for step, gn in enumerate([1.0, 1.1, 0.9, 1.0]):
        rec.record(step=step)
        assert wd.check(step, 2.0, gn) is None
    path = wd.check(4, 2.0, 50.0)
    assert path and "spike" in wd.tripped[-1][1]
    doc = json.load(open(path))
    assert doc["n_records"] == 3 and [r["step"] for r in doc["records"]] \
        == [1, 2, 3]
    path = wd.check(5, float("nan"), 1.0)
    assert "non-finite loss" in json.load(open(path))["reason"]
    assert tobs.global_registry().get("pt_train_anomalies_total").value() \
        >= 2


def test_log_memory_stats_and_record_scalars(telemetry_on, tmp_path):
    """On the CPU there are no card statistics: the flag records none
    (JAX's CPU device reports none either)."""
    telemetry_on.set(log_memory_stats=True)
    tel = tobs.TrainTelemetry(sample_every=1, dump_dir=str(tmp_path))
    tel.on_step(1, torch.tensor(2.0), torch.tensor(1.0), tokens=8,
                wall_s=0.01)
    assert "memory" not in tel.last_sample
    assert tel.last_sample["loss"] == 2.0
    tobs.record_scalars("eval", {"acc": [0.5], "name": "x", "n": 3})
    reg = tobs.global_registry()
    assert reg.get("pt_eval_acc").value() == 0.5
    assert reg.get("pt_eval_n").value() == 3 and reg.get("pt_eval_name") \
        is None


def test_collective_accounting_matches_jax(telemetry_on):
    x = np.zeros((4, 8), np.float32)
    tobs.reset_comm_log()
    jobs.reset_comm_log()
    tobs.record_collective("all_reduce", "dp", torch.as_tensor(x))
    jobs.record_collective("all_reduce", "dp", jnp.asarray(x))
    got, want = tobs.comm_log(), jobs.comm_log()
    assert len(got) == len(want) == 1
    assert {k: v for k, v in got[0].items() if k != "site"} \
        == {k: v for k, v in want[0].items() if k != "site"}
    assert got[0]["bytes"] == 128
    tobs.reset_comm_log()
    jobs.reset_comm_log()
    assert tobs.comm_log() == []


def test_dump_cli(obs_runs, telemetry_on):
    def main(*argv):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert tdump.main(list(argv)) == 0
        return buf.getvalue()

    doc = json.loads(main("--no-device"))
    assert doc["telemetry_enabled"] is True
    assert "pt_serve_ttft_ms" in doc["metrics"]
    assert isinstance(doc["collectives"], list)
    assert "pt_serve_tokens_generated_total" in main("--prometheus")
    trace = json.loads(main("--trace"))
    assert any(e.get("cat") == "request" for e in trace["traceEvents"])
    assert main("--trace-jsonl").strip()
    timeline = json.loads(main("--timeline"))
    assert any(s["windows"] >= 1 for s in timeline)
    assert isinstance(json.loads(main("--fleet")), list)
