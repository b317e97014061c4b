"""The port's serving resilience layer against the JAX package on the CPU:
``FaultInjector`` fires at the same draws as JAX's for every site, with
the same spec errors; ``DegradationController`` walks the same levels;
under seeded step/nan/latency/pool storms the port engine quarantines and
replays to the JAX engine's greedy tokens and ``resilience_snapshot()``
(paged and contiguous), also with speculative decoding (held to the JAX
spec-off clean run); retry exhaustion, a hard-fault rebuild (the old
caches freed), ``auto`` letting a plain ``RuntimeError`` propagate, the
ladder's actions, drain/resume and a drain deadline, the
``request_ledger`` payload, and a JAX engine drained mid-generation whose
ledgers a port engine continues token for token. The JAX scenarios run
once per module, with telemetry off and the default ladder."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json
import time
import weakref

import numpy as np
import pytest
import torch

import torch_resilience_utils as U
from paddle_tpu import flags as jflags
from paddle_tpu.inference import resilience as jres
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatchingEngine, block_hashes
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.inference import serving as tserving

STORM = "step:0.2,nan:0.1,latency:0.05,pool:0.1"
STORM_SEED = 0
# repetitive prompts (the n-gram drafter proposes) and random ones
PROMPTS = ([np.tile(np.array([5, 9, 13, 2]), 4),
            np.tile(np.array([7, 3, 11]), 5)]
           + U.prompts(n=4, seed=2))
NEW = 8


@pytest.fixture(scope="module")
def flag_state():
    fl = U.BothFlags()
    fl.set()
    yield fl
    fl.restore()


@pytest.fixture(scope="module")
def models(flag_state):
    return U.tiny_models()


def _storm_run(eng):
    rids = [eng.add_request(p, NEW) for p in PROMPTS]
    U.drive(eng)
    return ([eng._finished[r].output for r in rids],
            [eng._finished[r].finish_reason for r in rids],
            eng.resilience_snapshot())


@pytest.fixture(scope="module")
def jax_runs(models, flag_state):
    """The JAX scenarios, once: the clean paged run, the storm in both
    cache modes, and an engine drained mid-generation."""
    jmodel, _ = models
    out = {"clean": [r.output for r in JEngine(
        jmodel, U.jax_ecfg(True, max_slots=3)).run(PROMPTS, NEW)]}
    for paged in (True, False):
        inj = jres.FaultInjector(STORM, seed=STORM_SEED, latency_ms=1.0)
        eng = JEngine(jmodel, U.jax_ecfg(paged, max_slots=3, max_retries=20),
                      fault_injector=inj)
        out[paged] = _storm_run(eng)
    src = JEngine(jmodel, U.jax_ecfg(True, max_slots=3))
    for p in PROMPTS[:3]:
        src.add_request(p, NEW)
    src.step_chunk(3)
    out["drained"] = src.drain(deadline_ms=1.0, max_chunk=2)
    return out


NEW_FLAGS = ("fault_inject", "serve_recovery", "degradation", "sanitize",
             "slo_degradation", "router_breaker_window",
             "router_breaker_trip", "router_breaker_cooldown",
             "router_retry_schedule")


@pytest.mark.parametrize("name", NEW_FLAGS)
def test_flag_defaults_match_jax(name):
    assert tflags._REGISTRY[name]["default"] \
        == jflags._REGISTRY[name]["default"]
    assert tflags._REGISTRY[name]["help"]


# ------------------------------------------------------------ injector
@pytest.mark.parametrize("site", tres.SITES)
def test_injector_fires_at_jax_draws(site):
    assert tres.SITES == jres.SITES
    assert tres.CORRUPT_SITES == jres.CORRUPT_SITES
    assert tres.ROUTER_SITES == jres.ROUTER_SITES
    other = "nan" if site != "nan" else "step"
    spec = f"{site}:0.3,{other}:0.1,seed:11"
    a, b = tres.FaultInjector(spec), jres.FaultInjector(spec)
    assert [a.fire(site) for _ in range(1000)] \
        == [b.fire(site) for _ in range(1000)]
    assert a.snapshot() == b.snapshot()
    assert 200 < a.fires[site] < 400


BAD_SPECS = ["bogus:0.5", "step:1.5", "step", "latency_ms:0", "nan:-0.1",
             "seed:x"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_injector_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jres.FaultInjector(spec)
    with pytest.raises(ValueError) as got:
        tres.FaultInjector(spec)
    assert str(got.value) == str(want.value)


def test_injector_from_flag_and_rate_dict_match_jax(flag_state):
    flag_state.set(fault_inject="step:0.25,seed:9,latency_ms:3.5")
    try:
        a, b = tres.FaultInjector.from_flag(), jres.FaultInjector.from_flag()
    finally:
        flag_state.set()
    assert a.snapshot() == b.snapshot()
    assert a.seed == 9 and a.rates["step"] == 0.25
    assert tres.FaultInjector.from_flag() is None
    a = tres.FaultInjector(rates={"leak_ref": 1.0})
    b = jres.FaultInjector(rates={"leak_ref": 1.0})
    assert a.snapshot() == b.snapshot() and a.fire("leak_ref")


def test_runtime_errors_are_device_errors_only():
    assert torch.OutOfMemoryError in tres.RUNTIME_ERRORS
    assert all(c is not RuntimeError for c in tres.RUNTIME_ERRORS)
    assert not isinstance(RuntimeError("launch failed"), tres.RUNTIME_ERRORS)


# ------------------------------------------------------------ the ladder
def _ladder_script():
    rng = np.random.default_rng(5)
    script = [(True, 0)] * 7 + [(False, 1), (False, 1)] + [(False, 0)] * 20
    script += [(bool(rng.random() < 0.5), int(rng.random() < 0.15))
               for _ in range(200)]
    return script


def test_degradation_controller_matches_jax():
    kw = dict(trip_after=3, recover_after=2, fault_window=8, fault_trip=2)
    a, b = tres.DegradationController(**kw), jres.DegradationController(**kw)
    levels = []
    for sat, faults in _ladder_script():
        la = a.observe(saturated=sat, faults=faults)
        assert la == b.observe(saturated=sat, faults=faults)
        assert a.snapshot() == b.snapshot()
        levels.append(la)
    assert set(levels) == {0, 1, 2, 3}
    for bad in (dict(trip_after=0), dict(sat_max_level=4, max_level=3)):
        with pytest.raises(ValueError) as want:
            jres.DegradationController(**bad)
        with pytest.raises(ValueError) as got:
            tres.DegradationController(**bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ replay
@pytest.mark.parametrize("paged", [True, False])
def test_storm_replay_matches_jax(models, jax_runs, paged):
    _, tmodel = models
    inj = tres.FaultInjector(STORM, seed=STORM_SEED, latency_ms=1.0)
    eng = ContinuousBatchingEngine(
        tmodel, U.port_ecfg(paged, max_slots=3, max_retries=20),
        device="cpu", fault_injector=inj)
    toks, reasons, snap = _storm_run(eng)
    want = jax_runs[paged]
    assert toks == want[0] == jax_runs["clean"]
    assert reasons == want[1] == ["max_new_tokens"] * len(PROMPTS)
    assert snap == want[2]
    assert snap["recoveries"] > 0 and snap["nan_steps"] > 0
    assert snap["faults"]["pool"] > 0 and snap["faults"]["latency"] > 0
    assert eng.metrics_snapshot()["resilience"] == snap
    U.assert_no_leaks(eng)


def test_spec_decode_storm_matches_the_spec_off_clean_run(models, jax_runs,
                                                          flag_state):
    """Quarantines during verify passes replay to the JAX spec-off clean
    tokens (the JAX spec-on arms are no oracle)."""
    _, tmodel = models
    flag_state.set(spec_decode="ngram")
    try:
        inj = tres.FaultInjector("step:0.25,nan:0.1", seed=5)
        eng = ContinuousBatchingEngine(
            tmodel, U.port_ecfg(True, max_slots=3, max_retries=20),
            device="cpu", fault_injector=inj)
        rids = [eng.add_request(p, NEW) for p in PROMPTS]
        while eng.step() or eng._queue or eng.active.any():
            pass
    finally:
        flag_state.set()
    assert [eng._finished[r].output for r in rids] == jax_runs["clean"]
    assert eng.resilience_stats["recoveries"] > 0
    assert eng.spec_stats["verify_calls"] > 0
    assert eng.resilience_stats["faults"].get("step", 0) \
        + eng.resilience_stats["faults"].get("nan", 0) \
        == eng.resilience_stats["recoveries"]
    U.assert_no_leaks(eng)


def _exhaust(eng):
    rids = [eng.add_request(p, 4) for p in PROMPTS[:3]]
    U.drive(eng)
    return ([eng._finished[r].finish_reason for r in rids],
            eng.resilience_snapshot(), eng.tenant_snapshot()["tenants"])


def test_retry_exhaustion_fails_like_jax(models, flag_state):
    jmodel, tmodel = models
    want = _exhaust(JEngine(jmodel, U.jax_ecfg(True, max_retries=1),
                            fault_injector=jres.FaultInjector("step:1.0")))
    eng = ContinuousBatchingEngine(
        tmodel, U.port_ecfg(True, max_retries=1), device="cpu",
        fault_injector=tres.FaultInjector("step:1.0"))
    got = _exhaust(eng)
    assert got[0] == want[0] == ["failed"] * 3
    assert got[1] == want[1] and got[1]["failed"] == 3
    assert got[2]["-"] == {k: want[2]["-"][k] for k in got[2]["-"]}
    U.assert_no_leaks(eng)
    # the request's own bound beats the engine's
    eng._injector = None
    rid = eng.add_request(np.arange(1, 9), 3, max_retries=0)
    U.drive(eng)
    assert eng._finished[rid].finish_reason == "max_new_tokens"


@pytest.mark.parametrize("mode,exc", [
    ("all", RuntimeError("device fell over")),
    ("auto", torch.OutOfMemoryError("CUDA out of memory"))])
def test_hard_fault_rebuilds_and_replays(models, jax_runs, flag_state, mode,
                                         exc):
    """A failure that was not injected, on the second decode chunk:
    every active request re-queues, the prefix store is dropped and the
    caches are rebuilt, no reference to the old caches survives, and
    replay gives the clean tokens."""
    _, tmodel = models
    flag_state.set(serve_recovery=mode)
    try:
        eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True,
                                                           max_slots=3),
                                       device="cpu")
    finally:
        flag_state.set()
    real = eng._decode_chunk
    calls = []
    old = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            old.append(weakref.ref(eng.caches[0].k_pages))
            raise exc
        return real(*a, **k)

    eng._decode_chunk = flaky
    rids = [eng.add_request(p, NEW) for p in PROMPTS]
    U.drive(eng, max_chunk=2)
    st = eng.resilience_stats
    assert st["rebuilds"] == 1 and st["faults"] == {"error": 1}
    assert old[0]() is None  # the old pool was freed
    assert [eng._finished[r].output for r in rids] == jax_runs["clean"]
    U.assert_no_leaks(eng)


def test_a_failing_rebuild_propagates(models, flag_state):
    """Hard recovery has no retry loop: when the rebuild itself fails (a
    dead CUDA context would), that error propagates."""
    _, tmodel = models
    flag_state.set(serve_recovery="all")
    try:
        eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True),
                                       device="cpu")
    finally:
        flag_state.set()

    def dead(*a, **k):
        raise RuntimeError("the decode forward failed")

    def no_rebuild():
        raise torch.OutOfMemoryError("the rebuild failed too")

    eng._decode_chunk = dead
    eng._init_cache_state = no_rebuild
    eng.add_request(np.arange(1, 9), 4)
    with pytest.raises(torch.OutOfMemoryError, match="rebuild failed"):
        U.drive(eng, 2)
    assert eng.resilience_stats["rebuilds"] == 1


def test_legacy_prefill_is_a_fault_seam(models, jax_runs, flag_state):
    """The bucketed prefill (``prefill_chunk=0``) quarantines an injected
    fault at its forward (the port's seam; the JAX path has none) and
    replays to the clean tokens."""
    _, tmodel = models
    flag_state.set(prefill_chunk=0)
    try:
        inj = tres.FaultInjector("step:0.3,nan:0.1", seed=2)
        eng = ContinuousBatchingEngine(
            tmodel, U.port_ecfg(True, max_slots=3, max_retries=20),
            device="cpu", fault_injector=inj)
        rids = [eng.add_request(p, NEW) for p in PROMPTS]
        U.drive(eng)
    finally:
        flag_state.set()
    assert eng.stats["prefill_bucket"] > len(PROMPTS)
    assert eng.resilience_stats["recoveries"] > 0
    assert [eng._finished[r].output for r in rids] == jax_runs["clean"]
    U.assert_no_leaks(eng)


@pytest.mark.parametrize("paged", [True, False])
def test_auto_propagates_a_plain_runtime_error(models, paged):
    """A kernel wrapper's failed launch raises a plain RuntimeError: under
    ``auto`` it propagates, nothing is recovered."""
    _, tmodel = models
    assert tflags.flag("serve_recovery") == "auto"
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(paged), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("the fused decode kernel failed to launch")

    eng._decode_chunk = boom
    eng.add_request(np.arange(1, 9), 4)
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.step_chunk(2)
    assert eng.resilience_stats["recoveries"] == 0
    assert eng.resilience_stats["rebuilds"] == 0


# ------------------------------------------------------------ the ladder
def test_min_service_keeps_tokens_and_skips_the_prefix_cache(models,
                                                            jax_runs):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True, max_slots=3),
                                   device="cpu")
    eng.run([PROMPTS[0]], 2)  # publishes the first prompt's blocks
    hits = eng.prefix_stats["hits"]
    eng._degctl.level = 3
    eng._degctl.recover_after = 10 ** 9
    assert eng.prefix_affinity_tokens(block_hashes(PROMPTS[0], 8)) == 0
    rids = [eng.add_request(p, NEW) for p in PROMPTS]
    U.drive(eng)
    assert eng.prefix_stats["hits"] == hits
    assert [eng._finished[r].output for r in rids] == jax_runs["clean"]
    bp = eng.backpressure()
    assert bp["degraded"] and bp["degradation_level"] == 3
    assert eng.metrics_snapshot()["resilience"]["degradation"]["name"] \
        == "min_service"


def test_shed_batch_defers_batch_class(models):
    """At shed_batch a queued batch-class request is deferred (kept in
    place) while interactive traffic admits past it; back at level 0 it
    admits (the JAX engine's case)."""
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(False, max_slots=1),
                                   device="cpu")
    eng._degctl.level = 1
    rb = eng.add_request(np.arange(1, 9), 3, slo="batch")
    ri = eng.add_request(np.arange(2, 9), 8, slo="interactive")
    eng.step_chunk(2)
    assert [r.rid for r in eng._slot_req.values()] == [ri]
    assert [r.rid for r in eng._queue] == [rb]
    while eng.active.any():
        eng.step_chunk(2)
    assert rb not in eng._finished  # still shed, still queued
    eng._degctl.level = 0
    U.drive(eng, 2)
    assert eng._finished[rb].finish_reason == "max_new_tokens"
    assert len(eng._finished[rb].output) == 3


def test_throttle_admits_one_a_wave_and_shortens_step_adaptive(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(False, max_slots=3),
                                   device="cpu")
    eng._degctl.level = 2
    eng._degctl.recover_after = 10 ** 9
    for p in PROMPTS[:3]:
        eng.add_request(p, NEW)
    eng._admit()
    assert int(eng.active.sum()) == 1
    ks = []
    real = eng.step_chunk
    eng.step_chunk = lambda k: ks.append(k) or real(k)
    eng.step_adaptive(6, probe_chunk=2)
    assert ks == [2]


def test_pool_site_saturates_then_heals(models):
    _, tmodel = models
    inj = tres.FaultInjector("pool:1.0")
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True), device="cpu",
                                   fault_injector=inj)
    rid = eng.add_request(np.arange(1, 9), 3)
    eng.step_chunk(2)
    assert eng._pool_blocked and eng.backpressure()["saturated"]
    assert not eng.active.any()
    inj.rates["pool"] = 0.0
    U.drive(eng, 2)
    assert len(eng._finished[rid].output) == 3
    assert eng.resilience_stats["faults"]["pool"] >= 1


# ------------------------------------------------------------ drain
def test_drain_completes_inflight_and_resume_readmits(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(False, max_slots=2),
                                   device="cpu")
    rids = [eng.add_request(p, 5) for p in U.prompts(4, seed=6)]
    eng.step_chunk(2)
    summary = eng.drain()
    unfinished = summary.pop("unfinished")
    assert summary == {"drained": True, "expired": 0, "active": 0,
                       "queued": 2}
    assert sorted(led["rid"] for led in unfinished) \
        == [r for r in rids if r not in eng._finished] == rids[2:]
    assert eng.backpressure()["draining"]
    # run() of a draining engine stops once nothing is in flight
    assert eng.run([PROMPTS[0]], 2) == []
    eng.resume()
    assert not eng.backpressure()["draining"]
    U.drive(eng)
    assert all(len(eng._finished[r].output) == 5 for r in rids)
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.drain(deadline_ms=0)


def test_drain_completes_quarantined_replays(models, jax_runs):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True, max_slots=3),
                                   device="cpu")
    rids = [eng.add_request(p, NEW) for p in PROMPTS[:3]]
    eng.step_chunk(2)
    eng._recover_step(tres.InjectedFault("step", "decode_chunk"),
                      eng.active.copy(), "decode_chunk")
    assert not eng.active.any() and eng._drain_pending()
    summary = eng.drain(max_chunk=2)
    assert summary["active"] == summary["queued"] == 0
    assert [eng._finished[r].output for r in rids] == jax_runs["clean"][:3]
    U.assert_no_leaks(eng)


def test_drain_deadline_expires_stragglers(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True), device="cpu")
    free0 = eng.pool.free_pages
    rid = eng.add_request(np.arange(1, 9), 100)
    eng.step_chunk(2)
    summary = eng.drain(deadline_ms=25.0, max_chunk=2)
    assert summary["expired"] == 1 and summary["active"] == 0
    req = eng._finished[rid]
    assert req.finish_reason == "timeout" and req.output
    assert [led["rid"] for led in summary["unfinished"]] == [rid]
    assert summary["unfinished"][0]["output"] == req.output
    assert eng.resilience_stats["timeouts"] == 1
    eng._evict_pages(10 ** 9)
    assert eng.pool.free_pages == free0 and not eng.pool.ref


def test_request_ledger_matches_jax():
    kw = dict(eos_token_id=7777, temperature=0.7, top_k=5, top_p=0.9,
              greedy=True, slo="interactive", max_retries=4, tenant="acme")
    a = tserving.build_request(3, np.arange(1, 11), 60, max_len=128, **kw)
    b = jserving.build_request(3, np.arange(1, 11), 60, max_len=128, **kw)
    for req in (a, b):
        req.output = [4, 8, 15]
        req._retries = 2
        req.ttft_ms = 12.5
        req._admit_t = req._submit_t + 0.01
    la, lb = tserving.request_ledger(a), jserving.request_ledger(b)
    assert set(la) == set(lb)
    assert U.without_instants(la) == U.without_instants(lb)
    assert la["deadline_t"] - la["submit_t"] == pytest.approx(30.0)
    json.dumps(la)


def test_jax_drain_ledgers_continue_on_a_port_engine(models, jax_runs):
    """A JAX engine drained mid-generation: a port engine admits its
    ledgers and continues token for token as the uninterrupted JAX run,
    with the first admission's TTFT."""
    _, tmodel = models
    summary = jax_runs["drained"]
    ledgers = summary["unfinished"]
    assert summary["expired"] == 3 and len(ledgers) == 3
    assert all(0 < len(led["output"]) < NEW for led in ledgers)
    dst = ContinuousBatchingEngine(tmodel, U.port_ecfg(True, max_slots=3),
                                   device="cpu")
    for led in ledgers:
        assert dst.admit_ledger(led) == led["rid"]
    with pytest.raises(ValueError, match="already owned"):
        dst.admit_ledger(ledgers[0])
    U.drive(dst, 3)
    for led, want in zip(ledgers, jax_runs["clean"]):
        got = dst._finished[led["rid"]]
        assert got.output == want
        assert got.ttft_ms == led["ttft_ms"]
        assert got._submit_t == led["submit_t"]
        assert got.finish_reason == "max_new_tokens"
    assert dst.add_request(PROMPTS[0], 2) == max(l["rid"] for l in ledgers) + 1


def test_deadline_expiry_counts_timeouts(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, U.port_ecfg(True, max_slots=1),
                                   device="cpu")
    r0 = eng.add_request(np.arange(1, 9), 24, slo="interactive")
    r1 = eng.add_request(np.arange(1, 9), 4, deadline_ms=5.0)
    eng.step_chunk(2)
    eng._slot_req[0]._deadline_t = time.perf_counter()
    time.sleep(0.006)
    eng.step_chunk(2)
    assert eng._finished[r0].finish_reason == "timeout"
    assert eng._finished[r1].finish_reason == "timeout"
    assert eng.resilience_stats["timeouts"] == 2
    assert eng.slo_snapshot()["classes"]["interactive"]["timeouts"] == 1
