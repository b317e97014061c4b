"""The port's multi-engine router (``paddle_tpu_torch.inference.router``)
against the JAX package's on the CPU: the circuit breaker's states,
cooldowns and seeded jitter; a 2-replica fleet whose placement per rid
(prefix affinity, least-loaded) and, under a seeded replica-crash storm
with one scripted crash, whose tokens and fleet counters equal the JAX
router's and a single clean engine's; a hung replica opening its breaker
and a canary closing it; a flaky probe that does not flap; cancel and
deadline racing a failover; dual ownership caught by the fleet sanitizer;
the drain handoff payload; the aggregate ``/healthz``; and the front door
streaming SSE from a router to ``[DONE]``. The JAX fleet scenario runs
once per module."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json
import socket
import time

import numpy as np
import pytest

import torch_resilience_utils as U
from paddle_tpu.inference import resilience as jres
from paddle_tpu.inference import router as jrouter
from paddle_tpu_torch.analysis import SanitizerError
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.serving_api import server as tserver
from paddle_tpu_torch.serving_api import start_api_server

TIMEOUT = 60
STORM = "replica_crash:0.2,replica_hang:0.08,seed:5"


@pytest.fixture(scope="module")
def flag_state():
    fl = U.BothFlags()
    fl.set(sanitize=True)
    yield fl
    fl.restore()


@pytest.fixture(scope="module")
def models(flag_state):
    return U.tiny_models()


def _assert_fleet_no_leaks(router):
    for rep in router._replicas:
        U.assert_no_leaks(rep.engine)


# ------------------------------------------------------------ breaker
def _breaker_trace(mod, seed, idx):
    br = mod.CircuitBreaker(window=6, trip=2, cooldown=4, schedule="1,2,4",
                            rng=np.random.default_rng((0xB4EA, seed, idx)))
    rng = np.random.default_rng(seed + 100)
    out = []
    for tick in range(1, 160):
        op = rng.integers(0, 5)
        if op == 0:
            r = br.note_fault(tick)
        elif op == 1:
            r = br.trip_now(tick)
        elif op == 2:
            r = br.note_ok(tick)
        elif op == 3:
            r = br.advance(tick)
        else:
            r = br.state(tick)
        out.append((tick, int(op), r, br.snapshot(tick), br.snapshot()))
    return out


@pytest.mark.parametrize("seed,idx", [(0, 0), (0, 1), (7, 0)])
def test_breaker_matches_jax(seed, idx):
    got = _breaker_trace(trouter, seed, idx)
    assert got == _breaker_trace(jrouter, seed, idx)
    assert {s["name"] for *_, s, _ in got} == {"closed", "open",
                                               "half_open"}


def test_breaker_and_router_validation_match_jax(models):
    jmodel, tmodel = models
    for kw in (dict(n_replicas=0), dict(hang_ticks=0),
               dict(retry_schedule="1,0"), dict(breaker_trip=0)):
        with pytest.raises(ValueError) as want:
            jrouter.EngineRouter(jmodel, U.jax_ecfg(False), **kw)
        with pytest.raises(ValueError) as got:
            trouter.EngineRouter(tmodel, U.port_ecfg(False), device="cpu",
                                 **kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the fleet
def _fleet(router, injector_cls):
    """Affinity placement on a clean fleet, then a crash/hang storm with
    one scripted crash (tick 3, replica 0's consultation 4)."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 256, 24)  # 3 hash blocks
    r0 = router.add_request(np.concatenate([shared,
                                            rng.integers(1, 256, 4)]), 4)
    while router.step(2):
        pass
    followers = [router.add_request(
        np.concatenate([shared, rng.integers(1, 256, 5)]), 4)
        for _ in range(3)]
    unrelated = router.add_request(rng.integers(1, 256, 16), 4)
    placement = {rid: router._owner[rid]
                 for rid in [r0] + followers + [unrelated]}
    while router.step(2):
        pass
    clean = dict(router.fleet_stats)
    router._injector = injector_cls(STORM)
    prompts = U.prompts(6, seed=3, lo=6, hi=20)
    rids = [router.add_request(p, 8) for p in prompts]
    while router.step(2):
        pass
    results = [router.result(r) for r in rids]
    return {"placement": placement, "clean": clean,
            "tokens": [r.output for r in results],
            "reasons": [r.finish_reason for r in results],
            "owners": [router._owner[r] for r in rids],
            "fleet": router.fleet_snapshot(), "prompts": prompts}


@pytest.fixture(scope="module")
def jax_fleet(models):
    jmodel, _ = models
    return _fleet(jrouter.EngineRouter(
        jmodel, U.jax_ecfg(True, max_retries=50), n_replicas=2,
        breaker_cooldown=3), jres.FaultInjector)


@pytest.fixture(scope="module")
def port_fleet(models):
    _, tmodel = models
    router = trouter.EngineRouter(
        tmodel, U.port_ecfg(True, max_retries=50), n_replicas=2,
        breaker_cooldown=3, device="cpu")
    return _fleet(router, tres.FaultInjector), router


def test_placement_matches_jax(jax_fleet, port_fleet):
    got, _ = port_fleet
    assert got["placement"] == jax_fleet["placement"]
    warm = got["placement"][0]
    assert [got["placement"][r] for r in (1, 2, 3)] == [warm] * 3
    assert got["placement"][4] != warm
    assert got["clean"] == jax_fleet["clean"]
    assert got["clean"]["affinity_routed"] >= 3


def test_crash_storm_matches_jax_and_a_clean_engine(models, jax_fleet,
                                                    port_fleet):
    got, router = port_fleet
    _, tmodel = models
    ref = ContinuousBatchingEngine(tmodel, U.port_ecfg(True),
                                   device="cpu").run(got["prompts"], 8,
                                                     max_chunk=2)
    assert got["tokens"] == jax_fleet["tokens"] == [r.output for r in ref]
    assert got["reasons"] == ["max_new_tokens"] * 6
    assert got["owners"] == jax_fleet["owners"]
    assert got["fleet"] == jax_fleet["fleet"]
    fs = got["fleet"]
    assert fs["failovers"] >= 1 and fs["reclaimed"] >= 1
    assert fs["injector"]["fires"]["replica_hang"] >= 1
    assert router._san is not None  # the fleet sanitizer ran every tick
    _assert_fleet_no_leaks(router)


@pytest.mark.parametrize("paged", [True, False])
def test_scripted_crash_fails_over_with_original_instants(models, paged):
    _, tmodel = models
    prompts = U.prompts(4, seed=9, lo=6, hi=20)
    ref = ContinuousBatchingEngine(tmodel, U.port_ecfg(paged),
                                   device="cpu").run(prompts, 8, max_chunk=2)
    inj = U.ScriptedInjector({"replica_crash": {4}})  # tick 3, replica 0
    router = trouter.EngineRouter(tmodel, U.port_ecfg(paged), n_replicas=2,
                                  fault_injector=inj, device="cpu")
    rids = [router.add_request(p, 8, slo="interactive") for p in prompts]
    router.step(2)
    router.step(2)
    stamped = {req.rid: (req.ttft_ms, req._admit_t, req._submit_t)
               for rep in router._replicas
               for req in rep.engine._slot_req.values()}
    victims = [r.rid for r in router._replicas[0].engine._slot_req.values()]
    assert victims
    while router.step(2):
        pass
    assert router.fleet_stats["failovers"] == 1
    assert router._replicas[0].engine.resilience_stats["rebuilds"] == 1
    assert [router.result(r).output for r in rids] == [r.output for r in ref]
    for rid, instants in stamped.items():
        req = router.result(rid)
        assert (req.ttft_ms, req._admit_t, req._submit_t) == instants
    assert all(router._owner[rid] == 1 for rid in victims)
    _assert_fleet_no_leaks(router)


def test_hang_opens_the_breaker_and_a_canary_closes_it(models):
    _, tmodel = models
    prompts = U.prompts(4, seed=7, lo=6, hi=20)
    ref = ContinuousBatchingEngine(tmodel, U.port_ecfg(True),
                                   device="cpu").run(prompts, 6, max_chunk=2)
    inj = U.ScriptedInjector({"replica_hang": {2}})
    router = trouter.EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                                  fault_injector=inj, breaker_trip=2,
                                  breaker_cooldown=2, hang_ticks=4,
                                  device="cpu")
    rids = [router.add_request(p, 6) for p in prompts]
    while router.step(2):
        pass
    fs = router.fleet_snapshot()
    assert fs["breaker_opens"] >= 1 and fs["failovers"] >= 1
    assert [router.result(r).output for r in rids] == [r.output for r in ref]
    for _ in range(8):
        router.step(2)
    assert all(b["name"] == "closed"
               for b in router.fleet_snapshot()["breakers"])
    more = router.run(U.prompts(3, seed=8), 4, max_chunk=2)
    assert {router._owner[r.rid] for r in more} == {0, 1}
    _assert_fleet_no_leaks(router)


def test_flaky_probe_does_not_flap_the_breaker(models):
    _, tmodel = models
    inj = U.ScriptedInjector({"probe_flaky": {1, 40}})
    router = trouter.EngineRouter(tmodel, U.port_ecfg(False), n_replicas=2,
                                  fault_injector=inj, breaker_window=4,
                                  breaker_trip=2, device="cpu")
    assert len(router.run(U.prompts(4), 6, max_chunk=2)) == 4
    fs = router.fleet_snapshot()
    assert fs["breaker_opens"] == 0 and fs["failovers"] == 0
    assert inj.fires["probe_flaky"] >= 1


def test_device_error_escaping_the_engine_opens_the_breaker(models,
                                                            flag_state):
    """A failed device call the engine does not recover (recovery off)
    opens the breaker at once and fails the replica over; a plain
    RuntimeError propagates."""
    _, tmodel = models
    flag_state.set(sanitize=True, serve_recovery="off")
    try:
        router = trouter.EngineRouter(tmodel, U.port_ecfg(True),
                                      n_replicas=2, device="cpu")
    finally:
        flag_state.set(sanitize=True)
    prompts = U.prompts(4, seed=5, lo=6, hi=20)
    rids = [router.add_request(p, 6) for p in prompts]
    router.step(2)
    eng0 = router._replicas[0].engine
    real = eng0._step_chunk_impl
    calls = []

    def oom(k):
        calls.append(k)
        if len(calls) == 1:
            raise tres.RUNTIME_ERRORS[0]("CUDA out of memory")
        return real(k)

    eng0._step_chunk_impl = oom
    while router.step(2):
        pass
    fs = router.fleet_snapshot()
    assert fs["failovers"] == 1 and fs["breakers"][0]["opens"] == 1
    assert eng0.resilience_stats["rebuilds"] == 1
    assert all(router.result(r).finish_reason == "max_new_tokens"
               for r in rids)

    def boom(k):
        raise RuntimeError("host bug")

    router._replicas[1].engine._step_chunk_impl = boom
    router.add_request(prompts[0], 2)
    with pytest.raises(RuntimeError, match="host bug"):
        for _ in range(20):
            router.step(2)


def test_cancel_and_deadline_during_failover_never_replay(models):
    _, tmodel = models
    prompts = U.prompts(4, seed=13, lo=8, hi=12)
    inj = U.ScriptedInjector({"replica_crash": {4}})
    router = trouter.EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                                  fault_injector=inj, device="cpu")
    rids = [router.add_request(p, 20) for p in prompts]
    doomed = router.add_request(prompts[0], 20, deadline_ms=1.0)
    router.step(2)
    router.step(2)
    vic = next(iter(router._replicas[0].engine._slot_req.values())).rid
    assert router.cancel(vic)
    time.sleep(0.005)
    while router.step(2):
        pass
    assert router.fleet_stats["failovers"] == 1
    assert router.result(vic).finish_reason == "cancel"
    assert router.result(doomed).finish_reason == "timeout"
    regs = [router._finished] + [r.engine._finished
                                 for r in router._replicas]
    for rid in rids + [doomed]:
        assert sum(rid in reg for reg in regs) == 1, rid
    _assert_fleet_no_leaks(router)


def test_fleet_sanitizer_catches_dual_ownership(models):
    _, tmodel = models
    router = trouter.EngineRouter(tmodel, U.port_ecfg(False), n_replicas=2,
                                  device="cpu")
    rid = router.add_request(np.arange(1, 9), 16)
    owner = router._owner[rid]
    req = next(r for r in router._replicas[owner].engine._queue
               if r.rid == rid)
    router._replicas[1 - owner].engine._queue.append(req)
    with pytest.raises(SanitizerError, match="rid-ownership"):
        router.step(2)


def test_router_drain_returns_the_fleet_handoff_payload(models):
    _, tmodel = models
    router = trouter.EngineRouter(tmodel, U.port_ecfg(False, max_slots=1),
                                  n_replicas=2, device="cpu")
    rng = np.random.default_rng(2)
    rids = [router.add_request(rng.integers(1, 256, 8), 30)
            for _ in range(3)]
    router.step(2)
    summary = router.drain(deadline_ms=10.0, max_chunk=2)
    assert summary["drained"] and summary["expired"] >= 1
    done = {r for r in rids if router.result(r) is not None
            and router.result(r).finish_reason == "max_new_tokens"}
    assert {led["rid"] for led in summary["unfinished"]} == set(rids) - done
    assert router.backpressure()["draining"]
    code, body, _ = tserver.healthz(router)
    assert code == 503 and json.loads(body)["status"] == "draining"
    # a fresh fleet continues the ledgers
    router.resume()
    assert not router.backpressure()["draining"]
    dst = ContinuousBatchingEngine(tmodel, U.port_ecfg(False, max_slots=2),
                                   device="cpu")
    for led in summary["unfinished"]:
        dst.admit_ledger(led)
    U.drive(dst, 2)
    assert all(len(dst._finished[led["rid"]].output) == 30
               for led in summary["unfinished"])


def test_aggregate_healthz_and_snapshots(models):
    _, tmodel = models
    router = trouter.EngineRouter(tmodel, U.port_ecfg(False), n_replicas=2,
                                  device="cpu")
    router.run(U.prompts(2), 3)
    code, body, _ = tserver.healthz(router)
    hz = json.loads(body)
    assert code == 200 and hz["status"] == "ok"
    assert hz["degradation_level"] == 0
    bp = hz["backpressure"]
    assert bp["routable_replicas"] == 2 and len(bp["replicas"]) == 2
    assert all(r["breaker"] == "closed" for r in bp["replicas"])
    assert len(hz["engine"]["replicas"]) == 2
    snap = router.metrics_snapshot()
    assert snap["telemetry"] == "off"
    assert {"fleet", "slo", "tenants", "replicas"} <= set(snap)
    assert all("resilience" in r for r in snap["replicas"])
    assert router.timeline_snapshot() == {"enabled": False}
    assert router.fleet_chrome_trace() == {"traceEvents": [],
                                           "displayTimeUnit": "ms"}


def _sse(url, body):
    """POST a streaming completion over a raw socket; (token chunks,
    finish reason, saw [DONE])."""
    host, port = url.split("//")[1].split(":")
    payload = json.dumps(body).encode()
    with socket.create_connection((host, int(port)), timeout=TIMEOUT) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                  + payload)
        data = b""
        while b"data: [DONE]" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    tokens, reason = [], None
    for line in data.decode().split("\n"):
        if not line.startswith("data: {"):
            continue
        choice = json.loads(line[6:])["choices"][0]
        tokens += choice.get("token_ids") or []
        reason = choice.get("finish_reason") or reason
    return tokens, reason, b"data: [DONE]" in data


def test_front_door_streams_from_a_router(models):
    _, tmodel = models
    prompts = U.prompts(3, seed=4)
    ref = ContinuousBatchingEngine(tmodel, U.port_ecfg(True),
                                   device="cpu").run(prompts, 6)
    router = trouter.EngineRouter(tmodel, U.port_ecfg(True), n_replicas=2,
                                  device="cpu")
    with start_api_server(router, scheduler=None, max_chunk=2) as srv:
        assert srv.front_door._is_router
        outs = [_sse(srv.url, {"prompt": [int(t) for t in p],
                               "max_tokens": 6, "stream": True})
                for p in prompts]
    for (tokens, reason, done), r in zip(outs, ref):
        assert tokens == r.output and reason == "max_new_tokens" and done
    # delivered requests are reaped from the router and its replicas
    assert not router._finished and not router._owner
    assert all(not rep.engine._finished for rep in router._replicas)
