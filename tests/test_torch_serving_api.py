"""The port's serving front door (``paddle_tpu_torch.serving_api``) on the
CPU: ``parse_completion_request`` and the SLO-fair scheduler held against
the JAX package's (parsed fields and errors; picks, quota blocks,
newcomer service, ``chunk_len`` and ``slot_caps`` over the fake engine
states of ``tests/test_serving_api.py``), then ``start_api_server`` over
a tiny float32 port engine on a loopback socket: SSE tokens equal the
library path's, the first chunk arrives before the finish, a client
disconnect frees every page, ``/v1/models``, ``/healthz`` (503 while
saturated), the 429 at the tenant cap, and a dying engine thread errors every
open stream and raises. Every socket and join has a timeout."""

import collections
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.inference.serving import build_request as jbuild
from paddle_tpu.serving_api import SLOFairScheduler as JScheduler
from paddle_tpu.serving_api import TenantQuota as JQuota
from paddle_tpu.serving_api import default_scheduler as jdefault
from paddle_tpu.serving_api import protocol as jprotocol
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatchingEngine, EngineConfig
from paddle_tpu_torch.inference.serving import build_request as tbuild
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving_api import (SLOFairScheduler, TenantQuota,
                                          default_scheduler, protocol,
                                          start_api_server)
from paddle_tpu_torch.serving_api import server as tserver

TIMEOUT = 60

# ------------------------------------------------------------- protocol
PARSE_CASES = [
    {"prompt": [3, 7, 11]},
    {"prompt": 5, "max_tokens": 4, "stream": True, "echo": True},
    {"prompt": [1, 2], "tenant": "acme", "slo": "interactive",
     "ttft_target_ms": 100, "tpot_target_ms": 2.5, "deadline_ms": 1000,
     "temperature": 0.7, "top_k": 5, "top_p": 0.9, "greedy": False,
     "eos_token_id": 2, "model": "m", "user": "u", "n": 1, "stop": []},
    [1, 2],
    {"prompt": [1], "max_new_tokens": 4},
    {"prompt": [1], "n": 2},
    {"prompt": [1], "stop": ["x"]},
    {"prompt": []},
    {"prompt": "hello"},
    {"prompt": [1, True]},
    {"prompt": [1], "max_tokens": 0},
    {"prompt": [1], "max_tokens": True},
    {"prompt": [1], "stream": "yes"},
    {"prompt": [1], "tenant": 5},
    {"prompt": [1], "eos_token_id": 1.5},
    {"prompt": [1], "top_k": 2.0},
    {"prompt": [1], "temperature": "hot"},
    {"prompt": [1], "deadline_ms": False},
]


def _parse(mod, body):
    try:
        creq = mod.parse_completion_request(body)
    except mod.ProtocolError as e:
        return ("error", e.status, str(e))
    d = dict(vars(creq))
    d["prompt"] = d["prompt"].tolist()
    return ("ok", d, creq.engine_kwargs())


@pytest.mark.parametrize("body", PARSE_CASES,
                         ids=[str(i) for i in range(len(PARSE_CASES))])
def test_parse_completion_request_matches_jax(body):
    assert _parse(protocol, body) == _parse(jprotocol, body)


def test_renderers_match_jax():
    chunk = protocol.completion_chunk("c", "m", [4, 5], "eos")
    want = jprotocol.completion_chunk("c", "m", [4, 5], "eos")
    for d in (chunk, want):
        d.pop("created")
    assert chunk == want
    resp = protocol.completion_response("c", "m", [4], "eos", 3, [1, 2, 3])
    want = jprotocol.completion_response("c", "m", [4], "eos", 3, [1, 2, 3])
    for d in (resp, want):
        d.pop("created")
    assert resp == want
    assert protocol.error_body("x") == jprotocol.error_body("x")
    assert protocol.SSE_DONE == jprotocol.SSE_DONE
    assert protocol.sse_data({"a": 1}) == jprotocol.sse_data({"a": 1})


# ------------------------------------------------------------ scheduler
class _FakeEngine:
    """The engine surface the policy reads (``tests/test_serving_api.py``'s
    fake; only the JAX policy reads ``_draining``)."""

    def __init__(self, max_slots=2):
        class _Cfg:
            pass

        self.cfg = _Cfg()
        self.cfg.max_slots = max_slots
        self.cfg.max_len = 256
        self.active = np.zeros(max_slots, bool)
        self.seq_lens = np.zeros(max_slots, np.int64)
        self._draining = False
        self._pool_blocked_prev = False
        self._queue = collections.deque()
        self._slot_req = {}
        self._free_heap = list(range(max_slots))
        self.pool = None


SIDES = [(jbuild, JScheduler, JQuota), (tbuild, SLOFairScheduler,
                                        TenantQuota)]


def _req(build, rid, tenant=None, slo=None, ttft=None, prompt_len=8,
         max_new=8):
    return build(rid, np.arange(1, prompt_len + 1), max_new, tenant=tenant,
                 slo=slo, ttft_target_ms=ttft, max_len=256)


def _pick_sequence(build, sched_cls, quota_cls):
    eng = _FakeEngine()
    sched = sched_cls(ttft_margin_ms=50.0)
    hog = [_req(build, i, tenant="hog") for i in range(3)]
    small = _req(build, 10, tenant="small")
    eng._queue.extend(hog + [small])
    cands = list(eng._queue)
    out = []
    first = sched.pick(eng, cands)
    out.append(first.rid)
    sched.note_admit(eng, first)
    out.append(sched.pick(eng, cands[1:]).rid)
    urgent = _req(build, 11, tenant="hog", slo="interactive", ttft=1.0)
    urgent._submit_t -= 10.0
    out.append(sched.pick(eng, [small, urgent]).rid)
    return out, dict(sched._service)


def _quota_sequence(build, sched_cls, quota_cls):
    eng = _FakeEngine(max_slots=2)
    sched = sched_cls(tenants={"a": quota_cls(weight=1.0, max_slots=1)})
    eng._slot_req[0] = _req(build, 0, tenant="a")
    queued_a, queued_b = _req(build, 1, tenant="a"), _req(build, 2,
                                                          tenant="b")
    out = [sched.pick(eng, [queued_a, queued_b]).rid,
           sched.pick(eng, [queued_a])]
    del eng._slot_req[0]
    out.append(sched.pick(eng, [queued_a]).rid)
    return out


def _newcomer(build, sched_cls, quota_cls):
    eng = _FakeEngine()
    sched = sched_cls()
    for i in range(4):
        sched.note_admit(eng, _req(build, i, tenant="old"))
    return sched._service_of("new"), dict(sched._service)


def _levers(build, sched_cls, quota_cls):
    eng = _FakeEngine()
    sched = sched_cls(probe_chunk=2, ttft_margin_ms=1e9)
    out = [sched.chunk_len(eng, 8)]
    eng._slot_req[0] = _req(build, 0, tenant="bulk", slo="batch",
                            max_new=100)
    eng.active[0] = True
    eng._queue.append(_req(build, 1, slo="interactive", ttft=100.0))
    out.append(sched.chunk_len(eng, 8))
    out.append(sched.slot_caps(eng).tolist())
    eng._slot_req[1] = _req(build, 2, tenant="bulk", slo="batch",
                            max_new=100)
    eng.active[1] = True
    out.append(sched.chunk_len(eng, 8))
    eng._slot_req[1].output.extend([1] * 97)
    out.append(sched.chunk_len(eng, 8))
    eng._queue.clear()
    out.append(sched.slot_caps(eng))
    sched2 = sched_cls(tenants={"a": quota_cls(weight=1.0, max_slots=1)},
                       probe_chunk=2, ttft_margin_ms=1e9)
    eng._slot_req[1] = _req(build, 3, tenant="a")
    eng._queue.append(_req(build, 4, tenant="a", slo="interactive",
                           ttft=100.0))
    out.append(sched2.slot_caps(eng))
    return out


@pytest.mark.parametrize("case", [_pick_sequence, _quota_sequence,
                                  _newcomer, _levers],
                         ids=["pick", "quota", "newcomer", "levers"])
def test_scheduler_matches_jax(case):
    want, got = case(*SIDES[0]), case(*SIDES[1])
    assert got == want


def test_scheduler_preemption_window_matches_jax():
    """before_admission on a full fake engine: the batch slot with the
    fewest tokens is preempted once, never twice."""
    class _Engine(_FakeEngine):
        def __init__(self):
            super().__init__()
            self.preempted = []

        def preempt(self, slot):
            self.preempted.append(slot)
            req = self._slot_req.pop(slot)
            self._queue.appendleft(req)
            return True

    out = []
    for build, sched_cls, _ in SIDES:
        eng = _Engine()
        eng._free_heap = []
        sched = sched_cls(ttft_margin_ms=1e9, preempt=True)
        for slot, n_out in ((0, 5), (1, 2)):
            eng._slot_req[slot] = _req(build, slot, slo="batch")
            eng._slot_req[slot].output.extend([1] * n_out)
        eng._queue.append(_req(build, 7, slo="interactive", ttft=100.0))
        first = sched.before_admission(eng)
        eng._slot_req[1] = eng._queue.popleft()  # re-admitted
        second = sched.before_admission(eng)
        out.append((first, eng.preempted, second, sched.snapshot()))
    assert out[1] == out[0]
    assert out[1][0] == (1,) and out[1][1] == [1, 0]


def test_quota_and_default_scheduler_errors_match_jax():
    for kw in (dict(weight=0.0), dict(max_slots=0), dict(max_pages=True)):
        with pytest.raises(ValueError) as want:
            JQuota(**kw)
        with pytest.raises(ValueError) as got:
            TenantQuota(**kw)
        assert str(got.value) == str(want.value)
    saved = jflags.flag("sched_policy"), tflags.flag("sched_policy")
    try:
        for policy in ("fifo", "slo_fair", "nope"):
            jflags.set_flags({"sched_policy": policy})
            tflags.set_flags({"sched_policy": policy})
            if policy == "nope":
                with pytest.raises(ValueError) as want:
                    jdefault()
                with pytest.raises(ValueError) as got:
                    default_scheduler()
                assert str(got.value) == str(want.value)
            else:
                assert type(default_scheduler()).__name__ \
                    == type(jdefault()).__name__
    finally:
        jflags.set_flags({"sched_policy": saved[0]})
        tflags.set_flags({"sched_policy": saved[1]})


# ------------------------------------------------------- the front door
@pytest.fixture(scope="module")
def tmodel():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=5)


@pytest.fixture
def flags_on():
    keys = ("prefill_chunk", "prefix_cache", "api_max_tenants")
    saved = {k: tflags.flag(k) for k in keys}
    tflags.set_flags({"prefill_chunk": 16, "prefix_cache": True})
    yield
    tflags.set_flags(saved)


def _engine(tmodel, **kw):
    return ContinuousBatchingEngine(
        tmodel, EngineConfig(max_slots=2, max_len=128, page_size=8,
                             paged=True, cache_dtype=torch.float32, **kw),
        device="cpu")


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _sse(url, body):
    """Stream one request; returns the token-id chunks (with the time
    each arrived), the finish reason and whether [DONE] came."""
    chunks, reason, done = [], None, False
    with _post(url, dict(body, stream=True)) as resp:
        for raw in resp:
            line = raw.strip()
            if line == b"data: [DONE]":
                done = True
                break
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if "error" in ev:
                return chunks, ("error", ev["error"]["message"]), done
            choice = ev["choices"][0]
            if choice["token_ids"]:
                chunks.append((time.perf_counter(), choice["token_ids"]))
            if choice["finish_reason"] is not None:
                reason = (time.perf_counter(), choice["finish_reason"])
    return chunks, reason, done


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pool_clean(eng):
    pool = eng.pool
    return (pool.free_pages + eng._prefix.evictable_pages(pool)
            == pool.n_pages - 1 and pool.shared_pages == 0)


def test_sse_tokens_equal_the_library_path(tmodel, flags_on):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, int(n)) for n in (9, 20, 13, 30)]
    refs = [r.output for r in _engine(tmodel).run(prompts, 12, max_chunk=2)]
    eng = _engine(tmodel)
    results = [None] * len(prompts)
    with start_api_server(eng, scheduler=SLOFairScheduler(), max_chunk=2) \
            as srv:
        def client(i):
            results[i] = _sse(srv.url, {"prompt": prompts[i].tolist(),
                                        "max_tokens": 12,
                                        "tenant": "t%d" % (i % 2),
                                        "slo": "batch"})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        # an aggregate request, with the prompt echoed
        with _post(srv.url, {"prompt": prompts[0].tolist(),
                             "max_tokens": 12, "echo": True}) as resp:
            agg = json.loads(resp.read())
        code, models = _get(srv.url, "/v1/models")
        hz_code, hz = _get(srv.url, "/healthz")
        miss = [_get(srv.url, p)[0] for p in ("/metrics", "/trace",
                                              "/timeline", "/nope")]
    for (chunks, reason, done), ref in zip(results, refs):
        assert done and reason[1] == "max_new_tokens"
        assert [t for _, ts in chunks for t in ts] == ref
        # the first tokens arrived before the request finished
        assert len(chunks) > 1 and chunks[0][0] < reason[0]
    assert agg["choices"][0]["token_ids"] == prompts[0].tolist() + refs[0]
    assert agg["usage"] == {"prompt_tokens": 9, "completion_tokens": 12,
                            "total_tokens": 21}
    assert code == 200 and models["data"][0]["id"] == "paddle-tpu"
    assert hz_code == 200 and hz["status"] == "ok"
    assert hz["backpressure"]["saturated"] is False
    assert hz["engine"]["tenants"]["scheduler"]["policy"] == "slo_fair"
    assert miss == [404] * 4
    assert _pool_clean(eng) and not eng._finished  # delivered and reaped


def test_client_disconnect_frees_every_page(tmodel, flags_on):
    eng = _engine(tmodel)
    prompt = np.random.default_rng(6).integers(1, 256, 9).tolist()
    body = json.dumps({"prompt": prompt, "max_tokens": 110,
                       "stream": True}).encode()
    with start_api_server(eng, scheduler=None, max_chunk=2) as srv:
        host, port = srv.server_address[:2]
        sock = socket.create_connection((host, port), timeout=TIMEOUT)
        f = sock.makefile("rb")
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                     % len(body) + body)
        while not f.readline().startswith(b"data: "):
            pass
        # reset the connection after the first chunk
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        f.close()
        sock.close()
        end = time.perf_counter() + TIMEOUT
        while time.perf_counter() < end:
            st = eng.tenant_snapshot()["tenants"].get("-", {})
            if st.get("cancelled", 0) + st.get("finished", 0) == 1:
                break
            time.sleep(0.02)
    st = eng.tenant_snapshot()["tenants"]["-"]
    assert st["cancelled"] == 1 and st["finished"] == 0
    assert not eng.active.any() and not eng._queue
    assert _pool_clean(eng)
    eng._evict_pages(10 ** 9)
    assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_tenant_cap_answers_429(tmodel, flags_on):
    tflags.set_flags({"api_max_tenants": 2})
    with start_api_server(_engine(tmodel), scheduler=None) as srv:
        body = {"prompt": [1, 2, 3], "max_tokens": 2}
        with _post(srv.url, dict(body, tenant="a")) as r:
            assert r.status == 200
        # a rejected request does not spend the second place
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(srv.url, dict(body, tenant="b", temperature=-1.0))
        assert bad.value.code == 400
        with _post(srv.url, dict(body, tenant="c")) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as cap:
            _post(srv.url, dict(body, tenant="d"))
        assert cap.value.code == 429
        assert "tenant cardinality cap" in json.loads(
            cap.value.read())["error"]["message"]
        with _post(srv.url, dict(body, tenant="a")) as r:
            assert r.status == 200
        with _post(srv.url, body) as r:
            assert r.status == 200


def test_concurrent_add_request_mints_unique_rids(tmodel, flags_on):
    """Handler threads submit while nothing steps: with a short switch
    interval, 16 threads x 25 requests must get 400 distinct rids and all
    400 requests queued (a lost rid update would share one)."""
    import sys

    eng = _engine(tmodel)
    rids = []
    lock = threading.Lock()

    def producer():
        got = [eng.add_request([1, 2, 3], 2, tenant="t") for _ in range(25)]
        with lock:
            rids.extend(got)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=producer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert sorted(rids) == list(range(400))
    assert sorted(r.rid for r in eng._queue) == list(range(400))


def test_healthz_saturated_and_router_target(tmodel, flags_on):
    eng = _engine(tmodel)
    for _ in range(3):
        eng.add_request([1, 2, 3], 4)
    eng._admit()  # both slots taken, one request waits
    code, body, _ = tserver.healthz(eng)
    payload = json.loads(body)
    assert code == 503 and payload["status"] == "saturated"
    assert payload["backpressure"]["queue_depth"] == 1
    assert payload["degraded"] is False and payload["degradation_level"] == 0
    with pytest.raises(TypeError, match="router"):
        start_api_server(object(), scheduler=None)


def test_dead_engine_thread_errors_every_stream(tmodel, flags_on, monkeypatch):
    eng = _engine(tmodel)
    real = eng.step_chunk
    calls = []

    def failing(k):
        calls.append(k)
        if len(calls) > 2:
            raise RuntimeError("planted engine fault")
        return real(k)

    eng.step_chunk = failing
    raised = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: raised.append(args.exc_value))
    with start_api_server(eng, scheduler=None, max_chunk=2) as srv:
        chunks, reason, done = _sse(srv.url, {"prompt": [4, 5, 6],
                                              "max_tokens": 40})
        srv.front_door._thread.join(timeout=TIMEOUT)
        with pytest.raises(urllib.error.HTTPError) as after:
            _post(srv.url, {"prompt": [1], "max_tokens": 2})
    assert reason == ("error", "RuntimeError: planted engine fault")
    assert not done
    assert after.value.code == 500
    assert [str(e) for e in raised] == ["planted engine fault"]
