"""The port's SLO, deadline, tenant and preemption surface against the JAX
engine on the CPU: ``build_request``'s accepted values and errors, the
SLO-fair scheduler driving both engines (paged and contiguous) through
two preemptions with the same admission order, finish reasons, SLO and
tenant counters and greedy tokens, deadline expiry freeing the slot and
pages, ``step_adaptive``'s chunk lengths on a step-indexed arrival
schedule, ``backpressure()`` and the ``metrics_snapshot()`` sub-documents,
and per-tenant prefix isolation with ``PT_FLAGS_tenant_prefix_namespace``
on and off. The tiny Llama's weights are carried across in float32. The
engines run with ``telemetry`` off (these cases compare the telemetry-off
documents; the observability layer is held to JAX in
``tests/test_torch_observability.py`` and its neighbours) and with
``degradation`` off; every JAX scenario runs once per module."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.serving_api import SLOFairScheduler as JScheduler
from paddle_tpu.serving_api import TenantQuota as JQuota
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        EngineConfig, block_hashes)
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving_api import SLOFairScheduler, TenantQuota

import serving_utils

JFLAGS = {"prefix_cache": True, "spec_decode": "off", "prefill_chunk": 16,
          "degradation": False, "telemetry": False,
          "tenant_prefix_namespace": True, "sched_preempt": True}
TFLAGS = {"prefix_cache": True, "spec_decode": "off", "prefill_chunk": 16,
          "degradation": False, "telemetry": False,
          "tenant_prefix_namespace": True, "sched_preempt": True}


class _Flags:
    """Sets both packages' flags and restores every one it touched."""

    def __init__(self):
        self.saved = ({k: jflags.flag(k) for k in JFLAGS},
                      {k: tflags.flag(k) for k in TFLAGS})

    def set(self, **kw):
        jflags.set_flags({**JFLAGS, **kw})
        tflags.set_flags({**TFLAGS, **kw})

    def restore(self):
        jflags.set_flags(self.saved[0])
        tflags.set_flags(self.saved[1])


@pytest.fixture(scope="module")
def flag_state():
    fl = _Flags()
    fl.set()
    yield fl
    fl.restore()


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


def _engines(models, paged, **kw):
    jmodel, tmodel = models
    jeng = JEngine(jmodel, serving_utils.tiny_ecfg(paged, **kw))
    teng = ContinuousBatchingEngine(
        tmodel, EngineConfig(max_slots=2, max_len=128, seq_buckets=(32,),
                             page_size=8, cache_dtype=torch.float32,
                             paged=paged, **kw), device="cpu")
    return jeng, teng


def _prompts(n, lo=5, hi=30, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(lo, hi)))
            for _ in range(n)]


def _drain(eng, tick, limit=400):
    for _ in range(limit):
        if not (tick() or eng._queue or eng.active.any()):
            return
    raise AssertionError("the engine did not drain")


# ------------------------------------------------------------ build_request
BUILD_CASES = [
    dict(),
    dict(tenant="acme"),
    dict(tenant="a" * 64, slo="batch"),
    dict(slo="interactive"),
    dict(slo="interactive", ttft_target_ms=10.0, deadline_ms=5.0),
    dict(ttft_target_ms=20.0),
    dict(tpot_target_ms=3.0, max_retries=0),
    dict(slo="custom", tpot_target_ms=1.5),
    dict(deadline_ms=1.0, max_retries=4),
    dict(tenant=""),
    dict(tenant="has space"),
    dict(tenant="x" * 65),
    dict(tenant="tab\tx"),
    dict(tenant="-"),
    dict(tenant=7),
    dict(slo="gold"),
    dict(slo="custom"),
    dict(ttft_target_ms=0.0),
    dict(tpot_target_ms=-1.0),
    dict(deadline_ms=0.0),
    dict(deadline_ms=0.5),
    dict(slo="batch", deadline_ms=-3.0),
    dict(max_retries=-1),
    dict(max_retries=True),
    dict(max_retries=1.5),
    dict(max_new_tokens=200),
    dict(temperature=0.0),
    dict(top_p=1.5),
]

FIELDS = ("tenant", "slo", "ttft_target_ms", "tpot_target_ms",
          "deadline_ms", "max_retries", "max_new_tokens", "temperature",
          "top_p")


def _build(mod, kw):
    kw = dict(kw)
    new = kw.pop("max_new_tokens", 8)
    try:
        req = mod.build_request(0, np.arange(1, 6), new, max_len=128, **kw)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", {f: getattr(req, f) for f in FIELDS},
            req._deadline_t - req._submit_t if req._deadline_t else 0.0)


@pytest.mark.parametrize("kw", BUILD_CASES,
                         ids=[str(i) for i in range(len(BUILD_CASES))])
def test_build_request_matches_jax(kw):
    want, got = _build(jserving, kw), _build(tserving, kw)
    assert got[:2] == want[:2]
    if got[0] == "ok":
        assert got[2] == pytest.approx(want[2], abs=1e-9)


def test_request_namespace_follows_the_flag(flag_state):
    req = tserving.build_request(0, [1, 2], 1, tenant="acme", max_len=8)
    anon = tserving.build_request(1, [1, 2], 1, max_len=8)
    assert tserving.request_namespace(req) == "acme"
    assert tserving.request_namespace(anon) == ""
    flag_state.set(tenant_prefix_namespace=False)
    try:
        assert tserving.request_namespace(req) == ""
    finally:
        flag_state.set()


# ------------------------------------------------ SLO-fair scheduling
BATCH = dict(tenant="bulk", slo="batch", ttft_target_ms=1e12,
             tpot_target_ms=1e12, deadline_ms=6e5)
INTERACTIVE = dict(tenant="acme", slo="interactive", ttft_target_ms=1e-3,
                   tpot_target_ms=1e12, deadline_ms=6e5)


def _sched_run(eng, sched_cls, quota_cls):
    """3 batch requests fill both slots; 2 interactive ones arrive at the
    third tick. The scheduler (every TTFT target 'at risk' at a margin of
    1e9 ms, the batch ones never: their targets are far beyond it)
    preempts both batch slots for them."""
    sched = sched_cls(tenants={"bulk": quota_cls(max_slots=2),
                               "acme": quota_cls(weight=2.0)},
                      ttft_margin_ms=1e9, preempt=True)
    eng.set_scheduler(sched)
    prompts = _prompts(5)
    rids = [eng.add_request(p, 14, **BATCH) for p in prompts[:3]]
    bp = None
    ticks = 0

    def tick():
        nonlocal bp, ticks
        ticks += 1
        if ticks == 3:
            rids.extend(eng.add_request(p, 6, **INTERACTIVE)
                        for p in prompts[3:])
            bp = eng.backpressure()
        return eng.step_chunk(sched.chunk_len(eng, 4))

    _drain(eng, tick)
    reqs = [eng._finished[r] for r in rids]
    order = [r.rid for r in sorted(reqs, key=lambda r: r._admit_t)]
    tenants = {k: {f: v[f] for f in ("finished", "cancelled", "timeouts",
                                     "tokens", "slo_met", "slo_violated",
                                     "preemptions", "active_slots", "pages",
                                     "queued")}
               for k, v in eng.tenant_snapshot()["tenants"].items()}
    return {"tokens": [r.output for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "slo_met": [r.slo_met for r in reqs],
            "order": order,
            "sched": eng.sched_stats,
            "slo": eng.slo_snapshot(),
            "tenants": tenants,
            "backpressure": bp,
            "prefix": eng.prefix_snapshot(),
            "metrics": eng.metrics_snapshot()}


@pytest.fixture(scope="module")
def sched_runs(models, flag_state):
    out = {}
    for paged in (True, False):
        jeng, teng = _engines(models, paged)
        out[paged] = (_sched_run(jeng, JScheduler, JQuota),
                      _sched_run(teng, SLOFairScheduler, TenantQuota), teng)
    return out


@pytest.mark.parametrize("paged", [True, False])
def test_slo_fair_preemption_matches_jax(sched_runs, paged):
    want, got, teng = sched_runs[paged]
    assert got["tokens"] == want["tokens"]
    assert all(len(t) == n for t, n in zip(got["tokens"],
                                           [14, 14, 14, 6, 6]))
    assert got["reasons"] == want["reasons"]
    assert got["order"] == want["order"]
    assert got["sched"] == want["sched"] == {"policy": "slo_fair",
                                             "preemptions": 2}
    assert got["slo_met"] == want["slo_met"] == [True] * 3 + [False] * 2
    assert got["slo"] == want["slo"]
    assert got["slo"]["classes"]["interactive"]["ttft_violations"] == 2
    assert got["tenants"] == want["tenants"]
    assert got["tenants"]["bulk"]["preemptions"] == 2
    assert got["prefix"] == want["prefix"]
    if paged:
        pool = teng.pool
        assert pool.free_pages + teng._prefix.evictable_pages(pool) \
            == pool.n_pages - 1 and pool.shared_pages == 0


@pytest.mark.parametrize("paged", [True, False])
def test_backpressure_and_metrics_snapshot_match_jax(sched_runs, paged):
    want, got, _ = sched_runs[paged]
    # both slots busy and two requests queued at the third tick
    assert got["backpressure"] == {k: want["backpressure"][k]
                                   for k in got["backpressure"]}
    assert set(got["backpressure"]) == set(want["backpressure"])
    assert got["backpressure"]["saturated"]
    tm, jm = got["metrics"], want["metrics"]
    assert set(tm) == {"telemetry", "slots", "prefix_cache",
                       "spec_decode", "slo", "tenants",
                       "resilience"} < set(jm)
    assert tm["telemetry"] == jm["telemetry"] == "off"
    for key in ("slots", "prefix_cache", "spec_decode", "slo",
                "resilience"):
        assert tm[key] == jm[key], key
    assert tm["tenants"]["scheduler"] == jm["tenants"]["scheduler"]
    for name, bucket in tm["tenants"]["tenants"].items():
        # device_ms (attributed device time) is a time: both carry it,
        # and every other counter is equal
        want_bucket = jm["tenants"]["tenants"][name]
        assert set(bucket) == set(want_bucket)
        assert {k: v for k, v in bucket.items() if k != "device_ms"} \
            == {k: want_bucket[k] for k in bucket if k != "device_ms"}


# ------------------------------------------------------------ deadlines
def _deadline_run(eng):
    """Two requests run, one waits; at the fourth tick the active slot 0
    request's and the queued request's deadlines pass."""
    rids = [eng.add_request(p, 20, deadline_ms=6e5, slo="batch")
            for p in _prompts(3, seed=5)]
    ticks = 0

    def tick():
        nonlocal ticks
        ticks += 1
        if ticks == 4:
            now = time.perf_counter()
            eng._slot_req[0]._deadline_t = now
            eng._queue[0]._deadline_t = now
        return eng.step_chunk(4)

    free = []
    for _ in range(4):
        tick()
        free.append((len(eng._free_heap),
                     eng.pool.free_pages if eng.pool is not None else None))
    _drain(eng, tick)
    reqs = [eng._finished[r] for r in rids]
    return ([r.output for r in reqs], [r.finish_reason for r in reqs],
            free, eng.slo_snapshot(), eng.tenant_snapshot()["tenants"])


@pytest.mark.parametrize("paged", [True, False])
def test_deadline_expiry_frees_slot_and_pages(models, flag_state, paged):
    jeng, teng = _engines(models, paged)
    want, got = _deadline_run(jeng), _deadline_run(teng)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[1] == ["timeout", "max_new_tokens", "timeout"]
    # after the fourth tick: slot 0 is free again and its pages are back
    assert got[2] == want[2]
    assert got[2][-1][0] == 1
    assert got[3] == want[3]
    assert got[3]["classes"]["batch"]["timeouts"] == 2
    # device_ms (attributed device time) is a time: compared as present
    assert set(got[4]["-"]) == set(want[4]["-"])
    assert {k: got[4]["-"][k] for k in got[4]["-"] if k != "device_ms"} \
        == {k: want[4]["-"][k] for k in got[4]["-"] if k != "device_ms"}
    if paged:
        assert teng.pool.free_pages + teng._prefix.evictable_pages(
            teng.pool) == teng.pool.n_pages - 1


# ------------------------------------------------------------ step_adaptive
ARRIVALS = {0: 2, 1: 1, 4: 2, 9: 1, 10: 1}  # tick -> new requests


def _adaptive_run(eng):
    ks = []
    orig = eng.step_chunk

    def spy(k):
        ks.append(k)
        return orig(k)

    eng.step_chunk = spy
    prompts = iter(_prompts(7, seed=9))
    rids = []
    for i in range(400):
        for _ in range(ARRIVALS.get(i, 0)):
            rids.append(eng.add_request(next(prompts), 7))
        busy = eng.step_adaptive(6, probe_chunk=2)
        if i > max(ARRIVALS) and not (busy or eng._queue
                                      or eng.active.any()):
            break
    return ks, [eng._finished[r].output for r in rids]


@pytest.mark.parametrize("paged", [True, False])
def test_step_adaptive_k_sequence_matches_jax(models, flag_state, paged):
    jeng, teng = _engines(models, paged)
    want, got = _adaptive_run(jeng), _adaptive_run(teng)
    assert got[0] == want[0]
    assert {2, 6} <= set(got[0])
    assert got[1] == want[1] and all(len(o) == 7 for o in got[1])


# ------------------------------------------------------ tenant namespaces
def _isolation_run(eng):
    """acme publishes a 40-token prompt; then acme and beta send it
    again. Returns the tokens, ``prefix_snapshot()`` and
    ``prefix_affinity_tokens`` of the prompt's chain in each namespace."""
    prompt = _prompts(1, lo=40, hi=41, seed=11)[0]
    outs = []
    for tenant in ("acme", "acme", "beta"):
        rid = eng.add_request(prompt, 4, tenant=tenant)
        _drain(eng, lambda: eng.step_chunk(4))
        outs.append(eng._finished[rid].output)
    affinity = [eng.prefix_affinity_tokens(block_hashes(prompt, 8, ns))
                for ns in ("acme", "beta", "", "gamma")]
    return outs, eng.prefix_snapshot(), affinity


@pytest.mark.parametrize("isolate", [True, False])
def test_tenant_prefix_isolation_matches_jax(models, flag_state, isolate):
    flag_state.set(tenant_prefix_namespace=isolate)
    try:
        jeng, teng = _engines(models, True)
        want, got = _isolation_run(jeng), _isolation_run(teng)
    finally:
        flag_state.set()
    assert got == want
    # 40 tokens = 5 blocks of 8: acme's second request hits 32 tokens of
    # its own chain (the last token is recomputed), beta's only with
    # isolation off
    assert got[1]["hits"] == (1 if isolate else 2)
    assert got[1]["hit_tokens"] == (39 if isolate else 78)
    # isolated, each tenant's chain is cached under its own namespace;
    # shared, under the default one
    assert got[2] == ([40, 40, 0, 0] if isolate else [0, 0, 40, 0])
