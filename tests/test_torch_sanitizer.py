"""The port's runtime invariant sanitizer (``paddle_tpu_torch.analysis``)
against the JAX package's on the CPU: each corruption site (``seq_shrink``,
``leak_ref`` paged and contiguous, ``scale_desync`` on int8 caches) is
caught at the same tick with the same invariant name as in the JAX
engine; sanitize off constructs nothing and sanitize on changes no token;
foreign-thread reads and a second-thread tick; every ``SAFE_READS`` name
is a reader of the port's engine or router; and no check synchronizes with
the device (no ``.item()``/``.cpu()``/``.tolist()``/``.numpy()`` of a
tensor, and the checks pass over ``meta`` caches)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import threading

import numpy as np
import pytest
import torch

import torch_resilience_utils as U
from paddle_tpu.analysis import sanitizer as jsan
from paddle_tpu.inference import resilience as jres
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.analysis import SAFE_READS, SanitizerError
from paddle_tpu_torch.inference import ContinuousBatchingEngine, EngineRouter
from paddle_tpu_torch.inference import resilience as tres
from paddle_tpu_torch.inference.paged import PagedLayerCache, QuantizedKV

PROMPT = np.arange(3, 12)

# (site, paged, cache dtype); the JAX engine is run on each
CASES = [("seq_shrink", False, None), ("leak_ref", True, None),
         ("leak_ref", False, None), ("scale_desync", True, "int8")]


@pytest.fixture(scope="module")
def flag_state():
    fl = U.BothFlags()
    fl.set(sanitize=True)
    yield fl
    fl.restore()


@pytest.fixture(scope="module")
def models(flag_state):
    return U.tiny_models()


def _caught(eng, limit=20):
    """(tick, invariant, site) of the first SanitizerError."""
    eng.add_request(PROMPT, 8)
    for tick in range(1, limit + 1):
        try:
            eng.step_chunk(4)
        except (SanitizerError, jsan.SanitizerError) as e:
            return tick, e.invariant, e.site, type(e).__name__
    raise AssertionError("no invariant tripped")


def _kw(dtype):
    return {} if dtype is None else {"cache_dtype": dtype}


@pytest.fixture(scope="module")
def jax_caught(models, flag_state):
    jmodel, _ = models
    out = {}
    for site, paged, dtype in CASES:
        eng = JEngine(jmodel, U.jax_ecfg(paged, max_slots=3, **_kw(dtype)),
                      fault_injector=jres.FaultInjector(rates={site: 1.0}))
        assert eng._san is not None
        out[(site, paged)] = _caught(eng)
    return out


def _port(models, paged, rates=None, **kw):
    _, tmodel = models
    inj = tres.FaultInjector(rates=rates) if rates else None
    return ContinuousBatchingEngine(
        tmodel, U.port_ecfg(paged, max_slots=3, **kw), device="cpu",
        fault_injector=inj)


@pytest.mark.parametrize("site,paged,dtype", CASES,
                         ids=[f"{s}-{'paged' if p else 'contig'}"
                              for s, p, _ in CASES])
def test_corruption_caught_at_the_jax_tick(models, jax_caught, site, paged,
                                           dtype):
    eng = _port(models, paged, {site: 1.0}, **_kw(dtype))
    got = _caught(eng)
    want = jax_caught[(site, paged)]
    assert got[:3] == want[:3]
    assert got[3] == want[3] == "SanitizerError"
    assert eng.resilience_stats["faults"] == {site: 1}


@pytest.mark.parametrize("site,paged,dtype,invariant", [
    ("seq_shrink", True, None, "seq-len"),
    ("scale_desync", False, "int8", "scale-pool")])
def test_corruption_in_the_other_cache_mode(models, site, paged, dtype,
                                            invariant):
    tick, inv, where, _ = _caught(_port(models, paged, {site: 1.0},
                                        **_kw(dtype)))
    assert (tick, inv, where) == (1, invariant, "step_chunk")


def test_direct_corruption_is_caught_without_an_injector(models):
    eng = _port(models, True)
    eng.add_request(PROMPT, 6)
    eng.step_chunk(4)
    slot = next(iter(eng._slot_req))
    eng.pool.ref[eng.pool.pages_of[slot][0]] += 1
    with pytest.raises(SanitizerError) as e:
        eng._san.check_tick(eng, "manual")
    assert e.value.invariant == "page-conservation"
    assert e.value.site == "manual"


def test_sanitize_off_is_identity_and_on_changes_no_token(models,
                                                          flag_state):
    prompts = U.prompts(3, seed=7)
    flag_state.set(sanitize=False)
    try:
        off = _port(models, True)
    finally:
        flag_state.set(sanitize=True)
    assert off._san is None
    on = _port(models, True)
    assert on._san is not None
    assert [r.output for r in off.run(prompts, 10)] \
        == [r.output for r in on.run(prompts, 10)]


def _in_thread(fn):
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001
            box["exc"] = e

    t = threading.Thread(target=target)
    t.start()
    t.join(30)
    return box


def test_foreign_thread_reads(models):
    eng = _port(models, True)
    eng.add_request(PROMPT, 6)
    eng.step_chunk(2)
    ok = _in_thread(lambda: [getattr(eng, name)()
                             for name in sorted(SAFE_READS)
                             if hasattr(eng, name)])
    assert "exc" not in ok, ok.get("exc")
    bad = _in_thread(lambda: eng._san.check_read("raw_state_peek"))
    assert isinstance(bad.get("exc"), SanitizerError)
    assert bad["exc"].invariant == "thread-ownership"
    assert "SAFE_READS" in str(bad["exc"])


def test_second_thread_tick_is_flagged(models):
    eng = _port(models, False)
    eng.add_request(PROMPT, 6)
    eng.step_chunk(2)
    bad = _in_thread(lambda: eng.step_chunk(2))
    assert isinstance(bad.get("exc"), SanitizerError)
    assert bad["exc"].invariant == "scheduler-ownership"


def test_safe_reads_are_port_readers():
    """Every registered reader is a method of the port's engine or router,
    and the set is the JAX package's less the seal-time audit's reader
    (the audit is still to come)."""
    for name in SAFE_READS:
        assert callable(getattr(ContinuousBatchingEngine, name, None)) \
            or callable(getattr(EngineRouter, name, None)), name
    for name in ("backpressure", "metrics_snapshot", "fleet_snapshot",
                 "slo_snapshot", "tenant_snapshot"):
        assert callable(getattr(EngineRouter, name)), name
    assert SAFE_READS < jsan.SAFE_READS
    assert jsan.SAFE_READS - SAFE_READS == {"audit_snapshot"}


SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
         "__float__", "__index__")


@pytest.mark.parametrize("paged,dtype", [(True, None), (False, None),
                                         (True, "int8"), (False, "int8")])
def test_checks_make_no_device_sync(models, monkeypatch, paged, dtype):
    """Every tensor method that would sync the host with the device is
    counted while the checks run: none is called. Then the caches are
    swapped for ``meta`` tensors of the same shapes (no data at all) and
    the checks still pass."""
    eng = _port(models, paged, **_kw(dtype))
    for p in U.prompts(3, seed=8):
        eng.add_request(p, 6)
    eng.step_chunk(2)
    calls = []
    for name in SYNCS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    eng._san.check_tick(eng, "counted")
    assert calls == []
    monkeypatch.undo()

    def meta(t):
        if isinstance(t, QuantizedKV):
            return QuantizedKV(meta(t.q), meta(t.scale))
        return None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                                  device="meta")

    if paged:
        eng.caches = [PagedLayerCache(*(meta(t) for t in c))
                      for c in eng.caches]
    else:
        eng.caches = [(meta(k), meta(v)) for k, v in eng.caches]
    eng._san.check_tick(eng, "meta")
