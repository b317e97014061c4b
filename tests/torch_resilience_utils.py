"""Shared pieces of the port's resilience, sanitizer and router tests
(``tests/test_torch_resilience.py``, ``test_torch_sanitizer.py``,
``test_torch_router.py``): both packages' serving flags set and restored
together, the tiny Llama carried from the JAX package to the port in
float32, the engine configurations of the JAX package's own tests for
each side, and a fault injector that fires at scripted draws."""

import functools

import numpy as np
import torch

import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import EngineConfig
from paddle_tpu_torch.inference.resilience import FaultInjector
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

# the serving flags both sides run with; degradation keeps each package's
# default (on) unless a case sets it. Telemetry is off on both: these
# files compare the telemetry-off documents (the observability layer is
# held to JAX in tests/test_torch_observability.py and its neighbours)
COMMON = {"prefix_cache": True, "spec_decode": "off", "prefill_chunk": 16,
          "serve_recovery": "auto", "fault_inject": "", "sanitize": False,
          "degradation": True, "telemetry": False}


class BothFlags:
    """Sets both packages' serving flags and restores every one it
    touched."""

    def __init__(self):
        self.saved = ({k: jflags.flag(k) for k in COMMON},
                      {k: tflags.flag(k) for k in COMMON})

    def set(self, **kw):
        jflags.set_flags({**COMMON, **kw})
        tflags.set_flags({**COMMON, **kw})

    def restore(self):
        jflags.set_flags(self.saved[0])
        tflags.set_flags(self.saved[1])


@functools.lru_cache(maxsize=None)
def tiny_models(seed: int = 0):
    """(JAX tiny Llama, the port's copy of it on the CPU), built once a
    process: the three test files share them, and no test writes a
    weight."""
    jmodel, _ = serving_utils.tiny_model(seed)
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


def jax_ecfg(paged, **kw):
    return serving_utils.tiny_ecfg(paged, **kw)


def port_ecfg(paged, **kw):
    """``serving_utils.tiny_ecfg``'s configuration for the port."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 128)
    kw.setdefault("seq_buckets", (32,))
    kw.setdefault("cache_dtype", torch.float32)
    kw.setdefault("page_size", 8)
    return EngineConfig(paged=paged, **kw)


def prompts(n=6, seed=0, lo=4, hi=20, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(lo, hi)))
            for _ in range(n)]


def drive(eng, max_chunk=4, limit=2000):
    for _ in range(limit):
        if not (eng.step_chunk(max_chunk) or eng._queue
                or eng.active.any()):
            return
    raise AssertionError("the engine did not drain")


def assert_no_leaks(eng):
    """Slots back on the heap and, paged, the pool whole once the store's
    evictable pages are released."""
    assert not eng.active.any()
    assert sorted(eng._free_heap) == list(range(eng.cfg.max_slots))
    assert not eng._slot_req
    if eng.cfg.paged:
        eng._evict_pages(10 ** 9)
        assert eng.pool.free_pages == eng.pool.n_pages - 1
        assert not eng.pool.ref


class ScriptedInjector(FaultInjector):
    """``fire`` hits at the scripted consultation indices of each site
    (the JAX router tests' ``ScriptedInjector``)."""

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


def without_instants(ledger: dict) -> dict:
    """A ledger with its perf_counter instants and TTFT reduced to their
    presence and type (the values differ between two runs)."""
    out = dict(ledger)
    for k in ("deadline_t", "submit_t", "admit_t", "ttft_ms"):
        v = out[k]
        out[k] = (v is not None and v != 0, type(v).__name__)
    return out
