"""The port's continuous-batching engine (paddle_tpu_torch.inference)
against the JAX engine on the CPU: with the tiny Llama's weights carried
across, greedy tokens are identical on a queued workload (5 prompts of
3-40 tokens over 2 slots, prompts spanning several 16-token prefill
chunks), driven through ``run(max_chunk=4)`` and through a ``step()``
loop, with the port's fused decode on and off, and under the legacy
bucketed prefill (``PT_FLAGS_prefill_chunk=0``) against the JAX engine's
legacy arm. Both engines run with prefix caching off and speculative
decoding off (their own tests are ``test_torch_prefix_cache.py`` and
``test_torch_spec_decode.py``), the JAX engine with its default CPU decode
path."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import ContinuousBatchingEngine, EngineConfig
from paddle_tpu_torch.inference.serving import build_request
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

MAX_NEW = 12


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


@pytest.fixture
def flags16():
    """16-token prefill chunks on both sides; restores every flag."""
    jkeys = ("prefix_cache", "spec_decode", "prefill_chunk")
    jsaved = {k: jflags.flag(k) for k in jkeys}
    tsaved = {k: tflags.flag(k)
              for k in ("prefill_chunk", "fused_decode", "prefix_cache")}
    jflags.set_flags({"prefix_cache": False, "spec_decode": "off",
                      "prefill_chunk": 16})
    tflags.set_flags({"prefill_chunk": 16, "prefix_cache": False})
    yield
    jflags.set_flags(jsaved)
    tflags.set_flags(tsaved)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, n) for n in (3, 40, 17, 9, 33)]


def _port_engine(tmodel, **kw):
    # the tiny_ecfg shapes: 2 slots, max_len 128, float32 caches
    return ContinuousBatchingEngine(
        tmodel, EngineConfig(max_slots=2, max_len=128, seq_buckets=(32,),
                             page_size=8, cache_dtype=torch.float32, **kw),
        device="cpu")


def _drive(eng, prompts, driver, eos=None, max_new=MAX_NEW):
    if driver == "run":
        return [r.output for r in eng.run(prompts, max_new_tokens=max_new,
                                          eos_token_id=eos, max_chunk=4)]
    rids = [eng.add_request(p, max_new, eos) for p in prompts]
    serving_utils.drain(eng)
    return [eng._finished[r].output for r in rids]


@pytest.fixture(scope="module")
def jax_outputs(models):
    """The JAX engine's greedy tokens for each driver (computed once)."""
    jmodel, _ = models
    saved = {k: jflags.flag(k)
             for k in ("prefix_cache", "spec_decode", "prefill_chunk")}
    jflags.set_flags({"prefix_cache": False, "spec_decode": "off",
                      "prefill_chunk": 16})
    try:
        return {d: _drive(JEngine(jmodel, serving_utils.tiny_ecfg(
            paged=False)), _prompts(), d) for d in ("run", "step")}
    finally:
        jflags.set_flags(saved)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("driver", ["run", "step"])
def test_greedy_tokens_identical_to_jax(models, jax_outputs, flags16,
                                        driver, fused):
    _, tmodel = models
    tflags.set_flags({"fused_decode": fused})
    eng = _port_engine(tmodel)
    got = _drive(eng, _prompts(), driver)
    assert got == jax_outputs[driver]
    assert all(len(o) == MAX_NEW for o in got)
    # 5 requests over 2 slots: every slot was reused and is free again
    assert not eng.active.any() and sorted(eng._free_heap) == [0, 1]
    assert eng.stats["prefill_chunk"] >= 5 and eng.stats["decode_forwards"]


def test_eos_finish(models, jax_outputs, flags16):
    """A request stops at its first eos token, as in the JAX engine."""
    _, tmodel = models
    want = jax_outputs["run"]
    eos = want[1][4]
    got = _port_engine(tmodel).run(_prompts(), max_new_tokens=MAX_NEW,
                                   eos_token_id=eos, max_chunk=4)
    for req, full in zip(got, want):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert req.output == full[:cut]
        assert req.finish_reason == ("eos" if eos in full
                                     else "max_new_tokens")


def test_max_len_boundary_matches_jax(models, flags16):
    """prompt + max_new_tokens == max_len fills the cache to its last row
    with JAX's tokens. The ``max_len`` finish itself is unreachable
    through add_request (the budget check fires first), so a request
    whose budget overruns the cache is queued past the validation, as a
    replayed request would arrive, and leaves at the cap."""
    jmodel, tmodel = models
    prompt = np.random.default_rng(3).integers(1, 256, 100)
    jreq = JEngine(jmodel, serving_utils.tiny_ecfg(paged=False)).run(
        [prompt], max_new_tokens=28, max_chunk=4)[0]
    eng = _port_engine(tmodel)
    req = eng.run([prompt], max_new_tokens=28, max_chunk=4)[0]
    assert req.output == jreq.output and len(req.output) == 28
    assert req.finish_reason == jreq.finish_reason == "max_new_tokens"
    over = build_request(99, prompt, 40, max_len=1024)
    eng._queue.append(over)
    serving_utils.drain(eng, lambda: eng.step_chunk(4))
    assert over.finish_reason == "max_len"
    assert over.output == jreq.output  # 128 - 100 tokens fit


def test_cancel_queued_and_active(models, flags16):
    _, tmodel = models
    eng = _port_engine(tmodel)
    prompts = _prompts()[:3]
    rids = [eng.add_request(p, MAX_NEW) for p in prompts]
    eng.step()  # admits two, the third stays queued
    assert eng.active.all() and len(eng._queue) == 1
    assert eng.cancel(rids[2])  # queued
    assert eng.cancel(rids[0])  # active: its slot frees at once
    assert not eng.cancel(rids[0])  # already finished
    assert not eng.cancel(999)
    assert eng.active.sum() == 1
    serving_utils.drain(eng)
    done = eng._finished
    assert done[rids[0]].cancelled and done[rids[0]].finish_reason == "cancel"
    assert done[rids[2]].cancelled and done[rids[2]].output == []
    assert len(done[rids[1]].output) == MAX_NEW
    assert sorted(eng._free_heap) == [0, 1]


def test_add_request_rejects_bad_requests(models, flags16):
    _, tmodel = models
    eng = _port_engine(tmodel)
    with pytest.raises(ValueError):
        eng.add_request([])
    with pytest.raises(ValueError):
        eng.add_request(np.arange(1, 120), max_new_tokens=10)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], temperature=0.0)
    assert not eng._queue


@pytest.mark.parametrize("bad", ["fp8_weights", "int4_cache",
                                 "zero_group_size", "int8_cache_legacy"])
def test_configs_outside_the_slice_raise(models, flags16, bad):
    """Configurations the JAX engine refuses raise its ``ValueError`` at
    init (tests/test_quant_serving.py), an int8 cache under the legacy
    bucketed prefill among them."""
    _, tmodel = models
    kw, match = {
        "fp8_weights": (dict(weight_dtype="fp8"), "weight_dtype"),
        "int4_cache": (dict(cache_dtype="int4"), "cache_dtype"),
        "zero_group_size": (dict(weight_dtype="int8", weight_group_size=0),
                            "weight_group_size"),
        "int8_cache_legacy": (dict(paged=True, cache_dtype="int8"),
                              "chunked prefill")}[bad]
    if bad == "int8_cache_legacy":
        tflags.set_flags({"prefill_chunk": 0})
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(tmodel, EngineConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def jax_legacy(models):
    """The JAX engine's greedy tokens under the legacy bucketed prefill
    (``run`` loop; the prefix cache is off there by construction)."""
    jmodel, _ = models
    saved = {k: jflags.flag(k) for k in ("spec_decode", "prefill_chunk")}
    jflags.set_flags({"spec_decode": "off", "prefill_chunk": 0})
    try:
        return _drive(JEngine(jmodel, serving_utils.tiny_ecfg(paged=False)),
                      _prompts(), "run")
    finally:
        jflags.set_flags(saved)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("loop", ["run", "step"])
def test_legacy_prefill_tokens_identical_to_jax(models, jax_outputs,
                                                jax_legacy, flags16, loop,
                                                fused):
    """``PT_FLAGS_prefill_chunk=0``: one ``[1, bucket]`` prefill a request
    (buckets 32 and max_len 128) at the shared index 0, copied into the
    slot. The tokens are the JAX legacy engine's and the chunked
    engines'; the prefix cache stays off though its flag is on."""
    _, tmodel = models
    assert jax_legacy == jax_outputs["run"]
    tflags.set_flags({"fused_decode": fused, "prefill_chunk": 0,
                      "prefix_cache": True})
    eng = _port_engine(tmodel)
    got = _drive(eng, _prompts(), loop)
    assert got == jax_outputs[loop]
    assert eng.stats["prefill_bucket"] == 5 and eng.stats["prefill_chunk"] == 0
    snap = eng.prefix_snapshot()
    assert not snap["enabled"] and snap["hits"] == snap["misses"] == 0
    assert not eng.active.any() and sorted(eng._free_heap) == [0, 1]
    # the working bucket table: 32, else max_len
    assert eng._bucket(3) == 32 and eng._bucket(33) == 128


def test_legacy_prefill_sampling_requests_run(models, flags16):
    """A sampling request's first token is drawn in the bucketed prefill
    from its own parameters: reproducible from the seed, and a greedy
    neighbour keeps its chunked-engine tokens."""
    _, tmodel = models
    solo = _port_engine(tmodel).run([[9, 10, 11]], max_new_tokens=6,
                                    max_chunk=4)[0].output
    tflags.set_flags({"prefill_chunk": 0})
    outs = []
    for _ in range(2):
        eng = _port_engine(tmodel, seed=3)
        a = eng.add_request([5, 6, 7], 6, temperature=0.8, top_k=20,
                            top_p=0.9)
        b = eng.add_request([9, 10, 11], 6)
        serving_utils.drain(eng, lambda: eng.step_chunk(4))
        outs.append((eng._finished[a].output, eng._finished[b].output))
    assert outs[0] == outs[1] and outs[0][1] == solo
    assert all(0 <= t < 256 for t in outs[0][0]) and len(outs[0][0]) == 6


def test_sampling_requests_run(models, flags16):
    """Per-request sampling draws from the engine's own generator: the
    tokens differ from the JAX engine's by design, so this checks only
    that they are valid and reproducible from the seed, and that greedy
    neighbours keep their greedy tokens."""
    _, tmodel = models
    outs = []
    for _ in range(2):
        eng = _port_engine(tmodel, seed=3)
        a = eng.add_request([5, 6, 7], 6, temperature=0.8, top_k=20,
                            top_p=0.9)
        b = eng.add_request([9, 10, 11], 6)
        serving_utils.drain(eng, lambda: eng.step_chunk(4))
        outs.append((eng._finished[a].output, eng._finished[b].output))
    assert outs[0] == outs[1]
    assert all(0 <= t < 256 for t in outs[0][0]) and len(outs[0][0]) == 6
    solo = _port_engine(tmodel).run([[9, 10, 11]], max_new_tokens=6,
                                    max_chunk=4)[0].output
    assert outs[0][1] == solo
