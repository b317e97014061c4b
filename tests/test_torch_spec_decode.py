"""The port's speculative decoding (paddle_tpu_torch.inference.spec_decode
and the engine's verify pass) against the JAX package on the CPU: the
n-gram drafter's proposals and errors, and the engine with the tiny
Llama's weights carried across, float32, paged and contiguous, under
``step`` and ``step_chunk``: greedy tokens equal to the JAX engine's
spec-off tokens and ``spec_snapshot()`` equal to the JAX spec-on arm's;
rejected rows never read, sampling slots never draft, the copy-on-write
guard over the whole verify window, the chunk's drafting-share gate, the
``auto`` throttle and the flag's validation."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu.inference import spec_decode as jsd
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import (ContinuousBatchingEngine, Drafter,
                                        EngineConfig, NgramDrafter)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

EMPTY = np.zeros((0,), np.int64)


# ---------------------------------------------------------- n-gram drafter
def _histories():
    rng = np.random.default_rng(13)
    unit = rng.integers(1, 50, 4)
    out = [np.zeros((0,), np.int64), np.array([7]), np.array([7, 7]),
           np.array([1, 7, 8, 9, 10, 5, 7, 8]),
           np.array([9, 2, 3, 50, 4, 2, 3, 60, 9, 2, 3]),
           np.concatenate([unit] * 4), np.concatenate([unit] * 2)[:-1]]
    out += [rng.integers(1, 6, n) for n in (5, 12, 30, 64)]
    return out


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (1, 1), (2, 2),
                                                 (4, 2)])
def test_ngram_drafter_equals_jax(max_ngram, min_ngram, k):
    mine = NgramDrafter(max_ngram, min_ngram)
    ref = jsd.NgramDrafter(max_ngram, min_ngram)
    hits = 0
    for h in _histories():
        got, want = mine.propose(h, k), ref.propose(h, k)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
        hits += got.size > 0
    assert hits >= 4
    assert mine.propose(_histories()[3], 0).size == 0


@pytest.mark.parametrize("max_ngram,min_ngram", [(1, 2), (3, 0), (0, 0)])
def test_ngram_drafter_validation_equals_jax(max_ngram, min_ngram):
    with pytest.raises(ValueError) as want:
        jsd.NgramDrafter(max_ngram, min_ngram)
    with pytest.raises(ValueError) as got:
        NgramDrafter(max_ngram, min_ngram)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def models():
    pt.seed(3)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


KEYS = ("prefix_cache", "spec_decode", "prefill_chunk")


@pytest.fixture
def set_both():
    """Sets flags on both packages (16-token prefill chunks, the prefix
    cache on, as by default); restores every flag."""
    jsaved = {k: jflags.flag(k) for k in KEYS}
    tsaved = {k: tflags.flag(k) for k in KEYS}

    def set_flags(**kw):
        kw = {"prefix_cache": True, "prefill_chunk": 16, **kw}
        jflags.set_flags(kw)
        tflags.set_flags(kw)

    yield set_flags
    jflags.set_flags(jsaved)
    tflags.set_flags(tsaved)


def _port_engine(tmodel, paged, drafter=None, **kw):
    # the tiny_ecfg shapes: 2 slots, max_len 128, 8-token pages
    kw = {"max_slots": 2, "max_len": 128, "seq_buckets": (32,),
          "page_size": 8, **kw}
    return ContinuousBatchingEngine(
        tmodel, EngineConfig(paged=paged, cache_dtype=torch.float32, **kw),
        device="cpu", drafter=drafter)


def _prompts():
    """Repetitive prompts (drafts fire), a random one and a ragged short
    one (``serving_utils.mixed_prompts``)."""
    return serving_utils.mixed_prompts(JConfig.tiny(),
                                       np.random.default_rng(5))


def _serve(eng, loop, max_new=24):
    """The prompts through ``step`` or ``step_chunk(4)``, then one request
    whose 1-token budget leaves no room to draft."""
    step = eng.step if loop == "step" else (lambda: eng.step_chunk(4))
    outs = []
    for prompts, n in ((_prompts(), max_new), (_prompts()[:1], 1)):
        rids = [eng.add_request(p, n) for p in prompts]
        serving_utils.drain(eng, step)
        outs += [eng._finished[r].output for r in rids]
    return outs


@pytest.fixture(scope="module")
def jax_arms(models):
    """The JAX engine's spec-off tokens and spec-on snapshot, float32, per
    cache mode and loop."""
    jmodel, _ = models
    saved = {k: jflags.flag(k) for k in KEYS}
    out = {}
    try:
        for paged in (False, True):
            for loop in ("step", "chunk"):
                arm = {}
                for mode in ("off", "ngram"):
                    jflags.set_flags({"prefix_cache": True,
                                      "prefill_chunk": 16,
                                      "spec_decode": mode})
                    eng = JEngine(jmodel, serving_utils.tiny_ecfg(paged))
                    arm[mode] = (_serve(eng, loop), eng.spec_snapshot())
                out[(paged, loop)] = arm
    finally:
        jflags.set_flags(saved)
    return out


@pytest.mark.parametrize("loop", ["step", "chunk"])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_tokens_and_snapshot_equal_jax(models, jax_arms, set_both,
                                            paged, loop):
    _, tmodel = models
    arm = jax_arms[(paged, loop)]
    set_both(spec_decode="ngram")
    eng = _port_engine(tmodel, paged)
    got = _serve(eng, loop)
    assert got == arm["off"][0]
    snap = eng.spec_snapshot()
    assert snap == arm["ngram"][1]
    assert snap["verify_calls"] > 0 and snap["accepted"] > 0
    assert snap["emitted"] > snap["verify_calls"]
    # verify passes are counted apart from decode forwards
    assert eng.stats["verify_forwards"] == snap["verify_calls"]
    if paged:
        pool = eng.pool
        assert pool.free_pages + eng._prefix.evictable_pages(pool) \
            == pool.n_pages - 1 and pool.shared_pages == 0
    set_both(spec_decode="off")
    off = _port_engine(tmodel, paged)
    assert _serve(off, loop) == got
    assert off.spec_snapshot()["verify_calls"] == 0
    assert off.stats["verify_forwards"] == 0


def _oracle(tmodel, paged, prompt, n):
    return _port_engine(tmodel, paged).run([prompt],
                                           max_new_tokens=n)[0].output


class _Scripted(Drafter):
    """Proposes, once, the oracle's next tokens with the ones from index
    ``wrong_from`` on changed; nothing after."""

    def __init__(self, oracle, n_prompt, wrong_from, n):
        self.oracle, self.n_prompt = oracle, n_prompt
        self.wrong_from, self.n = wrong_from, n
        self.fired = False

    def propose(self, history, k):
        if self.fired or k < self.n:
            return EMPTY
        self.fired = True
        nxt = len(history) - self.n_prompt
        d = [self.oracle[nxt + j] + (j >= self.wrong_from)
             for j in range(self.n)]
        return np.asarray(d, np.int64) % 256


@pytest.mark.parametrize("paged", [False, True])
def test_rejected_rows_are_never_read(models, set_both, paged):
    """An all-rejected verify pass wrote spec_k rows past the slot's
    length; the slot advances by one token, and the rest of the stream is
    the spec-off one, so no later attention read those rows."""
    _, tmodel = models
    set_both(spec_decode="off")
    prompt = np.random.default_rng(3).integers(1, 256, 9)
    ref = _oracle(tmodel, paged, prompt, 12)
    set_both(spec_decode="ngram")
    eng = _port_engine(tmodel, paged, drafter=_Scripted(ref, 9, 0, 4))
    rid = eng.add_request(prompt, max_new_tokens=12)
    eng._admit()
    len0 = int(eng.seq_lens[0])
    assert eng.step()
    assert eng.spec_stats["verify_calls"] == 1
    assert eng.spec_stats["proposed"] == 4 and eng.spec_stats["accepted"] == 0
    assert int(eng.seq_lens[0]) == len0 + 1
    serving_utils.drain(eng)
    assert eng._finished[rid].output == ref


def test_partial_acceptance_advances_by_accepted_plus_one(models, set_both):
    _, tmodel = models
    set_both(spec_decode="off")
    prompt = np.random.default_rng(4).integers(1, 256, 9)
    ref = _oracle(tmodel, False, prompt, 12)
    set_both(spec_decode="ngram")
    eng = _port_engine(tmodel, False, drafter=_Scripted(ref, 9, 2, 3))
    rid = eng.add_request(prompt, max_new_tokens=12)
    eng._admit()
    len0 = int(eng.seq_lens[0])
    eng.step()
    assert eng.spec_stats["accepted"] == 2
    assert int(eng.seq_lens[0]) == len0 + 3  # two drafts and the bonus
    serving_utils.drain(eng)
    assert eng._finished[rid].output == ref


def test_sampling_slots_skip_drafting(models, set_both):
    """The greedy repetitive slot drafts, the sampling slot never does,
    and the greedy slot's tokens are the spec-off ones."""
    _, tmodel = models
    rng = np.random.default_rng(7)
    unit = rng.integers(1, 256, 4)
    pa, pb = np.concatenate([unit] * 5), rng.integers(1, 256, 8)
    set_both(spec_decode="off")
    ref = _oracle(tmodel, True, pa, 32)
    set_both(spec_decode="ngram")
    eng = _port_engine(tmodel, True)
    ra = eng.add_request(pa, max_new_tokens=32)
    rb = eng.add_request(pb, max_new_tokens=32, temperature=3.0)
    serving_utils.drain(eng)
    assert eng._finished[ra].output == ref
    assert len(eng._finished[rb].output) == 32
    assert eng.spec_stats["accepted"] > 0
    assert eng._finished[rb]._spec_proposed == 0
    assert eng._finished[ra]._spec_proposed == eng.spec_stats["proposed"]


class _Repeat(Drafter):
    """Always proposes ``k`` copies of the last token."""

    def propose(self, history, k):
        return np.full((k,), int(history[-1]), np.int64)


def test_cow_guard_covers_the_verify_window(models, set_both):
    """A page inside the spec_k + 1 window, shared by an outside
    ``pool.retain``, is copied before the first (verify) pass: its bytes
    stay as they were and the tokens are the spec-off ones."""
    _, tmodel = models
    rng = np.random.default_rng(1)
    prompt = np.concatenate([rng.integers(1, 256, 2)] * 3)
    set_both(spec_decode="off")
    ref = _oracle(tmodel, True, prompt, 10)
    set_both(spec_decode="ngram")
    eng = _port_engine(tmodel, True, drafter=_Repeat())
    rid = eng.add_request(prompt, max_new_tokens=10)
    eng._admit()
    page = int(eng.pool.block_tables[0, 0])
    eng.pool.retain(page)
    snap = [t[:, page].clone() for t in eng.caches[0] if t is not None]
    serving_utils.drain(eng)
    assert eng.spec_stats["verify_calls"] >= 1
    assert eng.prefix_stats["cow_copies"] >= 1
    for before, t in zip(snap, eng.caches[0]):
        assert torch.equal(before, t[:, page])
    assert eng._finished[rid].output == ref
    eng.pool.release(page)


class _Marker(Drafter):
    """Proposes two copies of the last token, only for histories that
    start with ``marker``."""

    def __init__(self, marker):
        self.marker = marker

    def propose(self, history, k):
        if history.size and int(history[0]) == self.marker:
            return np.full((min(k, 2),), int(history[-1]), np.int64)
        return EMPTY


def test_chunk_takes_the_verify_pass_only_when_half_the_slots_draft(
        models, set_both):
    _, tmodel = models
    rng = np.random.default_rng(12)
    marker = 77
    drafting = np.concatenate([[marker], rng.integers(1, 256, 8)])
    others = [np.concatenate([[marker + 1 + i], rng.integers(1, 256, 7 + i)])
              for i in range(3)]
    set_both(spec_decode="ngram")
    for step, prompts, verifies in (
            ("chunk", [drafting] + others, False),  # 1 of 4 drafts
            ("chunk", [drafting, drafting[:5]], True),  # 2 of 2
            ("step", [drafting] + others, True)):  # step(): always
        eng = _port_engine(tmodel, True, drafter=_Marker(marker),
                           max_slots=len(prompts))
        for p in prompts:
            eng.add_request(p, max_new_tokens=12)
        serving_utils.drain(eng, eng.step if step == "step"
                            else (lambda: eng.step_chunk(4)))
        assert (eng.spec_stats["verify_calls"] > 0) == verifies
        if not verifies:
            assert eng.spec_stats["fallback_steps"] > 0


def test_auto_mode_throttles_a_drafter_that_never_accepts(models, set_both):
    _, tmodel = models
    prompt = np.concatenate([np.random.default_rng(8).integers(1, 256, 4)]
                            * 5)
    set_both(spec_decode="off")
    ref = _oracle(tmodel, True, prompt, 40)

    class Garbage(Drafter):
        def propose(self, history, k):
            return np.full((k,), -1, np.int64)  # never a real token

    set_both(spec_decode="auto")
    eng = _port_engine(tmodel, True, drafter=Garbage())
    rid = eng.add_request(prompt, max_new_tokens=40)
    serving_utils.drain(eng)
    assert eng._finished[rid].output == ref
    assert eng.spec_stats["accepted"] == 0
    assert 16 <= eng._finished[rid]._spec_proposed <= 20
    assert eng.spec_stats["fallback_steps"] > 0
    assert eng.spec_snapshot()["mode"] == "auto"


def test_spec_flag_and_spec_k_are_validated(models, set_both):
    _, tmodel = models
    for mode in ("ngram", "auto", "NGRAM"):
        set_both(spec_decode=mode)
        eng = _port_engine(tmodel, False)
        assert isinstance(eng._drafter, NgramDrafter)
        assert eng.spec_snapshot()["enabled"]
    set_both(spec_decode="off")
    assert _port_engine(tmodel, False)._drafter is None
    set_both(spec_decode="bogus")
    with pytest.raises(ValueError, match="spec_decode"):
        _port_engine(tmodel, False)
    set_both(spec_decode="ngram")
    with pytest.raises(ValueError, match="spec_k"):
        _port_engine(tmodel, False, spec_k=0)
