"""The port's prefix KV cache (paddle_tpu_torch.inference.prefix_cache and
the engine's prefix admission) against the JAX package on the CPU: the
block digests byte for byte, the stores and page pools driven through one
sequence of match/insert/adopt/copy-on-write/evict, and the engine with
the tiny Llama's weights carried across, float32 and int8 caches, paged
and contiguous: greedy tokens and ``prefix_snapshot()`` equal to the JAX
engine's with the prefix cache on, the same tokens with it off, and the
cached pages' bytes unchanged while the store holds them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import (ContigPrefixStore,
                                        ContinuousBatchingEngine,
                                        EngineConfig, PagedPrefixStore,
                                        block_hashes)
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

MAX_NEW = 8


# ------------------------------------------------------------ block digests
@pytest.mark.parametrize("namespace", ["", "tenant-a"])
def test_block_hashes_equal_jax(namespace):
    rng = np.random.default_rng(0)
    for n, block in ((0, 8), (7, 8), (8, 8), (37, 8), (64, 16), (50, 1)):
        prompt = rng.integers(1, 32000, n)
        got = block_hashes(prompt, block, namespace=namespace)
        assert got == jpc.block_hashes(prompt, block, namespace=namespace)
        assert len(got) == n // block
    # the chain: a shared first block gives a shared first digest only
    a, b = rng.integers(1, 9, 16), rng.integers(1, 9, 16)
    b[:8] = a[:8]
    b[8] = a[8] + 1
    ha, hb = block_hashes(a, 8, namespace), block_hashes(b, 8, namespace)
    assert ha[0] == hb[0] and ha[1] != hb[1]
    # a namespace gives a disjoint chain
    assert block_hashes(a, 8, "other")[0] != ha[0]


# ------------------------------------------------------- stores and pools
def _paged_state(pool, store, jax_side):
    pages = ([p for p, _ in store._blocks.values()] if jax_side
             else store.pages())
    return (pool.block_tables.tolist(), dict(pool.ref), list(pool._free),
            pool.shared_pages, pages, store.evictions)


def test_paged_store_and_pool_sequence_matches_jax():
    """The calls prefix admission makes, on both packages' pools and
    stores: publish a slot's pages, match a longer chain, adopt, top up,
    copy-on-write the last adopted page, count and evict store-only
    pages, free. Equal returns and equal state after every call."""
    args = (12, 4, 3, 5, True)
    sides = [(jpaged.PagePool(*args), jpc.PagedPrefixStore(), True),
             (tpaged.PagePool(*args), PagedPrefixStore(), False)]
    h = block_hashes(np.arange(1, 21), 4)  # 5 digests

    def both(fn):
        out = []
        for pool, store, jax_side in sides:
            out.append(fn(pool, store))
            out.append(_paged_state(pool, store, jax_side))
        assert out[0] == out[2] and out[1] == out[3], out
        return out[0]

    assert both(lambda p, s: p.alloc(0, 13))
    assert both(lambda p, s: [s.insert(h[i], int(p.block_tables[0, i]), p)
                              for i in range(3)]) == [True] * 3
    assert both(lambda p, s: s.insert(h[0], 9, p)) is False  # refreshed
    shared = both(lambda p, s: s.match(h))
    assert len(shared) == 3
    assert both(lambda p, s: s.evictable_pages(p)) == 0  # slot 0 borrows
    both(lambda p, s: p.free(0))
    assert both(lambda p, s: s.evictable_pages(p, exclude=shared[:2])) == 1
    assert both(lambda p, s: p.adopt(1, shared))
    assert both(lambda p, s: p.alloc(1, 17))
    assert both(lambda p, s: p.cow(1, 2)) is not None
    assert both(lambda p, s: s.evictable_pages(p)) == 1
    assert both(lambda p, s: s.match(h[:2] + h[3:]))  # stops at no gap
    assert both(lambda p, s: s.evict(p, 5)) == 1
    assert both(lambda p, s: s.match(h)) == shared[:2]
    both(lambda p, s: p.free(1))
    assert both(lambda p, s: s.evict(p, 1)) == 1
    assert both(lambda p, s: (p.free_pages, len(s), s.cached_pages)) \
        == (10, 1, 1)


def test_contig_store_sequence_matches_jax():
    """LRU under a block cap, with the inserting chain protected, and
    matches that refresh recency: equal returns and key order."""
    h = block_hashes(np.arange(1, 33), 4)  # 8 digests
    sides = [jpc.ContigPrefixStore(3), ContigPrefixStore(3)]

    def both(fn):
        out = [fn(s) for s in sides]
        keys = [list(s._blocks) for s in sides]
        assert out[0] == out[1] and keys[0] == keys[1], (out, keys)
        assert sides[0].evictions == sides[1].evictions
        return out[0]

    assert both(lambda s: [s.insert(h[i], i, -i) for i in range(3)]) \
        == [True] * 3
    assert both(lambda s: s.match(h[:2])) == [(0, 0), (1, -1)]
    assert both(lambda s: s.insert(h[3], 3, -3, protect=h[2:4])) is True
    assert both(lambda s: s.insert(h[4], 4, -4, protect=h[:5])) is True
    assert both(lambda s: s.match(h)) == []  # block 0 was evicted
    assert both(lambda s: s.insert(h[1], 1, -1)) is False
    assert both(lambda s: s.insert(h[5], 5, -5, protect=h)) is True
    assert both(lambda s: len(s)) == 3
    assert ContigPrefixStore(0).insert(h[0], 0, 0) is False


# --------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def models():
    pt.seed(5)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


@pytest.fixture
def set_both():
    """Sets a flag on both packages (16-token prefill chunks, speculative
    decoding off by default); restores every flag."""
    keys = ("prefix_cache", "spec_decode", "prefill_chunk")
    jsaved = {k: jflags.flag(k) for k in keys}
    tsaved = {k: tflags.flag(k) for k in keys}

    def set_flags(**kw):
        kw = {"spec_decode": "off", "prefill_chunk": 16, **kw}
        jflags.set_flags(kw)
        tflags.set_flags(kw)

    yield set_flags
    jflags.set_flags(jsaved)
    tflags.set_flags(tsaved)


def _workload():
    """Three prompts over a shared 16-token prefix (two 8-token blocks)
    with suffixes of their own, and a block-aligned 16-token prompt: the
    first run's two slots make two admission waves. The second run sends
    the aligned prompt again (a full-cover hit: the copy-on-write of its
    last page) beside a fourth shared-prefix prompt."""
    rng = np.random.default_rng(21)
    shared = rng.integers(1, 256, 16)
    own = [np.concatenate([shared, rng.integers(1, 256, k)])
           for k in (5, 9, 3, 6)]
    aligned = rng.integers(1, 256, 16)
    return [own[0], own[1], own[2], aligned], [aligned.copy(), own[3]]


def _port_engine(tmodel, paged, cache_dtype, **kw):
    # the tiny_ecfg shapes: 2 slots, max_len 128, 8-token pages / blocks
    kw = {"max_slots": 2, "max_len": 128, "seq_buckets": (32,),
          "page_size": 8, **kw}
    return ContinuousBatchingEngine(
        tmodel, EngineConfig(paged=paged, cache_dtype=cache_dtype, **kw),
        device="cpu")


def _serve(eng, waves):
    return [[r.output for r in eng.run(w, max_new_tokens=MAX_NEW,
                                       max_chunk=4)] for w in waves]


def _cached_bytes(eng):
    """digest -> numpy copies of the store's entry (with its namespace):
    the page (payload and int8 scales) in every layer, or the contiguous
    block."""
    def arr(t):
        return [t.q.numpy().copy(), t.scale.numpy().copy()] \
            if isinstance(t, tpaged.QuantizedKV) else [t.numpy().copy()]

    if eng.pool is not None:
        return {h: [t[:, p].numpy().copy() for layer in eng.caches
                    for t in layer if t is not None]
                for h, (p, _) in eng._prefix._blocks.items()}
    return {h: arr(k) + arr(v)
            for h, (k, v, _) in eng._prefix._blocks.items()}


def _assert_pool_identity(eng):
    """Every page is free or held by the store alone; none is shared."""
    pool = eng.pool
    assert pool.free_pages + eng._prefix.evictable_pages(pool) \
        == pool.n_pages - 1 == eng.stats["free_pages"] \
        + eng._prefix.cached_pages
    assert pool.shared_pages == 0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_prefix_engine_tokens_and_snapshot_equal_jax(models, set_both,
                                                     paged, cache):
    jmodel, tmodel = models
    first, second = _workload()
    jdt = {"float32": serving_utils.tiny_ecfg(False).cache_dtype,
           "int8": "int8"}[cache]
    set_both(prefix_cache=True)
    jeng = JEngine(jmodel, serving_utils.tiny_ecfg(paged, cache_dtype=jdt))
    want = _serve(jeng, [first, second])
    eng = _port_engine(tmodel, paged, getattr(torch, cache))
    got = [_serve(eng, [first])[0]]
    snap = eng.prefix_snapshot()
    assert snap["misses"] >= 2 and snap["hits"] >= 1 and snap["enabled"]
    held = _cached_bytes(eng)
    got += _serve(eng, [second])
    assert got == want
    assert eng.prefix_snapshot() == jeng.prefix_snapshot()
    snap = eng.prefix_snapshot()
    assert snap["hits"] >= 3 and snap["hit_tokens"] >= 2 * 16 + 15
    if paged:
        assert snap["cow_copies"] >= 1
        _assert_pool_identity(eng)
    # what the store held after the first run and still holds is byte
    # for byte the same
    now = _cached_bytes(eng)
    kept = held.keys() & now.keys()
    assert len(kept) >= 2
    for h in kept:
        for x, y in zip(held[h], now[h]):
            np.testing.assert_array_equal(x, y)
    # the same tokens with the prefix cache off
    set_both(prefix_cache=False)
    off = _port_engine(tmodel, paged, getattr(torch, cache))
    assert _serve(off, [first, second]) == want
    assert off.prefix_snapshot()["enabled"] is False
    assert off.prefix_snapshot()["hits"] == 0
    if paged:
        assert off.pool.free_pages == off.pool.n_pages - 1
        assert not off.pool.ref


def test_prefix_engine_step_loop_equals_jax(models, set_both):
    """The per-token ``step()`` loop over the same traffic, paged."""
    jmodel, tmodel = models
    first, second = _workload()
    set_both(prefix_cache=True)

    def drive(eng):
        rids = [eng.add_request(p, MAX_NEW) for p in first + second]
        serving_utils.drain(eng)
        return [eng._finished[r].output for r in rids]

    jeng = JEngine(jmodel, serving_utils.tiny_ecfg(True))
    eng = _port_engine(tmodel, True, torch.float32)
    assert drive(eng) == drive(jeng)
    assert eng.prefix_snapshot() == jeng.prefix_snapshot()
    _assert_pool_identity(eng)


@pytest.mark.parametrize("loop", ["step", "chunk"])
def test_cow_for_decode_guard_copies_a_shared_page(models, set_both,
                                                   loop):
    """A page that the next append lands in, shared by an outside
    ``pool.retain``, is copied before the decode dispatch (``step`` and
    ``step_chunk``): its bytes stay as they were, and the request's tokens
    are those of an engine that never saw the retain."""
    _, tmodel = models
    set_both(prefix_cache=True)
    prompt = np.random.default_rng(1).integers(1, 256, 5)
    ref = _port_engine(tmodel, True, torch.float32).run(
        [prompt], max_new_tokens=6)[0].output
    eng = _port_engine(tmodel, True, torch.float32)
    rid = eng.add_request(prompt, max_new_tokens=6)
    eng._admit()
    page = int(eng.pool.block_tables[0, 0])  # position 5 -> block 0
    eng.pool.retain(page)
    snap = [t[:, page].clone() for t in eng.caches[0] if t is not None]
    serving_utils.drain(eng, eng.step if loop == "step"
                        else lambda: eng.step_chunk(4))
    assert eng.prefix_stats["cow_copies"] >= 1
    for before, t in zip(snap, eng.caches[0]):
        assert torch.equal(before, t[:, page])
    assert eng._finished[rid].output == ref
    eng.pool.release(page)


def test_blocked_admission_does_not_churn_the_store(models, set_both):
    """A pool-blocked head request retries admission every tick: the
    retries make no copy and evict nothing; the cached prefix survives
    and serves the hit once the long request finishes."""
    _, tmodel = models
    set_both(prefix_cache=True)
    rng = np.random.default_rng(7)
    P = rng.integers(1, 256, 8)  # the shared prompt, one block
    Q = rng.integers(1, 256, 8)  # the long request
    small = dict(max_len=32, seq_buckets=(8,), n_pages=5)
    ref = _port_engine(tmodel, True, torch.float32, **small).run(
        [P], max_new_tokens=8)[0].output
    eng = _port_engine(tmodel, True, torch.float32, **small)
    assert eng.run([P], max_new_tokens=8)[0].output == ref  # publish P
    assert len(eng._prefix) == 1
    rb = eng.add_request(Q, max_new_tokens=16)  # 3 of the 4 usable pages
    eng.step()
    rc = eng.add_request(P, max_new_tokens=8)  # full cover; blocked
    cows = eng.prefix_stats["cow_copies"]
    blocked = 0
    for _ in range(8):
        eng.step()
        if not eng._queue:
            break
        blocked += 1
        assert eng._pool_blocked and len(eng._prefix) == 2
        assert eng.prefix_stats["evictions"] == 0
        assert eng.prefix_stats["cow_copies"] == cows
    assert blocked > 0
    serving_utils.drain(eng)
    assert eng._finished[rb].done
    assert eng._finished[rc].output == ref
    assert eng.prefix_stats["hits"] >= 1
    assert eng.prefix_stats["cow_copies"] > cows
    _assert_pool_identity(eng)


def test_eviction_makes_room_and_a_request_that_never_fits_raises(
        models, set_both):
    """With too few free pages, a new prompt evicts store-only pages (LRU)
    to fit; one that cannot fit even after eviction, with nothing
    running, raises and leaves the queue and the pool whole."""
    _, tmodel = models
    set_both(prefix_cache=True)
    rng = np.random.default_rng(4)
    eng = _port_engine(tmodel, True, torch.float32, max_len=32,
                       seq_buckets=(8,), n_pages=5)
    for _ in range(2):  # two one-block prompts: 2 store-only pages
        eng.run([rng.integers(1, 256, 9)], max_new_tokens=4)
    assert len(eng._prefix) == 2 and eng.pool.free_pages == 2
    eng.run([rng.integers(1, 256, 17)], max_new_tokens=8)  # 4 pages
    assert eng.prefix_stats["evictions"] == 2 and len(eng._prefix) == 2
    _assert_pool_identity(eng)
    tiny = _port_engine(tmodel, True, torch.float32, max_len=64,
                        seq_buckets=(8,), n_pages=4)
    tiny.add_request(rng.integers(1, 256, 30), max_new_tokens=4)
    with pytest.raises(RuntimeError, match="size n_pages up"):
        tiny.step()
    assert len(tiny._queue) == 1 and tiny.pool.free_pages == 3
    assert not tiny.active.any() and not tiny.pool.ref
