"""Paged-KV serving in the PyTorch port (paddle_tpu_torch.inference.paged,
kernels.paged_attention, the paged Llama branches and the engine's paged
mode) against the JAX package on the CPU, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode where a test holds
the port's plain versions against them (``paged_decode_attention`` and
``fused_paged_decode_attention`` called directly), and its lax references
elsewhere. The engine tests compare greedy tokens with the JAX engine's,
computed once per module on its default CPU path (the unfused lax path;
``tests/test_decode_attention.py`` pins its fused tokens as equal). The
Hopper kernels themselves run only on the card
(``tests/test_torch_gpu_kernels.py`` and ``chip_smoke.py``)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels.rope import rope_frequencies as j_rope_frequencies
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import ContinuousBatchingEngine, EngineConfig
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels.rope import rope_frequencies
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from torch_decode_cases import check_plan_geometry, plan_shapes, split_model

# GQA ratios: kvh 1/4/8 at 8 query heads (tests/test_decode_attention.py)
GQA = [(1, 8), (4, 2), (8, 1)]
POOL_DTYPES = {"float32": (jnp.float32, torch.float32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SLOTS, D, PS, N_PAGES, MAX_PAGES = 3, 32, 16, 32, 4


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _setup(kvh, group, seed=0, sink_free=False):
    """The JAX tests' paged setup as numpy arrays: slots 3, d 32, 16-row
    pages, 32 pages, 4 pages per slot, a permuted block table, lengths
    mid-page, on a page boundary and 0. ``sink_free`` draws the table
    from pages 1..31, as the engine's pool does, for writes that the port
    redirects to page 0 where JAX drops them."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(N_PAGES - 1) + 1 if sink_free \
        else rng.permutation(N_PAGES)
    return dict(
        kp=rng.standard_normal((kvh, N_PAGES, PS, D)).astype(np.float32),
        vp=rng.standard_normal((kvh, N_PAGES, PS, D)).astype(np.float32),
        bt=pages[:SLOTS * MAX_PAGES].reshape(SLOTS, MAX_PAGES)
        .astype(np.int32),
        lens=np.asarray([37, 16, 0], np.int32),
        q=rng.standard_normal((SLOTS, kvh, group, D)).astype(np.float32),
        kn=rng.standard_normal((SLOTS, kvh, D)).astype(np.float32),
        vn=rng.standard_normal((SLOTS, kvh, D)).astype(np.float32))


def _jax_pool(x, dtype):
    jdt = POOL_DTYPES[dtype][0]
    return (jpaged.PagedLayerCache(jnp.asarray(x["kp"], jdt),
                                   jnp.asarray(x["vp"], jdt)),
            jpaged.PagedState(jnp.asarray(x["bt"]), jnp.asarray(x["lens"])))


def _torch_pool(x, dtype):
    tdt = POOL_DTYPES[dtype][1]
    # copies: the port writes the pools in place
    return (tpaged.PagedLayerCache(torch.tensor(x["kp"]).to(tdt),
                                   torch.tensor(x["vp"]).to(tdt)),
            tpaged.PagedState(torch.tensor(x["bt"]),
                              torch.tensor(x["lens"])))


def _pools_equal_outside_sink(got, want, tol):
    """Pools compared on every page but the sink page 0: bit-identical
    (tol None) or within tol."""
    for g, w in ((got.k_pages, want.k_pages), (got.v_pages, want.v_pages)):
        g, w = _np(g)[:, 1:], _np(w)[:, 1:]
        if tol is None:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------- PagePool
def _pool_state(pool):
    return (pool.block_tables.tolist(), {k: list(v) for k, v in
                                         pool.pages_of.items()},
            dict(pool.ref), pool.free_pages, pool.shared_pages)


@pytest.mark.parametrize("reserve_sink", [False, True])
def test_page_pool_random_operations_match_jax(reserve_sink):
    """One seeded random sequence of alloc/free/retain/release/cow/adopt
    on both pools, used as a prefix store would use them (retain a slot's
    page, adopt retained pages into an empty slot, copy a shared page on
    write, release the store's pages): equal state after every call, and
    the same calls refused (False/None) or raising (a double release,
    adopt into a slot that holds pages)."""
    rng = np.random.default_rng(3)
    args = (20, 4, 3, 5, reserve_sink)
    jp, tp = jpaged.PagePool(*args), tpaged.PagePool(*args)
    store = []  # pages the imagined prefix store retains
    ops = ("alloc", "free", "retain", "release", "cow", "adopt")
    counts = dict.fromkeys(ops, 0)
    for _ in range(600):
        op = ops[rng.integers(len(ops))]
        slot = int(rng.integers(3))
        held = jp.pages_of[slot]
        if op == "alloc":
            call = ("alloc", slot, int(rng.integers(1, 24)))
        elif op == "free":
            call = ("free", slot)
        elif op == "retain":
            if not held:
                continue
            call = ("retain", int(held[rng.integers(len(held))]))
        elif op == "release":
            # mostly a store page; sometimes an un-owned one (raises)
            call = ("release", store.pop(rng.integers(len(store)))
                    if store and rng.random() < 0.9
                    else next(p for p in range(20) if p not in jp.ref))
        elif op == "cow":
            if not held:
                continue
            call = ("cow", slot, int(rng.integers(len(held))))
        else:
            k = int(rng.integers(0, min(len(store), 6) + 1))
            call = ("adopt", slot, [int(p) for p in store[:k]])
        results = []
        for pool in (jp, tp):
            try:
                results.append(getattr(pool, call[0])(*call[1:]))
            except ValueError as e:
                results.append(type(e))
        assert results[0] == results[1], call
        assert _pool_state(jp) == _pool_state(tp), call
        if op == "retain":
            store.append(call[1])
        # calls that took effect: no raise, no refusal (alloc and adopt
        # refuse with False, cow with None; the others return None)
        refused = (ValueError, False) + ((None,) if op == "cow" else ())
        counts[op] += results[0] not in refused
    assert min(counts.values()) >= 10, counts
    assert tp.pages_needed(33) == jp.pages_needed(33) == 9


def test_page_pool_device_state_copies_the_table():
    pool = tpaged.PagePool(9, 4, 2, 4, reserve_sink=True)
    assert pool.alloc(0, 10)
    state = pool.device_state(np.asarray([10, 0]), device="cpu")
    assert state.block_tables.dtype == state.seq_lens.dtype == torch.int32
    assert state.block_tables.tolist() == [[1, 2, 3, 0], [0, 0, 0, 0]]
    pool.free(0)  # a later free never reaches the snapshot
    assert state.block_tables.tolist()[0] == [1, 2, 3, 0]
    assert pool.free_pages == 8


# ----------------------------------------------- append, gather, attention
@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("kvh", [1, 4])
def test_append_kv_matches_jax(dtype, kvh):
    x = _setup(kvh, 1)
    jc, js = _jax_pool(x, dtype)
    tc, ts = _torch_pool(x, dtype)
    k = np.random.default_rng(1).standard_normal(
        (SLOTS, 1, kvh, D)).astype(np.float32)
    want = jpaged.append_kv(jc, js, jnp.asarray(k), jnp.asarray(k * 2))
    got = tpaged.append_kv(tc, ts, torch.tensor(k), torch.tensor(k * 2))
    assert got.k_pages is tc.k_pages  # in place
    _pools_equal_outside_sink(got, want, 1e-6 if dtype == "float32"
                              else None)
    # page 0 too: no row was dropped, and the table's pages are distinct
    np.testing.assert_array_equal(_np(got.k_pages), _np(want.k_pages))


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("start", [[5, 60, 64], [0, 16, 33]])
def test_append_kv_chunk_matches_jax(dtype, start):
    """Chunks of 8 rows: mid-page and page-crossing starts, a chunk that
    crosses max_len (60: rows 64-67 fall past the table) and the
    ``start = max_len`` sentinel (64). JAX drops the rows past the table;
    the port sends them to the sink page 0, so every other page agrees."""
    kvh = 4
    x = _setup(kvh, 1, sink_free=True)
    jc, js = _jax_pool(x, dtype)
    tc, ts = _torch_pool(x, dtype)
    rng = np.random.default_rng(2)
    k = rng.standard_normal((SLOTS, 8, kvh, D)).astype(np.float32)
    v = rng.standard_normal((SLOTS, 8, kvh, D)).astype(np.float32)
    st = np.asarray(start, np.int32)
    want = jpaged.append_kv_chunk(jc, js, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(st))
    got = tpaged.append_kv_chunk(tc, ts, torch.tensor(k), torch.tensor(v),
                                 torch.tensor(st))
    _pools_equal_outside_sink(got, want, 1e-6 if dtype == "float32"
                              else None)
    # the chunk really landed: slot 0's first row is where its start says
    row = _np(got.k_pages)[:, x["bt"][0, st[0] // PS], st[0] % PS]
    np.testing.assert_allclose(row, k[0, 0], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
@pytest.mark.parametrize("kvh,group", GQA)
def test_gather_and_dense_attention_match_jax(dtype, kvh, group):
    x = _setup(kvh, group)
    jc, js = _jax_pool(x, dtype)
    tc, ts = _torch_pool(x, dtype)
    for got, want in zip(tpaged.gather_kv(tc, ts), jpaged.gather_kv(jc, js)):
        assert tuple(got.shape) == (SLOTS, MAX_PAGES * PS, kvh, D)
        np.testing.assert_array_equal(_np(got), _np(want))
    q = x["q"].reshape(SLOTS, 1, kvh * group, D)
    want = jpaged.dense_paged_attention(jnp.asarray(q), jc, js)
    got = tpaged.dense_paged_attention(torch.tensor(q), tc, ts)
    # 1e-5: the same float32 gather, einsum and softmax
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_int8_pools_raise():
    """An int8 pool carries zeroed float32 scale arrays of the JAX pool's
    shape, [kv_heads, n_pages, page_size, 1]; a pool whose payload and
    scales disagree (float pages with scales, or int8 pages without)
    raises, as does a pool dtype that is neither float nor int8."""
    want = jpaged.init_paged_pool(2, 5, 4, 3, 32, dtype=jnp.int8)
    got = tpaged.init_paged_pool(2, 5, 4, 3, 32, dtype=torch.int8,
                                 device="cpu")
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            assert tuple(gt.shape) == tuple(wt.shape)
            assert str(gt.dtype).split(".")[-1] == str(wt.dtype)
            assert not gt.any()
    assert tuple(got[0].k_scale.shape) == (3, 5, 4, 1)
    x = _setup(1, 1)
    tc, ts = _torch_pool(x, "float32")
    quant = tc._replace(k_scale=torch.ones(1), v_scale=torch.ones(1))
    with pytest.raises(ValueError):
        tpaged.gather_kv(quant, ts)
    with pytest.raises(ValueError):
        tpaged.gather_kv(got[0]._replace(k_scale=None, v_scale=None), ts)
    with pytest.raises(ValueError):
        tpaged.init_paged_pool(1, 4, 4, 1, 32, dtype=torch.int32,
                               device="cpu")
    pools = tpaged.init_paged_pool(2, 4, 4, 1, 32, dtype=torch.float32,
                                   device="cpu")
    assert len(pools) == 2 and not pools[1].v_pages.any()
    assert tuple(pools[0].k_pages.shape) == (1, 4, 4, 32)
    assert pools[0].k_scale is None


# ------------------------------------------- the two kernels' plain versions
@pytest.mark.parametrize("kvh,group", GQA)
def test_block_table_plain_matches_jax_kernel_and_reference(kvh, group):
    """Row 3: the port's ``paged_decode_attention`` on CPU tensors (its
    plain version) against the Pallas kernel (interpret mode) and the JAX
    dense reference."""
    x = _setup(kvh, group)
    jc, js = _jax_pool(x, "float32")
    tc, ts = _torch_pool(x, "float32")
    want_k = jpa.paged_decode_attention(jnp.asarray(x["q"]), jc.k_pages,
                                        jc.v_pages, js.block_tables,
                                        js.seq_lens)
    want_r = jpaged.dense_paged_attention(
        jnp.asarray(x["q"].reshape(SLOTS, 1, kvh * group, D)), jc, js)
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_decode_attention(torch.tensor(x["q"]), tc.k_pages,
                                     tc.v_pages, ts.block_tables,
                                     ts.seq_lens)
    assert tpa.LAUNCHES == before == dict.fromkeys(before, 0)
    # 2e-3: the Pallas kernel's online softmax sums in another order
    np.testing.assert_allclose(_np(got), _np(want_k), rtol=2e-3, atol=2e-3)
    # 1e-5: the same dense float32 arithmetic as the JAX reference
    np.testing.assert_allclose(
        _np(got), _np(want_r).reshape(got.shape), rtol=1e-5, atol=1e-5)
    # the dispatch the unfused llama branch calls takes the same route
    via = tpaged.paged_attention(
        torch.tensor(x["q"].reshape(SLOTS, 1, kvh * group, D)), tc, ts)
    assert torch.equal(via.reshape(got.shape), got)


def _fused_args(x, jdt, tdt):
    cos_j, sin_j = j_rope_frequencies(D, 128)
    cos_t, sin_t = rope_frequencies(D, 128, device="cpu")
    lens = x["lens"]
    jargs = (jnp.asarray(x["q"]), jnp.asarray(x["kn"]), jnp.asarray(x["vn"]),
             jnp.asarray(x["kp"], jdt), jnp.asarray(x["vp"], jdt),
             jnp.asarray(x["bt"]), jnp.asarray(lens), jnp.asarray(lens),
             cos_j, sin_j)
    targs = (torch.tensor(x["q"]), torch.tensor(x["kn"]),
             torch.tensor(x["vn"]), torch.tensor(x["kp"]).to(tdt),
             torch.tensor(x["vp"]).to(tdt), torch.tensor(x["bt"]),
             torch.tensor(lens), torch.tensor(lens), cos_t, sin_t)
    return jargs, targs


@pytest.mark.parametrize("kvh,group", GQA)
def test_fused_plain_matches_jax_kernel_and_reference(kvh, group):
    """Row 2: the port's ``fused_paged_decode_attention`` on CPU tensors
    (its plain version) against the Pallas kernel (interpret mode) and
    the JAX ``fused_paged_decode_reference``."""
    x = _setup(kvh, group)
    jargs, targs = _fused_args(x, jnp.float32, torch.float32)
    out_k, kp_k, vp_k = jpa.fused_paged_decode_attention(*jargs)
    out_r, kp_r, vp_r = jda.fused_paged_decode_reference(*jargs)
    before = dict(tpa.LAUNCHES)
    out, kp, vp = tpa.fused_paged_decode_attention(*targs)
    assert tpa.LAUNCHES == before == dict.fromkeys(before, 0)
    assert kp is targs[3] and vp is targs[4]  # in place
    np.testing.assert_allclose(_np(out), _np(out_k), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(out), _np(out_r), rtol=1e-5, atol=1e-5)
    # appended rows: the rotated k_new / v_new, within 1e-6 of both JAX
    # paths' pools (float32 rope)
    for got, jk, jr in ((kp, kp_k, kp_r), (vp, vp_k, vp_r)):
        np.testing.assert_allclose(_np(got), _np(jk), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(got), _np(jr), rtol=1e-6, atol=1e-6)
    # every row but the appended one is bit-identical to the input
    keep = np.ones((N_PAGES, PS), bool)
    for s, L in enumerate(x["lens"]):
        keep[x["bt"][s, L // PS], L % PS] = False
    assert np.array_equal(_np(kp)[:, keep], x["kp"][:, keep])
    assert not np.array_equal(_np(kp), x["kp"])


def test_fused_plain_takes_bf16_pools_like_jax():
    """bf16 pools with float32 activations: the appended rows are the
    reference scatter's bf16 rounding, bit for bit, and the output stays
    within the JAX test's bf16 tolerance of the reference."""
    x = _setup(2, 2)
    jargs, targs = _fused_args(x, jnp.bfloat16, torch.bfloat16)
    out_r, kp_r, vp_r = jda.fused_paged_decode_reference(*jargs)
    out, kp, vp = tpa.fused_paged_decode_attention(*targs)
    assert kp.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(kp), _np(kp_r))
    np.testing.assert_array_equal(_np(vp), _np(vp_r))
    np.testing.assert_allclose(_np(out), _np(out_r), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bad", ["head_dim", "group", "pool_dtype",
                                 "table_dtype", "layout", "rope"])
def test_wrapper_checks_reject_what_the_kernels_do_not_take(bad):
    """The gate the wrappers apply before a launch on the card raises
    rather than routing anything to a plain version."""
    kvh, group, d = 2, 2, 64
    args = dict(q=torch.zeros(SLOTS, kvh, group, d),
                k_pages=torch.zeros(kvh, 8, 4, d, dtype=torch.bfloat16),
                v_pages=torch.zeros(kvh, 8, 4, d, dtype=torch.bfloat16),
                block_tables=torch.zeros(SLOTS, 2, dtype=torch.int32),
                seq_lens=torch.zeros(SLOTS, dtype=torch.int32))
    fused = dict(k_new=torch.zeros(SLOTS, kvh, d),
                 v_new=torch.zeros(SLOTS, kvh, d),
                 positions=torch.zeros(SLOTS, dtype=torch.int32),
                 cos=torch.zeros(16, d // 2), sin=torch.zeros(16, d // 2))
    tpa._check(**args, **fused)  # the well-formed calls pass
    tpa._check(**args)
    if bad == "head_dim":
        args.update(q=torch.zeros(SLOTS, kvh, group, 48))
    elif bad == "group":
        args.update(q=torch.zeros(SLOTS, kvh, 17, d))
    elif bad == "pool_dtype":
        args.update(k_pages=args["k_pages"].to(torch.int8),
                    v_pages=args["v_pages"].to(torch.int8))
    elif bad == "table_dtype":
        args.update(block_tables=args["block_tables"].long())
    elif bad == "layout":
        args.update(k_pages=args["k_pages"].transpose(1, 2))
    else:
        fused.update(cos=torch.zeros(16, d))
    with pytest.raises(ValueError):
        tpa._check(**args, **fused)


# ------------------------------------------------------ the paged Llama path
@pytest.mark.parametrize("shape", plan_shapes("paged"))
def test_split_plan_geometry_paged(shape):
    """Row 2's plan at every paged card-test shape (the CPU model)."""
    check_plan_geometry(*shape)


@pytest.mark.parametrize("page_size", [1, 5, 16])
@pytest.mark.parametrize("quant", [False, True])
def test_split_model_matches_the_paged_plain_version(page_size, quant):
    """The split kernel's rank split and merge, modelled in plain torch
    over each stream's rows gathered through a permuted block table (page
    size 1, 5 and 16; float32 and int8 pools; an inactive slot on the sink
    page), equal the plain version at 1e-5 for 1, 2, 4 and 8 ranks of
    CTAs of 4 and 8 warps; with rank 1's partial left out the model
    differs."""
    rng = np.random.default_rng(page_size)
    lens = [0, 8, 63, 100, 0]
    slots, kvh, group, d, span = len(lens), 1, 2, 32, 112
    max_pages = span // page_size + (span % page_size > 0)
    n_pages = slots * max_pages + 1
    bt = (rng.permutation(n_pages - 1) + 1).reshape(slots, max_pages)
    bt[-1] = 0  # an inactive slot: the sink page
    f = lambda *sh: torch.tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32))
    q, kn, vn = f(slots, kvh, group, d), f(slots, kvh, d), f(slots, kvh, d)
    shape = (kvh, n_pages, page_size, d)
    extra = {}
    if quant:
        kp = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        vp = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        extra = dict(k_scale=torch.rand(*shape[:3], 1) * 0.02 + 1e-3,
                     v_scale=torch.rand(*shape[:3], 1) * 0.02 + 1e-3)
    else:
        kp, vp = f(*shape), f(*shape)
    cos, sin = rope_frequencies(d, 256, device="cpu")
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got = tpa.fused_paged_decode_plain(
        q, kn, vn, kp, vp, torch.tensor(bt, dtype=torch.int32), lens_t,
        lens_t + 1, cos, sin, **extra)
    out = got[0]
    qr = tpa._rope_rotate(q.reshape(slots, kvh * group, d), lens_t + 1, cos,
                          sin).reshape(slots, kvh, group, d)
    for s, L in enumerate(lens):
        j = torch.arange(L + 1)
        page, off = torch.as_tensor(bt[s])[j // page_size], j % page_size
        k, v = got[1][0, page, off].float(), got[2][0, page, off].float()
        scales = ((got[3][0, page, off, 0], got[4][0, page, off, 0])
                  if quant else (None, None))
        for ranks in (1, 2, 4, 8):
            for warps in (4, 8):
                want = split_model(qr[s, 0], k, v, L, ranks, d ** -0.5,
                                   *scales, warps=warps)
                torch.testing.assert_close(want, out[s, 0], rtol=1e-5,
                                           atol=1e-5)
        if L >= 8:  # rank 1 of 4 holds rows
            bad = split_model(qr[s, 0], k, v, L, 4, d ** -0.5, *scales,
                              drop=1)
            assert not torch.allclose(bad, out[s, 0], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


@pytest.mark.parametrize("fused", ["on", "off"])
def test_llama_paged_branches_match_jax(models, fused):
    """A two-chunk paged prefill (slot 1 idle at the max_len sentinel for
    the first chunk), then four decode steps, over a pool whose table the
    host pool allocates. The JAX side runs its default CPU path; the port
    runs the plain fused version (on) or the unfused branch (off)."""
    jmodel, tmodel = models
    cfg = tmodel.config
    slots, max_len, ps, C = 2, 128, 8, 8
    max_pages = max_len // ps
    pool = tpaged.PagePool(slots * max_pages + 1, ps, slots, max_pages,
                           reserve_sink=True)
    assert pool.alloc(0, 30) and pool.alloc(1, 30)
    bt = pool.block_tables.copy()
    n_pages = pool.n_pages
    jc = jpaged.init_paged_pool(cfg.num_hidden_layers, n_pages, ps,
                                cfg.num_key_value_heads, cfg.head_dim,
                                dtype=jnp.float32)
    tc = tpaged.init_paged_pool(cfg.num_hidden_layers, n_pages, ps,
                                cfg.num_key_value_heads, cfg.head_dim,
                                dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(6)

    def step(ids, pos, lens, live):
        nonlocal jc
        js = jpaged.PagedState(jnp.asarray(bt), jnp.asarray(lens, jnp.int32))
        ts = tpaged.PagedState(torch.tensor(bt),
                               torch.tensor(lens, dtype=torch.int32))
        jl, jkv = jmodel(jnp.asarray(ids), position_ids=jnp.asarray(pos),
                         kv_caches=[(c, js) for c in jc],
                         cache_index=jnp.asarray(lens, jnp.int32))
        jc = [c for c, _ in jkv]
        tl, _ = tmodel(torch.as_tensor(ids), position_ids=torch.as_tensor(pos),
                       kv_caches=[(c, ts) for c in tc],
                       cache_index=torch.as_tensor(lens))
        # 1e-4: float32 end to end; the plain fused version and the JAX
        # reference sum the softmax over the gathered view alike. Only the
        # rows the engine reads: a slot at the max_len sentinel attends
        # its whole view, sink page included, where the port has put the
        # rows JAX drops.
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=1e-4, atol=1e-4)

    saved = tflags.flag("fused_decode")
    tflags.set_flags({"fused_decode": fused})
    try:
        for start in (np.asarray([0, max_len]), np.asarray([C, 0])):
            step(rng.integers(1, 256, (slots, C)),
                 start[:, None] + np.arange(C), start, start < max_len)
        lens = np.asarray([2 * C, C])
        for _ in range(4):
            step(rng.integers(1, 256, (slots, 1)), lens[:, None], lens,
                 lens >= 0)
            lens = lens + 1
    finally:
        tflags.set_flags({"fused_decode": saved})
    for j, t in zip(jc, tc):
        _pools_equal_outside_sink(t, j, 1e-4)


# ---------------------------------------------------------------- the engine
MAX_NEW = 12


@pytest.fixture
def flags16():
    """16-token prefill chunks, no prefix cache on either side and no
    speculative decoding on the JAX side; restores every flag."""
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
    # the tiny_ecfg(paged=True) shapes: 2 slots, max_len 128, 8-token
    # pages, float32 pools
    return ContinuousBatchingEngine(
        tmodel, EngineConfig(max_slots=2, max_len=128, seq_buckets=(32,),
                             page_size=8, paged=True,
                             cache_dtype=torch.float32, **kw),
        device="cpu")


def _drive(eng, prompts, loop):
    """Serve through ``run`` or a ``step`` loop; returns the outputs and
    whether any admission pass waited on the pool."""
    blocked = False
    rids = [eng.add_request(p, MAX_NEW) for p in prompts]
    # run() drives step_chunk(max_chunk) in this loop
    step = (lambda: eng.step_chunk(4)) if loop == "run" else eng.step
    while step() or eng._queue or eng.active.any():
        blocked = blocked or eng._pool_blocked
    return [eng._finished[r].output for r in rids], blocked


@pytest.fixture(scope="module")
def jax_outputs(models):
    """The JAX paged engine's greedy tokens for each loop."""
    jmodel, _ = models
    saved = {k: jflags.flag(k)
             for k in ("prefix_cache", "spec_decode", "prefill_chunk")}
    jflags.set_flags({"prefix_cache": False, "spec_decode": "off",
                      "prefill_chunk": 16})
    try:
        out = {}
        for d in ("run", "step"):
            eng = JEngine(jmodel, serving_utils.tiny_ecfg(paged=True))
            if d == "run":
                out[d] = [r.output for r in eng.run(
                    _prompts(), max_new_tokens=MAX_NEW, max_chunk=4)]
            else:
                rids = [eng.add_request(p, MAX_NEW) for p in _prompts()]
                serving_utils.drain(eng)
                out[d] = [eng._finished[r].output for r in rids]
        return out
    finally:
        jflags.set_flags(saved)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("loop", ["run", "step"])
def test_paged_engine_greedy_tokens_identical_to_jax(models, jax_outputs,
                                                     flags16, loop, fused):
    _, tmodel = models
    tflags.set_flags({"fused_decode": fused})
    eng = _port_engine(tmodel)
    got, _ = _drive(eng, _prompts(), loop)
    assert got == jax_outputs[loop]
    assert all(len(o) == MAX_NEW for o in got)
    # every page is back in the pool; page 0 (the sink) never left it
    assert eng.stats["free_pages"] == eng.pool.free_pages == 32
    assert not eng.pool.ref and sorted(eng._free_heap) == [0, 1]
    if loop == "run":
        assert [r.output for r in _port_engine(tmodel).run(
            _prompts(), max_new_tokens=MAX_NEW, max_chunk=4)] == got


@pytest.mark.parametrize("fused", ["on", "off"])
def test_oversubscribed_pool_waits_and_gives_the_same_tokens(
        models, jax_outputs, flags16, fused):
    """A pool of 8 usable pages under 2 slots of 16 pages each: the
    40-token request (7 pages) cannot join the 3-token one (2 pages), so
    admission waits for a finisher with a slot free. The tokens stay the
    JAX engine's, and every page returns."""
    _, tmodel = models
    tflags.set_flags({"fused_decode": fused})
    eng = _port_engine(tmodel, n_pages=9)
    got, blocked = _drive(eng, _prompts(), "run")
    assert blocked
    assert got == jax_outputs["run"]
    assert eng.stats["free_pages"] == eng.pool.free_pages == 8
    assert not eng.pool.ref


def test_request_that_can_never_fit_raises(models, flags16):
    _, tmodel = models
    eng = _port_engine(tmodel, n_pages=4)  # 3 usable pages = 24 tokens
    eng.add_request(np.arange(1, 20), max_new_tokens=10)
    with pytest.raises(RuntimeError, match="size n_pages up"):
        eng.step_chunk(4)
    # the failed admission left the request queued and the pool whole
    assert len(eng._queue) == 1 and eng.pool.free_pages == 3
    assert not eng.active.any()


def test_cancel_returns_pages(models, flags16):
    _, tmodel = models
    eng = _port_engine(tmodel)
    rids = [eng.add_request(p, MAX_NEW) for p in _prompts()[:3]]
    eng.step()  # admits two, the third waits for a slot
    held = eng.pool.free_pages
    assert held < 32 and eng.stats["free_pages"] == held
    need = eng.pool.pages_needed(_prompts()[0].size + MAX_NEW)
    assert eng.cancel(rids[0])  # active: its pages return at once
    assert eng.pool.free_pages == held + need
    assert eng.pool.block_tables[0].tolist() == [0] * 16
    assert eng.cancel(rids[2])  # queued: held no pages
    serving_utils.drain(eng)
    assert eng._finished[rids[0]].finish_reason == "cancel"
    assert len(eng._finished[rids[1]].output) == MAX_NEW
    assert eng.pool.free_pages == 32 and not eng.pool.ref


@pytest.fixture(scope="module")
def jax_legacy(models):
    """The JAX paged engine's greedy tokens under the legacy bucketed
    prefill (``PT_FLAGS_prefill_chunk=0``, ``run`` loop)."""
    jmodel, _ = models
    saved = {k: jflags.flag(k) for k in ("spec_decode", "prefill_chunk")}
    jflags.set_flags({"spec_decode": "off", "prefill_chunk": 0})
    try:
        eng = JEngine(jmodel, serving_utils.tiny_ecfg(paged=True))
        return [r.output for r in eng.run(_prompts(), max_new_tokens=MAX_NEW,
                                          max_chunk=4)]
    finally:
        jflags.set_flags(saved)


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("loop", ["run", "step"])
def test_legacy_prefill_paged_tokens_identical_to_jax(
        models, jax_outputs, jax_legacy, flags16, loop, fused):
    """``PT_FLAGS_prefill_chunk=0`` on the paged engine: each request
    claims max(prompt + max_new_tokens, bucket) rows of pages and its
    ``[1, bucket]`` prefill cache is scattered into the first bucket /
    page_size of them. The tokens are the JAX legacy engine's and the
    chunked engines'; every page returns, and the prefix cache stays off
    though its flag is on."""
    _, tmodel = models
    assert jax_legacy == jax_outputs["run"]
    tflags.set_flags({"fused_decode": fused, "prefill_chunk": 0,
                      "prefix_cache": True})
    eng = _port_engine(tmodel)
    got, _ = _drive(eng, _prompts(), loop)
    assert got == jax_outputs[loop]
    assert eng.stats["prefill_bucket"] == 5
    assert eng.stats["free_pages"] == eng.pool.free_pages == 32
    assert not eng.pool.ref and sorted(eng._free_heap) == [0, 1]
    snap = eng.prefix_snapshot()
    assert not snap["enabled"] and snap["hits"] == snap["misses"] == 0


def test_legacy_prefill_pool_waits_or_raises(models, jax_outputs, flags16):
    """A pool of 17 usable pages: the 40-token request claims a whole
    128-row bucket (16 pages) and cannot join the 3-token one, so
    admission waits for a finisher with the tokens unchanged; a request
    that can never fit raises, stays queued and leaves the pool whole."""
    _, tmodel = models
    tflags.set_flags({"prefill_chunk": 0})
    eng = _port_engine(tmodel, n_pages=18)
    got, blocked = _drive(eng, _prompts(), "run")
    assert blocked and got == jax_outputs["run"]
    assert eng.pool.free_pages == 17 and not eng.pool.ref
    eng = _port_engine(tmodel, n_pages=4)  # 3 usable pages < the 32 bucket
    eng.add_request(np.arange(1, 20), max_new_tokens=10)
    with pytest.raises(RuntimeError, match="size n_pages up"):
        eng.step_chunk(4)
    assert len(eng._queue) == 1 and eng.pool.free_pages == 3
    assert not eng.active.any() and sorted(eng._free_heap) == [0, 1]


@pytest.mark.parametrize("bad", ["page_size", "max_len", "bucket"])
def test_paged_configs_the_jax_engine_refuses_raise(models, flags16, bad):
    _, tmodel = models
    kw = {"page_size": dict(page_size=0), "max_len": dict(page_size=24),
          "bucket": dict(page_size=16, seq_buckets=(40,))}[bad]
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(
            tmodel, EngineConfig(max_slots=2, max_len=128, paged=True,
                                 cache_dtype=torch.float32, **kw),
            device="cpu")

