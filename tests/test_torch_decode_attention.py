"""The port's fused decode attention (paddle_tpu_torch.kernels.
decode_attention) against the JAX package's: its plain PyTorch version,
which CPU tensors take, is held against the Pallas kernel (interpret
mode) and against the JAX unfused reference on the same numpy inputs.
The Hopper kernel itself runs only on the card (tests/
test_torch_gpu_kernels.py and chip_smoke.py)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels.rope import rope_frequencies as j_rope_frequencies
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels.rope import rope_frequencies
from torch_decode_cases import (check_plan_geometry, plan_shapes, rank_rows,
                                split_model)

# GQA ratios: kvh 1/4/8 at 8 query heads
GQA = [(1, 8), (4, 2), (8, 1)]
CACHE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def fused_on():
    """The JAX side runs its Pallas kernel in interpret mode."""
    jflags.set_flags({"fused_decode": "on"})
    yield
    jflags.set_flags({"fused_decode": "auto"})


def _inputs(kvh, group, seed=1, slots=3, d=32, max_len=48):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((slots, kvh, group, d)).astype(np.float32),
        k_new=rng.standard_normal((slots, kvh, d)).astype(np.float32),
        v_new=rng.standard_normal((slots, kvh, d)).astype(np.float32),
        ck=rng.standard_normal((slots, max_len, kvh, d)).astype(np.float32),
        cv=rng.standard_normal((slots, max_len, kvh, d)).astype(np.float32),
        # ragged: mid-chunk, on a chunk boundary (chunk = gcd(48, 128) =
        # 16), and an empty slot
        seq_lens=np.asarray([37, 16, 0], np.int32))


def _jax_args(x, cache_dtype):
    jdt = CACHE_DTYPES[cache_dtype][0]
    cos, sin = j_rope_frequencies(x["q"].shape[-1], 128)
    lens = jnp.asarray(x["seq_lens"])
    return (jnp.asarray(x["q"]), jnp.asarray(x["k_new"]),
            jnp.asarray(x["v_new"]), jnp.asarray(x["ck"], jdt),
            jnp.asarray(x["cv"], jdt), lens, lens, cos, sin)


def _torch_args(x, cache_dtype):
    tdt = CACHE_DTYPES[cache_dtype][1]
    cos, sin = rope_frequencies(x["q"].shape[-1], 128, device="cpu")
    lens = torch.tensor(x["seq_lens"])
    # copies: the port updates the caches in place
    return (torch.tensor(x["q"]), torch.tensor(x["k_new"]),
            torch.tensor(x["v_new"]), torch.tensor(x["ck"]).to(tdt),
            torch.tensor(x["cv"]).to(tdt), lens, lens.clone(), cos, sin)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("cache_dtype", sorted(CACHE_DTYPES))
@pytest.mark.parametrize("kvh,group", GQA)
def test_plain_matches_jax_kernel_and_reference(fused_on, kvh, group,
                                                cache_dtype):
    x = _inputs(kvh, group)
    out_k, ck_k, cv_k = jda.fused_contiguous_decode_attention(
        *_jax_args(x, cache_dtype))
    out_r, ck_r, cv_r = jda.fused_contiguous_decode_reference(
        *_jax_args(x, cache_dtype))
    targs = _torch_args(x, cache_dtype)
    before = tda.LAUNCHES
    out, ck, cv = tda.fused_contiguous_decode_attention(*targs)
    # CPU tensors take the plain version: no kernel launch is counted
    assert tda.LAUNCHES == before == 0
    # the caches are updated in place and returned
    assert ck is targs[3] and cv is targs[4]
    # 2e-3: the Pallas kernel's online softmax sums in another order
    # (the tolerance tests/test_decode_attention.py holds it to)
    np.testing.assert_allclose(_np(out), _np(out_k), rtol=2e-3, atol=2e-3)
    # 1e-5: the same unfused float32 arithmetic as the JAX reference
    np.testing.assert_allclose(_np(out), _np(out_r), rtol=1e-5, atol=1e-5)
    # appended rows: the rotated k_new / v_new rounded to the cache dtype,
    # equal to both JAX paths' rows (float32 rope: within 1e-6)
    for got, jk, jr in ((ck, ck_k, ck_r), (cv, cv_k, cv_r)):
        np.testing.assert_allclose(_np(got), _np(jk), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(got), _np(jr), rtol=1e-6, atol=1e-6)
    # every row but the appended one is bit-identical to the input
    keep = np.ones(ck.shape[:2], bool)
    keep[np.arange(3), x["seq_lens"]] = False
    ck_in, cv_in = targs[3].new_tensor(x["ck"]), targs[4].new_tensor(x["cv"])
    assert torch.equal(ck[torch.as_tensor(keep)],
                       ck_in[torch.as_tensor(keep)])
    assert torch.equal(cv[torch.as_tensor(keep)],
                       cv_in[torch.as_tensor(keep)])
    assert not torch.equal(ck, ck_in)


def test_plain_clamps_positions_past_the_rope_table():
    """Positions past the cos/sin table read its last row, as JAX's
    gather clamps them."""
    x = _inputs(2, 2)
    targs = list(_torch_args(x, "float32"))
    far = torch.as_tensor([500, 16, 0], dtype=torch.int32)
    last = torch.as_tensor([127, 16, 0], dtype=torch.int32)
    a = tda.fused_contiguous_decode_plain(
        *[t.clone() for t in targs[:6]], far, *targs[7:])[0]
    b = tda.fused_contiguous_decode_plain(
        *[t.clone() for t in targs[:6]], last, *targs[7:])[0]
    assert torch.equal(a, b)


def test_fused_decode_gate():
    from paddle_tpu_torch import flags

    saved = flags.flag("fused_decode")
    try:
        for val, want in (("auto", True), ("on", True), ("off", False)):
            flags.set_flags({"fused_decode": val})
            assert tda.fused_decode_active() is want
        flags.set_flags({"fused_decode": "sometimes"})
        with pytest.raises(ValueError):
            tda.fused_decode_active()
    finally:
        flags.set_flags({"fused_decode": saved})
    assert tda.contiguous_chunk(48) == jda.contiguous_chunk(48) == 16
    assert tda.contiguous_chunk(1024) == jda.contiguous_chunk(1024) == 128


@pytest.mark.parametrize("bad", ["head_dim", "group", "act_dtype",
                                 "cache_dtype", "lens_dtype", "layout"])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(bad):
    """The shape/dtype/layout gate the wrapper applies before a launch on
    the card raises rather than routing anything to the plain version."""
    slots, kvh, group, d, max_len = 2, 2, 2, 64, 16
    q = torch.zeros(slots, kvh, group, d)
    kn = torch.zeros(slots, kvh, d)
    ck = torch.zeros(slots, max_len, kvh, d, dtype=torch.bfloat16)
    lens = torch.zeros(slots, dtype=torch.int32)
    cos = torch.zeros(32, d // 2)
    args = dict(q=q, k_new=kn, v_new=kn.clone(), ck=ck, cv=ck.clone(),
                seq_lens=lens, positions=lens.clone(), cos=cos,
                sin=cos.clone())
    tda._check(**args)  # the well-formed call passes
    if bad == "head_dim":
        args.update(q=torch.zeros(slots, kvh, group, 48),
                    k_new=torch.zeros(slots, kvh, 48),
                    v_new=torch.zeros(slots, kvh, 48))
    elif bad == "group":
        args.update(q=torch.zeros(slots, kvh, 17, d))
    elif bad == "act_dtype":
        args.update(q=q.double())
    elif bad == "cache_dtype":
        args.update(ck=ck.to(torch.int8), cv=ck.to(torch.int8))
    elif bad == "lens_dtype":
        args.update(seq_lens=lens.long())
    else:
        args.update(ck=ck.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        tda._check(**args)


# ---------------------------------------------------------------------------
# the split kernel's launch plan and its rank split, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape",
                         plan_shapes("contig") + plan_shapes("table"))
def test_split_plan_geometry(shape):
    check_plan_geometry(*shape)


def test_split_plans_at_the_timed_shapes():
    """The CPU model keeps the serving shape and 8 slots at 4096 rows at
    one CTA a stream (256 clusters, held at once), and splits one slot at
    4096 rows over 4 ranks and GQA (64 clusters) over 2."""
    plan = tda._decode_plan
    assert plan(8, 32, 1, 128, 1024, 2, False).ranks == 1
    assert plan(8, 32, 1, 128, 4096, 2, False).ranks == 1
    assert plan(1, 32, 1, 128, 4096, 2, False).ranks == 4
    assert plan(8, 8, 8, 128, 4096, 2, False).ranks == 2
    assert plan(8, 32, 1, 128, 1024, 1, True).ranks == 1


SPLIT_LENS = [0, 7, 8, 64, 100, 127]


def _contig_model_case(quant, seed=3, kvh=1, group=3, d=32, max_len=128):
    rng = np.random.default_rng(seed)
    slots = len(SPLIT_LENS)
    f = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, kn, vn = f(slots, kvh, group, d), f(slots, kvh, d), f(slots, kvh, d)
    cos, sin = rope_frequencies(d, 256, device="cpu")
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32)
    extra = {}
    if quant:
        ck = torch.tensor(rng.integers(-127, 128, (slots, max_len, kvh, d)),
                          dtype=torch.int8)
        cv = torch.tensor(rng.integers(-127, 128, (slots, max_len, kvh, d)),
                          dtype=torch.int8)
        extra = dict(k_scale=torch.rand(slots, max_len, kvh) * 0.02 + 1e-3,
                     v_scale=torch.rand(slots, max_len, kvh) * 0.02 + 1e-3)
    else:
        ck, cv = f(slots, max_len, kvh, d), f(slots, max_len, kvh, d)
    got = tda.fused_contiguous_decode_plain(q, kn, vn, ck, cv, lens,
                                            lens + 2, cos, sin, **extra)
    qr = tda._rope_rotate(q.reshape(slots, kvh * group, d), lens + 2, cos,
                          sin).reshape(slots, kvh, group, d)
    return got, qr, lens


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ranks", tda.RANK_CHOICES)
def test_split_model_matches_the_plain_version(ranks, quant):
    """The rank split and its rank-ordered merge, modelled in plain torch
    with CTAs of 4 and 8 warps, equal the plain version (dense masked
    attention) at 1e-5, float32 and int8 caches, lengths at tile and rank
    boundaries."""
    got, qr, lens = _contig_model_case(quant)
    out, ck, cv = got[:3]
    slots, kvh, group, d = qr.shape
    for s in range(slots):
        L = int(lens[s])
        for h in range(kvh):
            k, v = ck[s, :L + 1, h].float(), cv[s, :L + 1, h].float()
            scales = ((got[3][s, :L + 1, h], got[4][s, :L + 1, h]) if quant
                      else (None, None))
            for warps in (4, 8):  # the kernel's two CTA sizes
                want = split_model(qr[s, h], k, v, L, ranks, d ** -0.5,
                                   *scales, warps=warps)
                torch.testing.assert_close(want, out[s, h], rtol=1e-5,
                                           atol=1e-5)


def test_split_model_without_one_rank_fails():
    """The check has teeth: the model with rank 1's partial left out of
    the merge differs from the plain version on every slot whose rank 1
    holds rows."""
    got, qr, lens = _contig_model_case(False)
    out, ck, cv = got
    d = qr.shape[-1]
    for s, L in enumerate(lens.tolist()):
        if rank_rows(L, 4)[1][0] == rank_rows(L, 4)[1][1]:
            continue
        bad = split_model(qr[s, 0], ck[s, :L + 1, 0], cv[s, :L + 1, 0], L, 4,
                          d ** -0.5, drop=1)
        assert not torch.allclose(bad, out[s, 0], rtol=1e-5, atol=1e-5)


def _table_model_case(page_size, seed=5, kvh=2, group=3, d=32):
    """Row 3's plain version on a float32 pool addressed through a
    permuted block table (one inactive slot on the sink page), at the
    ``SPLIT_LENS`` lengths; returns its output and, per slot and kv head,
    the query rows and the pool rows 0..L as the kernel reads them."""
    rng = np.random.default_rng(seed)
    slots, span = len(SPLIT_LENS) + 1, 128
    max_pages = -(-span // page_size)
    n_pages = slots * max_pages + 1
    bt = (rng.permutation(n_pages - 1) + 1).reshape(slots, max_pages)
    bt[-1] = 0  # an inactive slot: the sink page, length 0
    f = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q = f(slots, kvh, group, d)
    kp, vp = f(kvh, n_pages, page_size, d), f(kvh, n_pages, page_size, d)
    lens = SPLIT_LENS + [0]
    out = tpa.paged_decode_plain(q, kp, vp,
                                 torch.tensor(bt, dtype=torch.int32),
                                 torch.tensor(lens, dtype=torch.int32))
    streams = []
    for s, L in enumerate(lens):
        j = torch.arange(L + 1)
        page, off = torch.as_tensor(bt[s])[j // page_size], j % page_size
        for h in range(kvh):
            streams.append((q[s, h], kp[h, page, off], vp[h, page, off], L,
                            out[s, h]))
    return streams


@pytest.mark.parametrize("page_size", [1, 16])
@pytest.mark.parametrize("ranks", tda.RANK_CHOICES)
def test_split_model_matches_the_block_table_plain_version(ranks,
                                                           page_size):
    """Row 3 on the split kernel: the rank split and merge modelled over
    each stream's rows 0..L taken whole from the pool (no rotation, no
    new row), with CTAs of 4 and 8 warps, equal ``paged_decode_plain`` at
    1e-5 at lengths on tile and rank boundaries and on the sink page."""
    for q, k, v, L, want in _table_model_case(page_size):
        for warps in (4, 8):
            got = split_model(q, k, v, L, ranks, q.shape[-1] ** -0.5,
                              warps=warps)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_block_table_split_model_without_one_rank_fails():
    """The block-table check has teeth: with rank 1's partial left out of
    the merge, the model differs from ``paged_decode_plain`` on every
    stream whose rank 1 holds rows."""
    checked = 0
    for q, k, v, L, want in _table_model_case(16):
        if rank_rows(L, 4)[1][0] == rank_rows(L, 4)[1][1]:
            continue
        bad = split_model(q, k, v, L, 4, q.shape[-1] ** -0.5, drop=1)
        assert not torch.allclose(bad, want, rtol=1e-5, atol=1e-5)
        checked += 1
    assert checked > 0
