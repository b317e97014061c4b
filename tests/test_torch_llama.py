"""The port's Llama path (paddle_tpu_torch) against the JAX package on the
CPU: rope, rms_norm, masked attention and the per-slot logits processor
on the same numpy inputs, then the tiny LlamaForCausalLM with the JAX
weights carried across, without a cache and through the contiguous
per-slot cache branches (chunked prefill, then decode with the fused
path on and off). All float32; each tolerance says why."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import generation as jgen
from paddle_tpu.kernels import rope as jrope
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference.paged import (PagedState, QuantizedKV,
                                               init_paged_pool)
from paddle_tpu_torch.kernels import rope as trope
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_rope_matches_jax_including_positions_past_the_table():
    rng = np.random.default_rng(0)
    jc, js = jrope.rope_frequencies(32, 64)
    tc, ts = trope.rope_frequencies(32, 64, device="cpu")
    # 1e-6: the same float32 table, sin/cos of one library each
    _close(tc.numpy(), jc, 1e-6)
    _close(ts.numpy(), js, 1e-6)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 32)).astype(np.float32)
    # row 1 runs past the 64-row table: both clamp to its last row
    pos = np.asarray([[0, 3, 9, 20, 63], [60, 62, 64, 70, 200]], np.int32)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js,
                              jnp.asarray(pos))
    tq, tk = trope.apply_rope(torch.tensor(q), torch.tensor(k), tc, ts,
                              torch.tensor(pos))
    _close(tq.numpy(), jq, 1e-5)
    _close(tk.numpy(), jk, 1e-5)
    jq, _ = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, _ = trope.apply_rope(torch.tensor(q), torch.tensor(k), tc, ts)
    _close(tq.numpy(), jq, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JF.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6)
    got = TF.rms_norm(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                      1e-6)
    assert got.dtype == tdt
    # float32: same statistics, 1e-6; bf16: the cast back to bf16 before
    # the weight product can round one ulp apart (2^-7 of the value)
    _close(got.float().numpy(), want, 1e-6 if dtype == "float32" else 2e-2)


def test_sdpa_masked_gqa_and_causal_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    mask = rng.random((2, 1, 5, 9)) < 0.7
    mask[..., 0] = True
    # 1e-5: float32 logits and softmax in both
    want = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=jnp.asarray(mask), training=False)
    got = TF.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        attn_mask=torch.tensor(mask))
    _close(got.numpy(), want, 1e-5)
    want = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
        training=False)
    got = TF.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), is_causal=True)
    _close(got.numpy(), want, 1e-5)


def test_process_logits_batch_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 40)).astype(np.float32) * 3
    temp = np.asarray([1.0, 0.5, 2.0, 1e-9, 0.7], np.float32)
    top_k = np.asarray([0, 5, 1, 0, 40], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.3, 0.05, 1e-6], np.float32)
    want = np.asarray(jgen.process_logits_batch(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = tgen.process_logits_batch(
        torch.tensor(logits), torch.tensor(temp), torch.tensor(top_k),
        torch.tensor(top_p)).numpy()
    # rows with top_p < 1: the same entries survive each row's filters,
    # with equal values (float32 division by the same temperature: 1e-6
    # relative)
    rows = top_p < 1.0
    np.testing.assert_array_equal(got[rows] <= -1e29, want[rows] <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    assert keep.sum(axis=1).min() >= 1  # the top-1 token always survives
    # a top_p = 1 row keeps every token in the port; the JAX function can
    # drop a tail token there (it drops one in this row) when the float32
    # cumulative sum before it rounds to 1.0 (ROADMAP.md Queue C)
    assert (got[0] > -1e29).all()


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny Llama and the port's, with the weights carried
    across."""
    pt.seed(5)
    jmodel = JModel(JConfig.tiny())
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(tmodel, state)
    return jmodel, tmodel, state


def test_state_dict_names_and_shapes_carry_across(tiny_pair):
    _, tmodel, state = tiny_pair
    own = tmodel.state_dict()
    assert len(state) == 21
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in state.items()}
    assert tuple(own["model.layers.0.self_attn.q_proj.weight"].shape) \
        == (64, 64)
    with pytest.raises(KeyError):
        load_numpy_state_dict(tmodel, {k: v for k, v in state.items()
                                       if "lm_head" not in k})
    with pytest.raises(KeyError):
        load_numpy_state_dict(tmodel, dict(state, extra=np.zeros(2)))
    bad = dict(state)
    bad["model.norm.weight"] = np.zeros((63,), np.float32)
    with pytest.raises(ValueError):
        load_numpy_state_dict(tmodel, bad)


def test_no_cache_logits_match_jax(tiny_pair):
    jmodel, tmodel, _ = tiny_pair
    ids = np.random.default_rng(4).integers(0, 256, (2, 12))
    want = np.asarray(jmodel(jnp.asarray(ids)))
    got = tmodel(torch.as_tensor(ids)).detach().numpy()
    # 1e-5: float32 end to end, highest matmul precision on the JAX side
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_chunked_prefill_then_decode_match_jax(tiny_pair, fused):
    """A two-chunk prefill (slot 1 idle for the first chunk, at the
    max_len sentinel whose positions run past the rope table), then four
    decode steps, on contiguous per-slot caches. The JAX side runs its
    default CPU path (the unfused reference); the port runs the plain
    fused version (on) or the unfused branch (off)."""
    jmodel, tmodel, _ = tiny_pair
    slots, max_len, C = 2, 128, 8
    rng = np.random.default_rng(6)
    jc = jmodel.init_kv_caches(slots, max_len, dtype=jnp.float32)
    tc = tmodel.init_kv_caches(slots, max_len, dtype=torch.float32)
    saved = tflags.flag("fused_decode")
    tflags.set_flags({"fused_decode": fused})
    try:
        steps = [np.asarray([0, max_len]), np.asarray([C, 0])]
        for start in steps:
            ids = rng.integers(1, 256, (slots, C))
            pos = start[:, None] + np.arange(C)
            jl, jc = jmodel(jnp.asarray(ids), position_ids=jnp.asarray(pos),
                            kv_caches=jc,
                            cache_index=jnp.asarray(start, jnp.int32))
            tl, _ = tmodel(torch.as_tensor(ids),
                           position_ids=torch.as_tensor(pos),
                           kv_caches=tc, cache_index=torch.as_tensor(start))
            _close(tl.numpy(), jl, 1e-5)
        lens = np.asarray([2 * C, C])
        for _ in range(4):
            tok = rng.integers(1, 256, (slots, 1))
            jl, jc = jmodel(jnp.asarray(tok),
                            position_ids=jnp.asarray(lens[:, None]),
                            kv_caches=jc,
                            cache_index=jnp.asarray(lens, jnp.int32))
            tl, _ = tmodel(torch.as_tensor(tok),
                           position_ids=torch.as_tensor(lens[:, None]),
                           kv_caches=tc, cache_index=torch.as_tensor(lens))
            # 1e-5: float32; the fused plain version sums the softmax over
            # the whole cache in one pass, as the JAX reference does
            _close(tl.numpy(), jl, 1e-5)
            lens = lens + 1
    finally:
        tflags.set_flags({"fused_decode": saved})
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk.numpy(), jk, 1e-5)
        _close(tv.numpy(), jv, 1e-5)
    # the sentinel chunk dropped its rows: slot 1's rows past its
    # 8 prompt + 4 decoded tokens are still zero
    assert not tc[0][0][1, C + 4:].any()


def test_unported_branches_raise(tiny_pair):
    jmodel, tmodel, weights = tiny_pair
    # int8 caches are QuantizedKV pairs of the JAX shapes: an int8 payload
    # [slots, max_len, kv_heads, d] and float32 scales [slots, max_len,
    # kv_heads], zeroed
    want = jmodel.init_kv_caches(2, 16, dtype=jnp.int8)
    got = tmodel.init_kv_caches(2, 16, dtype=torch.int8)
    assert len(got) == len(want) == 2
    for (tk, tv), (jk, jv) in zip(got, want):
        for t, j in ((tk, jk), (tv, jv)):
            assert isinstance(t, QuantizedKV)
            assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
            assert tuple(t.q.shape) == tuple(j.q.shape) == (2, 16, 2, 16)
            assert tuple(t.scale.shape) == tuple(j.scale.shape) == (2, 16, 2)
            assert not t.q.any() and not t.scale.any()
    # a shared scalar cache_index takes float contiguous caches only: the
    # int8 pairs and a paged pool raise (the JAX model never takes them)
    ids = torch.ones((2, 4), dtype=torch.long)
    pool = init_paged_pool(2, 5, 8, 2, 16, dtype=torch.float32, device="cpu")
    state = PagedState(torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))
    for caches in (got, [(c, state) for c in pool]):
        with pytest.raises(NotImplementedError, match="scalar cache_index"):
            tmodel(ids, kv_caches=caches, cache_index=0)
    # fused_head_loss_chunk is ported: the chunked head + loss gives the
    # full-logits loss, and the logits without labels are unchanged
    fused = LlamaForCausalLM(LlamaConfig.tiny(fused_head_loss_chunk=64),
                             device="cpu")
    load_numpy_state_dict(fused, weights)
    ids = torch.as_tensor(np.random.default_rng(8).integers(0, 256, (2, 9)))
    _close(fused(ids, ids).detach().numpy(),
           tmodel(ids, ids).detach().numpy(), 1e-5)
    assert torch.equal(fused(ids), tmodel(ids))


def test_prefill_rows_past_max_len_drop_like_jax(tiny_pair):
    """A chunk that starts 3 rows before max_len writes those 3 rows and
    drops the rest (JAX's mode="drop"); the rows before it keep their
    values, and the other slot's chunk lands whole."""
    jmodel, tmodel, _ = tiny_pair
    slots, max_len, C = 2, 32, 8
    rng = np.random.default_rng(8)
    ck0 = rng.standard_normal((slots, max_len, 2, 16)).astype(np.float32)
    jc = [(jnp.asarray(ck0), jnp.asarray(ck0 * 2)) for _ in range(2)]
    tc = [(torch.tensor(ck0), torch.tensor(ck0 * 2)) for _ in range(2)]
    start = np.asarray([max_len - 3, 5])
    ids = rng.integers(1, 256, (slots, C))
    pos = start[:, None] + np.arange(C)
    jl, jc = jmodel(jnp.asarray(ids), position_ids=jnp.asarray(pos),
                    kv_caches=jc, cache_index=jnp.asarray(start, jnp.int32))
    tl, _ = tmodel(torch.as_tensor(ids), position_ids=torch.as_tensor(pos),
                   kv_caches=tc, cache_index=torch.as_tensor(start))
    _close(tl.numpy(), jl, 1e-5)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk.numpy(), jk, 1e-5)
        _close(tv.numpy(), jv, 1e-5)
    # untouched rows are bit-identical to the initial cache
    assert torch.equal(tc[0][0][0, :max_len - 3], torch.tensor(ck0[0, :-3]))
    assert torch.equal(tc[0][0][1, :5], torch.tensor(ck0[1, :5]))
    assert torch.equal(tc[0][0][1, 5 + C:], torch.tensor(ck0[1, 5 + C:]))
