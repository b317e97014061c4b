"""The port's flash attention (``paddle_tpu_torch/kernels/mha.py`` and the
``kernels/flash_attention.py`` dispatch) against the JAX package on the
CPU: the plain forward and LSE against JAX ``mha``/``mha_with_lse`` run
in interpret mode, as ``tests/test_pallas_attention.py`` runs them; the
fused and the two-pass plain backward, with an LSE cotangent, against
``jax.grad``; the causal ``sq != sk`` case against
``_reference_attention``; and the dispatch rules. Inputs come from numpy
with one seed."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import pallas_attention as jpa
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import mha as tm
from paddle_tpu_torch.nn import functional as TF


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b, sq, sk, hq, hk, d):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, hq, d), _rand(rng, b, sk, hk, d),
            _rand(rng, b, sk, hk, d), rng)


def _segments(kind, b, s):
    """Sorted segment ids; as a pair, the kv ids equal the q ids (every
    query sees its own segment's keys, so no row is fully masked)."""
    if kind is None:
        return None, None
    ids = np.repeat(np.arange(4, dtype=np.int32), s // 4)[None]
    ids = np.repeat(ids, b, axis=0)
    if kind == "one":
        return jnp.asarray(ids), torch.tensor(ids)
    return ((jnp.asarray(ids), jnp.asarray(ids.copy())),
            (torch.tensor(ids), torch.tensor(ids.copy())))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# float32 throughout: 1e-5 covers the two frameworks' summation orders
FWD_CASES = [  # b, s, hq, hk, d, causal, window, segments
    (1, 256, 2, 2, 64, True, 0, None),
    (2, 256, 2, 2, 64, False, 0, None),
    (1, 256, 4, 2, 128, True, 0, None),
    (1, 256, 2, 1, 96, True, 0, None),
    (1, 256, 2, 2, 64, True, 64, None),
    (2, 256, 2, 2, 64, True, 0, "one"),
    (1, 256, 4, 2, 64, False, 0, "pair"),
]


@pytest.mark.parametrize("b,s,hq,hk,d,causal,window,segments", FWD_CASES)
def test_plain_forward_and_lse_match_jax_mha(b, s, hq, hk, d, causal,
                                             window, segments):
    q, k, v, _ = _qkv(0, b, s, s, hq, hk, d)
    jseg, tseg = _segments(segments, b, s)
    jo, jl = jpa.mha_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, segment_ids=jseg, window=window)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    to, tl = tm.mha_with_lse(tq, tk, tv, causal=causal, segment_ids=tseg,
                             window=window)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, hq, s)
    _close(to, jo, 1e-5)
    _close(tl, jl, 1e-5)
    # mha is the same forward without the LSE
    _close(tm.mha(tq, tk, tv, causal=causal, segment_ids=tseg,
                  window=window), jo, 1e-5)


def _spy(monkeypatch):
    """Record which backward passes the dispatch runs."""
    ran = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(tm, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            ran.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tm, name, wrapped)
    return ran


@pytest.mark.parametrize("s,jax_block,blocks", [
    # seq 256: one kv span (fused) at the default block, eight at 32
    (256, 1024, {1024: ["flash_bwd_fused"],
                 32: ["flash_bwd_dq", "flash_bwd_dkv"]}),
    # seq 768, JAX's two-pass/fused split: 256 -> 3 spans (fused),
    # 128 -> 6 (two passes)
    (768, 256, {256: ["flash_bwd_fused"],
                128: ["flash_bwd_dq", "flash_bwd_dkv"]}),
])
def test_fused_and_two_pass_gradients_match_jax(monkeypatch, s, jax_block,
                                                blocks):
    """d(sum(o * w) + sum(lse * wl)) for causal GQA attention: the LSE
    cotangent folds into delta. Both backward passes against jax.grad of
    the Pallas kernel in interpret mode, within 1e-4."""
    q, k, v, rng = _qkv(1, 1, s, s, 4, 2, 64)
    w, wl = _rand(rng, 1, s, 4, 64), _rand(rng, 1, 4, s)

    def jloss(q, k, v):
        o, lse = jpa.mha_with_lse(q, k, v, causal=True, q_block=128,
                                  k_block=jax_block)
        return jnp.sum(o * w) + jnp.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ran = _spy(monkeypatch)
    for blk, passes in blocks.items():
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        o, lse = tm.mha_with_lse(*ts, causal=True, k_block=blk)
        ((o * torch.tensor(w)).sum() + (lse * torch.tensor(wl)).sum()) \
            .backward()
        assert ran == passes
        ran.clear()
        for t, g in zip(ts, want):
            _close(t.grad, g, 1e-4)


def test_causal_with_sq_not_sk_is_aligned_bottom_right():
    """The port follows the dense reference's bottom-right alignment
    (``tril(sk - sq)``) in its plain versions, its kernels and the
    dispatch; the JAX Pallas kernel masks top-left and differs
    (ROADMAP.md Queue C)."""
    q, k, v, _ = _qkv(0, 1, 128, 256, 2, 2, 64)
    want = jfa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    _close(tm.mha(tq, tk, tv, causal=True), want, 1e-5)
    _close(tfa.flash_attention(tq, tk, tv, causal=True), want, 1e-5)
    _close(tfa._reference_attention(tq, tk, tv, causal=True), want, 1e-5)
    # the same with a window, against the reference's banded mask
    want_w = jfa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, window=32)
    _close(tm.mha(tq, tk, tv, causal=True, window=32), want_w, 1e-5)
    jax_kernel = jpa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, q_block=128, k_block=128)
    assert np.abs(np.asarray(jax_kernel) - np.asarray(want)).max() > 0.1


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window_size=48),
    dict(causal=True, segment_ids="one"),
    dict(causal=False, segment_ids="pair"),
])
def test_dispatch_matches_jax_flash_attention_on_the_cpu(kw):
    """On the CPU both packages take their dense references (GQA 4/2,
    an unaligned sequence of 100 rows)."""
    q, k, v, _ = _qkv(2, 2, 100, 100, 4, 2, 32)
    kw = dict(kw)
    jseg, tseg = _segments(kw.pop("segment_ids", None), 2, 100)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), segment_ids=jseg, **kw)
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), segment_ids=tseg, **kw)
    _close(got, want, 1e-5)


def test_dispatch_rules():
    def t(s, d, device="cpu"):
        return torch.zeros((1, s, 2, d), device=device)

    # CPU tensors never reach the kernels; every other tensor does, at any
    # shape: a sequence of 100 rows on a device that is not the card
    # reaches the kernel wrapper, which refuses the device, and never the
    # dense reference
    assert not tfa.use_kernel(t(256, 128))
    assert tfa.use_kernel(t(100, 12, "meta"))
    meta = t(100, 32, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(meta, meta, meta, causal=True)
    q = torch.zeros((1, 128, 2, 32))
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window_size=16)
    with pytest.raises(ValueError, match="requires causal"):
        tm.mha(q, q, q, causal=False, window=16)
    # dropout while training takes the plain SDPA on every device, as in
    # JAX: the kernel wrapper is never reached, even on a device it refuses
    gen = torch.Generator().manual_seed(1)
    out = tfa.flash_attention(q, q, q, dropout_p=0.1, generator=gen)
    assert out.shape == q.shape
    out = TF.flash_attention(q, q, q, dropout=0.1, causal=True,
                             generator=torch.Generator().manual_seed(1))
    assert out.shape == q.shape
    out = tfa.flash_attention(meta, meta, meta, causal=True, dropout_p=0.1)
    assert out.device.type == "meta"  # the plain SDPA ran, not the kernel
    # dropout outside training is a no-op, as in JAX
    _close(tfa.flash_attention(q, q, q, dropout_p=0.1, training=False),
           tfa._reference_attention(q, q, q).numpy(), 0)
    # mha takes sequences that are no multiple of 128 (the JAX mha
    # refuses them; the kernels mask their ragged tiles), here through
    # its plain versions, with gradients
    rng = np.random.default_rng(5)
    lq, lk, lv = (torch.tensor(_rand(rng, 1, 300, 4 // n, 32),
                               requires_grad=True) for n in (1, 2, 2))
    o, lse = tm.mha_with_lse(lq, lk, lv, causal=True)
    want = tfa._reference_attention(lq, lk, lv, causal=True)
    _close(o, want.detach().numpy(), 1e-5)
    assert lse.shape == (1, 4, 300)
    got = torch.autograd.grad(o.sum(), (lq, lk, lv))
    ref = torch.autograd.grad(want.sum(), (lq, lk, lv))
    for g, r in zip(got, ref):
        _close(g, r.numpy(), 1e-4)


@pytest.mark.parametrize("blk,sl", [(1024, 2048), (1024, 256), (768, 2048),
                                    (256, 768), (32, 256), (1024, 100),
                                    (192, 384)])
def test_fit_block_matches_jax(blk, sl):
    q = jnp.zeros((1, sl, 1, 8))
    *_, qb, kb = jpa._fold(q, q, q, None, blk, blk)
    assert tm.fit_block(blk, sl) == qb == kb


def test_plain_backward_passes_agree():
    """The fused plain pass (dq from per-span partials) against the dq
    and dk/dv plain passes, on bf16 inputs."""
    q, k, v, rng = _qkv(4, 2, 256, 256, 4, 1, 64)
    do = _rand(rng, 2, 256, 4, 64)
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, do))
    o, lse = tm.mha_forward_plain(tq, tk, tv, causal=True)
    delta = tm.attention_delta(o, tdo)
    args = (tq, tk, tv, tdo, lse, delta)
    dq, dk, dv = tm.mha_bwd_fused_plain(*args, causal=True, span=64)
    assert dq.dtype == torch.bfloat16
    _close(dq.float(), tm.mha_bwd_dq_plain(*args, causal=True).float(), 2e-2)
    dk2, dv2 = tm.mha_bwd_dkv_plain(*args, causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("kw", [dict(), dict(dropout_p=0.25, training=False),
                                dict(dropout_p=0.0, training=True)])
def test_sdpa_without_dropout_matches_jax(kw):
    """``dropout_p`` and ``training`` in the JAX order and defaults: with no
    dropout drawn (p 0, or not training) the output is JAX's at 1e-5, with
    GQA, a boolean mask and the causal mask."""
    from paddle_tpu.nn import functional as JF

    q, k, v, rng = _qkv(11, 2, 7, 9, 4, 2, 16)
    mask = rng.random((2, 1, 7, 9)) < 0.7
    mask[..., 0] = True
    for extra in (dict(attn_mask=mask), dict(is_causal=True)):
        want = JF.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            **{n: jnp.asarray(x) if n == "attn_mask" else x
               for n, x in extra.items()}, **kw)
        got = TF.scaled_dot_product_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            **{n: torch.tensor(x) if n == "attn_mask" else x
               for n, x in extra.items()}, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_dropout_uses_the_generators_keep_mask(dtype):
    """With ``dropout_p = 0.25`` while training, every output is the plain
    product of V with the probabilities under the generator's own
    keep-mask (one ``torch.rand`` of [b, heads, sq, sk] below 0.75),
    scaled by 1 / 0.75 in the probabilities' dtype. JAX draws other bits
    from its keys, so JAX is not the reference here; the probabilities
    are the same function's with dropout off."""
    q, k, v, _ = _qkv(12, 2, 6, 10, 4, 2, 8)
    q, k, v = (torch.tensor(x).to(dtype) for x in (q, k, v))
    got = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.25, is_causal=True,
        generator=torch.Generator().manual_seed(5))
    assert got.shape == q.shape and got.dtype == dtype
    # the probabilities as the function casts them, and the keep-mask the
    # same seed draws
    vr = v.repeat_interleave(2, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(
        2, dim=2)) * 8 ** -0.5
    causal = torch.ones((6, 10), dtype=torch.bool).tril(4)
    logits = logits.float().masked_fill(~causal, -1e30)
    p = torch.softmax(logits, dim=-1).to(dtype)
    keep = torch.rand(p.shape, generator=torch.Generator().manual_seed(5)) \
        < 0.75
    assert 0.6 < keep.float().mean().item() < 0.9
    dropped = torch.where(keep, p / 0.75, torch.zeros((), dtype=dtype))
    want = torch.einsum("bhqk,bkhd->bqhd", dropped, vr)
    assert torch.equal(got, want)
    # not training, or p 0: no draw, the plain function
    assert torch.equal(
        TF.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                        is_causal=True, training=False),
        TF.scaled_dot_product_attention(q, k, v, is_causal=True))


DROPOUT_CASES = [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window_size=24),
    dict(causal=True, segment_ids="one"),
    dict(causal=False, segment_ids="pair"),
    dict(causal=True, segment_ids="one", window_size=20),
]


def _dropout_masks(kw, b, s):
    """The masks the dropout path must apply, built here on their own:
    same segment, and for a window the band of the last ``window_size``
    keys (the causal mask is SDPA's own)."""
    mask = None
    seg = kw.get("segment_ids")
    if seg is not None:
        ids = torch.tensor(np.repeat(np.arange(4), s // 4))
        mask = (ids[:, None] == ids[None, :])[None, None].expand(b, 1, s, s)
    if kw.get("window_size"):
        i = torch.arange(s)
        band = ((i[:, None] - i[None, :]) < kw["window_size"])[None, None]
        mask = band if mask is None else mask & band
    return mask


@pytest.mark.parametrize("kw", DROPOUT_CASES)
def test_flash_attention_dropout_is_the_sdpa_with_the_same_generator(kw):
    """``dropout_p > 0`` while training: the port's SDPA with the segment
    mask and the window band, its keep-mask drawn from the caller's
    generator (the same draw gives the same output, float32 and bf16);
    with a keep probability that rounds to 1 in float32 the masks alone
    act, and both packages' dropout paths give the same attention."""
    q, k, v, _ = _qkv(13, 2, 48, 48, 4, 2, 16)
    kw = dict(kw)
    jseg, tseg = _segments(kw.pop("segment_ids", None), 2, 48)
    mask = _dropout_masks(dict(kw, segment_ids=tseg), 2, 48)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (torch.tensor(x).to(dtype) for x in (q, k, v))
        got = tfa.flash_attention(tq, tk, tv, dropout_p=0.2,
                                  segment_ids=tseg,
                                  generator=torch.Generator().manual_seed(9),
                                  **kw)
        want = TF.scaled_dot_product_attention(
            tq, tk, tv, attn_mask=mask, dropout_p=0.2,
            is_causal=kw["causal"],
            generator=torch.Generator().manual_seed(9))
        assert got.dtype == dtype and torch.equal(got, want)
    p = 1e-12  # 1 - p is 1.0 in float32: every element kept, scale 1
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), dropout_p=p,
                               segment_ids=jseg, **kw)
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), dropout_p=p,
                              segment_ids=tseg,
                              generator=torch.Generator().manual_seed(0),
                              **kw)
    _close(got, want, 1e-5)
    # dropout off (not training): the dense reference, equal to JAX's
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), dropout_p=0.2, training=False,
                               segment_ids=jseg, **kw)
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), dropout_p=0.2, training=False,
                              segment_ids=tseg, **kw)
    _close(got, want, 1e-5)
