"""The port's ``incubate`` against the JAX package on the CPU: every
``incubate.nn.functional`` function (``fused_linear_cross_entropy`` with
its loss and ``dx``/``dW``/``db``, a sequence that is no multiple of the
chunk, ignored tokens, the ``[V, H]`` tied layout and a bias), and the
``LookAhead``, ``ModelAverage`` and ``EMA`` wrappers over 9 updates (two
``k = 3`` syncs and more). Inputs come from numpy with a seed.

Tolerances: float32 both ways, 1e-5 (the chunked loss and its gradients,
attention), 1e-6 (the norms, rope, the wrappers' state); bf16 through
the port's own unfused path, 2e-2."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import incubate as jinc
from paddle_tpu import optimizer as jopt
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as TF


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


# ------------------------------------------------------- fused functional
def test_fused_norms_swiglu_linear_and_bias_act_match_jax():
    rng = np.random.default_rng(0)
    x, w, b, lw, lb, y = (_rand(rng, 2, 6, 32), _rand(rng, 32),
                          _rand(rng, 32), _rand(rng, 32, 16),
                          _rand(rng, 16), _rand(rng, 2, 6, 32))
    (jx, jw, jb, jlw, jlb, jy), (tx, tw, tb, tlw, tlb, ty) = _both(
        x, w, b, lw, lb, y)
    _close(TIF.fused_rms_norm(tx, tw, tb), JIF.fused_rms_norm(jx, jw, jb),
           1e-6)
    _close(TIF.fused_rms_norm(tx, tw), JIF.fused_rms_norm(jx, jw), 1e-6)
    _close(TIF.fused_layer_norm(tx, tw, tb),
           JIF.fused_layer_norm(jx, jw, jb), 1e-6)
    _close(TIF.swiglu(tx), JIF.swiglu(jx), 1e-6)
    _close(TIF.swiglu(tx, ty), JIF.swiglu(jx, jy), 1e-6)
    _close(TIF.fused_linear(tx, tlw, tlb), JIF.fused_linear(jx, jlw, jlb),
           1e-5)
    _close(TIF.fused_linear(tx, tlw.T.contiguous(), transpose_weight=True),
           JIF.fused_linear(jx, jlw.T, transpose_weight=True), 1e-5)
    for act in ("gelu", "relu", "silu", "swiglu"):
        _close(TIF.fused_bias_act(tx, tb, act),
               JIF.fused_bias_act(jx, jb, act), 1e-6)
    _close(TIF.fused_bias_act(tx, None, "relu"),
           JIF.fused_bias_act(jx, None, "relu"), 0)


def test_fused_dropout_add():
    """p 0 or not training: x + y, as JAX. With dropout, the keep-mask is
    the generator's: ``F.dropout`` from the same seed, plus y."""
    rng = np.random.default_rng(1)
    x, y = _rand(rng, 3, 5, 8), _rand(rng, 3, 5, 8)
    (jx, jy), (tx, ty) = _both(x, y)
    _close(TIF.fused_dropout_add(tx, ty), JIF.fused_dropout_add(jx, jy), 0)
    _close(TIF.fused_dropout_add(tx, ty, p=0.3, training=False),
           JIF.fused_dropout_add(jx, jy, p=0.3, training=False), 0)
    _close(TIF.fused_dropout_add(tx, ty, p=0.3, training=False,
                                 mode="downscale_in_infer"),
           JIF.fused_dropout_add(jx, jy, p=0.3, training=False,
                                 mode="downscale_in_infer"), 1e-6)
    got = TIF.fused_dropout_add(tx, ty, p=0.3,
                                generator=torch.Generator().manual_seed(7))
    want = TF.dropout(tx, 0.3, generator=torch.Generator().manual_seed(7)) \
        + ty
    assert torch.equal(got, want)
    assert 0.05 < (got == ty).float().mean().item() < 0.6


@pytest.mark.parametrize("neox", [True, False])
def test_fused_rotary_position_embedding_matches_jax(neox):
    """Default tables, position ids (tables sized from them, or from
    ``max_position``), the paddle [1, s, 1, d] duplicated-half tables and
    the compact [s, d/2] ones; q, k and v all rotated."""
    from paddle_tpu.kernels.rope import rope_frequencies as jfreq

    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 2, 6, 4, 16) for _ in range(3))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(use_neox_rotary_style=neox)
    for got, want in zip(TIF.fused_rotary_position_embedding(tq, tk, tv,
                                                             **kw),
                         JIF.fused_rotary_position_embedding(jq, jk, jv,
                                                             **kw)):
        _close(got, want, 1e-6)
    assert TIF.fused_rotary_position_embedding(tq)[1:] == (None, None)
    pos = rng.integers(0, 20, (2, 6))
    for extra in ({}, dict(max_position=32)):
        got = TIF.fused_rotary_position_embedding(
            tq, tk, position_ids=torch.tensor(pos), **kw, **extra)
        want = JIF.fused_rotary_position_embedding(
            jq, jk, position_ids=jnp.asarray(pos), **kw, **extra)
        _close(got[0], want[0], 1e-6)
        _close(got[1], want[1], 1e-6)
    cos, sin = (np.asarray(t) for t in jfreq(16, 8))
    for c, s in ((cos, sin),
                 (np.concatenate([cos, cos], -1)[None, :, None],
                  np.concatenate([sin, sin], -1)[None, :, None])):
        got = TIF.fused_rotary_position_embedding(
            tq, tk, sin=torch.tensor(s), cos=torch.tensor(c), **kw)
        want = JIF.fused_rotary_position_embedding(
            jq, jk, sin=jnp.asarray(s), cos=jnp.asarray(c), **kw)
        _close(got[0], want[0], 1e-6)
    with pytest.raises(ValueError, match="head_dim"):
        TIF.fused_rotary_position_embedding(
            tq, sin=torch.zeros(6, 5), cos=torch.zeros(6, 5))


def test_fused_multi_head_attention_matches_jax():
    """Biases, the output projection, the causal mask and a boolean mask,
    dropout off; with dropout, the port's SDPA from the same generator."""
    rng = np.random.default_rng(3)
    h, nh = 32, 4
    x, qw, qb, ow, ob = (_rand(rng, 2, 6, h), _rand(rng, h, 3 * h,
                                                    scale=0.1),
                         _rand(rng, 3 * h, scale=0.1),
                         _rand(rng, h, h, scale=0.1), _rand(rng, h))
    mask = rng.random((2, 1, 6, 6)) < 0.7
    mask[..., 0] = True
    (jx, jqw, jqb, jow, job), (tx, tqw, tqb, tow, tob) = _both(x, qw, qb, ow,
                                                               ob)
    for extra in (dict(causal=True), dict(attn_mask=mask),
                  dict(causal=True, dropout_rate=0.5, training=False)):
        jextra = {n: jnp.asarray(v) if n == "attn_mask" else v
                  for n, v in extra.items()}
        textra = {n: torch.tensor(v) if n == "attn_mask" else v
                  for n, v in extra.items()}
        want = JIF.fused_multi_head_attention(
            jx, jqw, jqb, jow, job, num_heads=nh, **jextra)
        got = TIF.fused_multi_head_attention(
            tx, tqw, tqb, tow, tob, num_heads=nh, **textra)
        _close(got, want, 1e-5)
    got = TIF.fused_multi_head_attention(
        tx, tqw, num_heads=nh, causal=True, dropout_rate=0.25,
        generator=torch.Generator().manual_seed(3))
    qkv = (tx @ tqw).reshape(2, 6, 3, nh, h // nh)
    want = TF.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True,
        dropout_p=0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, want.reshape(2, 6, h))


# --------------------------------------------- fused_linear_cross_entropy
LCE_CASES = [
    dict(S=37, chunk=8),
    dict(S=37, chunk=8, bias=True),
    dict(S=16, chunk=8, transpose=True, bias=True),
    dict(S=21, chunk=5, transpose=True),
    dict(S=12, chunk=64),  # one chunk, shorter than seq_chunk
    dict(S=9, chunk=4, lead=(2, 3)),  # [..., S, H] with two leading axes
]


def _lce_inputs(S, lead=(3,), H=16, V=29, seed=0):
    rng = np.random.default_rng(seed)
    x = _rand(rng, *lead, S, H)
    w = _rand(rng, H, V, scale=0.3)
    b = _rand(rng, V, scale=0.1)
    y = rng.integers(0, V, (*lead, S))
    flat = y.reshape(-1, S)
    flat[0, 3] = -100
    flat[-1, S - 1] = -100
    flat[0, S // 2] = -100
    return x, w, b, y


@pytest.mark.parametrize("case", LCE_CASES)
def test_fused_linear_cross_entropy_loss_and_grads_match_jax(case):
    S, chunk = case["S"], case["chunk"]
    x, w, b, y = _lce_inputs(S, lead=case.get("lead", (3,)))
    transpose, use_bias = case.get("transpose", False), case.get("bias",
                                                                 False)
    wl = w.T.copy() if transpose else w  # the layout the caller holds

    def jloss(x, w, b):
        return JIF.fused_linear_cross_entropy(
            x, w, jnp.asarray(y), bias=b if use_bias else None,
            transpose_weight=transpose, seq_chunk=chunk)

    want, (gx, gw, gb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(wl), jnp.asarray(b))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, wl, b))
    got = TIF.fused_linear_cross_entropy(
        tx, tw, torch.tensor(y), bias=tb if use_bias else None,
        transpose_weight=transpose, seq_chunk=chunk)
    assert got.dtype == torch.float32 and got.dim() == 0
    got.backward()
    _close(got, want, 1e-5)
    _close(tx.grad, gx, 1e-5)
    _close(tw.grad, gw, 1e-5)
    if use_bias:
        _close(tb.grad, gb, 1e-5)
    else:
        assert tb.grad is None
    # the same function as the port's unfused head + cross-entropy
    ux, uw, ub = (torch.tensor(a, requires_grad=True) for a in (x, wl, b))
    logits = TF.linear(ux, uw.T if transpose else uw,
                       ub if use_bias else None)
    ref = TF.cross_entropy(logits, torch.tensor(y), ignore_index=-100)
    ref.backward()
    _close(got, ref, 1e-5)
    _close(tx.grad, ux.grad, 1e-5)
    _close(tw.grad, uw.grad, 1e-5)
    if use_bias:
        _close(tb.grad, ub.grad, 1e-5)


def test_fused_linear_cross_entropy_never_holds_the_full_logits(
        monkeypatch):
    """Forward and backward: every logits tensor made is one chunk's, and
    autograd saves nothing of vocabulary width but the weight."""
    B, S, H, V, chunk = 2, 40, 8, 64, 16
    x, w, _, y = _lce_inputs(S, lead=(B,), H=H, V=V, seed=4)
    made = []
    real = TIF._chunk_logits

    def spy(h, w_, bias, dt):
        out = real(h, w_, bias, dt)
        made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(TIF, "_chunk_logits", spy)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TIF.fused_linear_cross_entropy(tx, tw, torch.tensor(y),
                                              seq_chunk=chunk)
    loss.backward()
    n_chunks = -(-S // chunk)
    assert len(made) == 2 * n_chunks  # forward, then the recompute
    assert max(b * s for b, s, _ in made) <= B * chunk
    assert saved and all(not s or s[-1] != V or s == (H, V)
                         for s in saved), saved
    assert tw.grad.shape == (H, V) and tx.grad.shape == (B, S, H)


def test_fused_linear_cross_entropy_bf16_against_the_unfused_path():
    """bf16 inputs: the loss in float32, the gradients in the inputs'
    dtypes (dW summed over chunks in float32, cast once), within bf16
    tolerance of the port's unfused bf16 path; the tied layout's gradient
    is the [V, H] weight's."""
    x, w, _, y = _lce_inputs(33, lead=(2,), H=32, V=48, seed=5)
    for transpose in (False, True):
        wl = w.T.copy() if transpose else w
        tx = torch.tensor(x).bfloat16().requires_grad_()
        tw = torch.tensor(wl).bfloat16().requires_grad_()
        got = TIF.fused_linear_cross_entropy(
            tx, tw, torch.tensor(y), transpose_weight=transpose, seq_chunk=8)
        got.backward()
        assert got.dtype == torch.float32
        assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
        assert tw.grad.shape == tw.shape
        ux = torch.tensor(x).bfloat16().requires_grad_()
        uw = torch.tensor(wl).bfloat16().requires_grad_()
        ref = TF.cross_entropy(TF.linear(ux, uw.T if transpose else uw),
                               torch.tensor(y))
        ref.backward()
        _close(got, ref, 2e-2)
        _close(tx.grad, ux.grad, 2e-2)
        _close(tw.grad, uw.grad, 2e-2)


def test_fused_linear_cross_entropy_all_ignored_is_zero():
    x, w, _, y = _lce_inputs(10, seed=6)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    loss = TIF.fused_linear_cross_entropy(
        tx, tw, torch.full(y.shape, -100), seq_chunk=4)
    want = JIF.fused_linear_cross_entropy(
        jnp.asarray(x), jnp.asarray(w), jnp.full(y.shape, -100),
        seq_chunk=4)
    loss.backward()
    assert float(loss.detach()) == float(want) == 0.0
    assert not tx.grad.any() and not tw.grad.any()


# ------------------------------------------------------ optimizer wrappers
def _wrapper_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"a": _rand(rng, 4, 3), "b": _rand(rng, 5)}


def _grads_seq(n, seed=8):
    rng = np.random.default_rng(seed)
    return [{"a": _rand(rng, 4, 3), "b": _rand(rng, 5)} for _ in range(n)]


def _run(wrapper, params, grads_seq, lib):
    if lib == "jax":
        p = {n: jnp.asarray(v) for n, v in params.items()}
        conv = jnp.asarray
    else:
        p = {n: torch.tensor(v) for n, v in params.items()}
        conv = torch.tensor
    st = wrapper.init(p)
    history = []
    for g in grads_seq:
        p, st = wrapper.update({n: conv(v) for n, v in g.items()}, st, p)
        history.append({n: np.array(_np(v)) for n, v in p.items()})
    return p, st, history


def test_lookahead_matches_jax_with_two_syncs():
    """LookAhead(AdamW), k 3, alpha 0.5, 9 updates of float32 parameters:
    the parameters and the slow weights after every update (syncs at 3, 6
    and 9)."""
    params, grads = _wrapper_params(), _grads_seq(9)

    def make(opt_mod, inc):
        return inc.LookAhead(opt_mod.AdamW(learning_rate=0.05,
                                           weight_decay=0.01,
                                           multi_precision=False),
                             alpha=0.5, k=3)

    jp, js, jh = _run(make(jopt, jinc), params, grads, "jax")
    tp, ts, th = _run(make(topt, tinc), params, grads, "torch")
    for tpv, jpv in zip(th, jh):
        for n in params:
            _close(tpv[n], jpv[n], 1e-6)
    for n in params:
        _close(ts["slow"][n], js["slow"][n], 1e-6)
        _close(ts["inner"]["slots"][n]["moment1"],
               js["inner"]["slots"][n]["moment1"], 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 9
    # a sync step leaves the parameters at the slow weights
    for n in params:
        _close(tp[n], ts["slow"][n], 0)


def test_lookahead_merges_the_float32_masters():
    """bf16 parameters under multi_precision: the slow weights merge with
    the inner masters; on a sync step the merged weights go back into the
    masters, and the parameters are their bf16 cast."""
    params = _wrapper_params()
    la = tinc.LookAhead(topt.SGD(learning_rate=0.1, multi_precision=True),
                        alpha=0.5, k=2)
    p = {n: torch.tensor(v).bfloat16() for n, v in params.items()}
    st = la.init(p)
    masters = st["inner"]["master"]
    start = {n: m.clone() for n, m in masters.items()}
    g = {n: torch.full(v.shape, 1.0) for n, v in params.items()}
    la.update(g, st, p)  # fast: master - 0.1, no sync
    for n in params:
        _close(masters[n], start[n] - 0.1, 1e-6)
        _close(st["slow"][n], start[n], 0)
    la.update(g, st, p)  # fast: master - 0.2; sync: slow = start - 0.1
    for n in params:
        _close(st["slow"][n], start[n] - 0.1, 1e-6)
        assert torch.equal(masters[n], st["slow"][n])
        assert torch.equal(p[n], st["slow"][n].bfloat16())


def test_model_average_matches_jax_with_a_restart():
    """ModelAverage over SGD with a window of 4: the running mean restarts
    after 4 counted steps; ``apply`` casts the average to each
    parameter's dtype."""
    params, grads = _wrapper_params(), _grads_seq(9, seed=9)

    def make(opt_mod, inc):
        return inc.ModelAverage(
            inner_optimizer=opt_mod.SGD(learning_rate=0.1,
                                        multi_precision=False),
            max_average_window=4)

    jw, tw = make(jopt, jinc), make(topt, tinc)
    jp, js, jh = _run(jw, params, grads, "jax")
    tp, ts, th = _run(tw, params, grads, "torch")
    for tpv, jpv in zip(th, jh):
        for n in params:
            _close(tpv[n], jpv[n], 1e-6)
    for n in params:
        _close(ts["avg"][n], js["avg"][n], 1e-6)
    assert float(ts["count"]) == float(js["count"])
    applied = tw.apply(ts, {n: v.bfloat16() for n, v in tp.items()})
    for n in params:
        assert applied[n].dtype == torch.bfloat16
        _close(applied[n], jw.apply(js, {
            n2: v.astype(jnp.bfloat16) for n2, v in jp.items()})[n], 0)
    with pytest.raises(ValueError, match="inner_optimizer"):
        tinc.ModelAverage().update({}, {}, {})


@pytest.mark.parametrize("kw", [dict(decay=0.9),
                                dict(decay=0.99, thres_steps=True),
                                dict(decay=0.8, zero_debias=False)])
def test_ema_matches_jax(kw):
    """Nine EMA updates over changing parameters (an SGD run), with the
    constant decay, the warm-up decay and without zero debias."""
    params, grads = _wrapper_params(seed=10), _grads_seq(9, seed=11)
    je, te = jinc.EMA(**kw), tinc.EMA(**kw)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.tensor(v) for n, v in params.items()}
    js, ts = je.init(jp), te.init(tp)
    for g in grads:
        jp = {n: v - 0.1 * jnp.asarray(g[n]) for n, v in jp.items()}
        tp = {n: v - 0.1 * torch.tensor(g[n]) for n, v in tp.items()}
        js = je.update(js, jp)
        ts = te.update(ts, tp)
        for n in params:
            _close(ts["ema"][n], js["ema"][n], 1e-6)
    _close(ts["decay_prod"], js["decay_prod"], 1e-6)
    assert int(ts["step"]) == 9
    out_j, out_t = je.apply(js, jp), te.apply(ts, tp)
    for n in params:
        _close(out_t[n], out_j[n], 1e-6)
