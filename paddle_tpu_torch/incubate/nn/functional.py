"""Fused-op functional surface (counterpart of
``paddle_tpu/incubate/nn/functional.py``: fused_rms_norm,
fused_layer_norm, swiglu, fused_linear, fused_linear_cross_entropy,
fused_bias_act, fused_dropout_add, fused_rotary_position_embedding,
fused_multi_head_attention).

"Fused" is a calling convention here, as in the JAX package: each
function is the composition of the port's ``nn.functional`` ops and
``kernels/rope.py``, so PaddleNLP-style model code ports without
rewrites. None of them reaches a Pallas kernel in JAX. The one that
changes what memory a step holds is ``fused_linear_cross_entropy``: the
vocabulary head and the cross-entropy a sequence chunk at a time, with a
hand-written backward that recomputes each chunk's logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels.rope import apply_rope, rope_frequencies
from ...nn import functional as F


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    y = F.rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        y = y + norm_bias
    return y


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, **kw):
    return F.layer_norm(x, weight=norm_weight, bias=norm_bias,
                        epsilon=epsilon)


def swiglu(x, y=None):
    return F.swiglu(x, y)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    w = weight.T if transpose_weight else weight
    return F.linear(x, w, bias)


def _chunk_logits(h, w, bias, dt):
    """One chunk's logits: ``h @ w`` (+ bias) in the compute dtype, then
    float32, as the JAX scan body takes them."""
    logits = torch.matmul(h.to(dt), w.to(dt))
    if bias is not None:
        logits = logits + bias
    return logits.float()


class _LinearCrossEntropy(torch.autograd.Function):
    """The chunked head + cross-entropy over ``x`` [B, S, H] and ``w`` [H,
    V] (a ``[V, H]`` weight seen through ``transpose_weight``).

    The forward keeps only its inputs and the float32 loss sum and count:
    never the ``[B, S, V]`` logits and no autograd graph per chunk. The
    backward recomputes each chunk's logits and gives that chunk's ``dx``
    and its share of ``dW`` (and ``db``), which is what the JAX package's
    ``jax.checkpoint``'ed scan body does."""

    @staticmethod
    def forward(ctx, x, weight, labels, bias, transpose_weight,
                ignore_index, chunk):
        w = weight.T if transpose_weight else weight
        dt = torch.promote_types(x.dtype, weight.dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for s0 in range(0, x.shape[1], chunk):
            t = labels[:, s0:s0 + chunk]
            logp = torch.log_softmax(
                _chunk_logits(x[:, s0:s0 + chunk], w, bias, dt), dim=-1)
            valid = t != ignore_index
            tsafe = torch.where(valid, t, 0).long()
            nll = -logp.gather(-1, tsafe[..., None]).squeeze(-1)
            loss_sum = loss_sum + torch.where(valid, nll, 0.0).sum()
            count = count + valid.sum()
        ctx.save_for_backward(x, weight, labels, bias, count)
        ctx.opts = (transpose_weight, ignore_index, chunk)
        return loss_sum / torch.clamp(count, min=1).float()

    @staticmethod
    def backward(ctx, grad_loss):
        x, weight, labels, bias, count = ctx.saved_tensors
        transpose_weight, ignore_index, chunk = ctx.opts
        w = weight.T if transpose_weight else weight
        dt = torch.promote_types(x.dtype, weight.dtype)
        need_x, need_w, _, need_b = ctx.needs_input_grad[:4]
        scale = grad_loss.float() / torch.clamp(count, min=1).float()
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
            if need_x else None
        # dW and db accumulate across the chunks in float32 (the JAX
        # scan's transpose sums them in the weight's dtype); each chunk's
        # product is taken in the compute dtype and added in place (no
        # float32 copy of it), and the sum is cast to the weight's dtype
        # once at the end
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=x.device) if need_w else None
        db = torch.zeros(bias.shape, dtype=torch.float32,
                         device=x.device) if need_b else None
        H = x.shape[-1]
        for s0 in range(0, x.shape[1], chunk):
            h = x[:, s0:s0 + chunk]
            t = labels[:, s0:s0 + chunk]
            valid = t != ignore_index
            tsafe = torch.where(valid, t, 0).long()
            # d loss / d logits = (softmax - onehot) * valid / count;
            # ignored rows (and none past S: the last chunk is short where
            # JAX pads it with ignored rows) add nothing
            d = torch.softmax(_chunk_logits(h, w, bias, dt), dim=-1)
            d.scatter_add_(-1, tsafe[..., None],
                           torch.full(tsafe[..., None].shape, -1.0,
                                      device=d.device))
            d.mul_((valid.float() * scale)[..., None])
            d = d.to(dt)
            if need_x:
                dx[:, s0:s0 + chunk] = torch.matmul(d, w.to(dt).T)
            if need_w:
                h2 = h.reshape(-1, H).to(dt)
                d2 = d.reshape(-1, d.shape[-1])
                dw.add_(d2.T @ h2 if transpose_weight else h2.T @ d2)
            if need_b:
                db += d.float().sum(dim=(0, 1))
        return (dx, dw.to(weight.dtype) if need_w else None, None,
                db.to(bias.dtype) if need_b else None, None, None, None)


def fused_linear_cross_entropy(x, weight, labels, bias=None,
                               transpose_weight=False, ignore_index=-100,
                               seq_chunk=256):
    """The vocabulary head and the softmax cross-entropy, mean over the
    tokens whose label is not ``ignore_index`` (the count floored at 1),
    without ever holding the ``[..., S, V]`` logits: the same function as
    ``F.cross_entropy(F.linear(x, w, bias), labels)``, since the softmax
    is row-wise and chunking the sequence changes no row.

    x: ``[..., S, H]``; labels: ``[..., S]`` ints; weight ``[H, V]`` (the
    linear layout; ``transpose_weight=True`` for a ``[V, H]`` tied
    embedding); bias ``[V]``. ``seq_chunk`` positions a chunk: each
    chunk's logits are ``h @ w`` in the input dtype, then float32 for the
    log-softmax. The last chunk is shorter when ``seq_chunk`` does not
    divide S (JAX pads it with ignored rows, which add nothing). Returns
    a float32 0-d loss, differentiable in x, weight and bias; the
    backward recomputes each chunk's logits."""
    S, H = x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, S, H)
    yb = labels.reshape(-1, S)
    chunk = int(min(seq_chunk, S))
    return _LinearCrossEntropy.apply(xb, weight, yb, bias,
                                     bool(transpose_weight),
                                     int(ignore_index), chunk)


def fused_bias_act(x, bias=None, act_method="gelu"):
    if bias is not None:
        x = x + bias
    return getattr(F, act_method)(x)


def fused_dropout_add(x, y, p=0.0, training=True, mode="upscale_in_train",
                      generator: Optional[torch.Generator] = None):
    """``dropout(x) + y``; the keep-mask is drawn from ``generator`` (JAX
    takes an ``rng_key``)."""
    return F.dropout(x, p=p, training=training, mode=mode,
                     generator=generator) + y


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    max_position=None):
    """Rotates every tensor given (q/k/v: [b, s, h, d]). sin/cos may be
    the paddle-shaped [1, s, 1, d] tables (the duplicated-half layout) or
    the compact [s, d/2] of ``kernels/rope.py``; None builds the default
    10000-base tables on q's device, long enough for ``position_ids``
    (``max_position`` if given). ``use_neox_rotary_style=False`` rotates
    interleaved pairs."""
    s, d = q.shape[1], q.shape[-1]
    if sin is None or cos is None:
        max_pos = s
        if position_ids is not None:
            max_pos = int(max_position) if max_position is not None \
                else int(torch.max(position_ids)) + 1
        cos_t, sin_t = rope_frequencies(d, max(max_pos, s), dtype=q.dtype,
                                        device=q.device)
    else:
        # [..., L, d] (the duplicated-half layout) or [..., L, d/2]; L may
        # exceed the sequence: keep the table's own length
        cos_t, sin_t = torch.as_tensor(cos), torch.as_tensor(sin)
        last = cos_t.shape[-1]
        if last not in (d, d // 2):
            raise ValueError(
                f"fused_rope: sin/cos last dim {last} matches neither "
                f"head_dim {d} nor head_dim/2")
        cos_t, sin_t = cos_t.reshape(-1, last), sin_t.reshape(-1, last)
        if last == d:
            cos_t, sin_t = cos_t[:, :d // 2], sin_t[:, :d // 2]

    def de_interleave(t):
        # interleaved (x0, x1), (x2, x3) pairs -> the split-half layout
        return t.reshape(*t.shape[:-1], d // 2, 2).transpose(-1, -2) \
            .reshape(*t.shape[:-1], d)

    def re_interleave(t):
        return t.reshape(*t.shape[:-1], 2, d // 2).transpose(-1, -2) \
            .reshape(*t.shape[:-1], d)

    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
            continue
        if not use_neox_rotary_style:
            t = de_interleave(t)
        rot, _ = apply_rope(t, t, cos_t, sin_t, position_ids=position_ids)
        if not use_neox_rotary_style:
            rot = re_interleave(rot)
        outs.append(rot)
    return tuple(outs)


def fused_multi_head_attention(x, qkv_weight, qkv_bias=None,
                               linear_weight=None, linear_bias=None,
                               num_heads=None, causal=False,
                               attn_mask=None, dropout_rate=0.0,
                               training=True,
                               generator: Optional[torch.Generator] = None):
    """One qkv GEMM, attention (the port's plain SDPA, dropout drawn from
    ``generator``), the output GEMM."""
    b, s, h = x.shape
    qkv = torch.matmul(x, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias
    d = h // num_heads
    qkv = qkv.reshape(b, s, 3, num_heads, d)
    out = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
        is_causal=causal, dropout_p=dropout_rate, training=training,
        generator=generator).reshape(b, s, h)
    if linear_weight is not None:
        out = torch.matmul(out, linear_weight)
        if linear_bias is not None:
            out = out + linear_bias
    return out
