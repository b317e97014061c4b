"""Plain attention (counterpart of
``paddle_tpu/nn/functional/flash_attention.py:
scaled_dot_product_attention``)."""

from __future__ import annotations

from typing import Optional

import torch

from .common import dropout

NEG_INF = -1e30


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True, *,
                                 generator: Optional[torch.Generator] = None):
    """Attention over ``[batch, seq, heads, dim]`` tensors, in the JAX
    reference's numerics and argument order: grouped-query heads are
    served by repeating K/V, logits are taken in the inputs' promoted
    dtype and then upcast to at least float32, a boolean mask (True =
    attend) and the causal mask fill with -1e30, and the probabilities are
    cast to the query's dtype before the product with V. With
    ``dropout_p > 0`` while ``training`` the cast probabilities go through
    ``dropout`` (upscale in train; its keep-mask is one ``torch.rand`` of
    the ``[b, heads, sq, sk]`` probabilities from ``generator``). The
    port's prefill and unfused decode branches and the UNet's attention
    use it; it is no kernel and no library call."""
    q, k, v = query, key, value
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hq != hk:
        rep = hq // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else d ** -0.5
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if is_causal:
        sk = k.shape[1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, NEG_INF)
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    dv = torch.promote_types(probs.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dv), v.to(dv))


def flash_attention(query, key, value, dropout=0.0, causal=False, *,
                    training=True, generator=None, **kw):
    """Parity: paddle.nn.functional.flash_attention.flash_attention.
    Delegates to ``kernels/flash_attention.py: flash_attention`` (the
    Hopper kernels for CUDA tensors, the dense reference for CPU
    tensors; with ``dropout`` while ``training``, the plain SDPA above
    with its keep-mask drawn from ``generator``); like the JAX function
    it ignores further keyword arguments."""
    from ...kernels import flash_attention as fa

    return fa.flash_attention(query, key, value, causal=causal,
                              dropout_p=dropout, training=training,
                              generator=generator)
