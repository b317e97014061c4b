"""Flash-attention dispatch (counterpart of
``paddle_tpu/kernels/flash_attention.py``).

``flash_attention`` sends every CUDA tensor to the Hopper kernels of
``mha.py``, which take any sequence lengths (ragged tiles are masked in
the kernels) and raise on what they cannot take (a head dim that is not
a multiple of 8 or is over 256). Only CPU tensors take the dense
references below. The JAX package also sends a sequence that is not a
multiple of 128 to its dense reference on a TPU; on the card that would
be a silent fall-back to O(s^2) memory, so the port does not. There is
no ``try`` around the kernel: a CUDA tensor launches it or raises.
Attention dropout while training is the one exception, on every device:
JAX's own rule sends it to the dense SDPA, and so does the port.

All paths align the causal mask bottom-right (key j visible to query i
iff ``j <= i + sk - sq``), the convention of ``_reference_attention``;
the JAX Pallas kernel aligns it top-left, which differs when
``sq != sk`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import flags
from ..nn.functional.flash_attention import scaled_dot_product_attention
from .mha import NEG_INF, mha


def _reference_attention(q, k, v, causal=False, scale=None, bias=None,
                         window=0):
    """Dense attention over [batch, seq, heads, head_dim], the JAX
    reference's numerics: logits in the inputs' dtype, then float32; the
    masks fill -1e30; probabilities cast to q's dtype before the product
    with V. Grouped-query heads repeat K/V."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hq != hk:
        rep = hq // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()
    if causal:
        sk = k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        if window:
            mask = mask & torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device).triu(
                                         sk - sq - window + 1)
        logits = logits.masked_fill(~mask, NEG_INF)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _same_segment(segment_ids, device):
    """[b, 1, sq, sk]: True where the query's and the key's segment ids
    match (one [b, s] array, or a (q_ids, kv_ids) pair)."""
    if isinstance(segment_ids, (tuple, list)):
        seg_q, seg_kv = segment_ids
    else:
        seg_q = seg_kv = segment_ids
    seg_q = torch.as_tensor(seg_q, device=device)
    seg_kv = torch.as_tensor(seg_kv, device=device)
    return seg_q[:, None, :, None] == seg_kv[:, None, None, :]


def _segment_reference_attention(q, k, v, segment_ids, causal=False,
                                 scale=None, window=0):
    """The dense reference with a segment mask (tokens attend only where
    ids match) given as a -1e30 bias."""
    same = _same_segment(segment_ids, q.device)
    bias = torch.where(same, 0.0, NEG_INF)
    return _reference_attention(q, k, v, causal=causal, scale=scale,
                                bias=bias, window=window)


def use_kernel(q) -> bool:
    """The dispatch rule: every tensor that is not on the CPU goes to the
    kernels (``mha`` raises for a device other than the card)."""
    return q.device.type != "cpu"


def _dropout_attention(q, k, v, causal, dropout_p, scale, segment_ids,
                       window_size, generator):
    """Attention with dropout, JAX's rule for it: the plain SDPA of
    ``nn.functional`` with the segment mask and the causal window band as
    one boolean mask (True = attend) and the causal mask its own."""
    attn_mask = None
    if segment_ids is not None:
        attn_mask = _same_segment(segment_ids, q.device)
    if window_size:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        band = ((q_pos - torch.arange(sk, device=q.device)[None, :])
                < window_size)[None, None]
        attn_mask = band if attn_mask is None else (attn_mask & band)
    return scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=dropout_p, is_causal=causal,
        scale=scale, training=True, generator=generator)


def flash_attention(q, k, v, causal: bool = False, dropout_p: float = 0.0,
                    training: bool = True, scale: Optional[float] = None,
                    segment_ids=None, window_size: int = 0, *,
                    generator: Optional[torch.Generator] = None):
    """[batch, seq, heads, head_dim] attention. ``segment_ids`` gives the
    packed-sequence form (one [b, s] array or a (q_ids, kv_ids) pair);
    ``window_size`` a causal sliding window. Differentiable on every
    path. ``dropout_p > 0`` while ``training`` goes, on every device, to
    the plain SDPA with dropout drawn from ``generator``, as the JAX
    package sends it to its dense SDPA; every other call on the card
    launches rows 5-9 or raises."""
    if window_size and not causal:
        raise ValueError("window_size requires causal=True")
    if dropout_p > 0.0 and training:
        return _dropout_attention(q, k, v, causal, dropout_p, scale,
                                  segment_ids, window_size, generator)
    if use_kernel(q):
        return mha(q, k, v, causal=causal, sm_scale=scale,
                   k_block=int(flags.flag("flash_attention_block_k")),
                   segment_ids=segment_ids, window=window_size)
    if segment_ids is not None:
        return _segment_reference_attention(q, k, v, segment_ids,
                                            causal=causal, scale=scale,
                                            window=window_size)
    return _reference_attention(q, k, v, causal=causal, scale=scale,
                                window=window_size)
