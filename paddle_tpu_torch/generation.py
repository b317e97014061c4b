"""Per-slot logits processing for the serving engine (counterpart of
``paddle_tpu/generation.py: process_logits_batch``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def process_logits_batch(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row temperature -> top-k -> top-p over ``[batch, vocab]``
    logits, each parameter a ``[batch]`` tensor. ``top_k <= 0`` and
    ``top_p >= 1`` disable their filter for that row. As in the JAX
    function, top-k cuts by sorted rank (ties at the k-th logit keep
    exactly k entries), top-p's nucleus mass is taken over the top-k
    survivors' renormalised distribution, and the top-1 token always
    survives both filters. A row with ``top_p >= 1`` drops nothing: the
    JAX function can drop tail tokens there when the float32 cumulative
    sum rounds up to 1.0 before the last token."""
    logits = logits / torch.clamp(temperature, min=1e-6)[:, None]
    b, v = logits.shape
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    drop_k = (top_k[:, None] > 0) & (rank >= top_k[:, None])
    probs = torch.softmax(sorted_logits.masked_fill(drop_k, NEG_INF),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drop_p = ((cum - probs) >= top_p[:, None]) & (top_p[:, None] < 1.0)
    drop_sorted = (drop_k | drop_p) & (rank > 0)
    drop = torch.zeros_like(drop_sorted).scatter(1, sort_idx, drop_sorted)
    return logits.masked_fill(drop, NEG_INF)
