"""Rotary position embedding (counterpart of ``paddle_tpu/kernels/rope.py``).

Neox/Llama half-rotation, computed in float32 and cast back to the
input's dtype. The JAX package leaves it to XLA to fuse; the port leaves
it as plain torch ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.device import resolve_device


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 10000.0, dtype=torch.float32,
                     scaling_factor: float = 1.0, device="cuda"):
    """cos/sin tables [max_seq_len, head_dim // 2] on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32,
                     device=device) / scaling_factor
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """Half-rotate ``x`` [..., d] by cos/sin broadcastable to [..., d/2],
    in float32, and cast back to ``x``'s dtype."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor,
               position_ids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [batch, seq, heads, head_dim]; cos/sin: [max_seq, d/2];
    ``position_ids``: optional [batch, seq] rows of the tables.

    Positions past the table are clamped to its last row, as JAX's
    gather clamps them: the serving engine's idle-slot sentinel rows
    reach past the table, and their results are discarded."""
    seq = q.shape[1]
    if position_ids is None:
        c = cos[:seq][None, :, None, :].float()
        s = sin[:seq][None, :, None, :].float()
    else:
        idx = position_ids.long().clamp(0, cos.shape[0] - 1)
        c = cos[idx][:, :, None, :].float()
        s = sin[idx][:, :, None, :].float()
    return rotate(q, c, s), rotate(k, c, s)
