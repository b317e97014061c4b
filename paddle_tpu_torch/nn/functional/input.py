"""Embedding lookup (counterpart of ``paddle_tpu/nn/functional/input.py``)."""

from __future__ import annotations

import torch


def embedding(x: torch.Tensor, weight: torch.Tensor,
              padding_idx=None) -> torch.Tensor:
    """Rows of ``weight`` [vocab, hidden] at the integer ids ``x``; ids equal
    to ``padding_idx`` look up zeros (and pass no gradient), as in JAX."""
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out
