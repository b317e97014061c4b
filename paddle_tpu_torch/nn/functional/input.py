"""Embedding lookup (counterpart of ``paddle_tpu/nn/functional/input.py``)."""

from __future__ import annotations

import torch


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` [vocab, hidden] at the integer ids ``x``."""
    return weight[x]
