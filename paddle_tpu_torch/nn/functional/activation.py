"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch


def swiglu(x: torch.Tensor, y=None) -> torch.Tensor:
    """silu(x) * y; with ``y`` None, ``x`` is split in half on its last
    axis (parity: phi fusion swiglu)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y
