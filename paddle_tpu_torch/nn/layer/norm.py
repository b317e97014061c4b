"""Normalisation layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ..functional.norm import rms_norm


class RMSNorm(nn.Module):
    """Parity: phi fusion rms_norm / PaddleNLP LlamaRMSNorm. The weight
    starts at ones, as in the JAX layer, and is trainable. ``device``
    defaults to the card (raises without one unless ``"cpu"`` is
    passed)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones((hidden_size,), dtype=dtype,
                       device=resolve_device(device)))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"hidden_size={self.hidden_size}, epsilon={self.epsilon}"
