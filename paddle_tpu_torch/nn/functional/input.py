"""Input encodings (counterpart of ``paddle_tpu/nn/functional/input.py``):
``one_hot`` and the embedding lookup."""

from __future__ import annotations

import torch

from ...core.dtype import convert_dtype


def one_hot(x: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """``[..., num_classes]`` of ``dtype`` (float32 by default), one where
    the class equals the id in ``x``: an id outside ``[0, num_classes)``
    gives an all-zero row, as ``jax.nn.one_hot`` gives it (where
    ``torch.nn.functional.one_hot`` raises)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(convert_dtype(dtype))


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
