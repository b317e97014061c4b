"""Tensor-parallel layers at tp=1 (counterpart of
``paddle_tpu/distributed/parallel_layers/mp_layers.py``).

The JAX layers keep the global logical shape and let GSPMD partition
them. On one device the port needs no partitioning, so each layer is a
plain ``nn.Module`` with the same parameter names and shapes: weights are
``[in_features, out_features]`` as in the JAX package, so a JAX
``state_dict`` loads without transposes. Tensor parallelism is later
work (ROADMAP Queue A, distributed).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.device import resolve_device
from ...core.random import normal_
from ...nn.functional import embedding, linear


def _weight(shape, std: float, dtype, device,
            generator: torch.Generator) -> nn.Parameter:
    """A trainable parameter drawn from Normal(0, std) with ``generator``
    (on ``device``), as the JAX layers draw from ``I.Normal``."""
    w = torch.empty(shape, dtype=dtype, device=device)
    normal_(w, 0.0, std, generator)
    return nn.Parameter(w)


class ColumnParallelLinear(nn.Module):
    """Weight [in, out]; at tp>1 the out dim would be sharded. ``device``
    defaults to the card (raises without one unless ``"cpu"`` is passed);
    ``generator`` must live on that device."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, has_bias: bool = True,
                 dtype=torch.float32, device="cuda",
                 *, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _weight((in_features, out_features), std, dtype,
                              device, generator)
        self.bias = (nn.Parameter(torch.zeros((out_features,), dtype=dtype,
                                              device=device))
                     if has_bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RowParallelLinear(ColumnParallelLinear):
    """Weight [in, out]; at tp>1 the in (contracted) dim would be
    sharded and the partial sums all-reduced."""


class VocabParallelEmbedding(nn.Module):
    """Embedding table [vocab, hidden]; at tp>1 the vocab dim would be
    sharded. ``device`` defaults to the card, as for the linears."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, dtype=torch.float32, device="cuda",
                 *, generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _weight((num_embeddings, embedding_dim), std, dtype,
                              device, generator)

    def forward(self, x):
        return embedding(x, self.weight)
