"""Tensor-parallel layers at tp=1 (counterpart of
``paddle_tpu/distributed/parallel_layers/mp_layers.py``).

The JAX layers keep the global logical shape and let GSPMD partition
them. On one device the port needs no partitioning, so each layer is a
plain ``Layer`` with the same parameter names and shapes: weights are
``[in_features, out_features]`` as in the JAX package, so a JAX
``state_dict`` loads without transposes. Tensor parallelism is later
work (ROADMAP Queue A, distributed).
"""

from __future__ import annotations

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...nn.functional import embedding, linear


class ColumnParallelLinear(Layer):
    """Weight [in, out] drawn from Normal(0, ``std``) with ``generator``, as
    the JAX layers draw from ``I.Normal``; at tp>1 the out dim would be
    sharded. ``device`` defaults to the current device (the card unless
    ``set_device("cpu")`` chose the host; without a card that raises);
    ``generator`` must live on that device."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, has_bias: bool = True,
                 dtype=torch.float32, device=None,
                 *, generator: torch.Generator):
        super().__init__(dtype=dtype)
        device = current_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), default_initializer=I.Normal(
                0.0, std), device=device, generator=generator)
        self.bias = (self.create_parameter((out_features,), is_bias=True,
                                           device=device)
                     if has_bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RowParallelLinear(ColumnParallelLinear):
    """Weight [in, out]; at tp>1 the in (contracted) dim would be
    sharded and the partial sums all-reduced."""


class VocabParallelEmbedding(Layer):
    """Embedding table [vocab, hidden] drawn as the linears' weights; at
    tp>1 the vocab dim would be sharded. ``device`` as for the linears."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, dtype=torch.float32, device=None,
                 *, generator: torch.Generator):
        super().__init__(dtype=dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), default_initializer=I.Normal(
                0.0, std), device=current_device(device),
            generator=generator)

    def forward(self, x):
        return embedding(x, self.weight)
