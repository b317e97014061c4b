"""Tensor-parallel layers at tp=1 (counterpart of
``paddle_tpu/distributed/parallel_layers``)."""

from .mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
