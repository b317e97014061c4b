"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/parallel_layers``)."""

from .mp_layers import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    TPGroup,
    VocabParallelEmbedding,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    scatter_to_tp,
    set_tensor_parallel,
)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "TPGroup", "VocabParallelEmbedding",
           "copy_to_tp", "gather_from_tp", "reduce_from_tp",
           "scatter_to_tp", "set_tensor_parallel"]
