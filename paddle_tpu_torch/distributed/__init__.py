"""paddle_tpu_torch.distributed — the distributed core of the port
(counterpart of ``paddle_tpu/distributed``; parity:
python/paddle/distributed/: fleet, the collective API, auto_parallel,
launch).

One process a rank on ``torch.distributed`` (NCCL on the card, gloo on
the host when asked), the hybrid mesh a ``DeviceMesh`` with the JAX axis
order, tensor parallelism and ZeRO stages 1-3 written here with their own
collectives, and ``TrainStep`` over the mesh with sequence (ring or
Ulysses attention) and expert parallelism. ``checkpoint`` saves sharded
state from one mesh and loads it onto another in the JAX package's
layout; ``pipeline`` runs the 1F1B, VPP and F-then-B schedules
(``PipelineTrainStep``).
"""

from . import checkpoint, fleet, launch, parallel_layers, stream  # noqa: F401
from .auto_parallel import (  # noqa: F401
    Partial,
    Placement,
    ProcessMesh,
    Replicate,
    Shard,
    dtensor_from_fn,
    dtensor_to_local,
    get_mesh,
    get_placements,
    parallelize,
    reshard,
    set_mesh,
    shard_layer,
    shard_optimizer,
    shard_tensor,
    unshard_dtensor,
)
from .collective import (  # noqa: F401
    Group,
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    gather,
    get_group,
    irecv,
    is_initialized,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .env import (  # noqa: F401
    ParallelEnv,
    device_count,
    get_local_rank,
    get_rank,
    get_world_size,
    init_parallel_env,
    local_device_count,
    spawn,
)
from .moe import DroplessMoELayer, MoELayer  # noqa: F401
from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .sharding import (  # noqa: F401
    batch_spec,
    group_sharded_parallel,
    model_shardings,
    opt_state_shardings,
    param_partition_spec,
    place_params_on_mesh,
    recompute,
    sequence_parallel_constraint,
    shard_activation,
)
from .strategy import (  # noqa: F401
    AmpConfig,
    DistributedStrategy,
    HybridConfig,
    MoEConfig,
    PipelineConfig,
    RecomputeConfig,
    ShardingConfig,
)
from .topology import (  # noqa: F401
    HybridCommunicateGroup,
    build_mesh,
    fleet_init,
    get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)

# the pipeline subclasses trainer.TrainStep, whose module imports this
# package: its names load on first use
_PIPELINE = ("LayerDesc", "PipelineLayer", "PipelineModule",
             "PipelineTrainStep", "SharedLayerDesc", "pipeline")


def __getattr__(name):
    if name in _PIPELINE:
        import importlib

        mod = importlib.import_module(f"{__name__}.pipeline")
        return mod if name == "pipeline" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
