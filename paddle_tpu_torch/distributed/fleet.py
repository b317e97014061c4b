"""paddle.distributed.fleet namespace (counterpart of
``paddle_tpu/distributed/fleet.py``; parity:
python/paddle/distributed/fleet/__init__.py): ``fleet.init(
is_collective=True, strategy)``, ``fleet.distributed_model/optimizer``
and the rank/worker queries.

``init`` joins the process group when there is none and builds the
global hybrid group (the mesh) from the strategy. As in JAX, the model
and the optimizer pass through: ``TrainStep`` reads the same strategy
and runs its parallelism over the mesh.
"""

from __future__ import annotations

from typing import Optional

from . import parallel_layers as meta_parallel  # noqa: F401
from .env import get_rank, get_world_size
from .strategy import DistributedStrategy  # noqa: F401
from .topology import (  # noqa: F401
    HybridCommunicateGroup,
    fleet_init,
    get_hybrid_communicate_group,
)

_strategy: Optional[DistributedStrategy] = None


def init(role_maker=None, is_collective=False,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO"):
    """Parity: fleet.init — the global HybridCommunicateGroup from the
    strategy's hybrid_configs (collective mode; parameter-server role
    makers are not ported, as in JAX)."""
    global _strategy
    _strategy = strategy or DistributedStrategy()
    fleet_init(_strategy)
    return None


def is_first_worker() -> bool:
    return get_rank() == 0


def worker_index() -> int:
    return get_rank()


def worker_num() -> int:
    return get_world_size()


def barrier_worker():
    from .collective import barrier

    barrier()


def distributed_model(model):
    """Parity: fleet.distributed_model — the model passes through;
    ``TrainStep`` over the mesh reduces the gradients."""
    return model


def distributed_optimizer(optimizer, strategy=None):
    """Parity: fleet.distributed_optimizer — the optimizer passes
    through; ``strategy`` replaces the one ``init`` kept."""
    global _strategy
    if strategy is not None:
        _strategy = strategy
    return optimizer


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy
