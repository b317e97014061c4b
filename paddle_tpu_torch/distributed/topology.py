"""Topology: the hybrid-parallel rank mesh (counterpart of
``paddle_tpu/distributed/topology.py``; parity: fleet/base/topology.py's
``CommunicateTopology`` and ``HybridCommunicateGroup``).

The grid is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=AXIS_ORDER`` over the first ``dp*pp*fsdp*ep*sep*tp``
ranks in row-major order, so rank r's coordinates are device r's in the
JAX mesh, and ``mesh.get_group(axis)`` is the process group of one axis
through this rank (its group ranks in coordinate order). The Fleet
queries (``get_model_parallel_world_size`` and the rest) read that
mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..errors import PreconditionNotMetError, enforce_ge
from .strategy import DistributedStrategy

AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sep", "tp")

_global_hcg: Optional["HybridCommunicateGroup"] = None


def _ensure_initialized():
    if not dist.is_initialized():
        from .env import init_parallel_env

        init_parallel_env()


def _device_type() -> str:
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def _mesh(sizes: Sequence[int], ranks=None) -> DeviceMesh:
    """The ``AXIS_ORDER`` mesh of ``sizes`` over ``ranks`` (default the
    first ranks of the world)."""
    need = int(np.prod(sizes))
    if ranks is None:
        ranks = range(need)
    grid = torch.as_tensor(list(ranks)[:need],
                           dtype=torch.int64).reshape(tuple(sizes))
    return DeviceMesh(_device_type(), grid, mesh_dim_names=AXIS_ORDER)


class CommGroup:
    """A slice of mesh ranks along one axis (parity: the object
    paddle.distributed.new_group returns); ``process_group`` is the
    torch group the collectives run on."""

    def __init__(self, axis: str, size: int, rank: int, ranks: List[int],
                 process_group=None):
        self.axis = axis
        self.nranks = size
        self.rank = rank
        self.ranks = ranks
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return (f"CommGroup(axis={self.axis}, nranks={self.nranks}, "
                f"rank={self.rank})")


class HybridCommunicateGroup:
    """The strategy's hybrid mesh over the job's ranks. Degrees given as
    keywords override the strategy's; with more ranks than the degrees
    need and no ``dp`` given, the extra ranks are absorbed into dp (as
    the JAX class does with devices). ``devices`` is the list of ranks
    to lay out (default all)."""

    def __init__(self, strategy: Optional[DistributedStrategy] = None,
                 devices: Optional[Sequence] = None, *, dp: int = None,
                 tp: int = None, pp: int = None, fsdp: int = None,
                 ep: int = None, sep: int = None, rank: int = None):
        _ensure_initialized()
        strategy = strategy or DistributedStrategy()
        h = strategy.hybrid_configs
        self.strategy = strategy
        self._dp = dp if dp is not None else h.dp_degree
        self._tp = tp if tp is not None else h.mp_degree
        self._pp = pp if pp is not None else h.pp_degree
        self._fsdp = fsdp if fsdp is not None else h.sharding_degree
        self._ep = ep if ep is not None else h.ep_degree
        self._sep = sep if sep is not None else h.sep_degree
        if devices is None:
            devices = list(range(dist.get_world_size()))
        rest = self._pp * self._fsdp * self._ep * self._sep * self._tp
        need = self._dp * rest
        if need == 0:
            raise ValueError("degrees must be >= 1")
        if len(devices) < need:
            raise ValueError(
                f"need {need} ranks for dp{self._dp}×pp{self._pp}"
                f"×fsdp{self._fsdp}×ep{self._ep}×sep{self._sep}"
                f"×tp{self._tp}, have {len(devices)}")
        if len(devices) > need and dp is None:
            self._dp = len(devices) // rest
            need = self._dp * rest
        self.mesh = _mesh(self._sizes(), devices)
        self.global_rank = dist.get_rank() if rank is None else rank
        self.nranks = need

    def _sizes(self) -> Tuple[int, ...]:
        return (self._dp, self._pp, self._fsdp, self._ep, self._sep,
                self._tp)

    def _coord(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(
            self.global_rank % self.nranks, self._sizes()))

    def topology(self):
        return dict(zip(AXIS_ORDER, self._sizes()))

    # fleet-parity queries ---------------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp

    def get_data_parallel_rank(self):
        return self._coord()[0]

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_stage_id(self):
        return self._coord()[1]

    def get_sharding_parallel_world_size(self):
        return self._fsdp

    def get_sharding_parallel_rank(self):
        return self._coord()[2]

    def get_expert_parallel_world_size(self):
        return self._ep

    def get_expert_parallel_rank(self):
        return self._coord()[3]

    def get_sep_parallel_world_size(self):
        return self._sep

    def get_sep_parallel_rank(self):
        return self._coord()[4]

    def get_model_parallel_world_size(self):
        return self._tp

    def get_model_parallel_rank(self):
        return self._coord()[5]

    def _group(self, axis: str) -> CommGroup:
        sizes = self._sizes()
        coord = list(self._coord())
        i = AXIS_ORDER.index(axis)
        ranks = []
        for j in range(sizes[i]):
            coord[i] = j
            ranks.append(int(np.ravel_multi_index(coord, sizes)))
        pg = (self.mesh.get_group(axis)
              if self.global_rank == dist.get_rank() else None)
        return CommGroup(axis, sizes[i], self._coord()[i], ranks, pg)

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("tp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("fsdp")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_expert_parallel_group(self):
        return self._group("ep")

    @property
    def is_first_stage(self):
        return self.get_stage_id() == 0

    @property
    def is_last_stage(self):
        return self.get_stage_id() == self._pp - 1


def build_mesh(*, dp: int = 1, pp: int = 1, fsdp: int = 1, ep: int = 1,
               sep: int = 1, tp: int = 1, devices=None) -> DeviceMesh:
    """The ``AXIS_ORDER`` mesh of these degrees over the first ranks of
    the job (or of ``devices``, a list of ranks); joins the default
    group first when there is none (NCCL, on the card). Too few ranks
    raise ``PreconditionNotMetError``."""
    _ensure_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size()))
    need = dp * pp * fsdp * ep * sep * tp
    enforce_ge(len(devices), need,
               f"available ranks (mesh dp={dp} pp={pp} fsdp={fsdp} "
               f"ep={ep} sep={sep} tp={tp} needs {need})",
               PreconditionNotMetError)
    return _mesh((dp, pp, fsdp, ep, sep, tp), devices)


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _global_hcg
    _global_hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _global_hcg


def fleet_init(strategy: Optional[DistributedStrategy] = None,
               devices=None):
    """Parity: fleet.init(is_collective=True, strategy=...) — builds the
    global hybrid group and mesh from the strategy's hybrid_configs."""
    hcg = HybridCommunicateGroup(strategy, devices=devices)
    set_hybrid_communicate_group(hcg)
    return hcg
