"""Semi-auto parallel API on DTensor (counterpart of
``paddle_tpu/distributed/auto_parallel.py``; parity:
python/paddle/distributed/auto_parallel/ — ``ProcessMesh``,
``shard_tensor(t, mesh, [Shard(0), Replicate()])``, placements,
``reshard``, ``shard_layer``).

This is where the JAX API hands out sharded global arrays, so the port
hands out ``torch.distributed.tensor.DTensor``s: ``ProcessMesh`` wraps a
``DeviceMesh``, ``Shard``/``Replicate``/``Partial`` map to torch's
placements (``placements[i]`` says how mesh dim i maps onto the tensor,
as in Paddle), and rank r's local block (``dtensor_to_local``) is the
JAX global array's shard on device r. Every rank passes the same global
tensor to ``shard_tensor``. The train path does not use DTensor: the
hand-written kernels and the optimizer take plain tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.module import Layer


def _dt():
    """torch's DTensor module (``torch.distributed.tensor``, or
    ``torch.distributed._tensor`` on older torch)."""
    try:
        from torch.distributed import tensor as dt

        dt.DTensor  # noqa: B018
    except (ImportError, AttributeError):
        from torch.distributed import _tensor as dt
    return dt


class Placement:
    pass


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def to_torch(self):
        return _dt().Shard(self.dim)


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def to_torch(self):
        return _dt().Replicate()


class Partial(Placement):
    """A pending reduction: ``reshard`` to ``Replicate`` reduces."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def to_torch(self):
        return _dt().Partial(self.reduce_type)


def _from_torch(pl) -> Placement:
    dt = _dt()
    if isinstance(pl, dt.Shard):
        return Shard(pl.dim)
    if isinstance(pl, dt.Partial):
        return Partial(getattr(pl, "reduce_op", "sum"))
    return Replicate()


class ProcessMesh:
    """Parity: paddle.distributed.ProcessMesh(mesh, dim_names): the ranks
    ``mesh`` (an nd list of process ids) as a ``DeviceMesh`` on the
    process group's device type (``device_mesh``)."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 devices=None):
        from torch.distributed.device_mesh import DeviceMesh

        grid = torch.as_tensor(mesh, dtype=torch.int64)
        self.shape = tuple(grid.shape)
        self.process_ids = grid.flatten().tolist()
        self.dim_names = list(dim_names or
                              [f"d{i}" for i in range(grid.dim())])
        dev = "cpu" if dist.get_backend() == "gloo" else "cuda"
        self.device_mesh = DeviceMesh(dev, grid,
                                      mesh_dim_names=tuple(self.dim_names))

    @property
    def ndim(self):
        return len(self.shape)

    def get_dim_size(self, name: str):
        return self.shape[self.dim_names.index(name)]

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


def _placements_to_spec(placements: List[Placement], mesh: ProcessMesh,
                        ndim: int):
    """The JAX spec entries of ``placements`` (for ``Parameter.spec``)."""
    entries: List = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            axis = mesh.dim_names[mesh_dim]
            cur = entries[pl.dim]
            if cur is None:
                entries[pl.dim] = axis
            elif isinstance(cur, tuple):
                entries[pl.dim] = cur + (axis,)
            else:
                entries[pl.dim] = (cur, axis)
    return tuple(entries)


def _torch_placements(placements):
    return [p.to_torch() for p in placements]


def shard_tensor(x, mesh: ProcessMesh, placements: List[Placement],
                 stop_gradient: bool = None):
    """A DTensor of the global ``x`` laid out by ``placements`` on
    ``mesh`` (rank r keeps its block). A parameter comes back as a new
    ``nn.Parameter`` of that DTensor carrying ``spec``."""
    dt = _dt()
    is_param = isinstance(x, nn.Parameter)
    src = x.detach() if is_param else x
    if isinstance(src, dt.DTensor):
        out = src.redistribute(mesh.device_mesh,
                               _torch_placements(placements))
    else:
        out = dt.distribute_tensor(src, mesh.device_mesh,
                                   _torch_placements(placements))
    if not is_param:
        if stop_gradient is False:
            out.requires_grad_(True)
        return out
    p = nn.Parameter(out, requires_grad=x.requires_grad
                     if stop_gradient is None else not stop_gradient)
    p.spec = _placements_to_spec(placements, mesh, x.dim())
    return p


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(x, mesh: ProcessMesh, placements: List[Placement]):
    """Parity: paddle.distributed.reshard — ``x`` with new placements
    (a Partial input is reduced: torch's ``redistribute``)."""
    if not isinstance(x, _dt().DTensor):
        return shard_tensor(x, mesh, placements)
    return x.redistribute(mesh.device_mesh, _torch_placements(placements))


def shard_layer(layer: Layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None) -> Layer:
    """Parity: dist.shard_layer — ``shard_fn(sublayer_name, sublayer,
    mesh)`` over the tree (default: every parameter replicated on the
    mesh), ``input_fn(args, mesh)``/``output_fn(out, mesh)`` as hooks."""
    if shard_fn is None:
        def shard_fn(name, sub, mesh):
            for pname, p in list(sub._parameters.items()):
                if p is not None:
                    sub._parameters[pname] = shard_tensor(
                        p, mesh, [Replicate()] * mesh.ndim)

    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda mod, args: input_fn(args, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda mod, args, out: output_fn(out, process_mesh))
    return layer


def get_placements(x, mesh: ProcessMesh = None):
    """The placements of a DTensor (all ``Replicate`` for a plain
    tensor)."""
    if isinstance(x, _dt().DTensor):
        return [_from_torch(p) for p in x.placements]
    n = mesh.ndim if mesh is not None else 1
    return [Replicate() for _ in range(n)]


_GLOBAL_MESH = [None]


def set_mesh(mesh):
    """Parity: paddle.distributed.set_mesh."""
    _GLOBAL_MESH[0] = mesh
    return mesh


def get_mesh():
    """Parity: paddle.distributed.get_mesh."""
    return _GLOBAL_MESH[0]


def shard_optimizer(optimizer, shard_fn=None):
    """Parity: paddle.distributed.shard_optimizer: ``shard_fn`` is applied
    to any state the optimizer already holds; the slots of ``TrainStep``
    over a mesh are laid out by ``opt_slot_partition_spec`` anyway."""
    if shard_fn is not None and getattr(optimizer, "_eager_state", None):
        optimizer._eager_state = shard_fn(optimizer._eager_state)
    return optimizer


def dtensor_to_local(x, mesh=None, placements=None):
    """This rank's block of a DTensor as a plain tensor (a plain tensor
    passes through)."""
    return x.to_local() if isinstance(x, _dt().DTensor) else x


def unshard_dtensor(x):
    """The global value of a DTensor, on every rank (an all-gather, or a
    reduction of partial placements); a plain tensor passes through."""
    return x.full_tensor() if isinstance(x, _dt().DTensor) else x


def parallelize(model, optimizer=None, mesh=None, config=None):
    """Parity: paddle.distributed.parallelize. The port's parallelism is
    declared on parameters (``spec``) and run by ``TrainStep`` over a
    mesh, so the pair passes through (unknown configs are ignored, as in
    JAX)."""
    if optimizer is None:
        return model
    return model, optimizer
