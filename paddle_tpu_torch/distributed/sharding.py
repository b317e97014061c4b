"""The sharding engine (counterpart of
``paddle_tpu/distributed/sharding.py``).

The JAX package declares its parallelism: each parameter carries a
logical ``spec`` (``ColumnParallelLinear`` ``(None, "tp")``,
``RowParallelLinear`` and ``VocabParallelEmbedding`` ``("tp", None)``),
``param_partition_spec``/``opt_slot_partition_spec`` add the ``fsdp``
axis (from stage 3 for parameters, from stage 1 for optimizer slots),
and GSPMD inserts the collectives. The port keeps the same specs and the
same spec functions, returning the tuples of JAX's ``P`` entries, and
does by hand what GSPMD does: every rank builds the model at the global
shapes from the same weights, ``place_params_on_mesh`` cuts each
parameter to this rank's block of its spec, the tensor-parallel layers
run the Megatron collectives (``parallel_layers/mp_layers.py``), and
``TrainStep`` reduces the gradients, keeps the optimizer slots as blocks
and gathers what it needs.

A block follows GSPMD's layout: a dim whose spec entry names axes
``(a1, ..., am)`` is cut into ``prod(sizes)`` pieces of ``ceil(n /
count)`` rows (the last ones shorter, or empty), and this rank takes the
piece at its row-major index over those axes' coordinates. So rank r's
block of any tensor is the JAX array's shard on device r.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import checkpoint as _ckpt

from .strategy import DistributedStrategy

_mesh_var: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_mesh", default=None)

# params smaller than this stay unsharded under ZeRO (parity:
# GroupShardedStage3 segment_size keeps small params whole)
MIN_SIZE_TO_SHARD = 2**13


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh (the collectives resolve axis names
    on it)."""
    tok = _mesh_var.set(mesh)
    try:
        yield mesh
    finally:
        _mesh_var.reset(tok)


def current_mesh():
    m = _mesh_var.get()
    if m is not None:
        return m
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.mesh if hcg is not None else None


# ---------------------------------------------------------------------------
# the spec functions (the JAX ones, entry for entry)
# ---------------------------------------------------------------------------
def _normalize_logical_spec(spec, ndim) -> Tuple:
    if spec is None:
        return tuple([None] * ndim)
    spec = tuple(spec)
    if len(spec) < ndim:
        spec = spec + tuple([None] * (ndim - len(spec)))
    return spec


def _axes_used(spec) -> set:
    used = set()
    for e in spec:
        used.update(entry_axes(e))
    return used


def entry_axes(e) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first."""
    if e is None:
        return ()
    if isinstance(e, (tuple, list)):
        return tuple(e)
    return (e,)


def fsdp_augment(spec: Tuple, shape, axis_name: str = "fsdp",
                 axis_size: int = 1) -> Tuple:
    """Add the fsdp axis to the best unsharded dim (prefer dim 0; prefer
    divisible dims; fall back to the largest)."""
    if axis_name in _axes_used(spec):
        return spec
    candidates = [i for i, e in enumerate(spec) if e is None and shape[i] > 1]
    if not candidates:
        # compose onto an already-sharded dim if divisible
        for i, e in enumerate(spec):
            if e is not None and shape[i] % max(axis_size, 1) == 0:
                cur = e if isinstance(e, tuple) else (e,)
                out = list(spec)
                out[i] = cur + (axis_name,)
                return tuple(out)
        return spec
    divisible = [i for i in candidates if shape[i] % max(axis_size, 1) == 0]
    pool = divisible or candidates
    dim = min(pool)  # prefer leading dim (weight rows / vocab / out_c)
    out = list(spec)
    out[dim] = axis_name
    return tuple(out)


def param_partition_spec(name: str, shape, logical_spec,
                         strategy: DistributedStrategy) -> Tuple:
    """The final spec of a parameter: its logical spec, plus fsdp from
    stage 3 for parameters of at least ``MIN_SIZE_TO_SHARD`` elements."""
    ndim = len(shape)
    spec = _normalize_logical_spec(logical_spec, ndim)
    size = int(np.prod(shape)) if ndim else 1
    if strategy.sharding_stage >= 3 and strategy.fsdp > 1 \
            and size >= MIN_SIZE_TO_SHARD:
        spec = fsdp_augment(spec, shape, "fsdp", strategy.fsdp)
    return tuple(spec)


def opt_slot_partition_spec(name: str, shape, logical_spec,
                            strategy: DistributedStrategy) -> Tuple:
    """The spec of optimizer moments and master weights: sharded over
    fsdp from stage 1 up (ZeRO-1's entire point)."""
    ndim = len(shape)
    spec = _normalize_logical_spec(logical_spec, ndim)
    size = int(np.prod(shape)) if ndim else 1
    if strategy.sharding_stage >= 1 and strategy.fsdp > 1 \
            and size >= MIN_SIZE_TO_SHARD:
        spec = fsdp_augment(spec, shape, "fsdp", strategy.fsdp)
    return tuple(spec)


def batch_spec(ndim: int = 2, seq_axis: Optional[int] = 1,
               strategy: Optional[DistributedStrategy] = None) -> Tuple:
    """Input batch sharding: batch over (dp, fsdp), sequence over sep."""
    entries = [None] * ndim
    entries[0] = ("dp", "fsdp")
    if seq_axis is not None and ndim > seq_axis and (
            strategy is None or strategy.sep > 1):
        entries[seq_axis] = "sep"
    return tuple(entries)


Sharding = collections.namedtuple("Sharding", ["mesh", "spec"])


def _filter_spec_for_mesh(spec_entries, mesh):
    names = set(mesh.mesh_dim_names)

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return e if e in names else None

    return tuple(keep(e) for e in spec_entries)


def _global_shape(p) -> Tuple[int, ...]:
    return tuple(getattr(p, "global_shape", None) or p.shape)


def model_shardings(model, mesh, strategy: DistributedStrategy,
                    filter_to_mesh: bool = False) -> Dict[str, Sharding]:
    """``Sharding(mesh, spec)`` per parameter (keys = qualified names)."""
    out = {}
    for name, p in model.named_parameters():
        spec = param_partition_spec(name, _global_shape(p),
                                    getattr(p, "spec", None), strategy)
        if filter_to_mesh:
            spec = _filter_spec_for_mesh(spec, mesh)
        out[name] = Sharding(mesh, spec)
    return out


def opt_state_shardings(optimizer, params_meta, mesh, strategy):
    """The ``Sharding`` of each leaf of ``optimizer.init``'s state
    (``params_meta``: ``{name: (shape, logical_spec)}``): slots shaped
    like their parameter take the opt-slot spec, others are
    replicated."""
    repl = Sharding(mesh, ())
    slot_shardings, master = {}, {}
    for name, (shape, lspec) in params_meta.items():
        sh = Sharding(mesh, opt_slot_partition_spec(name, shape, lspec,
                                                    strategy))
        slots = optimizer._init_slot(torch.empty(tuple(shape),
                                                 device="meta"))
        slot_shardings[name] = {
            k: (sh if tuple(getattr(v, "shape", ())) == tuple(shape)
                else repl) for k, v in slots.items()}
        master[name] = sh
    out = {"step": repl, "slots": slot_shardings}
    if optimizer.multi_precision:
        # master entries exist only for low-precision params
        out["master"] = master
    return out


# ---------------------------------------------------------------------------
# blocks: cutting, gathering and scattering by spec
# ---------------------------------------------------------------------------
def _size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def _coord(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if _size(mesh, axis) > 1 else 0


def dim_range(n: int, axes, mesh) -> Tuple[int, int, int]:
    """``(lo, hi, chunk)``: this rank's rows of a dim of ``n`` rows cut
    over ``axes`` (major first)."""
    count, idx = 1, 0
    for a in axes:
        k = _size(mesh, a)
        count *= k
        idx = idx * k + _coord(mesh, a)
    chunk = -(-n // count) if n else 0
    lo = min(n, idx * chunk)
    return lo, min(n, lo + chunk), chunk


def is_sharded(spec, mesh) -> bool:
    return any(_size(mesh, a) > 1 for a in _axes_used(spec))


def block_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    spec = _normalize_logical_spec(spec, len(shape))
    out = []
    for n, e in zip(shape, spec):
        lo, hi, _ = dim_range(n, entry_axes(e), mesh)
        out.append(slice(lo, hi))
    return tuple(out)


def cut(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` (a copy)."""
    return t[block_slices(tuple(t.shape), spec, mesh)].contiguous()


def _drop(spec, dim: int):
    """``spec`` with the last axis of dim ``dim``'s entry removed."""
    axes = entry_axes(spec[dim])[:-1]
    out = list(spec)
    out[dim] = None if not axes else (axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def _pad_to(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    if x.shape[dim] == rows:
        return x
    pad = list(x.shape)
    pad[dim] = rows - x.shape[dim]
    return torch.cat([x, x.new_zeros(pad)], dim=dim)


def _gather_last(x, dim, n, axes, mesh):
    """All-gather ``x`` (this rank's block along ``dim`` of a global dim
    of ``n`` rows cut over ``axes``) over the last of ``axes``: the block
    of the entry without it."""
    from .collective import _record

    axis = axes[-1]
    k = _size(mesh, axis)
    if k == 1:
        return x
    chunk = dim_range(n, axes, mesh)[2]
    olo, ohi, _ = dim_range(n, axes[:-1], mesh)
    xp = _pad_to(x, dim, chunk).movedim(dim, 0).contiguous()
    _record("all_gather", axis, xp)
    out = xp.new_empty((k * chunk,) + tuple(xp.shape[1:]))
    dist.all_gather_into_tensor(out, xp, group=mesh.get_group(axis))
    return out[: ohi - olo].movedim(0, dim)


def _scatter_last(g, dim, n, axes, mesh):
    """Reduce-scatter ``g`` (a gradient shaped like the block of the
    entry without the last of ``axes``) over that last axis: the sum's
    block of the full entry."""
    from .collective import _record

    axis = axes[-1]
    k = _size(mesh, axis)
    if k == 1:
        return g
    lo, hi, chunk = dim_range(n, axes, mesh)
    gp = _pad_to(g, dim, k * chunk).movedim(dim, 0).contiguous()
    _record("reduce_scatter", axis, gp)
    out = gp.new_empty((chunk,) + tuple(gp.shape[1:]))
    dist.reduce_scatter_tensor(out, gp, op=dist.ReduceOp.SUM,
                               group=mesh.get_group(axis))
    return out[: hi - lo].movedim(0, dim)


def axis_dim(spec, axis: str) -> Optional[int]:
    """The dim whose entry ends with ``axis``, or None."""
    for i, e in enumerate(spec):
        axes = entry_axes(e)
        if axes and axes[-1] == axis:
            return i
    return None


def gather_axis(x, spec, shape, mesh, axis: str):
    """``(block, spec)`` with ``axis`` gathered away (``axis`` must end
    its dim's entry, as ``fsdp_augment`` places fsdp)."""
    spec = _normalize_logical_spec(spec, len(shape))
    d = axis_dim(spec, axis)
    if d is None:
        return x, spec
    return (_gather_last(x, d, shape[d], entry_axes(spec[d]), mesh),
            _drop(spec, d))


def scatter_axis(g, spec, shape, mesh, axis: str):
    """The reduce-scatter over ``axis`` of a gradient shaped like the
    block of ``spec`` without ``axis``: the sum's block of ``spec``."""
    spec = _normalize_logical_spec(spec, len(shape))
    d = axis_dim(spec, axis)
    if d is None:
        return g
    return _scatter_last(g, d, shape[d], entry_axes(spec[d]), mesh)


def gather_full(x, spec, shape, mesh) -> torch.Tensor:
    """The global tensor from every rank's block of ``spec``."""
    spec = _normalize_logical_spec(spec, len(shape))
    for d in range(len(shape)):
        while entry_axes(spec[d]):
            axes = entry_axes(spec[d])
            x = _gather_last(x, d, shape[d], axes, mesh)
            spec = _drop(spec, d)
    return x


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def place_params_on_mesh(model, mesh, strategy):
    """Cut every parameter of ``model`` to this rank's block of its
    ``param_partition_spec`` (parity: the scatter DataParallel and
    GroupShardedStage3 do at wrap time) and hand the tensor-parallel
    layers their tp group. Each parameter keeps ``global_shape`` and
    ``placement`` (its spec). At tp > 1 a layer that builds
    tensor-parallel layers without running tensor parallelism raises
    ``NotImplementedError``. Cutting twice is a no-op."""
    from .parallel_layers.mp_layers import set_tensor_parallel

    set_tensor_parallel(model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if getattr(p, "placement", None) is not None:
                continue
            shape = tuple(p.shape)
            spec = param_partition_spec(name, shape, getattr(p, "spec", None),
                                        strategy)
            p.global_shape = shape
            p.placement = spec
            if is_sharded(spec, mesh):
                p.data = cut(p.data, spec, mesh)
    return model


def shard_activation(x, *spec_entries):
    """The identity: the port's activations are each rank's local tensors
    (the JAX package constrains a global array's layout here)."""
    return x


def sequence_parallel_constraint(x):
    """The identity on a local tensor (Megatron-SP's layout constraint in
    the JAX package; sequence parallelism is the next slice)."""
    return x


def recompute(function, *args, **kwargs):
    """Parity: paddle.distributed.fleet.utils.recompute — run ``function``
    without keeping its activations and recompute them in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    kwargs.pop("use_reentrant", None)
    return _ckpt.checkpoint(function, *args, use_reentrant=False, **kwargs)


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None,
                           **kw):
    """Parity: paddle.distributed.sharding.group_sharded_parallel.

    level: "os" (ZeRO-1: optimizer state), "os_g" (ZeRO-2: +grads),
    "p_g_os" (ZeRO-3: +params). Returns ``(model, optimizer, strategy,
    scaler)``: hand the strategy (and a mesh) to ``TrainStep``, which runs
    the stage."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level)
    if stage is None:
        raise ValueError(
            f"unknown group_sharded level {level!r}; one of os/os_g/p_g_os")
    strategy = DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs.stage = stage
    return model, optimizer, strategy, scaler
