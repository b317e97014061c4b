"""The collective API on ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/collective.py``; parity:
python/paddle/distributed/communication/ over ProcessGroupNCCL).

SPMD: every rank calls the collective with its own *local* tensor. The
JAX package is single-controller and takes the *global* array split
along dim 0 over the group's axis; rank r's tensor here is block r of
that array, and the outputs of the ranks, concatenated in rank order,
are the JAX global output (``gather`` and ragged ``alltoall_single``,
whose JAX forms return per-rank lists, give rank r entry r).

A ``group`` is a ``Group``, a ``topology.CommGroup``, a torch
``ProcessGroup`` or a mesh axis name, resolved on the active mesh
(``sharding.mesh_context``, else the hybrid group of ``fleet.init``), as
the JAX ``_group_axis`` resolves it; ``None`` is the active mesh's
``"dp"`` axis, or the whole job when no mesh is active. ``src``/``dst``/
``peer`` are ranks within the group (a mesh axis: the coordinate along
it), as in JAX. Tensors are reduced and written in place where Paddle
does so, and returned too. ``sync_op=False`` returns a ``_Task`` whose
``wait()`` gives the result.

Every collective calls ``observability.comm.record(op, axis, x)`` with
its local input, as the JAX in-jit collectives do at trace time.
Point-to-point follows Paddle's per-rank contract: the source calls
``send``, the destination ``recv`` (the JAX lockstep form moves a shard
along one ring edge in one call).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.distributed as dist

from ..observability.comm import record as _record
from .topology import CommGroup


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


# ---------------------------------------------------------------------------
# groups (parity: paddle.distributed.new_group / Group)
# ---------------------------------------------------------------------------
class Group:
    """A communicator handle: a mesh axis (``axis``) or a rank set, with
    its torch process group."""

    _registry: dict = {}
    _ids = itertools.count(1)

    def __init__(self, axis: Optional[str], ranks=None, process_group=None):
        self.axis = axis
        self.ranks = ranks
        self._pg = process_group
        self.id = next(Group._ids)
        Group._registry[self.id] = self

    @property
    def process_group(self):
        if self._pg is None and self.axis is not None:
            return _active_mesh().get_group(self.axis)
        return self._pg

    @property
    def nranks(self):
        return dist.get_world_size(self.process_group)

    @property
    def rank(self):
        return dist.get_rank(self.process_group)

    def __repr__(self):
        return f"Group(axis={self.axis!r}, id={self.id})"


def _active_mesh(required: bool = True):
    from .sharding import current_mesh

    mesh = current_mesh()
    if mesh is None and required:
        raise RuntimeError(
            "no active mesh: call distributed.fleet.init(...) / fleet_init, "
            "or enter sharding.mesh_context(mesh)")
    return mesh


def _axis_subgroups(mesh, axis: str):
    """The global rank sets of each subgroup of ``axis``."""
    grid = mesh.mesh
    ax = mesh.mesh_dim_names.index(axis)
    moved = grid.movedim(ax, -1).reshape(-1, grid.shape[ax])
    return [tuple(int(r) for r in row) for row in moved.tolist()]


def new_group(ranks=None, backend=None, timeout=None, axis=None):
    """A ``Group``: ``axis=`` binds a mesh axis; ``ranks`` matching one of
    an axis's subgroups of the active mesh binds that axis; any other
    rank set gets a torch group of its own (every rank of the job must
    call ``new_group`` with the same ranks, as torch requires)."""
    if axis is not None:
        return Group(axis, ranks)
    mesh = _active_mesh(required=False)
    if ranks is None:
        if mesh is not None:
            return Group(mesh.mesh_dim_names[0])
        return Group(None, list(range(dist.get_world_size())),
                     dist.group.WORLD)
    want = tuple(int(r) for r in ranks)
    if mesh is not None:
        for ax in mesh.mesh_dim_names:
            if want in _axis_subgroups(mesh, ax):
                return Group(ax, list(want))
    kw = {} if timeout is None else {"timeout": timeout}
    return Group(None, list(want), dist.new_group(list(want), backend=backend,
                                                  **kw))


def get_group(gid: int):
    return Group._registry.get(gid)


def destroy_process_group(group=None):
    """``None``: forget every ``Group`` and leave the job's process group
    (and the hybrid group); a ``Group``: forget it."""
    if group is None:
        Group._registry.clear()
        from .topology import set_hybrid_communicate_group

        set_hybrid_communicate_group(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    else:
        Group._registry.pop(getattr(group, "id", None), None)


def is_initialized():
    return dist.is_initialized()


def _resolve(group):
    """``(process group, axis label)`` for a group argument."""
    if group is None:
        mesh = _active_mesh(required=False)
        if mesh is None:
            return dist.group.WORLD, "world"
        return mesh.get_group("dp"), "dp"
    if isinstance(group, str):
        return _active_mesh().get_group(group), group
    if isinstance(group, (Group, CommGroup)):
        return group.process_group, group.axis or "group"
    return group, "group"


def _global(pg, group_rank: int) -> int:
    return dist.get_global_rank(pg, group_rank) \
        if pg is not None and pg != dist.group.WORLD else group_rank


class _Task:
    """A waitable result (parity: the task Paddle returns when
    ``sync_op=False``): ``wait()`` finishes the work and returns the
    value."""

    def __init__(self, work=None, finish=None, value=None):
        self._work = work
        self._finish = finish
        self.value = value

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._finish is not None:
                self.value = self._finish()
        return self.value

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _done(work, finish, sync_op):
    if sync_op:
        if work is not None:
            work.wait()
        return finish()
    return _Task(work, finish)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group in place and return it."""
    pg, axis = _resolve(group)
    _record("all_reduce", axis, tensor)
    if op == ReduceOp.AVG:
        work = dist.all_reduce(tensor, dist.ReduceOp.SUM, group=pg,
                               async_op=True)
        n = dist.get_world_size(pg)

        def finish():
            return tensor.div_(n) if tensor.is_floating_point() \
                else tensor.copy_(tensor // n)

        return _done(work, finish, sync_op)
    if op not in _TORCH_OPS:
        raise ValueError(op)
    work = dist.all_reduce(tensor, _TORCH_OPS[op], group=pg, async_op=True)
    return _done(work, lambda: tensor, sync_op)


def all_gather(tensor_or_list, tensor=None, group=None, sync_op=True):
    """Paddle's ``all_gather(out_list, tensor)`` appends every rank's
    tensor to ``out_list`` and returns it; ``all_gather(tensor)`` returns
    the ranks' tensors concatenated along dim 0 (JAX's functional
    form)."""
    if isinstance(tensor_or_list, list):
        out_list, x = tensor_or_list, tensor
    else:
        out_list, x = None, tensor_or_list
    pg, axis = _resolve(group)
    _record("all_gather", axis, x)
    n = dist.get_world_size(pg)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]) if x.dim()
                      else (n,), dtype=x.dtype, device=x.device)
    work = dist.all_gather_into_tensor(
        out, x.reshape(-1) if x.dim() == 0 else x, group=pg, async_op=True)

    def finish():
        if out_list is not None:
            out_list.extend(out.chunk(n) if x.dim() else list(out))
            return out_list
        return out

    return _done(work, finish, sync_op)


def reduce_scatter(tensor, group=None, op=ReduceOp.SUM, sync_op=True):
    """Rank r gets chunk r (of the group's size along dim 0) of the
    reduction of every rank's ``tensor``."""
    pg, axis = _resolve(group)
    _record("reduce_scatter", axis, tensor)
    n = dist.get_world_size(pg)
    if tensor.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({tensor.shape[0]}) is "
                         f"not divisible by the group's {n} ranks")
    out = torch.empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    top = dist.ReduceOp.SUM if op == ReduceOp.AVG else _TORCH_OPS[op]
    work = dist.reduce_scatter_tensor(out, tensor.contiguous(), op=top,
                                      group=pg, async_op=True)

    def finish():
        return out.div_(n) if op == ReduceOp.AVG else out

    return _done(work, finish, sync_op)


def _a2a(x, in_splits, out_splits, pg, sync_op, finish=None):
    x = x.contiguous()
    rows = sum(out_splits) if out_splits is not None else x.shape[0]
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = dist.all_to_all_single(out, x, out_splits, in_splits, group=pg,
                                  async_op=True)
    return _done(work, (lambda: finish(out)) if finish else (lambda: out),
                 sync_op)


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Chunk j (dim 0, of the group's size) of this rank's input goes to
    rank j; returns the received chunks concatenated in rank order (or
    appends them to ``out_tensor_list``)."""
    x = (torch.cat(list(in_tensor_list), dim=0)
         if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list)
    pg, axis = _resolve(group)
    return _alltoall(x, pg, axis, out_tensor_list, sync_op)


def _alltoall(x, pg, axis, out_tensor_list, sync_op):
    _record("all_to_all", axis, x)
    n = dist.get_world_size(pg)
    if x.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 ({x.shape[0]}) is not divisible "
                         f"by the group's {n} ranks")

    def finish(out):
        if out_tensor_list is not None:
            out_tensor_list.extend(out.chunk(n))
            return out_tensor_list
        return out

    return _a2a(x, None, None, pg, sync_op, finish)


all_to_all = alltoall


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """All-to-all on dim 0 with uniform or ragged splits.

    Ragged: ``in_split_sizes`` is this rank's list of ``nranks`` row
    counts (segment j goes to rank j), or the ``[nranks][nranks]`` matrix
    of every rank's lists (JAX's single-controller form; row ``rank`` is
    taken). It must sum to the local length. ``out_split_sizes`` (this
    rank's receive counts, or the matrix) is checked against the senders'
    counts, which are exchanged when it is missing. Returns the received
    segments concatenated in source order (JAX's ``out[rank]``), or
    copies them into ``out_tensor``."""
    pg, axis = _resolve(group)
    n = dist.get_world_size(pg)
    me = dist.get_rank(pg)
    if in_split_sizes is None and out_split_sizes is None:
        if out_tensor is None:
            return _alltoall(in_tensor, pg, axis, None, sync_op)
        return _copy_out(_alltoall(in_tensor, pg, axis, None, True),
                         out_tensor)

    def row(sizes, what):
        t = torch.as_tensor(sizes, dtype=torch.int64)
        if t.dim() == 2:
            if tuple(t.shape) != (n, n):
                raise ValueError(f"alltoall_single: {what} must be [{n}] or "
                                 f"[{n}][{n}], got {tuple(t.shape)}")
            return t, t[me].tolist()
        if tuple(t.shape) != (n,):
            raise ValueError(f"alltoall_single: {what} must be [{n}] or "
                             f"[{n}][{n}], got {tuple(t.shape)}")
        return None, t.tolist()

    if in_split_sizes is None:
        # only the receive counts: each sender's counts are their column
        mat, outs = row(out_split_sizes, "out_split_sizes")
        if mat is None:
            raise ValueError("alltoall_single: without in_split_sizes, "
                             "out_split_sizes must be the [n][n] matrix")
        in_split_sizes, out_split_sizes = mat.T, None
    mat, ins = row(in_split_sizes, "in_split_sizes")
    if sum(ins) != in_tensor.shape[0]:
        raise ValueError(f"alltoall_single: each rank's in_split_sizes must "
                         f"sum to its local length {in_tensor.shape[0]}, "
                         f"got {ins}")
    if mat is not None:
        recv = mat[:, me].tolist()
    else:
        # the receive counts are the senders' counts for this rank
        dev = in_tensor.device
        sent = torch.as_tensor(ins, dtype=torch.int64, device=dev)
        recv_t = torch.empty_like(sent)
        dist.all_to_all_single(recv_t, sent, group=pg)
        recv = recv_t.tolist()
    if out_split_sizes is not None:
        omat, outs = row(out_split_sizes, "out_split_sizes")
        if outs != recv:
            raise ValueError(
                "alltoall_single: out_split_sizes must be the transpose "
                "of in_split_sizes")
    _record("alltoall_single", axis, in_tensor)
    res = _a2a(in_tensor, ins, recv, pg, sync_op=True)
    if out_tensor is not None:
        if isinstance(out_tensor, list):
            out_tensor.append(res)
        else:
            _copy_out(res, out_tensor)
    return res if sync_op else _Task(value=res)


def _copy_out(res, out):
    out.copy_(res)
    return out


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """Every rank's ``tensor`` becomes the group rank ``src``'s, in
    place."""
    pg, axis = _resolve(group)
    _record("broadcast", axis, tensor)
    work = dist.broadcast(tensor, _global(pg, src), group=pg, async_op=True)
    return _done(work, lambda: tensor, sync_op)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Group rank ``dst``'s ``tensor`` becomes the reduction; the other
    ranks keep theirs (JAX's lockstep form)."""
    pg, axis = _resolve(group)
    _record("reduce", axis, tensor)
    buf = tensor.clone()
    top = dist.ReduceOp.SUM if op == ReduceOp.AVG else _TORCH_OPS[op]
    work = dist.reduce(buf, _global(pg, dst), top, group=pg, async_op=True)
    me = dist.get_rank(pg)

    def finish():
        if me == dst:
            if op == ReduceOp.AVG:
                buf.div_(dist.get_world_size(pg))
            tensor.copy_(buf)
        return tensor

    return _done(work, finish, sync_op)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """Group rank r receives piece r of ``src``'s ``tensor_list`` into
    ``tensor`` (allocated like the list's pieces when ``None``)."""
    pg, axis = _resolve(group)
    me = dist.get_rank(pg)
    if tensor is None:
        if tensor_list is None:
            raise ValueError("scatter: pass the output tensor")
        tensor = torch.empty_like(tensor_list[0])
    _record("scatter", axis, tensor)
    pieces = ([t.contiguous() for t in tensor_list] if me == src else None)
    work = dist.scatter(tensor, pieces, _global(pg, src), group=pg,
                        async_op=True)
    return _done(work, lambda: tensor, sync_op)


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op=True):
    """Every rank's ``tensor``, in group order; every rank gets the list
    (JAX's form of Paddle's dst-only contract)."""
    pg, axis = _resolve(group)
    _record("gather", axis, tensor)
    chunks = [torch.empty_like(tensor) for _ in range(dist.get_world_size(pg))]
    work = dist.all_gather(chunks, tensor.contiguous(), group=pg,
                           async_op=True)

    def finish():
        if gather_list is not None:
            gather_list.extend(chunks)
            return gather_list
        return chunks

    return _done(work, finish, sync_op)


def barrier(group=None):
    pg, _ = _resolve(group)
    dist.barrier(group=pg)


# ---------------------------------------------------------------------------
# object collectives (pickled Python objects)
# ---------------------------------------------------------------------------
def all_gather_object(object_list, obj, group=None):
    """Appends every rank's ``obj`` (any picklable) to ``object_list``."""
    pg, _ = _resolve(group)
    out = [None] * dist.get_world_size(pg)
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src: int = 0, group=None):
    """Replaces the list's contents with group rank ``src``'s."""
    pg, _ = _resolve(group)
    n = dist.get_world_size(pg)
    if not 0 <= src < n:
        raise ValueError(f"broadcast_object_list: src {src} out of range "
                         f"for {n} rank(s)")
    box = [list(object_list)]
    dist.broadcast_object_list(box, _global(pg, src), group=pg)
    object_list[:] = box[0]
    return object_list


# ---------------------------------------------------------------------------
# point to point (per-rank: the source sends, the destination receives)
# ---------------------------------------------------------------------------
def send(tensor, dst: int = 0, group=None, sync_op=True):
    pg, axis = _resolve(group)
    _record("send", axis, tensor)
    work = dist.isend(tensor.contiguous(), _global(pg, dst), group=pg)
    return _done(work, lambda: tensor, sync_op)


def recv(tensor, src: int = 0, group=None, sync_op=True):
    """Receive group rank ``src``'s tensor into ``tensor``."""
    pg, axis = _resolve(group)
    _record("recv", axis, tensor)
    work = dist.irecv(tensor, _global(pg, src), group=pg)
    return _done(work, lambda: tensor, sync_op)


def isend(tensor, dst: int = 0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src: int = 0, group=None):
    return recv(tensor, src, group, sync_op=False)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the device has finished the work queued on
    ``tensor``'s stream."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class P2POp:
    """Parity: paddle.distributed.P2POp — a deferred send/recv for
    ``batch_isend_irecv``."""

    def __init__(self, op, tensor, peer, group=None):
        name = getattr(op, "__name__", str(op))
        if name not in ("send", "isend", "recv", "irecv"):
            raise ValueError(f"P2POp: unknown op {op}")
        self.is_send = "send" in name
        self.tensor = tensor
        self.peer = peer
        self.group = group


class _Works:
    """Every work of one batched launch, waited together, once (a gloo
    send waited twice waits for a second send)."""

    def __init__(self, works):
        self.works = list(works)

    def wait(self):
        while self.works:
            self.works.pop(0).wait()

    def is_completed(self):
        return all(w.is_completed() for w in self.works)


def batch_isend_irecv(p2p_op_list):
    """Start every op in one batched launch (``torch.distributed.
    batch_isend_irecv``: NCCL groups them, so a rank may send to and
    receive from itself); returns one task per op, each waiting for the
    whole batch."""
    ops, resolved = [], []
    for o in p2p_op_list:
        pg, axis = _resolve(o.group)
        _record("send" if o.is_send else "recv", axis, o.tensor)
        fn = dist.isend if o.is_send else dist.irecv
        ops.append(dist.P2POp(fn, o.tensor.contiguous() if o.is_send
                              else o.tensor, _global(pg, o.peer), pg))
        resolved.append(o.tensor)
    works = _Works(dist.batch_isend_irecv(ops))
    return [_Task(works, (lambda t=t: t)) for t in resolved]
