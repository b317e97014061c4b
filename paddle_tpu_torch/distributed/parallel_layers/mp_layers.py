"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/parallel_layers/mp_layers.py``; parity:
fleet/meta_parallel/parallel_layers/mp_layers.py and mp_ops.py).

Each layer is built at the global shape with the JAX layer's parameter
names, shapes and specs: weights ``[in_features, out_features]``,
``ColumnParallelLinear`` ``(None, "tp")`` with its bias ``("tp",)``,
``RowParallelLinear`` ``("tp", None)`` with a replicated bias, and
``VocabParallelEmbedding`` ``("tp", None)``. At tp = 1 they are plain
layers and run no collective. ``sharding.place_params_on_mesh`` cuts the
weights to this rank's tp block and hands each layer its tp group; the
forward then runs the Megatron collectives as autograd functions (the
JAX layers leave them to GSPMD):

- ``ColumnParallelLinear``: ``copy_to_tp`` (identity forward, all-reduce
  backward) before the local matmul; ``gather_output`` concatenates over
  tp (split backward).
- ``RowParallelLinear``: the local matmul of this rank's slice of the
  input, ``reduce_from_tp`` of the partial sums (all-reduce forward,
  identity backward), then the bias, once.
- ``VocabParallelEmbedding``: ids outside this rank's vocab range give
  zero rows, then ``reduce_from_tp``.
- ``ParallelCrossEntropy``: the vocab-parallel softmax (all-reduce of the
  max, the sum of exponents and the target logit).

A layer that owns tensor-parallel layers declares ``tensor_parallel =
True`` when its forward is written for tp-local shapes (the Llama
layers); ``set_tensor_parallel`` refuses tp > 1 for any other owner.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...nn import functional as F
from ...nn.functional import embedding, linear

_NEXT = "tensor parallelism of this model is the next slice (ROADMAP.md "\
    "Queue A7)"


class TPGroup:
    """This rank's place on one mesh axis (``axis``, by default tp):
    ``size``, ``rank`` and the torch ``group``. The autograd collectives
    below take it for any axis."""

    def __init__(self, size: int, rank: int, group, axis: str = "tp"):
        self.size, self.rank, self.group = size, rank, group
        self.axis = axis

    def __repr__(self):
        return f"TPGroup(axis={self.axis!r}, size={self.size}, " \
            f"rank={self.rank})"


def axis_group(mesh, axis: str) -> Optional[TPGroup]:
    """This rank's ``TPGroup`` on ``axis`` of ``mesh``, or None where the
    axis is missing or of size 1."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if size == 1:
        return None
    return TPGroup(size, mesh.get_local_rank(axis), mesh.get_group(axis),
                   axis)


def p2p_exchange(grp, sends, recvs):
    """Point-to-point on ``grp`` (a ``TPGroup``, or one of size 1 with no
    torch group): ``sends`` [(dst rank, tensor, tag)] and ``recvs`` [(src
    rank, buffer, tag)], ranks on the group, in one ``batch_isend_irecv``
    in the order given (each pair's messages in the same order on both
    sides). A message to this rank itself is copied into the buffer of
    its tag."""
    from ..collective import _record

    mine = {tag: t for d, t, tag in sends if d == grp.rank}
    for s, buf, tag in recvs:
        if s == grp.rank:
            buf.copy_(mine[tag])
    ops = []
    for d, t, tag in sends:
        if d != grp.rank:
            _record("send_recv", grp.axis, t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  dist.get_global_rank(grp.group, d),
                                  grp.group, tag))
    for s, buf, tag in recvs:
        if s != grp.rank:
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(grp.group, s),
                                  grp.group, tag))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


def _tp_of(mesh) -> Optional[TPGroup]:
    return axis_group(mesh, "tp")


def _all_reduce(x, tp: TPGroup, op=dist.ReduceOp.SUM):
    from ..collective import _record

    _record("all_reduce", tp.axis, x)
    x = x.contiguous()
    dist.all_reduce(x, op, group=tp.group)
    return x


def _gather_last(x, tp: TPGroup, dim: int):
    from ..collective import _record

    _record("all_gather", tp.axis, x)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((tp.size * xs.shape[0],) + tuple(xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=tp.group)
    return out.movedim(0, dim)


def _own_slice(x, tp: TPGroup, dim: int):
    return x.chunk(tp.size, dim=dim)[tp.rank].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _gather_last(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.tp, ctx.dim), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own_slice(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.tp, ctx.dim), None, None


def copy_to_tp(x, tp: Optional[TPGroup]):
    """Identity forward, all-reduce over tp backward (the input of a
    column-parallel matmul)."""
    return x if tp is None else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: Optional[TPGroup]):
    """All-reduce over tp forward, identity backward (partial sums)."""
    return x if tp is None else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp: Optional[TPGroup], dim: int = -1):
    """Concatenate every tp rank's ``x`` along ``dim``; the backward
    takes this rank's slice."""
    if tp is None:
        return x
    return _GatherFromTP.apply(x, tp, dim % x.dim())


def scatter_to_tp(x, tp: Optional[TPGroup], dim: int = -1):
    """This rank's slice of ``x`` along ``dim``; the backward gathers."""
    if tp is None:
        return x
    return _ScatterToTP.apply(x, tp, dim % x.dim())


def set_tensor_parallel(model, mesh):
    """Hand every tensor-parallel layer of ``model`` its tp group (None at
    tp = 1). At tp > 1 a layer that owns tensor-parallel layers must
    declare ``tensor_parallel = True``, else ``NotImplementedError``."""
    tp = _tp_of(mesh)
    mp = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
          ParallelCrossEntropy)
    for _, layer in model.named_modules():
        if tp is not None and not getattr(layer, "tensor_parallel", False) \
                and not isinstance(layer, mp) \
                and any(isinstance(c, mp) for c in layer.children()):
            raise NotImplementedError(
                f"{type(layer).__name__} builds tensor-parallel layers but "
                f"does not run tp = {tp.size}: {_NEXT}")
        if isinstance(layer, mp) or getattr(layer, "tensor_parallel", False):
            check = getattr(layer, "check_tensor_parallel", None)
            if tp is not None and check is not None:
                check(tp.size)
            layer.tp = tp


class ColumnParallelLinear(Layer):
    """Weight [in, out] drawn from Normal(0, ``std``) with ``generator``, as
    the JAX layers draw from ``I.Normal``; the out dim is sharded over tp
    (the bias too). ``gather_output`` gives the full output on every tp
    rank; otherwise each rank keeps its columns (feeding a
    ``RowParallelLinear``). ``device`` defaults to the current device (the
    card unless ``set_device("cpu")`` chose the host; without a card that
    raises); ``generator`` must live on that device."""

    tp: Optional[TPGroup] = None

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, has_bias: bool = True,
                 dtype=torch.float32, device=None, *,
                 generator: torch.Generator, gather_output: bool = False,
                 fuse_matmul_bias: bool = False, name=None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            (in_features, out_features), default_initializer=I.Normal(
                0.0, std), spec=self._weight_spec, device=device,
            generator=generator)
        self.weight.is_distributed = True
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter(
                (out_features,), is_bias=True, spec=self._bias_spec,
                device=device)
            self.bias.is_distributed = self._bias_spec is not None

    _weight_spec = (None, "tp")
    _bias_spec = ("tp",)

    def check_tensor_parallel(self, tp: int):
        shape = getattr(self.weight, "global_shape", self.weight.shape)
        n = shape[self._weight_spec.index("tp")]
        if n % tp:
            raise ValueError(f"tp = {tp} must divide the sharded dim "
                             f"({n}) of {type(self).__name__}")

    def forward(self, x):
        y = linear(copy_to_tp(x, self.tp), self.weight, self.bias)
        return gather_from_tp(y, self.tp) if self.gather_output else y


class RowParallelLinear(ColumnParallelLinear):
    """Weight [in, out] with the in (contracted) dim sharded over tp: the
    partial sums are all-reduced and the (replicated) bias added after
    the reduce. ``input_is_parallel`` (the default) takes this rank's
    slice of the input; otherwise the full input is sliced here."""

    _weight_spec = ("tp", None)
    _bias_spec = None

    def __init__(self, in_features: int, out_features: int,
                 std: float = 0.02, has_bias: bool = True,
                 dtype=torch.float32, device=None, *,
                 generator: torch.Generator, input_is_parallel: bool = True,
                 fuse_matmul_bias: bool = False, name=None):
        super().__init__(in_features, out_features, std, has_bias, dtype,
                         device, generator=generator)
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_tp(x, self.tp)
        if self.tp is None:
            return linear(x, self.weight, self.bias)
        y = reduce_from_tp(linear(x, self.weight), self.tp)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Layer):
    """Embedding table [vocab, hidden] drawn as the linears' weights, the
    vocab dim sharded over tp. ``device`` as for the linears."""

    tp: Optional[TPGroup] = None

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, dtype=torch.float32, device=None, *,
                 generator: torch.Generator, name=None):
        super().__init__(dtype=dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), default_initializer=I.Normal(
                0.0, std), spec=("tp", None), device=current_device(device),
            generator=generator)
        self.weight.is_distributed = True

    def check_tensor_parallel(self, tp: int):
        if self.num_embeddings % tp:
            raise ValueError(f"tp = {tp} must divide num_embeddings "
                             f"({self.num_embeddings})")

    def forward(self, x):
        if self.tp is None:
            return embedding(x, self.weight)
        rows = self.weight.shape[0]
        start = self.tp.rank * rows
        outside = (x < start) | (x >= start + rows)
        local = torch.where(outside, 0, x - start)
        y = embedding(local, self.weight)
        y = y.masked_fill(outside[..., None], 0)
        return reduce_from_tp(y, self.tp)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits whose last (vocab) dim is sharded over
    tp, per token (``reduction="none"``, ids of ``ignore_index`` give 0):
    the max, the sum of exponents and the target logit are all-reduced
    over tp, so no rank holds the full vocab. At tp = 1 it is
    ``F.cross_entropy``."""

    tp: Optional[TPGroup] = None

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        if self.tp is None:
            return F.cross_entropy(logits, label,
                                   ignore_index=self.ignore_index,
                                   reduction="none")
        z = logits.float()
        with torch.no_grad():
            m = _all_reduce(z.amax(dim=-1), self.tp, dist.ReduceOp.MAX)
        shifted = z - m[..., None]
        sum_exp = reduce_from_tp(shifted.exp().sum(-1), self.tp)
        v = z.shape[-1]
        start = self.tp.rank * v
        label = label.long()
        mine = (label >= start) & (label < start + v)
        local = torch.where(mine, label - start, 0)
        target = torch.gather(shifted, -1, local[..., None])[..., 0]
        target = reduce_from_tp(torch.where(mine, target, 0.0), self.tp)
        loss = torch.log(sum_exp) - target
        return torch.where(label == self.ignore_index, 0.0, loss)
