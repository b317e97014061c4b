"""paddle.incubate surfaces of the PyTorch port (counterpart of
``paddle_tpu/incubate``): the fused nn functional ops (``incubate.nn.
functional``), the ``LookAhead``, ``ModelAverage`` and ``EMA`` optimizer
wrappers, the segment reductions and ``graph_send_recv``, the fused
softmax masks and ``identity_loss``.

The segment reductions are ``index_add_``/``scatter_reduce_`` with JAX's
values for an empty segment (``jax.ops.segment_*``): 0 for the sum and
the mean, the lowest value of the dtype for the max (-inf for floats)
and the highest for the min; ids outside ``[0, num_segments)`` are
dropped, as JAX drops them."""

from . import nn
from .optimizer import EMA, LookAhead, ModelAverage

__all__ = ["nn", "LookAhead", "ModelAverage", "EMA",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss"]


def _n_segments(segment_ids, num_segments):
    """Segment count: explicit, else the largest id plus one (Paddle
    sizes the output so)."""
    if num_segments is not None:
        return int(num_segments)
    return int(segment_ids.max()) + 1


def _segment(data, segment_ids, n, kind):
    import torch

    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        data, ids = data[keep], ids[keep]
    shape = (n,) + tuple(data.shape[1:])
    if kind == "sum":
        return torch.zeros(shape, dtype=data.dtype,
                           device=data.device).index_add_(0, ids, data)
    if data.is_floating_point():
        init = float("-inf") if kind == "max" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        init = info.min if kind == "max" else info.max
    out = torch.full(shape, init, dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data,
                               "amax" if kind == "max" else "amin")


def _segment_reduce(data, segment_ids, kind, num_segments=None):
    import torch

    n = _n_segments(segment_ids, num_segments)
    if kind == "mean":
        s = _segment(data, segment_ids, n, "sum")
        c = _segment(torch.ones_like(data), segment_ids, n, "sum")
        return s / torch.clamp(c, min=1)
    return _segment(data, segment_ids, n, kind)


def segment_sum(data, segment_ids, name=None, num_segments=None):
    """Parity: paddle.incubate.segment_sum (with JAX's ``num_segments``
    extension)."""
    return _segment_reduce(data, segment_ids, "sum", num_segments)


def segment_mean(data, segment_ids, name=None, num_segments=None):
    return _segment_reduce(data, segment_ids, "mean", num_segments)


def segment_max(data, segment_ids, name=None, num_segments=None):
    return _segment_reduce(data, segment_ids, "max", num_segments)


def segment_min(data, segment_ids, name=None, num_segments=None):
    return _segment_reduce(data, segment_ids, "min", num_segments)


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """Parity: paddle.incubate.graph_send_recv (graph message passing):
    gather x at src_index, segment-reduce onto dst_index."""
    pool = pool_type.lower()
    if pool not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    msgs = x[src_index.long()]
    return _segment_reduce(msgs, dst_index, pool, out_size)


def softmax_mask_fuse(x, mask, name=None):
    """Parity: incubate.softmax_mask_fuse: softmax(x + mask) over the
    last axis."""
    import torch

    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Parity: incubate.softmax_mask_fuse_upper_triangle: causal-masked
    softmax over [b, h, sq, sk] (JAX's -1e30 above the diagonal)."""
    import torch

    sq, sk = x.shape[-2], x.shape[-1]
    causal = torch.ones((sq, sk), dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(causal, x, -1e30), dim=-1)


def identity_loss(x, reduction="none"):
    """Parity: paddle.incubate.identity_loss: marks a tensor as a loss;
    functionally a reduction. Paddle's int codes: 0=sum, 1=mean, 2=none."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 0):
        return x.sum()
    if reduction in ("mean", 1):
        return x.mean()
    raise ValueError(f"unknown reduction {reduction!r}")
