"""Tensor creation and math (counterpart of ``paddle_tpu/tensor.py``;
parity: ``python/paddle/tensor/``).

The tensor type is ``torch.Tensor``, and the port does not patch it
(the JAX package installs Paddle's methods on ``jax.Array``): these are
plain functions on tensors with the JAX module's names, signatures and
defaults. Where the JAX function is a ``jnp`` alias it takes ``jnp``'s
keywords and defaults (``axis``, ``keepdims``; ``std``/``var`` with
``ddof=0``; ``split`` with a count of equal sections or a list of cut
*indices*; stable ``sort``/``argsort``; ``gather`` as ``jnp.take``;
``median`` as the midpoint of the two middle values), not torch's.

Differences from the JAX module, each deliberate:

- **64-bit widths.** The JAX package runs with x64 off, so its
  ``to_tensor`` of int64 or float64 data gives 32-bit arrays, and its
  integer results are int32. The port keeps the 64-bit dtype it is
  given, as torch and Paddle do, and its integer results are torch's
  (int64 indices and sums). Tests compare values after a cast.
- **Devices.** ``to_tensor`` honours ``place`` (a ``CPUPlace``/
  ``CUDAPlace``, a device string or a ``torch.device``) and
  ``stop_gradient=False`` sets ``requires_grad``; JAX ignores both. With
  no ``place`` the tensor lands on the card. The creation and random
  functions take ``device=`` and default to the card; the ``*_like``
  functions default to their input's device. Without a card each of
  these raises unless the caller asks for the CPU.
- **Random numbers** come from the port's generator for the device
  (``core/random.py``, reseeded by ``seed``): torch's numbers, not
  JAX's. Their shapes, dtypes and ranges are JAX's.
- The in-place spellings ``squeeze_``, ``unsqueeze_`` and ``clip_``
  change their input in place (JAX's arrays are immutable, so its
  versions only return the result); ``reshape_`` returns the reshaped
  tensor, as in JAX.
"""

from __future__ import annotations

import builtins as _b
import math as _math

import numpy as np
import torch

from .core import dtype as dtype_mod
from .core import random as _random
from .core.device import current_device as _current_device


def _dt(dtype):
    """``dtype and convert_dtype(dtype)``: None keeps the input's."""
    return dtype_mod.convert_dtype(dtype) if dtype is not None else None


def _t(x, like=None):
    """``x`` as a tensor: a tensor as it is; an array, list or number on
    ``like``'s device, or on the current device (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) \
        else _current_device()
    return _host_tensor(x).to(dev)


def _host_tensor(data):
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    if arr.dtype.kind not in "biufc":  # ml_dtypes' bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if isinstance(data, (int, float, complex, _b.bool, list, tuple)) \
            and arr.dtype == np.float64:
        # Python floats are float32, as in Paddle and jnp
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def _place_device(place):
    if place is None:
        return _current_device()
    if isinstance(place, torch.device):
        return _current_device(place)
    if isinstance(place, str):
        kind, _, idx = place.partition(":")
        if kind == "gpu":
            place = "cuda" + (":" + idx if idx else "")
        return _current_device(place)
    dev = getattr(place, "device", None)
    if not isinstance(dev, torch.device):
        raise TypeError(f"unsupported place {place!r}")
    return _current_device(dev)


def _float(x):
    """jnp's promotion of an integer or bool input of a floating result:
    float32 (the default dtype)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.get_default_dtype())


def _reduce(fn, x, axis, keepdims, **kw):
    x = _t(x)
    if axis is None:
        out = fn(x, **kw)
        return out.reshape((1,) * x.dim()) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims, **kw)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A tensor of ``data`` on ``place`` (the current device, the card by
    default), of ``dtype`` or the data's own (64-bit kept; Python floats
    are float32). ``stop_gradient=False`` makes it require gradients."""
    dev = _place_device(place)
    t = _host_tensor(data)
    dt = _dt(dtype)
    t = t.to(device=dev, dtype=dt, copy=True) if isinstance(
        data, torch.Tensor) else t.to(device=dev, dtype=dt)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, device=None):
    return torch.zeros(tuple(shape), dtype=dtype_mod.convert_dtype(dtype),
                       device=_current_device(device))


def ones(shape, dtype=None, device=None):
    return torch.ones(tuple(shape), dtype=dtype_mod.convert_dtype(dtype),
                      device=_current_device(device))


def full(shape, fill_value, dtype=None, device=None):
    return torch.full(tuple(shape), fill_value,
                      dtype=dtype_mod.convert_dtype(dtype),
                      device=_current_device(device))


def zeros_like(x, dtype=None, device=None):
    return torch.zeros_like(_t(x), dtype=_dt(dtype), device=device)


def ones_like(x, dtype=None, device=None):
    return torch.ones_like(_t(x), dtype=_dt(dtype), device=device)


def full_like(x, fill_value, dtype=None, device=None):
    return torch.full_like(_t(x), fill_value, dtype=_dt(dtype),
                           device=device)


def arange(start, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=_current_device(device))


def linspace(start, stop, num, dtype=None, device=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=_current_device(device))


def eye(n, m=None, dtype=None, device=None):
    return torch.eye(n, n if m is None else m,
                     dtype=dtype_mod.convert_dtype(dtype),
                     device=_current_device(device))


def empty(shape, dtype=None, device=None):
    """Zeros, as in JAX (its arrays have no uninitialised state)."""
    return zeros(shape, dtype, device)


# ---------------------------------------------------------------------------
# the jnp aliases: jnp's keywords and defaults
# ---------------------------------------------------------------------------
def _binary(fn):
    """``fn`` of two operands; a number or an array beside a tensor
    becomes a 0-d (or full) tensor on its device (a Python float as
    float32, so it promotes as jnp's weak types do)."""
    def wrapped(x1, x2):
        if isinstance(x1, torch.Tensor):
            x2 = _t(x2, x1)
        else:
            x2 = _t(x2)
            x1 = _t(x1, x2)
        return fn(x1, x2)

    wrapped.__name__ = fn.__name__
    return wrapped


def _unary(fn, promote=False):
    def wrapped(x):
        x = _t(x)
        return fn(_float(x) if promote else x)

    wrapped.__name__ = getattr(fn, "__name__", "op")
    return wrapped


matmul = _binary(torch.matmul)
add = _binary(torch.add)
subtract = _binary(torch.subtract)
multiply = _binary(torch.multiply)
divide = _binary(torch.true_divide)
pow = _binary(torch.pow)  # noqa: A001
sqrt = _unary(torch.sqrt, promote=True)
rsqrt = _unary(torch.rsqrt, promote=True)
exp = _unary(torch.exp, promote=True)
log = _unary(torch.log, promote=True)
abs = _unary(torch.abs)  # noqa: A001


def mean(a, axis=None, dtype=None, keepdims=False):
    a = _t(a)
    if dtype is not None:
        a = a.to(dtype_mod.convert_dtype(dtype))
    return _reduce(torch.mean, _float(a), axis, keepdims)


def sum(a, axis=None, dtype=None, keepdims=False):  # noqa: A001
    a = _t(a)
    if dtype is not None:
        a = a.to(dtype_mod.convert_dtype(dtype))
    return _reduce(torch.sum, a, axis, keepdims)


def max(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce(torch.amax, a, axis, keepdims)


def min(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce(torch.amin, a, axis, keepdims)


def argmax(a, axis=None, keepdims=False):
    return torch.argmax(_t(a), dim=axis, keepdim=_b.bool(keepdims))


def argmin(a, axis=None, keepdims=False):
    return torch.argmin(_t(a), dim=axis, keepdim=_b.bool(keepdims))


maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)


def clip(arr, min=None, max=None, *, a_min=None, a_max=None):  # noqa: A002
    """``jnp.clip``: ``minimum(maximum(x, min), max)``."""
    lo = a_min if min is None else min
    hi = a_max if max is None else max
    x = _t(arr)
    if lo is not None:
        x = torch.maximum(x, _t(lo, x))
    if hi is not None:
        x = torch.minimum(x, _t(hi, x))
    return x


def reshape(a, shape):
    return torch.reshape(_t(a), (shape,) if isinstance(shape, int)
                         else tuple(shape))


def transpose(a, axes=None):
    a = _t(a)
    if axes is None:
        axes = tuple(range(a.dim()))[::-1]
    return a.permute(tuple(axes))


def squeeze(a, axis=None):
    a = _t(a)
    if axis is None:
        return a.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in axes:
        if a.shape[ax] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one, got "
                             f"shape={tuple(a.shape)} and dimensions={axes}")
    return a.squeeze(axes)


def unsqueeze(a, axis):
    """``jnp.expand_dims``: ``axis`` an int or a tuple, each placed in the
    result's dimensions."""
    a = _t(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    nd = a.dim() + len(axes)
    for ax in sorted(ax % nd for ax in axes):
        a = a.unsqueeze(ax)
    return a


def concat(arrays, axis=0):
    arrays = [_t(x) for x in arrays]
    if axis is None:
        return torch.cat([x.reshape(-1) for x in arrays])
    return torch.cat(arrays, dim=axis)


def stack(arrays, axis=0):
    return torch.stack([_t(x) for x in arrays], dim=axis)


def split(ary, indices_or_sections, axis=0):
    """``jnp.split``: an int is a count of equal sections (the axis must
    divide), a list the indices to cut at."""
    ary = _t(ary)
    if isinstance(indices_or_sections, int):
        if ary.shape[axis] % indices_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(ary, indices_or_sections, dim=axis))
    return list(torch.tensor_split(ary, [int(i) for i in
                                         indices_or_sections], dim=axis))


def where(condition, x=None, y=None):
    condition = _t(condition)
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition.bool(), _t(x, condition),
                       _t(y, condition))


def cast(x, dtype):
    return _t(x).to(dtype_mod.convert_dtype(dtype))


tanh = _unary(torch.tanh, promote=True)
sin = _unary(torch.sin, promote=True)
cos = _unary(torch.cos, promote=True)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)


def round(a, decimals=0):  # noqa: A001
    """Half to even, as ``jnp.round``."""
    a = _t(a)
    if not a.is_floating_point():
        return a
    return torch.round(a, decimals=decimals)


sign = _unary(torch.sign)


def _cum(fn, a, axis, dtype):
    a = _t(a)
    if a.dtype == torch.bool:
        a = a.long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    return fn(a, dim=axis, dtype=_dt(dtype))


def cumsum(a, axis=None, dtype=None):
    return _cum(torch.cumsum, a, axis, dtype)


def cumprod(a, axis=None, dtype=None):
    return _cum(torch.cumprod, a, axis, dtype)


def sort(a, axis=-1, stable=True, descending=False):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True, descending=descending).values


def argsort(a, axis=-1, stable=True, descending=False):
    """Stable, as ``jnp.argsort``: ties keep their order (descending
    too)."""
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True, descending=descending)


def _fill_value(dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.uint8:
        return torch.iinfo(dtype).max
    return torch.iinfo(dtype).min


def _take(a, indices, axis=None):
    """``jnp.take`` in its default "fill" mode: negative indices count from
    the end, indices out of bounds give NaN (the lowest integer for signed
    integers, the highest for unsigned, True for bool)."""
    a = _t(a)
    idx = _t(indices, a).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    ok = (idx >= -n) & (idx < n)
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, _b.max(n - 1, 0))
    out = a.index_select(axis, safe.reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if not _b.bool(ok.all()):
        mask = ok.reshape((1,) * axis + idx.shape
                          + (1,) * (a.dim() - axis - 1))
        out = torch.where(mask, out, torch.full(
            (), _fill_value(a.dtype), dtype=a.dtype, device=a.device))
    return out


def gather(x, index, axis=0):
    return _take(x, index, axis)


def einsum(subscripts, *operands):
    return torch.einsum(subscripts, *[_t(o) for o in operands])


def tril(m, k=0):
    return torch.tril(_t(m), diagonal=k)


def triu(m, k=0):
    return torch.triu(_t(m), diagonal=k)


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    """Paddle semantics: (values, indices) along ``axis``; ties go to the
    lower index first, as ``lax.top_k``."""
    x = _t(x)
    moved = x.movedim(axis, -1)
    idx = torch.argsort(moved, dim=-1, stable=True,
                        descending=largest)[..., :k]
    vals = torch.gather(moved, -1, idx)
    return vals.movedim(-1, axis), idx.movedim(-1, axis)


def flatten(x, start_axis=0, stop_axis=-1):
    """Paddle semantics: collapse axes [start_axis, stop_axis] into one."""
    x = _t(x)
    nd = x.dim()
    if nd == 0:
        return x.reshape((1,))
    s = start_axis + nd if start_axis < 0 else start_axis
    e = stop_axis + nd if stop_axis < 0 else stop_axis
    if not (0 <= s <= e < nd):
        raise ValueError(
            f"flatten: invalid range start_axis={start_axis} "
            f"stop_axis={stop_axis} for ndim={nd}")
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))


def _index_tuple(index):
    return tuple(index[..., i] for i in range(index.shape[-1]))


def gather_nd(x, index):
    """index[..., :k] indexes the first k dims of x (paddle.gather_nd)."""
    x = _t(x)
    return x[_index_tuple(_t(index, x).long())]


def scatter(x, index, updates, overwrite=True):
    """paddle.scatter: write ``updates`` rows into x at 1-D ``index``;
    ``overwrite=False`` zeroes the target rows, then accumulates."""
    x = _t(x)
    index, updates = _t(index, x).long(), _t(updates, x).to(x.dtype)
    out = x.clone()
    if overwrite:
        out[index] = updates
        return out
    out[index] = 0
    return out.index_put((index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates):
    x = _t(x)
    idx = tuple(_t(index, x).long().movedim(-1, 0))
    return x.index_put(idx, _t(updates, x).to(x.dtype), accumulate=True)


def put_along_axis(x, indices, values, axis):
    x = _t(x)
    ax = axis % x.dim()
    idx = tuple(
        _t(indices, x).long() if i == ax else
        torch.arange(x.shape[i], device=x.device).reshape(
            [-1 if j == i else 1 for j in range(x.dim())])
        for i in range(x.dim()))
    idx = torch.broadcast_tensors(*idx)
    vals = torch.broadcast_to(_t(values, x).to(x.dtype), idx[0].shape)
    return x.index_put(idx, vals)


isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)
equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
greater_than = _binary(torch.gt)
less_than = _binary(torch.lt)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_not = _unary(torch.logical_not)


def all(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce(torch.all, a, axis, keepdims)


def any(a, axis=None, keepdims=False):  # noqa: A001
    return _reduce(torch.any, a, axis, keepdims)


square = _unary(torch.square)


def log_softmax(x, axis=-1):
    return torch.log_softmax(_float(_t(x)), dim=axis)


def softmax(x, axis=-1):
    return torch.softmax(_float(_t(x)), dim=axis)


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    """Population variance by default (``ddof=0``), as ``jnp.var``."""
    a = _t(a)
    if dtype is not None:
        a = a.to(dtype_mod.convert_dtype(dtype))
    return _reduce(torch.var, _float(a), axis, keepdims, correction=ddof)


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = _t(a)
    if dtype is not None:
        a = a.to(dtype_mod.convert_dtype(dtype))
    return _reduce(torch.std, _float(a), axis, keepdims, correction=ddof)


def norm(x, p="fro", axis=None, keepdim=False):
    """Paddle semantics: axis=None flattens (any rank) and computes a
    vector norm; 'fro' is p=2 elementwise. int axis: vector p-norm;
    2-tuple axis: matrix norm."""
    x = _float(_t(x))
    if axis is None:
        flat = x.reshape(-1)
        pp = 2.0 if p in ("fro", None) else p
        if pp == float("inf"):
            return flat.abs().max()
        if pp == float("-inf"):
            return flat.abs().min()
        out = (flat.abs() ** pp).sum() ** (1.0 / pp)
        return out.reshape((1,) * x.dim()) if keepdim else out
    if isinstance(axis, (tuple, list)):
        ord_ = "fro" if p in ("fro", None) else p
        return torch.linalg.matrix_norm(x, ord=ord_, dim=tuple(axis),
                                        keepdim=keepdim)
    pp = 2.0 if p in ("fro", None) else p
    if pp == float("inf"):
        return x.abs().amax(dim=axis, keepdim=keepdim)
    if pp == float("-inf"):
        return x.abs().amin(dim=axis, keepdim=keepdim)
    return (x.abs() ** pp).sum(dim=axis, keepdim=keepdim) ** (1.0 / pp)


def dot(x, y, name=None):
    """Parity: paddle.dot: 1-D inner product; 2-D is the per-row inner
    product returning [batch] (not a matmul)."""
    x = _t(x)
    y = _t(y, x)
    if x.dim() == 1:
        return (x * y).sum()
    if x.dim() == 2:
        return (x * y).sum(dim=-1)
    raise ValueError(f"dot expects 1-D/2-D inputs, got {x.dim()}-D")


def outer(a, b):
    a = _t(a)
    return torch.outer(a.reshape(-1), _t(b, a).reshape(-1))


def roll(a, shift, axis=None):
    a = _t(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, dims=axis)


def flip(m, axis=None):
    m = _t(m)
    if axis is None:
        axis = tuple(range(m.dim()))
    elif isinstance(axis, int):
        axis = (axis,)
    return torch.flip(m, dims=tuple(axis))


def tile(A, reps):  # noqa: N803
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(_t(A), reps)


def repeat_interleave(a, repeats, axis=None):
    """``jnp.repeat``: ``axis=None`` repeats the flattened array."""
    a = _t(a)
    if isinstance(repeats, (list, tuple, np.ndarray)):
        repeats = _t(repeats, a).long()
    return torch.repeat_interleave(a, repeats, dim=axis)


def broadcast_to(array, shape):
    return torch.broadcast_to(_t(array), tuple(shape))


expand = broadcast_to


def take_along_axis(arr, indices, axis=-1):
    arr = _t(arr)
    idx = _t(indices, arr).long()
    if axis is None:
        arr, idx, axis = arr.reshape(-1), idx.reshape(-1), 0
    n = arr.shape[axis]
    return torch.take_along_dim(arr, torch.where(idx < 0, idx + n, idx),
                                dim=axis)


def index_select(x, index, axis=0):
    return _take(x, index, axis)


def masked_select(x, mask):
    x = _t(x)
    return x[_t(mask, x).bool()]


def numel(a, axis=None):
    a = _t(a)
    return a.numel() if axis is None else a.shape[axis]


def diag(v, k=0):
    return torch.diag(_t(v), diagonal=k)


def bincount(x, weights=None, minlength=0, *, length=None):
    x = _t(x)
    w = None if weights is None else _t(weights, x)
    out = torch.bincount(x.clamp(min=0), weights=w, minlength=minlength
                         if length is None else length)
    return out if length is None else out[:length]


kron = _binary(torch.kron)


def trace(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2).sum(dim=-1)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2)


def meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    """``jnp.meshgrid``: Cartesian ("xy") indexing by default."""
    xs = [_t(x).reshape(-1) for x in xi]
    if not sparse:
        return list(torch.meshgrid(*xs, indexing=indexing))
    out = []
    for i, x in enumerate(xs):
        pos = 1 - i if indexing == "xy" and len(xs) >= 2 and i < 2 else i
        shape = [1] * len(xs)
        shape[pos] = -1
        out.append(x.reshape(shape))
    return out


def logsumexp(a, axis=None, b=None, keepdims=False):
    a = _float(_t(a))
    dims = tuple(range(a.dim())) if axis is None else axis
    if b is None:
        out = torch.logsumexp(a, dim=dims, keepdim=True)
    else:
        m = a.amax(dim=dims, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        out = torch.log((_t(b, a) * torch.exp(a - m)).sum(
            dim=dims, keepdim=True)) + m
    return out if keepdims else out.squeeze(dims)


def nanmean(a, axis=None, keepdims=False):
    return _reduce(torch.nanmean, _float(_t(a)), axis, keepdims)


def nansum(a, axis=None, keepdims=False):
    return _reduce(torch.nansum, a, axis, keepdims)


amax = max
amin = min


def diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _t(a)
    pre = None if prepend is None else _t(prepend, a)
    app = None if append is None else _t(append, a)
    return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


def searchsorted(sorted_sequence, values, right=False):
    seq = _t(sorted_sequence)
    values = _t(values, seq)
    dt = torch.result_type(seq, values)
    return torch.searchsorted(seq.to(dt), values.to(dt), right=right)


def bucketize(x, sorted_sequence, right=False):
    x = _t(x)
    return searchsorted(_t(sorted_sequence, x), x, right=right)


def _hist_edges(x, bins, lo, hi):
    """``jnp.histogram_bin_edges``: a zero-width range widens by 0.5."""
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, bins + 1, dtype=x.dtype, device=x.device)


def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    """The counts of ``jnp.histogram`` over [min, max] (the data's range
    when both are 0): the last bin closed, values outside dropped."""
    x = _float(_t(x)).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    edges = _hist_edges(x, bins, lo, hi)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], len(edges) - 1, idx)
    counts = torch.zeros(len(edges) + 1, dtype=x.dtype, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(x))
    return counts[1:len(edges)]


def lerp(x, y, weight):
    return x + weight * (y - x)


def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * (x @ y)


logaddexp = _binary(torch.logaddexp)
heaviside = _binary(lambda a, b: torch.heaviside(a, b.to(a.dtype)))
rad2deg = _unary(torch.rad2deg, promote=True)
deg2rad = _unary(torch.deg2rad, promote=True)


def frac(x):
    x = _t(x)
    return x - torch.trunc(x)


trunc = _unary(torch.trunc)
expm1 = _unary(torch.expm1, promote=True)
log1p = _unary(torch.log1p, promote=True)
log2 = _unary(torch.log2, promote=True)
log10 = _unary(torch.log10, promote=True)
atan2 = _binary(lambda a, b: torch.atan2(_float(a), _float(b)))
hypot = _binary(torch.hypot)
copysign = _binary(torch.copysign)
nextafter = _binary(torch.nextafter)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a = _t(a)
    return torch.isclose(a, _t(b, a), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    """A 0-d bool tensor, as ``jnp.allclose`` returns an array."""
    return isclose(a, b, rtol, atol, equal_nan).all()


def inner(a, b):
    a = _t(a)
    return torch.inner(a, _t(b, a))


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a = _t(a)
    b = _t(b, a)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.broadcast_tensors(a.movedim(axisa, -1), b.movedim(axisb, -1))
    return torch.linalg.cross(a, b, dim=-1).movedim(-1, axisc)


def clone(a):
    return _t(a).clone()


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m), k, dims=tuple(axes))


def vander(x, n=None, increasing=False):
    return torch.vander(_t(x), N=n, increasing=increasing)


def nonzero(x, as_tuple=False):
    """Paddle semantics: one [N, ndim] tensor of coordinates (a tuple of
    index tensors with ``as_tuple=True``)."""
    return torch.nonzero(_t(x), as_tuple=as_tuple)


def _quantile(fn, x, q, axis, keepdim, method):
    x = _float(_t(x))
    qt = _t(q, x).to(x.dtype)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0, interpolation=method)
        return out.reshape(tuple(qt.shape) + (1,) * x.dim()) \
            if keepdim else out
    if isinstance(axis, (tuple, list)):
        axes = sorted(a % x.dim() for a in axis)
        rest = [d for d in range(x.dim()) if d not in axes]
        moved = x.permute(rest + axes).reshape(
            [x.shape[d] for d in rest] + [-1])
        out = fn(moved, qt, dim=-1, interpolation=method)
        if keepdim:
            for a in axes:
                out = out.unsqueeze(a + qt.dim())
        return out
    return fn(x, qt, dim=axis, keepdim=keepdim, interpolation=method)


def median(x, axis=None, keepdim=False):
    """``jnp.median``: the midpoint of the two middle values of an even
    count (``torch.median`` returns the lower one)."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim, "midpoint")


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim, "linear")


def mode(x, axis=-1, keepdim=False):
    """Paddle semantics: (values, indices) of the most frequent element
    along ``axis``; ties go to the smallest value, and the index is the
    first occurrence of that value in the input's order (the JAX
    module's rule)."""
    x = _t(x)
    if axis % x.dim() != x.dim() - 1:
        values, idx = mode(x.movedim(axis, -1), axis=-1)
        if keepdim:
            values, idx = values.unsqueeze(axis), idx.unsqueeze(axis)
        return values, idx
    sorted_x = torch.sort(x, dim=-1).values
    counts = (sorted_x[..., :, None] == sorted_x[..., None, :]).sum(dim=-1)
    best = torch.argmax(counts, dim=-1)
    values = torch.gather(sorted_x, -1, best[..., None])[..., 0]
    idx = torch.argmax((x == values[..., None]).to(torch.int8), dim=-1)
    if keepdim:
        values, idx = values[..., None], idx[..., None]
    return values, idx


def _host(x):
    x = _t(x)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy(), x.device


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """``np.unique`` on the host, as the JAX module: the index is each
    value's first occurrence."""
    arr, dev = _host(x)
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(torch.from_numpy(np.asarray(r)).to(dev) for r in res)
    return torch.from_numpy(np.asarray(res)).to(dev)


def unbind(x, axis=0):
    return list(torch.unbind(_t(x), dim=axis))


def chunk(x, chunks, axis=0):
    """``jnp.array_split``: the first ``n % chunks`` pieces are one
    longer (``torch.chunk`` sizes differ)."""
    return list(torch.tensor_split(_t(x), chunks, dim=axis))


def masked_fill(x, mask, value):
    x = _t(x)
    mask = _t(mask, x).bool()
    if isinstance(value, torch.Tensor):
        return torch.where(mask, value.to(x.dtype), x)
    return x.masked_fill(mask, value)


def logcumsumexp(x, axis=None):
    """The JAX module's formula: ``m + log(cumsum(exp(x - m)))`` with
    ``m`` the maximum along the axis."""
    x = _float(_t(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    m = x.amax(dim=axis, keepdim=True)
    return m + torch.log(torch.cumsum(torch.exp(x - m), dim=axis))


def tensordot(x, y, axes=2):
    x = _t(x)
    return torch.tensordot(x, _t(y, x), dims=axes)


def renorm(x, p, axis, max_norm):
    """Parity: paddle.renorm: rescale each sub-tensor along ``axis`` so
    its p-norm is at most max_norm."""
    x = _t(x)
    axis = axis % x.dim()
    other = tuple(i for i in range(x.dim()) if i != axis)
    norms = (x.abs() ** p).sum(dim=other, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    return x * scale


def scatter_nd(index, updates, shape):
    """Parity: paddle.scatter_nd: zeros of ``shape`` with ``updates``
    scatter-added at ``index`` (duplicates accumulate)."""
    updates = _t(updates)
    out = torch.zeros(tuple(shape), dtype=updates.dtype,
                      device=updates.device)
    idx = tuple(_t(index, updates).long().movedim(-1, 0))
    return out.index_put(idx, updates, accumulate=True)


# ---------------------------------------------------------------------------
# random: the port's generator for ``device`` (the card by default)
# ---------------------------------------------------------------------------
def rand(shape, dtype=None, device=None):
    """Parity: paddle.rand: U[0, 1)."""
    return _random.uniform(tuple(shape), dtype, 0.0, 1.0,
                           device=_current_device(device))


def randn(shape, dtype=None, device=None):
    """Parity: paddle.randn."""
    return _random.normal(tuple(shape), dtype,
                          device=_current_device(device))


def randint(low=0, high=None, shape=(1,), dtype="int64", device=None):
    """Parity: paddle.randint."""
    return _random.randint(low, high, tuple(shape), dtype,
                           device=_current_device(device))


def randperm(n, dtype="int64", device=None):
    """Parity: paddle.randperm."""
    return _random.randperm(n, dtype, device=_current_device(device))


def uniform(shape, dtype=None, min=-1.0, max=1.0,  # noqa: A002
            device=None):
    """Parity: paddle.uniform (Paddle's default range is [-1, 1), unlike
    rand's [0, 1))."""
    return _random.uniform(tuple(shape), dtype, min, max,
                           device=_current_device(device))


def normal(mean=0.0, std=1.0, shape=(1,), device=None):
    """Parity: paddle.normal (mean and std first, Paddle's order)."""
    return _random.normal(tuple(shape), None, mean, std,
                          device=_current_device(device))


def multinomial(x, num_samples=1, replacement=False):
    """Parity: paddle.multinomial: rows of ``x`` are (unnormalized)
    probabilities, drawn on ``x``'s device. Without replacement, asking
    for more samples than there are nonzero-probability categories
    raises."""
    x = _t(x)
    if not replacement:
        nonzero_ = int((x > 0).sum(dim=-1).min())
        if num_samples > nonzero_:
            raise ValueError(
                f"multinomial(replacement=False): num_samples "
                f"{num_samples} exceeds the {nonzero_} nonzero-"
                f"probability categories")
    probs = _float(x).clamp(min=0)
    return torch.multinomial(probs, num_samples, replacement=replacement,
                             generator=_random.default_generator(x.device))


# ---------------------------------------------------------------------------
# long-tail surface (parity: python/paddle/tensor/{math,manipulation,
# search,linalg}.py module-level APIs)
# ---------------------------------------------------------------------------
def mv(x, vec, name=None):
    return torch.matmul(_t(x), _t(vec))


def bmm(x, y, name=None):
    x, y = _t(x), _t(y)
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError("bmm expects 3-D inputs")
    return torch.matmul(x, y)


def dist(x, y, p=2, name=None):
    """p-norm of (x - y) (paddle.dist, scalar)."""
    d = (_t(x) - _t(y)).reshape(-1)
    p = float(p)
    if p == float("inf"):
        return d.abs().max()
    if p == float("-inf"):
        return d.abs().min()
    if p == 0:
        return (d != 0).sum().to(d.dtype)
    return torch.pow(torch.pow(d.abs(), p).sum(), 1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-distance between row vectors of x [..., m, d] and
    y [..., n, d] -> [..., m, n] (the JAX module's direct differences)."""
    x, y = _t(x), _t(y)
    diff_ = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.clamp((diff_ * diff_).sum(dim=-1), min=0.0))
    if p == float("inf"):
        return diff_.abs().amax(dim=-1)
    if p == 1.0:
        return diff_.abs().sum(dim=-1)
    return torch.pow(torch.pow(diff_.abs(), p).sum(dim=-1), 1.0 / p)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _t(y)
    if x is not None:
        return torch.trapezoid(y, _t(x, y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _t(y).movedim(axis, -1)
    if x is not None:
        xx = _t(x, y)
        xx = xx.movedim(axis, -1) if xx.dim() == y.dim() else xx
        w = torch.diff(xx, dim=-1)
    else:
        w = 1.0 if dx is None else dx
    steps = (y[..., 1:] + y[..., :-1]) * 0.5 * w
    return torch.cumsum(steps, dim=-1).movedim(-1, axis)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim, "midpoint")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """k-th smallest (1-based, Paddle semantics) -> (values, indices);
    ties by a stable sort."""
    x = _t(x)
    idx = torch.argsort(x, dim=axis, stable=True)
    kth_idx = idx.select(axis, k - 1)
    vals = torch.gather(x, axis, kth_idx.unsqueeze(axis))
    if not keepdim:
        return vals.squeeze(axis), kth_idx
    return vals, kth_idx.unsqueeze(axis)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Eager host-side op (dynamic output shape), like ``unique``."""
    a, dev = _host(x)
    if axis is None:
        a = a.ravel()
        ax = 0
    else:
        ax = axis
    if a.shape[ax] == 0:
        change = np.zeros((0,), bool)
    else:
        moved = np.moveaxis(a, ax, 0)
        flat = moved.reshape(moved.shape[0], -1)
        change = np.concatenate(
            [[True], np.any(flat[1:] != flat[:-1], axis=1)])
    starts = np.flatnonzero(change)
    res = [np.take(a, starts, axis=ax)]
    if return_inverse:
        res.append(np.cumsum(change) - 1)
    if return_counts:
        res.append(np.diff(np.append(starts, a.shape[ax])))
    res = [torch.from_numpy(np.asarray(r)).to(dev) for r in res]
    return res[0] if len(res) == 1 else tuple(res)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(_t(x), offset=offset)


def frexp(x, name=None):
    m, e = torch.frexp(_float(_t(x)))
    return m, e.to(torch.int32)


def ldexp(x, y, name=None):
    x = _float(_t(x))
    return torch.ldexp(x, _t(y, x).to(torch.int32))


def lgamma(x, name=None):
    return torch.lgamma(_float(_t(x)))


def digamma(x, name=None):
    return torch.special.digamma(_float(_t(x)))


def polygamma(x, n, name=None):
    return torch.special.polygamma(int(n), _float(_t(x)))


def erfinv(x, name=None):
    return torch.special.erfinv(_float(_t(x)))


def i0(x, name=None):
    return torch.special.i0(_float(_t(x)))


def i0e(x, name=None):
    return torch.special.i0e(_float(_t(x)))


def i1(x, name=None):
    return torch.special.i1(_float(_t(x)))


def i1e(x, name=None):
    return torch.special.i1e(_float(_t(x)))


def sinc(x, name=None):
    return torch.sinc(_float(_t(x)))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``jnp.histogramdd`` of [N, D] samples: per-dimension edges (the
    last bin closed), counts of samples inside every range."""
    x = _float(_t(x))
    n, d = x.shape
    per_dim = [bins] * d if isinstance(bins, int) else list(bins)
    # counts are integers without weights, as jnp.bincount's
    w = torch.ones(n, dtype=torch.long, device=x.device) if weights is None \
        else _t(weights, x).to(x.dtype)
    idx_by_dim, edges_by_dim = [], []
    for i in range(d):
        col = x[:, i].contiguous()
        r = None if ranges is None else ranges[i]
        if isinstance(per_dim[i], int):
            lo, hi = (float(col.min()), float(col.max())) if r is None \
                else (float(r[0]), float(r[1]))
            edges = _hist_edges(col, per_dim[i], lo, hi)
        else:
            edges = _t(per_dim[i], x).to(x.dtype)
        idx = torch.searchsorted(edges, col, right=True)
        idx = torch.where(col == edges[-1], idx - 1, idx)
        idx_by_dim.append(idx)
        edges_by_dim.append(edges)
    nbins = [len(e) + 1 for e in edges_by_dim]
    flat = torch.zeros((), dtype=torch.long, device=x.device)
    for idx, nb in zip(idx_by_dim, nbins):
        flat = flat * nb + idx.clamp(0, nb - 1)
    hist = torch.zeros(_math.prod(nbins), dtype=w.dtype, device=x.device)
    hist.index_add_(0, flat, w)
    hist = hist.reshape(nbins)[tuple(slice(1, -1) for _ in range(d))]
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges_by_dim):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges_by_dim


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_dt(dtype), device=_current_device(device))


def masked_scatter(x, mask, value, name=None):
    """Fill True positions of ``mask`` with elements of ``value`` taken
    in row-major order (paddle.masked_scatter)."""
    x = _t(x)
    mask = torch.broadcast_to(_t(mask, x).bool(), x.shape)
    flat_m = mask.reshape(-1)
    take_ = torch.cumsum(flat_m.long(), dim=0) - 1
    src = _t(value, x).reshape(-1)
    picked = src[take_.clamp(0, src.numel() - 1)]
    return torch.where(flat_m, picked.to(x.dtype),
                       x.reshape(-1)).reshape(x.shape)


def index_put(x, indices, value, accumulate=False, name=None):
    x = _t(x)
    idx = tuple(_t(i, x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    return x.index_put(idx, _t(value, x).to(x.dtype), accumulate=accumulate)


def unflatten(x, axis, shape, name=None):
    x = _t(x)
    axis = axis % x.dim()
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape = tuple(x.shape[axis] // known if s == -1 else s
                      for s in shape)
    return x.reshape(tuple(x.shape[:axis]) + shape
                     + tuple(x.shape[axis + 1:]))


def tensor_split(x, num_or_indices, axis=0, name=None):
    if isinstance(num_or_indices, int):
        return list(torch.tensor_split(_t(x), num_or_indices, dim=axis))
    return list(torch.tensor_split(_t(x), [int(i) for i in num_or_indices],
                                   dim=axis))


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def hsplit(x, num_or_indices, name=None):
    x = _t(x)
    return tensor_split(x, num_or_indices, axis=0 if x.dim() == 1 else 1)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def as_strided(x, shape, stride, offset=0, name=None):
    """Strided view of the flattened input (paddle.as_strided), copied
    as the JAX module's gather copies."""
    flat = _t(x).contiguous().reshape(-1)
    return torch.as_strided(flat, tuple(int(s) for s in shape),
                            tuple(int(s) for s in stride), int(offset)
                            ).clone()


def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis`` (paddle.Tensor.unfold): the output
    gains a trailing window dim of length ``size``."""
    return _t(x).unfold(axis, size, step).clone()


def view(x, shape_or_dtype, name=None):
    """paddle.view: reshape, or a bitcast reinterpretation for a dtype
    (the last dim folds or grows where the widths differ)."""
    x = _t(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    return x.contiguous().view(dtype_mod.convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return _t(x).reshape(_t(other).shape)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def rank(x, name=None):
    x = _t(x)
    return torch.tensor(x.dim(), device=x.device)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing (torch's options; the JAX module sets numpy's,
    which its arrays print with)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def reshape_(x, shape, name=None):
    return reshape(x, shape)


def squeeze_(x, axis=None, name=None):
    x = _t(x)
    return x.squeeze_() if axis is None else x.squeeze_(axis)


def unsqueeze_(x, axis, name=None):
    return _t(x).unsqueeze_(axis)


def clip_(x, min=None, max=None, name=None):  # noqa: A002
    return _t(x).clamp_(min, max)


# ---- the migration-surface sweep (parity: python/paddle/tensor/math.py,
# creation.py, attribute.py) ----
def mm(input, mat2, name=None):  # noqa: A002
    return torch.matmul(_t(input), _t(mat2))


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = _t(x)
    if dtype is not None:
        x = x.to(dtype_mod.convert_dtype(dtype))
    if axis is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in sorted((a % x.dim() for a in axes), reverse=True):
        x = torch.prod(x, dim=ax, keepdim=keepdim)
    return x


def tan(x, name=None):
    return torch.tan(_float(_t(x)))


def sigmoid(x, name=None):
    return torch.sigmoid(_float(_t(x)))


def erf(x, name=None):
    return torch.erf(_float(_t(x)))


def floor_divide(x, y, name=None):
    return _binary(torch.floor_divide)(x, y)


def remainder(x, y, name=None):
    return _binary(torch.remainder)(x, y)


def mod(x, y, name=None):
    return _binary(torch.remainder)(x, y)


def real(x, name=None):
    x = _t(x)
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    x = _t(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def conj(x, name=None):
    return torch.conj_physical(_t(x))


def angle(x, name=None):
    return torch.angle(_float(_t(x)))


def as_complex(x, name=None):
    """[..., 2] float -> [...] complex (parity: paddle.as_complex)."""
    x = _t(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    """[...] complex -> [..., 2] float (parity: paddle.as_real)."""
    x = _t(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def take(x, index, mode="raise", name=None):
    """Flattened-index gather (parity: paddle.take; mode 'raise' clamps
    like 'clip', as in JAX; 'wrap' wraps)."""
    x = _t(x)
    index = _t(index, x).long()
    flat = x.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        index = torch.remainder(index, n)
    else:
        index = index.clamp(-n, n - 1)
    return flat[index]


def index_add(x, index, axis, value, name=None):
    """out[index[i]] += value[i] along ``axis`` (parity:
    paddle.index_add)."""
    x = _t(x)
    axis = axis % x.dim()
    return x.index_add(axis, _t(index, x).long(),
                       _t(value, x).to(x.dtype))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    x = _float(_t(x))
    if not rowvar and x.dim() > 1:
        x = x.T
    fw = None if fweights is None else _t(fweights, x)
    aw = None if aweights is None else _t(aweights, x)
    return torch.cov(x, correction=1 if ddof else 0, fweights=fw,
                     aweights=aw)


def corrcoef(x, rowvar=True, name=None):
    x = _float(_t(x))
    if not rowvar and x.dim() > 1:
        x = x.T
    return torch.corrcoef(x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__
           and n not in ("annotations",)]
