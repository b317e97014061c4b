"""Sparse tensors (counterpart of ``paddle_tpu/sparse/__init__.py``;
parity: ``paddle.sparse``) on torch's sparse COO and CSR layouts.

The JAX package builds on ``jax.experimental.sparse`` (BCOO/BCSR); here
a COO tensor is ``torch.sparse_coo_tensor`` (a hybrid one keeps trailing
dense dims in its values, as BCOO's ``n_dense``) and a CSR matrix
``torch.sparse_csr_tensor``. Operations keep data sparse where torch's
sparse kernels do (elementwise with a sparse or dense operand, sparse
products, reductions) and return what JAX returns: ``matmul`` of a
sparse and a dense operand is dense, of two sparse ones sparse;
``masked_matmul`` forms only the mask's entries. ``coalesce`` sums
duplicates and drops them (JAX keeps the freed slots, padded out of
range; ``nnz`` counts the in-range entries in both).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.device import current_device
from . import nn  # noqa: F401  (namespace parity: paddle.sparse.nn)

__all__ = [
    "sparse_coo_tensor",
    "sparse_csr_tensor",
    "to_dense",
    "to_sparse_coo",
    "to_sparse_csr",
    "is_sparse",
    "is_sparse_coo",
    "is_sparse_csr",
    "coalesce",
    "add",
    "subtract",
    "multiply",
    "divide",
    "matmul",
    "masked_matmul",
    "transpose",
    "relu",
    "nnz",
]


def _t(x, device=None, dtype=None):
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=current_device(device))


def _as_coo(x, coalesce: bool = False):
    """Any sparse operand as COO (optionally coalesced); dense as given."""
    x = _t(x)
    if x.layout == torch.sparse_csr:
        x = x.to_sparse_coo()
    if coalesce and x.layout == torch.sparse_coo:
        x = x.coalesce()
    return x


# -- construction -----------------------------------------------------------
def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      stop_gradient=True):
    """A COO tensor from ``[sparse_ndim, nnz]`` indices; ``shape``
    inferred from the largest index when not given."""
    values = _t(values, dtype=None if dtype is None else
                _dtype(dtype))
    indices = _t(indices, device=values.device).to(torch.int64)
    if indices.dim() != 2:
        raise ValueError(
            f"indices must be [sparse_ndim, nnz]; got shape "
            f"{tuple(indices.shape)}")
    if shape is None:
        if indices.shape[1] == 0:
            raise ValueError("shape must be given explicitly for empty "
                             "indices: it cannot be inferred")
        shape = tuple(int(m) + 1 for m in indices.amax(dim=1).tolist())
        shape = shape + tuple(values.shape[1:])
    return torch.sparse_coo_tensor(indices, values, tuple(shape))


def _dtype(d):
    from ..core.dtype import convert_dtype

    return convert_dtype(d)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      stop_gradient=True):
    """A CSR matrix (2-D only, as in JAX)."""
    values = _t(values, dtype=None if dtype is None else _dtype(dtype))
    crows = _t(crows, device=values.device).to(torch.int64)
    cols = _t(cols, device=values.device).to(torch.int64)
    if len(shape) != 2:
        raise ValueError("sparse_csr_tensor supports 2-D matrices; "
                         f"got shape {shape}")
    return torch.sparse_csr_tensor(crows, cols, values, tuple(shape))


# -- conversion -------------------------------------------------------------
def to_sparse_coo(x, sparse_dim: Optional[int] = None):
    x = _t(x)
    if x.layout == torch.sparse_csr:
        return x.to_sparse_coo()
    if x.layout == torch.sparse_coo:
        return x
    return x.to_sparse(sparse_dim if sparse_dim is not None else x.dim())


def to_sparse_csr(x):
    x = _t(x)
    if x.layout == torch.sparse_csr:
        return x
    if x.layout == torch.sparse_coo:
        return x.coalesce().to_sparse_csr()
    return x.to_sparse_csr()


def to_dense(x):
    x = _t(x)
    return x.to_dense() if is_sparse(x) else x


def is_sparse(x):
    return isinstance(x, torch.Tensor) and x.layout in (torch.sparse_coo,
                                                        torch.sparse_csr)


def is_sparse_coo(x):
    return isinstance(x, torch.Tensor) and x.layout == torch.sparse_coo


def is_sparse_csr(x):
    return isinstance(x, torch.Tensor) and x.layout == torch.sparse_csr


def nnz(x):
    """Stored entries (after ``coalesce``, each index once)."""
    x = _t(x)
    return x._nnz()


def coalesce(x):
    """Sum duplicate indices and sort (parity: ``Tensor.coalesce``)."""
    x = _t(x)
    return x.coalesce() if x.layout == torch.sparse_coo else x


# -- math -------------------------------------------------------------------
def _binary(op, x, y):
    x, y = _t(x), _t(y)
    xs, ys = is_sparse(x), is_sparse(y)
    if not xs and not ys:
        return op(x, y)
    x = _as_coo(x) if xs else x
    y = _as_coo(y) if ys else y
    if xs and ys:
        return op(x, y).coalesce()
    if op is torch.mul:
        # sparse * dense: the product is zero off the sparse pattern
        sp, dn = (x, y) if xs else (y, x)
        sp = sp.coalesce()
        idx = sp.indices()
        vals = sp.values() * dn.expand(sp.shape)[tuple(idx)]
        return torch.sparse_coo_tensor(idx, vals, sp.shape)
    if op is torch.sub:
        raise NotImplementedError(
            "subtraction between a sparse and a dense tensor (as in JAX): "
            "densify the sparse one with to_dense")
    # add with a dense operand: dense, as JAX's sparsify gives
    return op(x.to_dense() if xs else x, y.to_dense() if ys else y)


def add(x, y):
    return _binary(torch.add, x, y)


def subtract(x, y):
    return _binary(torch.sub, x, y)


def multiply(x, y):
    return _binary(torch.mul, x, y)


def divide(x, y):
    """Division by a scalar or dense divisor (as in the reference): the
    stored values divided, the pattern kept."""
    x = _as_coo(x, coalesce=True)
    y = _t(y, device=x.device)
    if x.layout != torch.sparse_coo:
        return x / y
    idx = x.indices()
    den = y if y.dim() == 0 else y.expand(x.shape)[tuple(idx)]
    return torch.sparse_coo_tensor(idx, x.values() / den, x.shape)


def matmul(x, y):
    """Sparse @ dense (dense result) or sparse @ sparse (sparse result)."""
    xs, ys = is_sparse(_t(x)), is_sparse(_t(y))
    x, y = _as_coo(x), _as_coo(y)
    if xs and ys:
        return torch.sparse.mm(x, y).coalesce()
    if xs:
        return torch.sparse.mm(x, y) if x.dim() == 2 else torch.matmul(
            x.to_dense(), y)
    if ys:
        return torch.matmul(x, y.to_dense())
    return torch.matmul(x, y)


def masked_matmul(x, y, mask):
    """Dense @ dense sampled at ``mask``'s pattern (SDDMM): only the
    mask's entries are formed, each as one row-by-column product."""
    x, y = _t(x), _t(y)
    mask = _as_coo(to_sparse_coo(mask), coalesce=True)
    r, c = mask.indices()
    data = (x[r] * y[:, c].T).sum(dim=-1)
    return torch.sparse_coo_tensor(mask.indices(), data, mask.shape)


def transpose(x, perm: Sequence[int]):
    x = _as_coo(x)
    return x.permute(tuple(perm))


def map_values(x, fn):
    """``fn`` on the stored values, after coalescing (with duplicate
    indices a nonlinear map would disagree with the dense meaning)."""
    x = _as_coo(x, coalesce=True)
    if x.layout == torch.sparse_coo:
        return torch.sparse_coo_tensor(x.indices(), fn(x.values()), x.shape)
    return fn(x)


def relu(x):
    """Elementwise relu on the values (parity: ``paddle.sparse.nn.ReLU``)."""
    return map_values(x, torch.relu)
