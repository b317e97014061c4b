"""``paddle.linalg`` on ``torch.linalg`` (counterpart of
``paddle_tpu/linalg.py``): the same 33 functions, their arguments and
return structures as in JAX. Each computes on its inputs' device."""

from __future__ import annotations

import torch


def _v(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = _v(x), _v(y)
    if transpose_x:
        x = x.mT
    if transpose_y:
        y = y.mT
    return torch.matmul(x, y)


def norm(x, p="fro", axis=None, keepdim=False):
    """Paddle semantics (axis=None flattens any rank; int axis: vector
    p-norm; 2-tuple axis: matrix norm), shared with ``tensor.norm``."""
    from . import tensor as _tensor

    return _tensor.norm(_v(x), p=p, axis=axis, keepdim=keepdim)


def inv(x):
    return torch.linalg.inv(_v(x))


def pinv(x, rcond=1e-15):
    """Singular values below ``rcond`` times the largest count as zero."""
    return torch.linalg.pinv(_v(x), rtol=rcond)


def det(x):
    return torch.linalg.det(_v(x))


def slogdet(x):
    return torch.linalg.slogdet(_v(x))


def svd(x, full_matrices=False):
    """``(u, s, vh)``, as ``jnp.linalg.svd``."""
    return torch.linalg.svd(_v(x), full_matrices=full_matrices)


def qr(x, mode="reduced"):
    """``(q, r)``; ``mode="r"`` gives r alone, as in JAX."""
    q, r = torch.linalg.qr(_v(x), mode=mode)
    return r if mode == "r" else (q, r)


def eigh(x, UPLO="L"):
    return torch.linalg.eigh(_v(x), UPLO=UPLO)


def eig(x):
    return torch.linalg.eig(_v(x))


def cholesky(x, upper=False):
    return torch.linalg.cholesky(_v(x), upper=upper)


def solve(a, b):
    return torch.linalg.solve(_v(a), _v(b))


def lstsq(a, b, rcond=None):
    """``(x, residuals, rank, singular values)`` as ``jnp.linalg.lstsq``:
    the residuals (squared, summed over rows) only at full column rank
    with more rows than columns, else empty."""
    a, b = _v(a), _v(b)
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    m, n = a.shape[-2], a.shape[-1]
    s = torch.linalg.svdvals(a)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    rank = (s > rcond * s.amax()).sum().to(torch.int32)
    driver = "gelsd" if a.device.type == "cpu" else "gels"
    x = torch.linalg.lstsq(a, b2, rcond=rcond if driver == "gelsd"
                           else None, driver=driver).solution
    if m > n and int(rank) == n:
        resid = ((a @ x - b2) ** 2).sum(dim=-2)
    else:
        resid = a.new_zeros((0,))
    if vec:
        x = x[:, 0]
    return x, resid, rank, s


def matrix_rank(x, tol=None):
    """Singular values above ``tol`` times the largest (JAX's default:
    eps times the larger dim) count."""
    return torch.linalg.matrix_rank(_v(x), rtol=tol)


def matrix_power(x, n):
    return torch.linalg.matrix_power(_v(x), n)


def cond(x, p=None):
    return torch.linalg.cond(_v(x), p)


def triangular_solve(a, b, upper=True, transpose=False, unitriangular=False):
    a = _v(a)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, _v(b), upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(b, y, upper=False):
    """Parity: ``paddle.linalg.cholesky_solve``: x with A x = b, given the
    Cholesky factor y of A."""
    return torch.cholesky_solve(_v(b), _v(y), upper=upper)


def eigvals(x):
    return torch.linalg.eigvals(_v(x))


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_v(x), UPLO=UPLO)


def lu(x, pivot=True):
    """Packed LU and its pivots, 1-based (LAPACK's getrf, Paddle's
    convention)."""
    lu_mat, piv = torch.linalg.lu_factor(_v(x))
    return lu_mat, piv.to(torch.int32)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True):
    """``(P, L, U)`` of a 2-D packed LU; the pivots' sequential row swaps
    are applied on the host, as the JAX function does for concrete
    pivots."""
    lu_mat = _v(lu_data)
    if lu_mat.dim() != 2:
        raise ValueError("lu_unpack: 2-D input only; vmap for batches")
    n, m = lu_mat.shape
    k = min(n, m)
    L = torch.tril(lu_mat[:, :k], -1) + torch.eye(
        n, k, dtype=lu_mat.dtype, device=lu_mat.device)
    U = torch.triu(lu_mat[:k, :])
    piv = [int(p) - 1 for p in _v(lu_pivots).reshape(-1).tolist()]
    perm = list(range(n))
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    eye = torch.eye(n, dtype=lu_mat.dtype, device=lu_mat.device)
    P = eye[torch.tensor(perm, device=lu_mat.device)].T
    return P, L, U


def multi_dot(tensors):
    return torch.linalg.multi_dot([_v(t) for t in tensors])


def matrix_exp(x):
    return torch.linalg.matrix_exp(_v(x))


def svdvals(x):
    return torch.linalg.svdvals(_v(x))


def vector_norm(x, p=2.0, axis=None, keepdim=False):
    """``jnp.linalg.norm`` semantics: axis None flattens; an int axis is a
    vector norm, a 2-tuple a matrix norm."""
    x = _v(x)
    if axis is None:
        out = torch.linalg.vector_norm(x.reshape(-1), ord=p)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.linalg.norm(x, ord=p, dim=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.norm(_v(x), ord=p, dim=tuple(axis), keepdim=keepdim)


def matrix_transpose(x):
    return _v(x).mT


def householder_product(x, tau):
    """Parity: ``paddle.linalg.householder_product`` (LAPACK orgqr)."""
    return torch.linalg.householder_product(_v(x), _v(tau))


def svd_lowrank(x, q=6, niter=2, M=None):
    """Randomized range finder with ``niter`` subspace iterations (Halko et
    al.), as in JAX; the projection is a Gaussian from a generator seeded
    with 0 (drawn on the host, then moved), so the result does not vary
    from call to call. Its bits differ from JAX's draw: the two agree
    where the range is found exactly (rank at most ``q``)."""
    a = _v(x)
    if M is not None:
        a = a - _v(M)
    m, n = a.shape[-2], a.shape[-1]
    q = min(q, m, n)
    g = torch.Generator()
    g.manual_seed(0)
    omega = torch.randn(tuple(a.shape[:-2]) + (n, q), generator=g,
                        dtype=a.dtype).to(a.device)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.mT @ y)
    Q, _ = torch.linalg.qr(y)
    b = Q.mT @ a
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    return Q @ u_b, s, vt.mT


def pca_lowrank(x, q=None, center=True, niter=2):
    a = _v(x)
    m, n = a.shape[-2], a.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        a = a - a.mean(dim=-2, keepdim=True)
    return svd_lowrank(a, q=q, niter=niter)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Parity: ``paddle.linalg.cov`` (``ddof`` a bool: 1 or 0)."""
    x = _v(x)
    if not rowvar:
        x = x.T
    return torch.cov(x, correction=1 if ddof else 0,
                     fweights=None if fweights is None else _v(fweights),
                     aweights=None if aweights is None else _v(aweights))


def corrcoef(x, rowvar=True, name=None):
    x = _v(x)
    return torch.corrcoef(x if rowvar else x.T)
