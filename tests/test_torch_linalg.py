"""``paddle_tpu_torch.linalg`` against ``paddle_tpu.linalg`` on the same
float32 inputs (seeded numpy, well-conditioned): all 33 functions, their
return structures and values at 1e-5 relative to each result's largest
magnitude (1e-4 where LAPACK's float32 algorithms differ: eigenvectors,
the matrix exponential, the randomized SVD; 1e-3 for the randomized
SVD's reconstruction after its power iterations). Factors that are defined
only up to signs (eigenvectors, SVD, QR) are held by what they define:
the reconstruction, the orthogonality and the values."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import linalg as jl
from paddle_tpu_torch import linalg as tl

RNG = np.random.default_rng(0)
A = (RNG.standard_normal((5, 5)) + 5 * np.eye(5)).astype(np.float32)
SPD = (A @ A.T + np.eye(5)).astype(np.float32)
B = RNG.standard_normal((5, 3)).astype(np.float32)
TALL = RNG.standard_normal((7, 4)).astype(np.float32)
BATCH = (RNG.standard_normal((3, 4, 4)) + 4 * np.eye(4)).astype(np.float32)
X = RNG.standard_normal((4, 6)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def near(got, want, tol=1e-5):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def both(name, *args, **kw):
    return (getattr(tl, name)(*(torch.tensor(a) if isinstance(a, np.ndarray)
                                else a for a in args), **kw),
            getattr(jl, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args), **kw))


@pytest.mark.parametrize("name,args,kw", [
    ("matmul", (A, B), {}),
    ("matmul", (B, A), dict(transpose_x=True)),
    ("matmul", (A, A), dict(transpose_y=True)),
    ("norm", (X,), {}),
    ("norm", (X,), dict(p=1, axis=1, keepdim=True)),
    ("norm", (X,), dict(p="fro", axis=(0, 1))),
    ("inv", (A,), {}),
    ("inv", (BATCH,), {}),
    ("pinv", (TALL,), {}),
    ("det", (A,), {}),
    ("det", (BATCH,), {}),
    ("solve", (A, B), {}),
    ("cholesky", (SPD,), {}),
    ("cholesky", (SPD,), dict(upper=True)),
    ("matrix_rank", (TALL,), {}),
    ("matrix_power", (A, 3), {}),
    ("matrix_power", (A, -2), {}),
    ("cond", (A,), {}),
    ("cond", (A, "fro"), {}),
    ("triangular_solve", (np.triu(A), B), {}),
    ("triangular_solve", (np.tril(A), B), dict(upper=False,
                                               transpose=True)),
    ("triangular_solve", (np.triu(A), B), dict(unitriangular=True)),
    ("cholesky_solve", (B, np.linalg.cholesky(SPD).astype(np.float32)), {}),
    ("eigvalsh", (SPD,), {}),
    ("eigvalsh", (SPD,), dict(UPLO="U")),
    ("multi_dot", ([A, B, B.T],), {}),
    ("svdvals", (TALL,), {}),
    ("vector_norm", (X,), {}),
    ("vector_norm", (X,), dict(p=3.0, axis=1, keepdim=True)),
    ("vector_norm", (X,), dict(p=float("inf"), keepdim=True)),
    ("matrix_norm", (X,), {}),
    ("matrix_norm", (BATCH,), dict(p=1, keepdim=True)),
    ("matrix_transpose", (BATCH,), {}),
    ("cov", (X,), {}),
    ("cov", (X,), dict(rowvar=False, ddof=False)),
    ("corrcoef", (X,), {}),
    ("corrcoef", (X,), dict(rowvar=False)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_values_match_jax(name, args, kw):
    got, want = both(name, *args, **kw)
    near(got, want)


def test_decompositions_match_jax_up_to_signs():
    (sign, logdet), (jsign, jlogdet) = both("slogdet", A)
    near(sign, jsign)
    near(logdet, jlogdet)
    # svd: values equal, factors reconstruct, vectors agree up to sign
    (u, s, vh), (ju, js, jvh) = both("svd", TALL)
    near(s, js)
    near(u @ torch.diag(s) @ vh, TALL)
    near(np.abs(_np(u)), np.abs(np.asarray(ju)), 1e-4)
    (u, s, vh), _ = both("svd", TALL, full_matrices=True)
    assert tuple(u.shape) == (7, 7) and tuple(vh.shape) == (4, 4)
    for mode in ("reduced", "complete"):
        (q, r), (jq, jr) = both("qr", TALL, mode=mode)
        assert q.shape == jq.shape and r.shape == jr.shape
        near(q @ r, TALL)
        near(np.abs(_np(r)), np.abs(np.asarray(jr)), 1e-4)
    r, jr = both("qr", TALL, mode="r")
    near(np.abs(_np(r)), np.abs(np.asarray(jr)), 1e-4)
    (w, v), (jw, jv) = both("eigh", SPD)
    near(w, jw)
    near(v @ torch.diag(w) @ v.T, SPD)
    near(np.abs(_np(v)), np.abs(np.asarray(jv)), 1e-4)
    (w, v), (jw, _) = both("eig", A)
    near(np.sort_complex(_np(w)), np.sort_complex(np.asarray(jw)))
    near(torch.tensor(A, dtype=torch.complex64) @ v, v * w, 1e-4)
    w, jw = both("eigvals", A)
    near(np.sort_complex(_np(w)), np.sort_complex(np.asarray(jw)))


def test_lstsq_lu_and_the_rest_match_jax():
    (x, res, rank, s), (jx, jres, jrank, js) = both("lstsq", TALL, TALL[:, :2])
    near(x, jx)
    near(res, jres)
    assert int(rank) == int(jrank) and int(rank) == 4
    near(s, js)
    (x, res, rank, s), (jx, jres, *_) = both("lstsq", TALL, TALL[:, 0])
    near(x, jx)
    near(res, jres)
    (lu, piv), (jlu, jpiv) = both("lu", A)
    near(lu, jlu)
    assert piv.dtype == torch.int32 and np.array_equal(_np(piv),
                                                       np.asarray(jpiv))
    for got, want in zip(tl.lu_unpack(lu, piv), jl.lu_unpack(jlu, jpiv)):
        near(got, want)
    P, L, U = tl.lu_unpack(lu, piv)
    near(P @ L @ U, A)
    got, want = both("matrix_exp", A * 0.1)
    near(got, want, 1e-4)
    # householder_product of LAPACK's geqrf output
    h, tau = torch.geqrf(torch.tensor(TALL))
    near(tl.householder_product(h, tau),
         jl.householder_product(jnp.asarray(h.numpy()),
                                jnp.asarray(tau.numpy())))
    # the randomized SVD finds a rank-3 range exactly, whatever its draw
    # (without power iterations, which raise float32 rounding by the
    # fourth power of the spread of the singular values)
    low = (RNG.standard_normal((8, 3)) @ RNG.standard_normal((3, 6))).astype(
        np.float32)
    (u, s, v), (ju, js, jv) = both("svd_lowrank", low, q=3, niter=0)
    near(s, js, 1e-4)
    near(u @ torch.diag(s) @ v.T, low, 1e-4)
    (u, s, v), (ju, js, jv) = both("pca_lowrank", low, q=3, niter=0)
    near(s, js, 1e-4)
    (u, s, v), _ = both("svd_lowrank", low, q=3)
    near(u @ torch.diag(s) @ v.T, low, 1e-3)
