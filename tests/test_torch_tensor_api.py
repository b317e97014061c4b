"""The port's ``tensor.py`` against the JAX package's on the CPU: one case
per public name (the JAX module's functions, found by introspection, so
a name the port lacks fails), the same inputs made with numpy from a
seed going through both, and explicit cases for the traps where the
JAX module's ``jnp`` semantics differ from torch's: ``std``/``var`` with
``ddof=0``, ``split`` at cut indices, stable ``sort``/``argsort`` ties
(descending too), ``gather`` as ``jnp.take`` (negative and
out-of-bounds indices), the index and tie rules of ``unique``,
``unique_consecutive``, ``median``, ``mode``, ``topk`` and
``kthvalue``, and ``to_tensor``'s widths, ``place`` and
``stop_gradient``. The random functions are held by shape, dtype,
range and seed repeat (the port draws torch's numbers, not JAX's).

Values are compared after a cast to float64 (the port keeps the 64-bit
widths the JAX package drops with x64 off), together with the kind of
dtype (bool, integer, float, complex). Tolerances: float32 both ways,
rtol = atol = 1e-6 for elementwise work, 1e-5 for reductions, the
special functions and the linear algebra.

The parametrised cases take the JAX side from one ``jax.jit`` over all
of them (the ``jax_refs`` fixture): the same functions on the same
inputs, compiled once instead of once for each primitive of each eager
call. A function whose result shape depends on its data runs eagerly."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.tensor as jt
import paddle_tpu_torch.tensor as tt
from paddle_tpu_torch.core import device as tdev
from paddle_tpu_torch.core import random as trandom

EW = 1e-6  # elementwise
RED = 1e-5  # reductions, special functions, linear algebra

JAX_NAMES = sorted(
    n for n, v in vars(jt).items()
    if not n.startswith("_") and callable(v)
    and getattr(v, "__module__", "") == "paddle_tpu.tensor")


@pytest.fixture(autouse=True, scope="module")
def _host_device():
    """The port's creation functions default to the card; these tests
    make the CPU the current device, then restore the default."""
    tdev.set_current(torch.device("cpu"))
    try:
        yield
    finally:
        tdev.set_current(None)


def _kind(dt) -> str:
    k = np.dtype(dt).kind
    return {"u": "i"}.get(k, k)


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def check(got, want, tol=EW):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), type(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            check(g, w, tol)
        return
    if isinstance(want, (bool, int, float)) and not isinstance(
            want, np.generic):
        assert got == pytest.approx(want, rel=tol, abs=tol)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert _kind(g.dtype) == _kind(w.dtype), (g.dtype, w.dtype)
    cast = np.complex128 if w.dtype.kind == "c" else np.float64
    np.testing.assert_allclose(g.astype(cast), w.astype(cast), rtol=tol,
                               atol=tol, equal_nan=True)


def _to(lib, a):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a) if lib == "jax" else torch.from_numpy(a.copy())
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_to(lib, x) for x in a]
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(_to(lib, x) for x in a)
    return a


def _is_data(a) -> bool:
    """An argument that carries data: an array, or a list or tuple of
    arrays (what ``_to`` converts)."""
    return isinstance(a, np.ndarray) or (
        isinstance(a, (list, tuple)) and bool(a)
        and isinstance(a[0], np.ndarray))


def run_both(name, args, kw=None, tol=EW):
    kw = kw or {}
    want = getattr(jt, name)(*[_to("jax", a) for a in args], **kw)
    got = getattr(tt, name)(*[_to("torch", a) for a in args], **kw)
    check(got, want, tol)
    return got, want


def f32(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def pos(rng, *shape):
    return (rng.random(shape) + 0.5).astype(np.float32)


def ints(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape).astype(np.int32)


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _with_nan(rng, *shape):
    x = f32(rng, *shape)
    x.flat[::5] = np.nan
    return x


# name -> list of (args, kwargs, tol); each becomes one parametrised case
def _cases(r):
    x34, y34 = f32(r, 3, 4), f32(r, 3, 4)
    p34 = pos(r, 3, 4)
    mask = f32(r, 3, 4) > 0
    v4, w4 = f32(r, 4), f32(r, 4)
    ties = np.array([[3, 1, 2, 1, 3, 2], [0, 0, 1, 1, 0, 1]], np.float32)
    seq = np.sort(f32(r, 8))
    return {
        "to_tensor": [((x34,), {}, EW), ((x34,), {"dtype": "int32"}, EW)],
        "zeros": [(((2, 3),), {}, EW), (((2, 3), "int32"), {}, EW)],
        "ones": [(((2, 3),), {}, EW)],
        "full": [(((2, 3), 1.5), {}, EW), (((2,), 7, "int32"), {}, EW)],
        "zeros_like": [((x34,), {}, EW), ((x34, "int32"), {}, EW)],
        "ones_like": [((x34,), {}, EW)],
        "full_like": [((x34, 2.5), {}, EW)],
        "arange": [((5,), {}, EW), ((1, 7, 2), {}, EW),
                   ((0.0, 1.0, 0.25), {}, EW)],
        "linspace": [((0.0, 1.0, 7), {}, EW)],
        "eye": [((3,), {}, EW), ((3, 4), {}, EW)],
        "empty": [(((2, 3),), {}, EW)],
        "matmul": [((x34, f32(r, 4, 2)), {}, RED)],
        "add": [((x34, y34), {}, EW), ((x34, 1.5), {}, EW)],
        "subtract": [((x34, y34), {}, EW)],
        "multiply": [((x34, y34), {}, EW)],
        "divide": [((x34, p34), {}, EW),
                   ((ints(r, 1, 9, 4), ints(r, 1, 5, 4)), {}, EW)],
        "pow": [((p34, y34), {}, EW)],
        "sqrt": [((p34,), {}, EW)],
        "rsqrt": [((p34,), {}, EW)],
        "exp": [((x34,), {}, EW)],
        "log": [((p34,), {}, EW)],
        "abs": [((x34,), {}, EW)],
        "mean": [((x34,), {}, RED), ((x34,), {"axis": 1, "keepdims": True},
                                     RED),
                 ((ints(r, 0, 9, 3, 4),), {"axis": 0}, RED)],
        "sum": [((x34,), {}, RED), ((x34,), {"axis": (0, 1)}, RED),
                ((mask,), {"axis": 1}, RED)],
        "max": [((x34,), {"axis": 1}, EW), ((x34,), {}, EW)],
        "min": [((x34,), {"axis": 0, "keepdims": True}, EW)],
        "argmax": [((x34,), {"axis": 1}, EW), ((x34,), {}, EW)],
        "argmin": [((x34,), {"axis": 0}, EW)],
        "maximum": [((x34, y34), {}, EW)],
        "minimum": [((x34, y34), {}, EW)],
        "clip": [((x34, -0.5, 0.5), {}, EW)],
        "reshape": [((x34, (4, 3)), {}, EW), ((x34, (-1,)), {}, EW)],
        "transpose": [((x34,), {}, EW),
                      ((f32(r, 2, 3, 4), (1, 0, 2)), {}, EW)],
        "squeeze": [((f32(r, 1, 3, 1),), {}, EW),
                    ((f32(r, 1, 3, 1), 2), {}, EW)],
        "unsqueeze": [((x34, 1), {}, EW), ((x34, (0, 3)), {}, EW)],
        "concat": [(([x34, y34],), {"axis": 1}, EW),
                   (([x34, y34],), {"axis": None}, EW)],
        "stack": [(([x34, y34],), {"axis": 1}, EW)],
        "split": [((f32(r, 6, 4), 3), {}, EW),
                  ((f32(r, 6, 4), [2, 5]), {}, EW),
                  ((f32(r, 4, 6), [1, 4]), {"axis": 1}, EW)],
        "where": [((mask, x34, y34), {}, EW), ((mask, x34, 0.0), {}, EW)],
        "cast": [((x34 * 4, "int32"), {}, EW), ((x34, "float16"), {}, 1e-3)],
        "tanh": [((x34,), {}, EW)],
        "sin": [((x34,), {}, EW)],
        "cos": [((x34,), {}, EW)],
        "floor": [((x34,), {}, EW)],
        "ceil": [((x34,), {}, EW)],
        "round": [((np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1.2], np.float32),),
                   {}, EW), ((x34 * 10, 1), {}, EW)],
        "sign": [((x34,), {}, EW)],
        "cumsum": [((x34,), {"axis": 1}, RED), ((x34,), {}, RED)],
        "cumprod": [((x34,), {"axis": 0}, RED)],
        "sort": [((x34,), {}, EW), ((ties,), {"descending": True}, EW),
                 ((x34,), {"axis": None}, EW)],
        "argsort": [((ties,), {}, EW), ((ties,), {"descending": True}, EW),
                    ((ties,), {"axis": 0}, EW)],
        "gather": [((x34, np.array([2, 0, 2], np.int32)), {}, EW),
                   ((x34, np.array([3, -1, 0], np.int32)), {"axis": 1}, EW),
                   ((x34, np.array([[1, 5], [-4, 0]], np.int32)),
                    {"axis": 1}, EW)],
        "einsum": [(("ij,jk->ik", x34, f32(r, 4, 2)), {}, RED)],
        "tril": [((x34,), {}, EW), ((x34, 1), {}, EW)],
        "triu": [((x34, -1), {}, EW)],
        "topk": [((x34, 2), {}, EW), ((ties, 3), {}, EW),
                 ((ties, 2), {"largest": False}, EW),
                 ((x34, 2), {"axis": 0}, EW)],
        "flatten": [((f32(r, 2, 3, 4), 1), {}, EW),
                    ((f32(r, 2, 3, 4), 0, 1), {}, EW)],
        "gather_nd": [((x34, np.array([[0, 1], [2, 3]], np.int32)), {}, EW),
                      ((x34, np.array([[1], [2]], np.int32)), {}, EW)],
        "scatter": [((f32(r, 5, 3), np.array([1, 3], np.int32),
                      f32(r, 2, 3)), {}, EW),
                    ((f32(r, 5, 3), np.array([1, 3, 1], np.int32),
                      f32(r, 3, 3)), {"overwrite": False}, EW)],
        "scatter_nd_add": [((f32(r, 5, 3), np.array([[1], [3], [1]],
                                                    np.int32),
                             f32(r, 3, 3)), {}, EW)],
        "put_along_axis": [((x34, np.array([[0], [2], [3]], np.int32),
                             f32(r, 3, 1), 1), {}, EW),
                           ((x34, np.array([[1, 0, 2, 1]], np.int32), 9.0,
                             0), {}, EW)],
        "isnan": [((_with_nan(r, 3, 4),), {}, EW)],
        "isinf": [((np.array([1.0, np.inf, -np.inf, np.nan], np.float32),),
                   {}, EW)],
        "isfinite": [((np.array([1.0, np.inf, -np.inf, np.nan],
                                np.float32),), {}, EW)],
        "equal": [((ints(r, 0, 3, 3, 4), ints(r, 0, 3, 3, 4)), {}, EW)],
        "not_equal": [((ints(r, 0, 3, 3, 4), ints(r, 0, 3, 3, 4)), {}, EW)],
        "greater_than": [((x34, y34), {}, EW)],
        "less_than": [((x34, y34), {}, EW)],
        "logical_and": [((mask, y34 > 0), {}, EW)],
        "logical_or": [((mask, y34 > 0), {}, EW)],
        "logical_not": [((mask,), {}, EW)],
        "all": [((mask,), {"axis": 1}, EW), ((mask,), {}, EW)],
        "any": [((mask,), {"axis": 0}, EW)],
        "square": [((x34,), {}, EW)],
        "log_softmax": [((x34,), {}, EW), ((x34,), {"axis": 0}, EW)],
        "softmax": [((x34,), {}, EW)],
        "var": [((x34,), {}, RED), ((x34,), {"axis": 1}, RED),
                ((x34,), {"axis": 0, "ddof": 1}, RED)],
        "std": [((x34,), {"axis": 1}, RED), ((x34,), {"keepdims": True},
                                             RED)],
        "norm": [((x34,), {}, RED), ((x34, 1), {"axis": 1}, RED),
                 ((x34, float("inf")), {}, RED),
                 ((x34, "fro"), {"axis": (0, 1)}, RED),
                 ((x34, "nuc"), {"axis": (0, 1)}, RED),
                 ((f32(r, 2, 3, 4),), {"keepdim": True}, RED)],
        "dot": [((v4, w4), {}, RED), ((x34, y34), {}, RED)],
        "outer": [((v4, f32(r, 3)), {}, EW)],
        "roll": [((x34, 1), {"axis": 1}, EW), ((x34, 2), {}, EW)],
        "flip": [((x34,), {"axis": 1}, EW), ((x34,), {}, EW)],
        "tile": [((x34, (2, 1)), {}, EW), ((v4, 2), {}, EW)],
        "repeat_interleave": [((x34, 2), {"axis": 0}, EW),
                              ((v4, 2), {}, EW)],
        "broadcast_to": [((v4, (3, 4)), {}, EW)],
        "expand": [((f32(r, 3, 1), (3, 4)), {}, EW)],
        "take_along_axis": [((x34, np.array([[0, 3], [1, 1], [2, -1]],
                                            np.int32)), {"axis": 1}, EW)],
        "index_select": [((x34, np.array([2, 0], np.int32)), {}, EW),
                         ((x34, np.array([3, 1], np.int32)), {"axis": 1},
                          EW)],
        "masked_select": [((x34, mask), {}, EW)],
        "numel": [((x34,), {}, EW)],
        "diag": [((v4,), {}, EW), ((x34,), {}, EW), ((v4, 1), {}, EW)],
        "bincount": [((ints(r, 0, 6, 20),), {}, EW),
                     ((ints(r, 0, 4, 10),), {"minlength": 7}, EW)],
        "kron": [((f32(r, 2, 2), f32(r, 2, 3)), {}, EW)],
        "trace": [((x34,), {}, RED), ((x34, 1), {}, RED)],
        "diagonal": [((x34,), {}, EW), ((x34, -1), {}, EW)],
        "meshgrid": [((v4, f32(r, 3)), {}, EW),
                     ((v4, f32(r, 3)), {"indexing": "ij"}, EW),
                     ((v4, f32(r, 3)), {"sparse": True}, EW)],
        "logsumexp": [((x34,), {"axis": 1}, RED), ((x34,), {}, RED),
                      ((x34,), {"axis": 0, "b": p34, "keepdims": True},
                       RED)],
        "nanmean": [((_with_nan(r, 3, 4),), {"axis": 1}, RED)],
        "nansum": [((_with_nan(r, 3, 4),), {}, RED)],
        "amax": [((x34,), {"axis": 0}, EW)],
        "amin": [((x34,), {"axis": 1}, EW)],
        "diff": [((x34,), {}, EW), ((x34,), {"axis": 0, "n": 2}, EW)],
        "searchsorted": [((seq, f32(r, 5)), {}, EW),
                         ((seq, seq[2:5]), {"right": True}, EW)],
        "bucketize": [((f32(r, 5), seq), {}, EW)],
        "histogram": [((f32(r, 50),), {"bins": 6}, EW),
                      ((f32(r, 50), 4, -1.0, 1.0), {}, EW)],
        "lerp": [((x34, y34, 0.3), {}, EW)],
        "addmm": [((f32(r, 3, 2), x34, f32(r, 4, 2)),
                   {"beta": 0.5, "alpha": 2.0}, RED)],
        "logaddexp": [((x34, y34), {}, EW)],
        "heaviside": [((np.array([-1.0, 0.0, 2.0], np.float32),
                        np.array([0.5, 0.5, 0.5], np.float32)), {}, EW)],
        "rad2deg": [((x34,), {}, EW)],
        "deg2rad": [((x34 * 90,), {}, EW)],
        "frac": [((x34 * 3,), {}, EW)],
        "trunc": [((x34 * 3,), {}, EW)],
        "expm1": [((x34,), {}, EW)],
        "log1p": [((p34,), {}, EW)],
        "log2": [((p34,), {}, EW)],
        "log10": [((p34,), {}, EW)],
        "atan2": [((x34, y34), {}, EW)],
        "hypot": [((x34, y34), {}, EW)],
        "copysign": [((x34, y34), {}, EW)],
        "nextafter": [((x34, y34), {}, 0.0)],
        "gcd": [((ints(r, 1, 30, 6), ints(r, 1, 30, 6)), {}, EW)],
        "lcm": [((ints(r, 1, 12, 6), ints(r, 1, 12, 6)), {}, EW)],
        "isclose": [((x34, x34 + 1e-6), {}, EW),
                    ((x34, y34), {"atol": 1.0}, EW)],
        "allclose": [((x34, x34 + 1e-7), {}, EW), ((x34, y34), {}, EW)],
        "inner": [((x34, y34), {}, RED)],
        "cross": [((f32(r, 2, 3), f32(r, 2, 3)), {}, EW)],
        "clone": [((x34,), {}, EW)],
        "rot90": [((x34,), {}, EW), ((x34, 3), {}, EW)],
        "vander": [((v4,), {}, EW), ((v4, 3, True), {}, EW)],
        "nonzero": [((mask,), {}, EW), ((mask, True), {}, EW)],
        "median": [((x34,), {"axis": 1}, EW), ((f32(r, 5, 3),),
                                               {"axis": 0}, EW),
                   ((x34,), {}, EW)],
        "quantile": [((x34, 0.3), {"axis": 1}, RED),
                     ((x34, np.array([0.1, 0.9], np.float32)), {}, RED),
                     ((f32(r, 2, 3, 4), 0.5), {"axis": (0, 2),
                                               "keepdim": True}, RED)],
        "mode": [((np.array([[2, 1, 2, 1, 3], [5, 5, 4, 4, 4]],
                            np.int32),), {}, EW),
                 ((np.array([[2, 1], [1, 1], [2, 3]], np.int32),),
                  {"axis": 0, "keepdim": True}, EW)],
        "unique": [((np.array([3, 1, 2, 3, 1, 0], np.int32),), {}, EW),
                   ((np.array([3, 1, 2, 3, 1, 0], np.int32), True, True,
                     True), {}, EW)],
        "unbind": [((x34, 1), {}, EW)],
        "chunk": [((f32(r, 7, 2), 3), {}, EW)],
        "masked_fill": [((x34, mask, 0.0), {}, EW)],
        "logcumsumexp": [((x34,), {"axis": 1}, RED), ((x34,), {}, RED)],
        "tensordot": [((x34, f32(r, 4, 2), 1), {}, RED),
                      ((f32(r, 2, 3, 4), f32(r, 3, 4, 2)), {}, RED)],
        "renorm": [((x34, 2.0, 0, 1.0), {}, EW)],
        "scatter_nd": [((np.array([[1], [3], [1]], np.int32), f32(r, 3, 2),
                         (5, 2)), {}, EW)],
        "mv": [((x34, v4), {}, RED)],
        "bmm": [((f32(r, 2, 3, 4), f32(r, 2, 4, 2)), {}, RED)],
        "dist": [((x34, y34), {}, RED), ((x34, y34, float("inf")), {}, RED),
                 ((x34, y34, 0), {}, RED), ((x34, y34, 3), {}, RED)],
        "cdist": [((f32(r, 3, 4), f32(r, 5, 4)), {}, RED),
                  ((f32(r, 3, 4), f32(r, 5, 4), 1.0), {}, RED),
                  ((f32(r, 3, 4), f32(r, 5, 4), float("inf")), {}, RED),
                  ((f32(r, 3, 4), f32(r, 5, 4), 3.0), {}, RED)],
        "trapezoid": [((x34,), {}, RED), ((x34, None, 0.5), {}, RED),
                      ((v4, np.cumsum(pos(r, 4))), {}, RED)],
        "cumulative_trapezoid": [((x34,), {}, RED),
                                 ((x34, None, 0.5), {"axis": 0}, RED)],
        "nanmedian": [((_with_nan(r, 3, 4),), {"axis": 1}, EW)],
        "kthvalue": [((ties, 2), {}, EW), ((x34, 2), {"axis": 0,
                                                       "keepdim": True}, EW)],
        "unique_consecutive": [
            ((np.array([1, 1, 2, 2, 3, 1, 1, 2], np.int32),), {}, EW),
            ((np.array([1, 1, 2, 2, 3, 1, 1, 2], np.int32), True, True),
             {}, EW),
            ((np.array([[1, 1], [1, 1], [2, 0]], np.int32),), {"axis": 0},
             EW)],
        "diagflat": [((v4,), {}, EW), ((f32(r, 2, 2), 1), {}, EW)],
        "frexp": [((x34,), {}, EW)],
        "ldexp": [((x34, ints(r, -3, 4, 3, 4)), {}, EW)],
        "lgamma": [((p34,), {}, RED)],
        "digamma": [((p34,), {}, RED)],
        "polygamma": [((p34, 1), {}, RED)],
        "erfinv": [((f32(r, 3, 4, lo=-0.9, hi=0.9),), {}, RED)],
        "i0": [((x34,), {}, RED)],
        "i0e": [((x34,), {}, RED)],
        "i1": [((x34,), {}, RED)],
        "i1e": [((x34,), {}, RED)],
        "sinc": [((x34,), {}, EW)],
        "histogramdd": [((f32(r, 20, 2),), {"bins": 3}, EW),
                        ((f32(r, 20, 2),), {"bins": [2, 3],
                                            "ranges": [(-1.0, 1.0),
                                                       (-2.0, 2.0)],
                                            "density": True}, RED)],
        "logspace": [((0.0, 2.0, 5), {}, RED), ((0.0, 3.0, 4, 2.0), {}, RED)],
        "masked_scatter": [((x34, mask, f32(r, 12)), {}, EW)],
        "index_put": [((x34, (np.array([0, 2], np.int32),
                              np.array([1, 3], np.int32)), f32(r, 2)), {},
                       EW),
                      ((x34, (np.array([0, 0], np.int32),
                              np.array([1, 1], np.int32)), f32(r, 2), True),
                       {}, EW)],
        "unflatten": [((f32(r, 2, 12), 1, (3, -1)), {}, EW)],
        "tensor_split": [((f32(r, 7, 2), 3), {}, EW),
                         ((f32(r, 7, 2), [1, 3]), {}, EW)],
        "vsplit": [((f32(r, 6, 2), 3), {}, EW)],
        "hsplit": [((f32(r, 2, 6), [2, 3]), {}, EW), ((f32(r, 6), 2), {},
                                                      EW)],
        "dsplit": [((f32(r, 2, 2, 4), 2), {}, EW)],
        "as_strided": [((x34, (2, 2), (1, 2), 1), {}, EW)],
        "unfold": [((f32(r, 2, 8), 1, 3, 2), {}, EW),
                   ((f32(r, 7, 2), 0, 2, 2), {}, EW)],
        "view": [((x34, [4, 3]), {}, EW), ((x34, "int32"), {}, EW)],
        "view_as": [((x34, f32(r, 2, 6)), {}, EW)],
        "is_tensor": [((x34,), {}, EW)],
        "rank": [((x34,), {}, EW)],
        "reshape_": [((x34, (2, 6)), {}, EW)],
        "squeeze_": [((f32(r, 1, 3, 1),), {}, EW)],
        "unsqueeze_": [((x34, 0), {}, EW)],
        "clip_": [((x34, -0.3, 0.4), {}, EW)],
        "mm": [((x34, f32(r, 4, 2)), {}, RED)],
        "prod": [((p34,), {"axis": 1}, RED), ((p34,), {}, RED),
                 ((p34,), {"axis": (0, 1), "keepdim": True}, RED)],
        "tan": [((x34,), {}, EW)],
        "sigmoid": [((x34,), {}, EW)],
        "erf": [((x34,), {}, EW)],
        "floor_divide": [((ints(r, -9, 9, 6), ints(r, 1, 4, 6)), {}, EW),
                         ((x34, p34), {}, EW)],
        "remainder": [((ints(r, -9, 9, 6), ints(r, 1, 4, 6)), {}, EW),
                      ((x34, p34), {}, EW)],
        "mod": [((ints(r, -9, 9, 6), -ints(r, 1, 4, 6)), {}, EW)],
        "real": [((cplx(r, 3),), {}, EW), ((x34,), {}, EW)],
        "imag": [((cplx(r, 3),), {}, EW)],
        "conj": [((cplx(r, 3),), {}, EW)],
        "angle": [((cplx(r, 3),), {}, EW)],
        "as_complex": [((f32(r, 3, 2),), {}, EW)],
        "as_real": [((cplx(r, 3),), {}, EW)],
        "broadcast_shape": [(([3, 1], [1, 4]), {}, EW)],
        "take": [((x34, np.array([0, 5, -1, 20, -30], np.int32)), {}, EW),
                 ((x34, np.array([0, 13, -14], np.int32)),
                  {"mode": "wrap"}, EW)],
        "index_add": [((f32(r, 5, 3), np.array([1, 3, 1], np.int32), 0,
                        f32(r, 3, 3)), {}, EW)],
        "cov": [((x34,), {}, RED), ((x34,), {"rowvar": False,
                                             "ddof": False}, RED)],
        "corrcoef": [((x34,), {}, RED)],
        "nanquantile": [((_with_nan(r, 3, 4), 0.5), {"axis": 1}, RED),
                        ((_with_nan(r, 3, 4), 0.25), {}, RED)],
    }


RANDOM = ("rand", "randn", "randint", "randperm", "uniform", "normal",
          "multinomial")
CASES = _cases(np.random.default_rng(0))
PARAMS = [pytest.param(name, i, id=f"{name}-{i}")
          for name in JAX_NAMES if name not in RANDOM + ("set_printoptions",)
          for i in range(len(CASES.get(name, [None])))]


def test_every_public_name_of_the_jax_module_is_ported():
    assert len(JAX_NAMES) > 200
    missing = [n for n in JAX_NAMES if not callable(getattr(tt, n, None))]
    assert missing == []
    assert set(JAX_NAMES) <= set(tt.__all__)
    covered = set(CASES) | set(RANDOM) | {"set_printoptions"}
    assert sorted(set(JAX_NAMES) - covered) == []


_KEPT = object()  # a result leaf the trace left a Python value


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX module's result for every parametrised case, from one
    ``jax.jit`` over all of them. A case whose function cannot be traced
    (``nonzero``, ``unique``: the result's shape depends on the data) is
    called eagerly; a result leaf that is not a tracer (a shape, a flag)
    is the Python value the eager call returns, and is kept as it is."""
    keys = [tuple(p.values) for p in PARAMS]
    eager, kept, trees = set(), {}, {}

    def all_cases(data):
        outs = []
        for key, d in zip(keys, data):
            args, kw, _ = CASES[key[0]][key[1]]
            it = iter(d)
            full = [next(it) if _is_data(a) else a for a in args]
            try:
                out = getattr(jt, key[0])(*full, **kw)
            except Exception:
                eager.add(key)
                outs.append([])
                continue
            leaves, trees[key] = jax.tree_util.tree_flatten(out)
            traced = [isinstance(v, jax.core.Tracer) for v in leaves]
            kept[key] = [_KEPT if t else v for v, t in zip(leaves, traced)]
            outs.append([v for v, t in zip(leaves, traced) if t])
        return outs

    data = [[a for a in CASES[n][i][0] if _is_data(a)] for n, i in keys]
    outs = jax.jit(all_cases)(data)
    refs = {}
    for key, traced in zip(keys, outs):
        args, kw, _ = CASES[key[0]][key[1]]
        if key in eager:
            refs[key] = getattr(jt, key[0])(
                *[_to("jax", a) for a in args], **kw)
            continue
        it = iter(traced)
        refs[key] = jax.tree_util.tree_unflatten(
            trees[key], [next(it) if v is _KEPT else v for v in kept[key]])
    return refs


@pytest.mark.parametrize("name,i", PARAMS)
def test_name_matches_jax(name, i, jax_refs):
    args, kw, tol = CASES[name][i]
    got = getattr(tt, name)(*[_to("torch", a) for a in args], **kw)
    check(got, jax_refs[name, i], tol)


# ---------------------------------------------------------------- traps
def test_std_and_var_are_population_statistics():
    x = f32(np.random.default_rng(1), 4, 5)
    got, _ = run_both("std", (x,), {"axis": 1}, RED)
    assert not torch.allclose(got, torch.from_numpy(x).std(dim=1))
    got, _ = run_both("var", (x,), {}, RED)
    assert torch.allclose(got, torch.from_numpy(x).var(correction=0))


def test_split_takes_cut_indices_and_equal_counts():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    got, _ = run_both("split", (x, [1, 4]))
    assert [p.shape[0] for p in got] == [1, 3, 2]
    with pytest.raises(ValueError):
        tt.split(torch.from_numpy(x), 4)
    with pytest.raises(ValueError):
        jt.split(jnp.asarray(x), 4)


def test_sort_and_argsort_keep_tie_order():
    a = np.array([2, 1, 2, 1, 2, 0, 1], np.float32)
    got, _ = run_both("argsort", (a,))
    assert got.tolist() == [5, 1, 3, 6, 0, 2, 4]
    got, _ = run_both("argsort", (a,), {"descending": True})
    assert got.tolist() == [0, 2, 4, 1, 3, 6, 5]


def test_gather_is_jnp_take():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got, _ = run_both("gather", (x, np.array([-1, 1, 5], np.int32)))
    assert got[0].tolist() == x[2].tolist()
    assert torch.isnan(got[2]).all()
    got, _ = run_both("gather", (np.arange(5, dtype=np.int32),
                                 np.array([7, -6], np.int32)))
    assert got.tolist() == [torch.iinfo(torch.int32).min] * 2


def test_unique_and_consecutive_index_rules():
    a = np.array([4, 2, 4, 3, 2, 2], np.int32)
    (vals, first, inv, cnt), _ = run_both("unique", (a, True, True, True))
    assert first.tolist() == [1, 3, 0]
    assert vals[inv].tolist() == a.tolist()
    assert cnt.tolist() == [3, 1, 2]
    got, _ = run_both("unique_consecutive", (a, True, True))
    assert got[0].tolist() == [4, 2, 4, 3, 2]


def test_median_mode_topk_kthvalue_tie_rules():
    got, _ = run_both("median", (np.array([4, 1, 3, 2], np.float32),))
    assert float(got) == 2.5  # torch.median gives 2
    vals, idx = run_both("mode", (np.array([3, 1, 3, 1, 2], np.int32),))[0]
    assert (int(vals), int(idx)) == (1, 1)  # the smallest modal value
    vals, idx = run_both("topk", (np.array([1, 5, 5, 2, 5], np.float32),
                                  2))[0]
    assert idx.tolist() == [1, 2]
    vals, idx = run_both("kthvalue", (np.array([3, 1, 1, 2], np.float32),
                                      2))[0]
    assert (float(vals), int(idx)) == (1.0, 2)


def test_to_tensor_widths_place_and_stop_gradient():
    ints64 = np.arange(3, dtype=np.int64)
    assert tt.to_tensor(ints64).dtype == torch.int64
    assert jt.to_tensor(ints64).dtype == jnp.int32  # x64 off
    assert tt.to_tensor(np.ones(2)).dtype == torch.float64
    assert tt.to_tensor([1.0, 2.0]).dtype == torch.float32
    assert tt.to_tensor([1, 2]).dtype == torch.int64
    assert tt.to_tensor(3.5).dtype == torch.float32
    assert tt.to_tensor(True).dtype == torch.bool
    t = tt.to_tensor([1.0, 2.0], stop_gradient=False, place="cpu")
    assert t.requires_grad and t.device.type == "cpu"
    src = torch.ones(2)
    assert tt.to_tensor(src).data_ptr() != src.data_ptr()
    assert not tt.to_tensor([1.0]).requires_grad


def test_random_functions_shape_dtype_range_and_seed_repeat():
    draws = {
        "rand": lambda: tt.rand((3, 4)),
        "randn": lambda: tt.randn((3, 4)),
        "randint": lambda: tt.randint(2, 9, (50,)),
        "randperm": lambda: tt.randperm(10),
        "uniform": lambda: tt.uniform((40,), min=-2.0, max=3.0),
        "normal": lambda: tt.normal(1.0, 0.5, (2, 3)),
        "multinomial": lambda: tt.multinomial(
            torch.tensor([[0.1, 0.0, 0.9, 0.5], [1.0, 1.0, 0.0, 1.0]]), 3),
    }
    trandom.seed(123)
    first = {k: f() for k, f in draws.items()}
    trandom.seed(123)
    again = {k: f() for k, f in draws.items()}
    for k in draws:
        assert torch.equal(first[k], again[k]), k
    jref = {"rand": jt.rand((3, 4)), "randn": jt.randn((3, 4)),
            "randint": jt.randint(2, 9, (50,)), "randperm": jt.randperm(10),
            "uniform": jt.uniform((40,), min=-2.0, max=3.0),
            "normal": jt.normal(1.0, 0.5, (2, 3)),
            "multinomial": jt.multinomial(
                jnp.asarray([[0.1, 0.0, 0.9, 0.5], [1.0, 1.0, 0.0, 1.0]]),
                3)}
    for k, v in first.items():
        assert tuple(v.shape) == tuple(jref[k].shape), k
        assert _kind(_np(v).dtype) == _kind(np.asarray(jref[k]).dtype), k
    assert first["rand"].dtype == torch.float32
    assert 0 <= float(first["rand"].min()) and float(first["rand"].max()) < 1
    assert 2 <= int(first["randint"].min()) and int(
        first["randint"].max()) < 9
    assert sorted(first["randperm"].tolist()) == list(range(10))
    assert -2 <= float(first["uniform"].min()) and float(
        first["uniform"].max()) < 3
    m = first["multinomial"]
    assert (m[0] != 1).all() and (m[1] != 2).all()  # zero-probability
    for row in m:
        assert len(set(row.tolist())) == 3  # without replacement
    with pytest.raises(ValueError):
        tt.multinomial(torch.tensor([0.5, 0.0, 0.5]), 3)
    trandom.seed(7)
    a = tt.randn((4,))
    b = tt.randn((4,))
    assert not torch.equal(a, b)


def test_set_printoptions_sets_torch_printing():
    saved_np = np.get_printoptions()
    try:
        jt.set_printoptions(precision=2)
        tt.set_printoptions(precision=2)
        assert "1.23" in str(torch.tensor([1.23456]))
        assert "1.23" in str(np.array([1.23456]))
    finally:
        torch.set_printoptions(profile="default")
        np.set_printoptions(**saved_np)


def test_inplace_spellings():
    x = torch.zeros(1, 3, 1)
    assert tt.squeeze_(x) is x and x.shape == (3,)
    assert tt.unsqueeze_(x, 0) is x and x.shape == (1, 3)
    y = torch.tensor([-2.0, 0.5, 3.0])
    tt.clip_(y, -1.0, 1.0)
    assert y.tolist() == [-1.0, 0.5, 1.0]
    z = torch.arange(6.0)
    r = tt.reshape_(z, (2, 3))
    assert r.shape == (2, 3) and z.shape == (6,)


def test_signatures_keep_jax_parameter_names():
    """Every name's parameters are the JAX function's (its ``jnp``
    alias's for the aliases), plus the port's ``device=``."""
    skip = {"_"}
    bad = []
    for name in JAX_NAMES:
        jf = getattr(jt, name)
        try:
            jparams = list(inspect.signature(jf).parameters)
        except (TypeError, ValueError):
            continue
        if jparams in (["args", "kwargs"],) or name in skip:
            continue
        tparams = [p for p in inspect.signature(getattr(tt, name)).parameters
                   if p != "device"]
        if jparams != tparams:
            bad.append((name, jparams, tparams))
    assert bad == []


# ------------------------------------------------------------- top level
TOP_LEVEL = (
    "amp", "autograd", "incubate", "io", "nn", "optimizer", "utils",
    "vision", "distributed", "inference", "models", "observability",
    "Model", "callbacks", "summary", "flops", "bfloat16", "bool_", "bool",
    "complex64", "complex128", "float16", "float32", "float64", "int8",
    "int16", "int32", "int64", "uint8", "get_default_dtype",
    "set_default_dtype", "Layer", "Parameter", "ParamAttr",
    "functional_call", "seed", "get_rng_state_tracker", "to_tensor", "save",
    "load", "iinfo", "finfo", "Tensor", "CPUPlace", "CUDAPlace", "XPUPlace",
    "DataParallel", "__version__", "no_grad", "grad", "set_grad_enabled",
    "is_grad_enabled", "get_device", "set_device")
# what waits for a later slice (nothing now), and what is about JAX itself
NOT_YET = set()
JAX_ONLY = {"jax", "jnp", "jax_compat", "dtype_mod", "annotations",
            "builtins"}


def test_top_level_names():
    """Every name of the JAX top level is in the port's, but those about
    JAX itself. (Which submodules are
    attributes depends on what the process imported, so a module counts
    where the port has one of its name.)"""
    import importlib.util

    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt

    missing = [n for n in TOP_LEVEL + tuple(JAX_NAMES)
               if not hasattr(tpt, n)]
    assert missing == []
    public = [n for n in dir(jpt) if not n.startswith("_")]
    absent = {n for n in public if not hasattr(tpt, n)
              and not (inspect.ismodule(getattr(jpt, n))
                       and importlib.util.find_spec(
                           f"paddle_tpu_torch.{n}") is not None)}
    assert absent == NOT_YET | JAX_ONLY
    assert tpt.Tensor is torch.Tensor and tpt.bool is torch.bool
    assert tpt.__version__ == jpt.__version__
    assert tpt.iinfo("int32").max == jpt.iinfo("int32").max
    assert tpt.finfo("bfloat16").eps == float(jpt.finfo("bfloat16").eps)
    assert tpt.finfo(tpt.float32).tiny == float(jpt.finfo("float32").tiny)
    assert tpt.CUDAPlace(1).device == torch.device("cuda", 1)
    assert tpt.CUDAPlace(1) == tpt.CUDAPlace(1) != tpt.CUDAPlace(0)
    assert tpt.XPUPlace is tpt.CUDAPlace
    assert tpt.CPUPlace() == tpt.CPUPlace()
    assert tpt.to_tensor([1.0], place=tpt.CPUPlace()).device.type == "cpu"
    assert tpt.get_rng_state_tracker() is tpt.get_rng_state_tracker()


def test_data_parallel_is_a_passthrough_with_the_inner_state_dict(tmp_path):
    import paddle_tpu_torch as tpt

    inner = tpt.nn.Linear(3, 2, device="cpu")
    dp = tpt.DataParallel(inner)
    x = torch.randn(4, 3)
    assert torch.equal(dp(x), inner(x))
    assert set(dp.state_dict()) == set(inner.state_dict()) == {"weight",
                                                               "bias"}
    assert dp.weight is inner.weight  # attributes reach the wrapped layer
    path = str(tmp_path / "m.pdparams")
    tpt.save(dp.state_dict(), path)
    bare = tpt.nn.Linear(3, 2, device="cpu")
    bare.set_state_dict(tpt.load(path, device="cpu"))
    assert torch.equal(bare(x), inner(x))
    dp2 = tpt.DataParallel(tpt.nn.Linear(3, 2, device="cpu"))
    dp2.set_state_dict(tpt.load(path, device="cpu"))
    assert torch.equal(dp2(x), inner(x))


def test_rng_state_tracker_scopes_a_seeded_generator():
    tracker = trandom.RNGStatesTracker()
    tracker.add("global_seed", 11)
    tracker.add("local_seed", 12)
    with pytest.raises(ValueError):
        tracker.add("other", 11)
    with pytest.raises(ValueError):
        tracker.add("local_seed", 13)
    with tracker.rng_state("local_seed", device="cpu"):
        a = tt.rand((3,))
    with tracker.rng_state("local_seed", device="cpu"):
        b = tt.rand((3,))
    assert torch.equal(a, b)
    with tracker.rng_state("global_seed", device="cpu"):
        assert not torch.equal(tt.rand((3,)), a)
    assert tracker.get_states_tracker() == {"global_seed": 11,
                                            "local_seed": 12}
    trandom.model_parallel_random_seed(5, tp_rank=2)
    assert trandom.get_rng_state_tracker().get_states_tracker() == {
        "global_seed": 5, "local_seed": 5 + 1024 + 2}
    with pytest.raises(ValueError):
        with tracker.rng_state("missing"):
            pass
    arr = np.arange(10)
    np.testing.assert_array_equal(trandom.shuffle_numpy(arr, 3),
                                  np.random.default_rng(3).permutation(10))


def test_utils_version_and_dlpack_match_jax():
    import paddle_tpu.utils as jutils
    import paddle_tpu.version as jversion
    import paddle_tpu_torch.utils as tutils
    import paddle_tpu_torch.version as tversion

    assert tversion.show() == jversion.show()
    assert (tversion.major, tversion.minor, tversion.patch) == (
        jversion.major, jversion.minor, jversion.patch)
    assert tutils.__all__ == jutils.__all__
    x = torch.arange(6.0).reshape(2, 3)
    back = tutils.dlpack.from_dlpack(tutils.dlpack.to_dlpack(x))
    assert torch.equal(back, x) and back.data_ptr() == x.data_ptr()
    assert torch.equal(tutils.dlpack.from_dlpack(np.arange(3.0)),
                       torch.arange(3.0, dtype=torch.float64))
    jx = jutils.dlpack.from_dlpack(x)  # the port's tensor into JAX
    np.testing.assert_array_equal(np.asarray(jx), x.numpy())

    @tutils.deprecated(update_to="new_fn", since="0.1", level=1)
    def old():
        return 3

    with pytest.warns(DeprecationWarning, match="new_fn"):
        assert old() == 3
    with pytest.raises(RuntimeError):
        tutils.deprecated(level=2)(lambda: 1)()
    assert tutils.deprecated(level=0)(lambda: 5)() == 5
    assert tutils.try_import("math").sqrt(4.0) == 2.0
    with pytest.raises(ImportError, match="needed"):
        tutils.try_import("no_such_module_here", "needed")
    gen = tutils.unique_name
    names = [gen.generate("fc") for _ in range(2)]
    with gen.guard():
        inner = gen.generate("fc")
    assert names == ["fc_0", "fc_1"] and inner == "fc_0"
    assert gen.generate("fc") == "fc_2"
    tutils.run_check()  # the module fixture made the CPU current
