"""``paddle_tpu_torch.sparse`` (COO and CSR on torch's sparse layouts)
against ``paddle_tpu.sparse`` (BCOO/BCSR), ``tests/test_sparse.py``'s
cases on both packages: construction (shape inferred, duplicates),
conversions, ``nnz`` before and after ``coalesce``, the elementwise ops
with sparse and dense operands (a sparse minus a dense one raises in
both), ``matmul`` (sparse @ dense and sparse @
sparse), ``masked_matmul`` (only the mask's entries), ``transpose``,
``relu``, and ``sparse.nn``'s ReLU, LeakyReLU, row Softmax and BatchNorm
(training and eval, the running statistics). Dense views agree at 1e-5
(float32)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu import sparse as js
from paddle_tpu_torch import sparse as ts
from paddle_tpu_torch.core import device as core_device


@pytest.fixture(autouse=True)
def on_cpu():
    saved = core_device._current
    tpt.set_device("cpu")
    yield
    core_device.set_current(saved)


def dense(x):
    if isinstance(x, torch.Tensor):
        return ts.to_dense(x).detach().numpy()
    return np.asarray(js.to_dense(x))


def near(got, want, tol=1e-5):
    np.testing.assert_allclose(dense(got), dense(want), rtol=tol, atol=tol)


RNG = np.random.default_rng(0)
IDX = np.array([[0, 1, 2, 2, 0], [1, 0, 3, 3, 2]])  # (2, 3) twice
VAL = RNG.standard_normal(5).astype(np.float32)
D = RNG.standard_normal((3, 4)).astype(np.float32)
W = RNG.standard_normal((4, 5)).astype(np.float32)


def pair():
    return (ts.sparse_coo_tensor(torch.tensor(IDX), torch.tensor(VAL),
                                 (3, 4)),
            js.sparse_coo_tensor(jnp.asarray(IDX), jnp.asarray(VAL),
                                 (3, 4)))


def test_construction_conversion_and_nnz():
    t, j = pair()
    near(t, j)
    assert ts.is_sparse(t) and ts.is_sparse_coo(t) and not ts.is_sparse_csr(t)
    inferred = ts.sparse_coo_tensor(torch.tensor(IDX), torch.tensor(VAL))
    assert tuple(inferred.shape) == tuple(js.sparse_coo_tensor(
        jnp.asarray(IDX), jnp.asarray(VAL)).shape) == (3, 4)
    assert ts.nnz(t) == 5
    c, jc = ts.coalesce(t), js.coalesce(j)
    assert ts.nnz(c) == js.nnz(jc) == 4
    near(c, jc)
    csr, jcsr = ts.to_sparse_csr(t), js.to_sparse_csr(j)
    assert ts.is_sparse_csr(csr) and js.is_sparse_csr(jcsr)
    near(csr, jcsr)
    # the other conversions keep the dense meaning (JAX's too)
    near(ts.to_sparse_coo(csr), dense(jcsr))
    near(ts.to_sparse_coo(torch.tensor(D)), D)
    near(ts.to_sparse_csr(torch.tensor(D)), D)
    crow, col = np.array([0, 2, 3, 5]), np.array([0, 3, 1, 0, 2])
    near(ts.sparse_csr_tensor(crow, col, VAL, (3, 4)),
         js.sparse_csr_tensor(crow, col, VAL, (3, 4)))
    # a hybrid COO keeps a trailing dense dim, as BCOO's n_dense
    h = ts.to_sparse_coo(torch.tensor(D[..., None].repeat(2, -1)),
                         sparse_dim=2)
    assert h.dense_dim() == 1 and tuple(h.values().shape) == (12, 2)
    with pytest.raises(ValueError, match="indices"):
        ts.sparse_coo_tensor(torch.tensor([0, 1]), torch.tensor(VAL[:2]))


def test_elementwise_ops_match_jax():
    t, j = pair()
    d = RNG.standard_normal((3, 4)).astype(np.float32)
    t2 = ts.to_sparse_coo(torch.tensor(d * (np.abs(d) > 0.5)))
    j2 = js.to_sparse_coo(jnp.asarray(d * (np.abs(d) > 0.5)))
    # the JAX side in one jitted program (each op compiles otherwise)
    want = jax.jit(lambda a, b, dd: [js.to_dense(f(a, b)) for f in (
        js.add, js.subtract, js.multiply)] + [js.to_dense(js.add(a, dd)),
                                               js.to_dense(js.multiply(a, dd)),
                                               js.to_dense(js.divide(a, 2.0)),
                                               js.to_dense(js.divide(a, dd))])(
        j, j2, jnp.asarray(d))
    got = [ts.add(t, t2), ts.subtract(t, t2), ts.multiply(t, t2),
           ts.add(t, torch.tensor(d)), ts.multiply(t, torch.tensor(d)),
           ts.divide(t, 2.0), ts.divide(t, torch.tensor(d))]
    for g, w in zip(got, want):
        near(g, w)
    for fn, a, b in ((ts.subtract, t, torch.tensor(d)),
                     (js.subtract, j, jnp.asarray(d))):
        with pytest.raises(NotImplementedError):
            fn(a, b)
    got = ts.multiply(t, torch.tensor(d))
    assert ts.is_sparse(got) and ts.nnz(got) == 4  # the pattern is kept
    near(ts.add(torch.tensor(d), torch.tensor(d)), 2 * d)


def test_products_match_jax():
    t, j = pair()
    sw = W * (np.abs(W) > 0.7)
    x = RNG.standard_normal((3, 6)).astype(np.float32)
    y = RNG.standard_normal((6, 4)).astype(np.float32)
    jsw = js.to_sparse_coo(jnp.asarray(sw))
    # the JAX side in one jitted program (each op compiles otherwise)
    want = jax.jit(lambda a, b, w, xx, yy: [js.to_dense(v) for v in (
        js.matmul(a, w), js.matmul(a, b),
        js.masked_matmul(xx, yy, a), js.transpose(a, [1, 0]))])(
        j, jsw, jnp.asarray(W), jnp.asarray(x), jnp.asarray(y))
    got = ts.matmul(t, torch.tensor(W))
    assert not ts.is_sparse(got)
    ss = ts.matmul(t, ts.to_sparse_coo(torch.tensor(sw)))
    assert ts.is_sparse(ss)
    mm = ts.masked_matmul(torch.tensor(x), torch.tensor(y), t)
    assert ts.nnz(mm) == 4
    for g, w in zip((got, ss, mm, ts.transpose(t, [1, 0])), want):
        near(g, w)
    near(mm, (x @ y) * (dense(ts.coalesce(t)) != 0))
    near(ts.matmul(ts.to_sparse_csr(t), torch.tensor(W)), want[0])


def test_relu_and_layers_match_jax():
    from paddle_tpu.sparse import nn as jnn
    from paddle_tpu_torch.sparse import nn as tnn

    t, j = pair()
    # the JAX maps in one jitted program (each coalesces: one compile)
    want = jax.jit(lambda m: [js.to_dense(f(m)) for f in (
        js.relu, jnn.ReLU(), jnn.LeakyReLU(0.1), jnn.Softmax())])(j)
    for got, w in zip((ts.relu(t), tnn.ReLU()(t), tnn.LeakyReLU(0.1)(t),
                       tnn.Softmax()(t)), want):
        near(got, w)
    # BatchNorm over a hybrid COO's channel; statistics move in training
    x = RNG.standard_normal((3, 4, 6)).astype(np.float32)
    x[0, 1] = 0.0
    x[2, 3] = 0.0
    th = ts.to_sparse_coo(torch.tensor(x), sparse_dim=2)
    jh = js.to_sparse_coo(jnp.asarray(x), sparse_dim=2)
    bn, jbn = tnn.BatchNorm(6), jnn.BatchNorm(6)
    near(bn(th), jbn(jh))
    np.testing.assert_allclose(bn._mean.numpy(),
                               np.asarray(jbn._buffers["_mean"]), atol=1e-6)
    np.testing.assert_allclose(bn._variance.numpy(),
                               np.asarray(jbn._buffers["_variance"]),
                               atol=1e-6)
    bn.eval()
    jbn.eval()
    near(bn(th), jbn(jh))
    with pytest.raises(ValueError, match="dense"):
        bn(t)
