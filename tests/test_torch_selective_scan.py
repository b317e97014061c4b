"""The port's selective scan (``paddle_tpu_torch/kernels/selective_scan.py``)
against the JAX package on the CPU: the plain versions of rows 10 and 11
against ``_scan_fwd_pallas``/``_scan_bwd_pallas`` run in interpret mode,
as ``tests/test_selective_scan.py`` runs them, with and without states;
the autograd gradients against ``jax.grad`` of ``chunked_selective_scan``;
the associative reference against JAX's; and the dispatch rules. Inputs
come from numpy with one seed (the JAX test's recipe)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import selective_scan as jss
from paddle_tpu_torch.kernels import selective_scan as tss


def _inputs(b=2, s=64, d=32, n=8, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d)).astype(np.float32)
    delta = np.abs(rng.standard_normal((b, s, d))).astype(np.float32) * 0.1
    A = -np.abs(rng.standard_normal((d, n))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal((d,)).astype(np.float32)
    return u, delta, A, B, C, D


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("with_states", [False, True])
def test_plain_forward_matches_interpreted_kernel(chunk, with_states):
    u, delta, A, B, C, _ = _inputs(seed=chunk)
    at = np.ascontiguousarray(A.T)
    want = jss._scan_fwd_pallas(*map(jnp.asarray, (u, delta, B, C, at)),
                                chunk, 32, with_states)
    got = tss.selective_scan_fwd(*_t(u, delta, B, C, at), chunk, with_states)
    if with_states:
        _close(got[0], want[0], 1e-5)
        assert got[1].shape == (2, 64 // chunk, 8, 32)
        _close(got[1], want[1], 1e-5)
    else:
        assert isinstance(got, torch.Tensor)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_plain_backward_matches_interpreted_kernel(chunk):
    u, delta, A, B, C, _ = _inputs(seed=10 + chunk)
    g = np.random.default_rng(chunk).standard_normal(u.shape).astype(
        np.float32)
    at = np.ascontiguousarray(A.T)
    _, h0s = jss._scan_fwd_pallas(*map(jnp.asarray, (u, delta, B, C, at)),
                                  chunk, 32, True)
    want = jss._scan_bwd_pallas(*map(jnp.asarray, (u, delta, B, C, at)),
                                h0s, jnp.asarray(g), chunk, 16)
    got = tss.selective_scan_bwd(*_t(u, delta, B, C, at, np.asarray(h0s), g),
                                 chunk)
    for name, a, b in zip(("du", "ddelta", "dB", "dC", "dat"), got, want):
        assert a.shape == b.shape, name
        _close(a, b, 1e-5)


def test_gradients_match_jax_grad():
    """All six gradients through ``_ChunkedScan`` (the plain rows 10-11,
    the D-skip outside) against ``jax.grad`` of the JAX custom VJP, with
    a non-trivial cotangent."""
    args = _inputs(seed=3)
    jargs = tuple(map(jnp.asarray, args))

    def jloss(*a):
        return jnp.sum(jnp.sin(jss.chunked_selective_scan(*a, chunk=16)))

    want_out = jss.chunked_selective_scan(*jargs, chunk=16)
    want = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = tss.chunked_selective_scan(*targs, chunk=16)
    _close(out, want_out, 1e-5)
    torch.sin(out).sum().backward()
    for name, t, w in zip("u delta A B C D".split(), targs, want):
        assert t.grad.shape == w.shape, name
        _close(t.grad, w, 1e-5)


def test_state_blocks_over_16_match_jax_grad():
    """40 states go through ``_ChunkedScan`` as blocks of 16, 16 and 8
    (the kernels take at most 16; the plain versions here): the output and
    all six gradients against the JAX chunked scan over all 40 at once,
    and the forward's h0s joined back into 40 states."""
    args = _inputs(n=40, seed=4)
    jargs = tuple(map(jnp.asarray, args))

    def jloss(*a):
        return jnp.sum(jnp.sin(jss.chunked_selective_scan(*a, chunk=16)))

    want_out = jss.chunked_selective_scan(*jargs, chunk=16)
    want = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = tss.chunked_selective_scan(*targs, chunk=16)
    _close(out, want_out, 1e-5)
    torch.sin(out).sum().backward()
    # 1e-5 of each gradient's largest value: with 40 states the sums reach
    # 125 (ddelta), where float32 sums in another order differ by 1e-4;
    # the unsplit plain versions differ from JAX's by the same amounts
    for name, t, w in zip("u delta A B C D".split(), targs, want):
        assert t.grad.shape == w.shape, name
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), (name, err)
    u, delta, A, B, C, _ = _t(*args)
    at = A.t().contiguous()
    y, h0s = tss.split_scan_fwd(u, delta, B, C, at, 16, True)
    y_all, h0s_all = tss.selective_scan_fwd_plain(u, delta, B, C, at, 16,
                                                  True)
    assert h0s.shape == (2, 4, 40, 32)
    _close(h0s, h0s_all.numpy(), 1e-5)
    _close(y, y_all.numpy(), 1e-5)


def test_associative_reference_matches_jax():
    """The port's associative scan follows ``jax.lax.associative_scan``'s
    combine order: outputs and gradients within 1e-5. The chunked scan,
    which sums in another order, is held to it at JAX's own 2e-3/2e-4."""
    args = _inputs(b=2, s=37, d=16, n=4, seed=4)
    jargs = tuple(map(jnp.asarray, args))
    want = jax.jit(jss.associative_selective_scan)(*jargs)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(
        jss.associative_selective_scan(*a))), argnums=tuple(range(6))))(
            *jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = tss.associative_selective_scan(*targs)
    _close(got, want, 1e-5)
    torch.sin(got).sum().backward()
    for t, w in zip(targs, jgrads):
        _close(t.grad, w, 1e-5)
    args = _inputs(seed=5)
    ref = tss.associative_selective_scan(*_t(*args))
    chunked = tss.chunked_selective_scan(*_t(*args), chunk=16)
    np.testing.assert_allclose(chunked.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_no_grad_forward_saves_no_states(monkeypatch):
    """Outside autograd the forward runs without states (row 10's
    ``:122`` variant), and under it with states (``:129``)."""
    calls = []
    real = tss.selective_scan_fwd

    def spy(*a, **kw):
        calls.append(kw.get("with_states", a[6] if len(a) > 6 else None))
        return real(*a, **kw)

    monkeypatch.setattr(tss, "selective_scan_fwd", spy)
    args = _inputs(seed=6)
    with torch.no_grad():
        a = tss.chunked_selective_scan(*_t(*args), chunk=16)
    targs = [torch.tensor(x, requires_grad=True) for x in args]
    b = tss.chunked_selective_scan(*targs, chunk=16)
    assert calls == [False, True]
    assert torch.equal(a, b.detach())


def test_dispatch_rules():
    """CPU tensors take the plain versions and, as in JAX, need s to be a
    multiple of the chunk. Every other tensor reaches the kernel wrappers
    whatever its length (a ragged s is the kernels' to mask): on a device
    that is not the card they refuse it, and never run a plain version."""
    u, delta, A, B, C, D = _t(*_inputs(s=60))
    with pytest.raises(ValueError, match="not divisible"):
        tss.chunked_selective_scan(u, delta, A, B, C, D, chunk=16)
    meta = [x.to("meta") for x in (u, delta, A, B, C, D)]
    with pytest.raises(ValueError, match="unsupported device"):
        tss.chunked_selective_scan(*meta, chunk=16)
    leaves = [x.requires_grad_() for x in meta]
    with pytest.raises(ValueError, match="unsupported device"):
        tss.chunked_selective_scan(*leaves, chunk=16)
    at = A.t().contiguous()
    with pytest.raises(ValueError, match="unsupported device"):
        tss.selective_scan_bwd(*(x.to("meta") for x in (
            u, delta, B, C, at, torch.zeros(2, 4, 8, 32), u)), 16)
    # the plain versions take a ragged last chunk as the kernels do: the
    # states entering each chunk, and the same y as whole chunks
    y, h0s = tss.selective_scan_fwd(u, delta, B, C, at, 16, True)
    assert h0s.shape == (2, 4, 8, 32)
    _close(y, tss.selective_scan_fwd(u, delta, B, C, at, 60, False).numpy(),
           1e-6)


def test_ragged_last_chunk_gradients_match_the_associative_scan():
    """The card's path for s not a multiple of the chunk (60 = 3 x 16 +
    12), through ``_ChunkedScan`` and the plain rows 10-11: outputs and
    all six gradients against autograd of the associative reference, at
    JAX's tolerance for the two orders of summation."""
    args = _inputs(s=60, seed=7)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    tb = [torch.tensor(a, requires_grad=True) for a in args]
    out = tss._ChunkedScan.apply(*ta, 16)
    ref = tss.associative_selective_scan(*tb)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-3, atol=2e-4)
    torch.sin(out).sum().backward()
    torch.sin(ref).sum().backward()
    for name, a, b in zip("u delta A B C D".split(), ta, tb):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=name)
