"""The port's selective scan (``paddle_tpu_torch/kernels/selective_scan.py``)
against the JAX package on the CPU: the plain versions of rows 10 and 11
against ``_scan_fwd_pallas``/``_scan_bwd_pallas`` run in interpret mode,
as ``tests/test_selective_scan.py`` runs them, with and without states;
the autograd gradients against ``jax.grad`` of ``chunked_selective_scan``;
the associative reference against JAX's; and the dispatch rules. Inputs
come from numpy with one seed (the JAX test's recipe)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import selective_scan as jss
from paddle_tpu_torch.kernels import selective_scan as tss
from torch_scan_cases import SCAN_CASES, TRAIN_SHAPE


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


# ---------------------------------------------------------------------------
# the kernels' launch plan and their two-level scan, on the CPU
# ---------------------------------------------------------------------------
def _rank_range(plan, s, rank):
    t0 = min(s, rank * plan.rank_len)
    return t0, min(s, t0 + plan.rank_len)


def _tile_segments(plan, s, rank, k):
    """The warp segments [t0, t1) of tile k of a rank, in warp order, as
    the kernels cut them (empty past the rank's end)."""
    t_start, t_end = _rank_range(plan, s, rank)
    tile = plan.warps * tss.SCAN_STEPS
    out = []
    for w in range(plan.warps):
        t0 = t_start + k * tile + w * tss.SCAN_STEPS
        out.append((t0, max(t0, min(t0 + tss.SCAN_STEPS, t_end))))
    return out


PLAN_SHAPES = SCAN_CASES


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("b,s,d,n,chunk", PLAN_SHAPES)
def test_scan_plan_geometry(b, s, d, n, chunk, backward):
    """The plan of every card-test shape (the train shape and b 1, s 8192
    among them), under the modelled occupancy: the warp segments of the
    ranks' tiles cover [0, s) exactly once, no rank empty; the channel
    tiles cover d; a CTA's shared memory within the 227 KB it may take;
    at most 8 ranks a cluster and 16 warps a CTA; backward ranks start at
    chunk starts, where h0s anchors them."""
    n = min(n, tss.MAX_STATE)
    plan = tss._scan_plan(b, s, d, n, chunk, backward)
    assert plan.ranks in tss.RANK_CHOICES and plan.ranks <= 8
    assert plan.warps in tss.WARP_CHOICES and plan.warps <= 16
    assert plan.smem == tss._smem_bytes(plan.warps, backward)
    assert plan.smem <= tss.SMEM_LIMIT == 227 * 1024
    seen = []
    for rank in range(plan.ranks):
        t_start, t_end = _rank_range(plan, s, rank)
        assert t_start < t_end, (plan, rank)
        if backward:
            assert t_start % chunk == 0, (plan, rank)
        assert plan.tiles * plan.warps * tss.SCAN_STEPS >= t_end - t_start
        for k in range(plan.tiles):
            for t0, t1 in _tile_segments(plan, s, rank, k):
                seen.extend(range(t0, t1))
    assert sorted(seen) == list(range(s))
    tiles = -(-d // tss.SCAN_LANES)
    assert tiles * tss.SCAN_LANES >= d > (tiles - 1) * tss.SCAN_LANES


def _decays(u, delta, B, at):
    """da [b, s, n, d] and dt u B [b, s, n, d]."""
    da = torch.exp(delta[:, :, None, :] * at)
    dbu = (delta * u)[:, :, None, :] * B[..., None]
    return da, dbu


def _scan_from_zero(da, dbu, t0, t1):
    """A segment's forward scan from zero: (decay product, end state)."""
    h = torch.zeros_like(da[:, 0])
    p = torch.ones_like(h)
    for t in range(t0, t1):
        h = da[:, t] * h + dbu[:, t]
        p = p * da[:, t]
    return p, h


def _gh_from_zero(da, cg, t0, t1):
    """A segment's reverse gh scan from zero: (decay product, the carry it
    hands to the step before t0)."""
    r = torch.zeros_like(da[:, 0])
    p = torch.ones_like(r)
    for t in reversed(range(t0, t1)):
        r = da[:, t] * (cg[:, t] + r)
        p = p * da[:, t]
    return p, r


def _model_fwd(u, delta, B, C, at, chunk, plan):
    """Row 10 as the kernel computes it: each rank's carry from the
    earlier ranks' ranges scanned from zero, combined in rank order; in
    each tile the warps' segments scanned from zero, combined in warp
    order with the tile's carry, and walked again from their carries."""
    b, s, d = u.shape
    da, dbu = _decays(u, delta, B, at)
    y = torch.empty_like(u)
    h0s = torch.empty((b, -(-s // chunk), at.shape[0], d))
    ranges = [_scan_from_zero(da, dbu, *_rank_range(plan, s, r))
              for r in range(plan.ranks)]
    for rank in range(plan.ranks):
        carry = torch.zeros_like(da[:, 0])
        for p, end in ranges[:rank]:
            carry = p * carry + end
        for k in range(plan.tiles):
            segs = _tile_segments(plan, s, rank, k)
            pairs = [_scan_from_zero(da, dbu, t0, t1) for t0, t1 in segs]
            for (t0, t1), (p, end) in zip(segs, pairs):
                h = carry
                for t in range(t0, t1):
                    if t % chunk == 0:
                        h0s[:, t // chunk] = h
                    h = da[:, t] * h + dbu[:, t]
                    y[:, t] = (C[:, t][:, :, None] * h).sum(dim=1)
                carry = p * carry + end
    return y, h0s


def _model_bwd(u, delta, B, C, at, h0s, g, chunk, plan):
    """Row 11 as the kernel computes it: each rank's gh carry from the
    later ranks' ranges scanned from zero, combined last first; the state
    entering each tile from the rank's h0s anchor; the tiles in reverse,
    each warp segment's forward carry from the warps before and its gh
    carry from the warps after, then the reverse walk."""
    b, s, d = u.shape
    da, dbu = _decays(u, delta, B, at)
    cg = C[..., None] * g[:, :, None, :]
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dB = torch.empty((b, s, at.shape[0]))
    dC = torch.empty_like(dB)
    dat = torch.zeros_like(da[:, 0])
    ranges = [_gh_from_zero(da, cg, *_rank_range(plan, s, r))
              for r in range(plan.ranks)]
    for rank in range(plan.ranks):
        t_start, _ = _rank_range(plan, s, rank)
        rev = torch.zeros_like(da[:, 0])
        for p, end in reversed(ranges[rank + 1:]):
            rev = p * rev + end
        entering, h = [], h0s[:, t_start // chunk]
        for k in range(plan.tiles):
            entering.append(h)
            for t0, t1 in _tile_segments(plan, s, rank, k):
                for t in range(t0, t1):
                    h = da[:, t] * h + dbu[:, t]
        for k in reversed(range(plan.tiles)):
            segs = _tile_segments(plan, s, rank, k)
            fwd_in, h = [], entering[k]
            for t0, t1 in segs:
                fwd_in.append(h)
                p, end = _scan_from_zero(da, dbu, t0, t1)
                h = p * h + end
            rev_in = [None] * len(segs)
            for w in reversed(range(len(segs))):
                rev_in[w] = rev
                p, end = _gh_from_zero(da, cg, *segs[w])
                rev = p * rev + end
            for (t0, t1), h, r in zip(segs, fwd_in, rev_in):
                hs = [h]
                for t in range(t0, t1):
                    hs.append(da[:, t] * hs[-1] + dbu[:, t])
                for t in reversed(range(t0, t1)):
                    gh = cg[:, t] + r
                    h_t, h_prev = hs[t - t0 + 1], hs[t - t0]
                    gt = g[:, t][:, None, :]
                    dC[:, t] = (h_t * gt).sum(dim=2)
                    dB[:, t] = (gh * (delta * u)[:, t][:, None, :]).sum(dim=2)
                    sum_ghb = (gh * B[:, t][:, :, None]).sum(dim=1)
                    du[:, t] = delta[:, t] * sum_ghb
                    ghh = gh * h_prev * da[:, t]
                    ddelta[:, t] = u[:, t] * sum_ghb + (ghh * at).sum(dim=1)
                    dat = dat + ghh * delta[:, t][:, None, :]
                    r = da[:, t] * gh
    return du, ddelta, dB, dC, dat.sum(dim=0)


def _row_err(got, want):
    """The largest error of a last-axis row over the plain row's norm (at
    least 1e-3 of the tensor's root-mean-square row norm), as the card
    tests measure the kernels."""
    den = want.norm(dim=-1)
    floor = (1e-3 * den.square().mean().sqrt()).clamp_min(1e-30)
    return ((got - want).norm(dim=-1) / torch.maximum(den, floor)).max().item()


# (b, s, d, n, chunk, warps, ranks): one rank; several ranks of a few
# tiles (the forward's ranges whole tiles, the backward's whole chunks);
# a chunk that is no multiple of a thread's steps with a ragged tail
MODEL_CASES = [(2, 150, 24, 8, 16, 4, 1), (2, 150, 24, 8, 16, 4, 3),
               (1, 200, 40, 16, 32, 8, 2), (2, 97, 8, 3, 10, 4, 2)]


@pytest.mark.parametrize("b,s,d,n,chunk,warps,ranks", MODEL_CASES)
def test_two_level_model_matches_the_plain_versions(b, s, d, n, chunk, warps,
                                                    ranks):
    """The kernels' decomposition in plain torch (``_model_fwd``,
    ``_model_bwd``: segments scanned from zero, carries combined in warp
    and rank order, the reverse gh carry) against the sequential plain
    versions, row-wise within 1e-5 as the card tests hold the kernels.
    Small decays (delta ~ 0.1) carry states across many segments."""
    u, delta, A, B, C, _ = _t(*_inputs(b=b, s=s, d=d, n=n, seed=s + ranks))
    g = torch.tensor(np.random.default_rng(ranks).standard_normal(
        (b, s, d)).astype(np.float32))
    at = A.t().contiguous()
    plans = {}
    for backward in (False, True):
        length = tss._rank_len(s, chunk, warps, ranks, backward)
        assert length is not None
        plans[backward] = tss.ScanPlan(
            warps, ranks, length, -(-length // (warps * tss.SCAN_STEPS)),
            tss._smem_bytes(warps, backward))
    y, h0s = _model_fwd(u, delta, B, C, at, chunk, plans[False])
    y_ref, h0s_ref = tss.selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                                  True)
    assert _row_err(y, y_ref) <= 1e-5
    assert _row_err(h0s, h0s_ref) <= 1e-5
    got = _model_bwd(u, delta, B, C, at, h0s_ref, g, chunk, plans[True])
    want = tss.selective_scan_bwd_plain(u, delta, B, C, at, h0s_ref, g, chunk)
    for name, x, w in zip(("du", "ddelta", "dB", "dC", "dat"), got, want):
        assert x.shape == w.shape, name
        assert _row_err(x, w) <= 1e-5, (name, _row_err(x, w))
