"""Chunked selective scan (S6 linear recurrence) for Mamba, with its
backward (counterpart of ``paddle_tpu/kernels/selective_scan.py``).

``h_t = exp(delta_t * A) * h_{t-1} + (delta_t u_t) B_t``, ``y_t = C_t .
h_t``, plus the ``u * D`` skip outside the kernels; u, delta ``[b, s, d]``,
B, C ``[b, s, n]``, A ``[d, n]`` (negative), D ``[d]``, every operand cast
to float32 as in JAX.

Two Hopper kernels (``csrc/selective_scan.cu``) carry it, each beside
its plain PyTorch version in this module:

- row 10, the forward (``_scan_kernel`` through ``_scan_fwd_pallas``):
  y, and with states the state entering each ``chunk`` of steps,
  ``h0s [b, ceil(s / chunk), n, d]``, the backward's only input about the
  forward. Without states it serves a ``no_grad`` forward;
- row 11, the backward (``_scan_bwd_kernel`` through
  ``_scan_bwd_pallas``): the states recomputed from the ``h0s`` anchors,
  then the reverse cotangent recurrence; du, ddelta, dB and dC (the
  kernel writes per-channel-tile partials of the sums over d, summed here
  in tile order) and dA^T (per-(batch, rank) partials, summed here).

Both kernels run each recurrence along time as a two-level scan: time
segments scanned from zero, their carries combined in order, each
segment walked again from its true carry. ``_scan_plan`` chooses the
geometry here, where the CPU tests reach it: 32 channels a CTA (one a
lane), ``SCAN_STEPS`` consecutive steps a thread, the CTA's warps along
time (a tile of warps x ``SCAN_STEPS`` steps) and the CTAs of a cluster
along s (ranks, each a range of steps; backward ranges start at chunk
starts). On the card it asks the kernels' library how many clusters of
each candidate the card holds at once (``_card_clusters``; a plan whose
shared memory differs from the kernel's raises) and reads the card's SM
count; the CPU tests use ``_card.clusters_model`` and the H100's 132.

No ``[b, s, d, n]`` tensor exists on either path, as in JAX.
``_ChunkedScan`` (a ``torch.autograd.Function``) runs the forward with
states and saves ``(u, delta, A, B, C, D, h0s)``; its backward adds the
D-skip terms outside the kernel, as ``_chunked_bwd`` does.

State sizes over 16: the kernels keep a channel's n <= 16 states in
registers, and each state's recurrence is independent of the others, so
``split_scan_fwd`` and ``split_scan_bwd`` cut the states into blocks of at
most 16 and run each block through the kernels (the plain versions on
the CPU): y, du and ddelta are summed over the blocks in block order, and
h0s, dB, dC and dA^T are joined along the states. ``_ChunkedScan`` and
``chunked_selective_scan`` go through them, so any state size runs on
both devices.

Dispatch: a CPU tensor takes the plain versions; a CUDA tensor launches
the kernels or raises (no fall-back). On the card the kernels take any
sequence length (the kernels mask a ragged last chunk: ``chunk`` only
sets where states are saved and the backward's recompute span); on the
CPU ``chunked_selective_scan`` requires ``s % chunk == 0``, as JAX does.
Each wrapper adds one to ``LAUNCHES[name]`` per launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._card import SMEM_LIMIT, SMS, clusters_model, held_clusters, sm_count

# kernel launches in this process: row 10 without states (a no_grad
# forward) and with states (the training forward), row 11
LAUNCHES = {"selective_scan_fwd": 0, "selective_scan_fwd_states": 0,
            "selective_scan_bwd": 0}
MAX_STATE = 16  # the kernels take n <= 16 states (their state loop's planes)

# the launch plan's geometry on the H100 (csrc/selective_scan.cu checks it)
SCAN_LANES = 32     # channels of a CTA, one a lane
SCAN_STEPS = 8      # consecutive steps a thread holds (kL)
WARP_CHOICES = (4, 8, 16)  # warps of a CTA along time (at most 16)
RANK_CHOICES = (1, 2, 4, 8)  # CTAs of a cluster along s (the portable 8)
# the plan's cost model, fitted to the card's times of every candidate at
# the train shape and at b 1, s 8192 (PERF.md, section 6): an SM issues at its
# rate from FULL_WARPS resident warps on; each warp a CTA adds CHAIN_COST
# to a step (the carry chain over the warps before it, which grows with
# the warps); the work of a rank in units of its main sweep: the
# backward's forward sweep for the tile states and, with ranks, the
# forward's range scan from zero and the backward's gh range scan
FULL_WARPS = 12
CHAIN_COST = 0.05
SWEEP_WORK = {False: (1.0, 0.7), True: (1.35, 0.3)}

_F32 = torch.float32
_P, _I = ctypes.c_void_p, ctypes.c_int


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _n_chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def _step(h, t, u, delta, B, at):
    """One step of the recurrence on h [b, n, d], in the JAX kernel's
    order: ``da * h + (dt * u) * B``."""
    dt = delta[:, t][:, None, :]
    da = torch.exp(dt * at)
    dbu = (dt * u[:, t][:, None, :]) * B[:, t][:, :, None]
    return da * h + dbu


def selective_scan_fwd_plain(u, delta, B, C, at, chunk: int,
                             with_states: bool):
    """Plain version of row 10, step by step as the JAX kernel: y [b, s,
    d] float32, and with ``with_states`` also ``h0s`` [b, ceil(s / chunk),
    n, d], the state entering each chunk. Inputs float32, ``at = A.T``
    [n, d]."""
    b, s, d = u.shape
    n = at.shape[0]
    h = torch.zeros((b, n, d), dtype=_F32, device=u.device)
    y = torch.empty((b, s, d), dtype=_F32, device=u.device)
    h0s = (torch.empty((b, _n_chunks(s, chunk), n, d), dtype=_F32,
                       device=u.device) if with_states else None)
    for t in range(s):
        if with_states and t % chunk == 0:
            h0s[:, t // chunk] = h
        h = _step(h, t, u, delta, B, at)
        y[:, t] = (h * C[:, t][:, :, None]).sum(dim=1)
    return (y, h0s) if with_states else y


def selective_scan_bwd_plain(u, delta, B, C, at, h0s, g, chunk: int):
    """Plain version of row 11, step by step as the JAX kernel: chunks
    in reverse, the chunk's states recomputed from ``h0s``, then the
    reverse cotangent recurrence ``gh_t = C_t g_t + dA_{t+1} gh_{t+1}``.
    Returns du, ddelta [b, s, d], dB, dC [b, s, n] and dat [n, d] (the
    gradient of ``at``), all float32."""
    b, s, d = u.shape
    n = at.shape[0]
    du = torch.empty_like(u)
    ddelta = torch.empty_like(u)
    dB = torch.empty((b, s, n), dtype=_F32, device=u.device)
    dC = torch.empty_like(dB)
    gh = torch.zeros((b, n, d), dtype=_F32, device=u.device)
    dat = torch.zeros((b, n, d), dtype=_F32, device=u.device)
    for ic in reversed(range(_n_chunks(s, chunk))):
        t0, t1 = ic * chunk, min(s, (ic + 1) * chunk)
        hs = [h0s[:, ic]]
        for t in range(t0, t1):
            hs.append(_step(hs[-1], t, u, delta, B, at))
        for t in reversed(range(t0, t1)):
            gt = g[:, t][:, None, :]
            dt = delta[:, t][:, None, :]
            bt = B[:, t][:, :, None]
            ct = C[:, t][:, :, None]
            ut = u[:, t][:, None, :]
            h_t, h_prev = hs[t - t0 + 1], hs[t - t0]
            da = torch.exp(dt * at)
            dC[:, t] = (h_t * gt).sum(dim=2)
            gh = gh + ct * gt
            sum_ghb = (gh * bt).sum(dim=1)
            du[:, t] = dt[:, 0] * sum_ghb
            dB[:, t] = (gh * (dt * ut)).sum(dim=2)
            ghh = gh * h_prev * da
            ddelta[:, t] = ut[:, 0] * sum_ghb + (ghh * at).sum(dim=1)
            dat = dat + ghh * dt
            gh = da * gh
    return du, ddelta, dB, dC, dat.sum(dim=0)


def associative_selective_scan(u, delta, A, B, C, D):
    """Plain reference of the other branch (``associative_selective_scan``
    in JAX): the discretised operands ``[b, s, d, n]`` combined by
    ``jax.lax.associative_scan``'s odd/even recursion along s, in its
    order, then ``y = h . C + u D``. Differentiable by autograd."""
    dA = torch.exp(delta[..., None] * A[None, None])
    dBu = (delta * u)[..., None] * B[:, :, None, :]

    def combine(x, y):
        return y[0] * x[0], y[0] * x[1] + y[1]

    def scan(a, bb):
        num = a.shape[1]
        if num < 2:
            return a, bb
        ra, rb = combine((a[:, 0:-1:2], bb[:, 0:-1:2]),
                         (a[:, 1::2], bb[:, 1::2]))
        oa, ob = scan(ra, rb)
        if num % 2 == 0:
            ea, eb = combine((oa[:, :-1], ob[:, :-1]),
                             (a[:, 2::2], bb[:, 2::2]))
        else:
            ea, eb = combine((oa, ob), (a[:, 2::2], bb[:, 2::2]))
        ea = torch.cat([a[:, :1], ea], dim=1)
        eb = torch.cat([bb[:, :1], eb], dim=1)
        return _interleave(ea, oa), _interleave(eb, ob)

    _, h_all = scan(dA, dBu)
    y = torch.einsum("bsdn,bsn->bsd", h_all, C)
    return y + u * D[None, None]


def _interleave(even, odd):
    """Elements of ``even`` at even and of ``odd`` at odd positions along
    axis 1 (``even`` has as many or one more)."""
    s = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], s) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------
class ScanPlan(NamedTuple):
    warps: int     # warps of a CTA, each SCAN_STEPS steps of a time tile
    ranks: int     # CTAs of a cluster along s
    rank_len: int  # steps of a rank's range (the last one ragged)
    tiles: int     # time tiles of a rank's range, warps x SCAN_STEPS each
    smem: int      # dynamic shared memory bytes of a CTA


def _smem_bytes(warps: int, backward: bool) -> int:
    """A CTA's dynamic shared memory, as ``csrc/selective_scan.cu:
    smem_floats`` sizes it: planes of [16 states][32 channels] (a, the
    carries by tile parity, the range's product and its published pair;
    the backward's reverse carry), a float4 exchange of two buffers per
    warp, and per warp the staged B and C rows (backward: also its dB/dC
    rows, its dat plane and the buffer of its sums over lanes)."""
    plane = MAX_STATE * SCAN_LANES
    if backward:  # and the buffer of the warp's sums over lanes
        per_warp = (2 * 32 * 4 + 4 * MAX_STATE * SCAN_STEPS + plane
                    + 32 * 20 + 16)
        return 4 * (8 * plane + warps * per_warp)
    return 4 * (6 * plane + warps * (2 * 32 * 4 + 2 * MAX_STATE * SCAN_STEPS))


def _rank_len(s: int, chunk: int, warps: int, ranks: int, backward: bool):
    """Steps of a rank's range: all of s for one rank; else s / ranks
    rounded up to whole tiles (forward) or whole chunks (backward, so that
    h0s anchors every range); None when the last rank would be empty."""
    if ranks == 1:
        return s
    step = chunk if backward else warps * SCAN_STEPS
    length = -(-(-(-s // ranks)) // step) * step
    return length if length * (ranks - 1) < s else None


def _plans(s: int, chunk: int, backward: bool):
    """Every candidate plan for ``s`` steps (``WARP_CHOICES`` x
    ``RANK_CHOICES`` where the ranges allow)."""
    out = []
    for ranks in RANK_CHOICES:
        for warps in WARP_CHOICES:
            length = _rank_len(s, chunk, warps, ranks, backward)
            if length is not None:
                out.append(ScanPlan(warps, ranks, length,
                                    -(-length // (warps * SCAN_STEPS)),
                                    _smem_bytes(warps, backward)))
    return out


def _plan_cost(plan: ScanPlan, b: int, d: int, backward: bool, held: int,
               sms: int):
    """The model's time of a plan (in steps of one CTA's sweep at an SM's
    full issue rate), given the clusters the card holds at once and its
    SMs: waves of the grid, times the CTAs of the busiest SM, times a CTA's
    work (``SWEEP_WORK``, each step dearer by ``CHAIN_COST`` a warp), over
    the SM's issue share at its warps (``FULL_WARPS`` saturate it)."""
    grid = b * -(-d // SCAN_LANES) * plan.ranks
    held_ctas = held * plan.ranks if plan.smem <= SMEM_LIMIT else 0
    if held_ctas <= 0:
        return float("inf")
    waves = -(-grid // held_ctas)
    per_sm = -(-min(grid, held_ctas) // sms)
    share = min(1.0, per_sm * plan.warps / FULL_WARPS)
    main, extra = SWEEP_WORK[backward]
    work = plan.tiles * plan.warps * SCAN_STEPS * (
        main + (extra if plan.ranks > 1 else 0.0)) * (
            1.0 + CHAIN_COST * plan.warps)
    return waves * per_sm * work / share


def _scan_plan(b: int, s: int, d: int, n: int, chunk: int,
               backward: bool = False, clusters=None,
               sms: int = SMS) -> ScanPlan:
    """The geometry of one launch over ``[b, s, d]`` with ``n`` states on
    a card of ``sms`` SMs: among ``_plans``, the least ``_plan_cost`` given
    how many clusters of each the card holds at once (``clusters(plan,
    backward)``, by default ``_card.clusters_model``); then the fewest
    waves, the fewest ranks (the least work) and the most warps."""
    if not 1 <= n <= MAX_STATE or chunk < 1 or s < 1 or d < 1:
        raise ValueError(f"no scan plan for s {s}, d {d}, n {n}, chunk "
                         f"{chunk}")
    def score(p):
        held = (clusters(p, backward) if clusters else
                clusters_model(32 * p.warps, p.smem, p.ranks, sms))
        grid = b * -(-d // SCAN_LANES) * p.ranks
        waves = -(-grid // max(1, held * p.ranks))
        return (_plan_cost(p, b, d, backward, held, sms), waves, p.ranks,
                -p.warps)

    return min(_plans(s, chunk, backward), key=score)


def resident_warps(plan: ScanPlan, b: int, d: int, held: int,
                   sms: int) -> float:
    """Warps an SM holds on average while the first wave of the grid runs,
    given the clusters the card holds at once and its SMs."""
    grid = b * -(-d // SCAN_LANES) * plan.ranks
    return min(grid, held * plan.ranks) * plan.warps / sms


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _device_ok(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _check(u, delta, B, C, at, chunk, others=()):
    b, s, d = u.shape
    n = at.shape[0]
    want = {"u": (b, s, d), "delta": (b, s, d), "B": (b, s, n),
            "C": (b, s, n), "at": (n, d)}
    for name, t in (("u", u), ("delta", delta), ("B", B), ("C", C),
                    ("at", at)) + tuple(others):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != _F32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}; got "
                             f"{tuple(t.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} is outside [1, {MAX_STATE}]")
    if chunk < 1:
        raise ValueError(f"chunk must be positive; got {chunk}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds 65535")


def _fn(name, argtypes):
    from . import _build

    fn = getattr(_build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _card_clusters(b, s, d, n, chunk):
    """``_scan_plan``'s ``clusters`` on the card: how many clusters of a
    plan's kernel the card holds at once (``_card.held_clusters`` through
    ``pt_selective_scan_plan``, which refuses a plan the kernels do not
    take)."""
    out = ctypes.POINTER(ctypes.c_int)
    fn = _fn("pt_selective_scan_plan", [_I] * 9 + [out, out])

    def clusters(plan, backward):
        return held_clusters(fn, (b, s, d, n, chunk, plan.warps, plan.ranks,
                                  plan.rank_len, int(backward)), plan, "scan")

    return clusters


_PLANS = {}  # the card's plans by their arguments: each found once


def _card_plan(device, b, s, d, n, chunk, backward):
    """``_scan_plan`` for a launch over ``[b, s, d]`` on the card
    ``device``, with its occupancy answers and SM count; computed once per
    shape, state count, chunk and direction."""
    key = (device, b, s, d, n, chunk, backward)
    if key not in _PLANS:
        _PLANS[key] = _scan_plan(b, s, d, n, chunk, backward,
                                 _card_clusters(b, s, d, n, chunk),
                                 sm_count(device))
    return _PLANS[key]


def selective_scan_fwd(u, delta, B, C, at, chunk: int, with_states: bool):
    """Row 10: ``y``, or ``(y, h0s)`` with ``with_states``, as
    ``selective_scan_fwd_plain``; float32 contiguous inputs."""
    if not _device_ok(u):
        return selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                        with_states)
    _check(u, delta, B, C, at, chunk)
    b, s, d = u.shape
    n = at.shape[0]
    y = torch.empty_like(u)
    h0s = (torch.empty((b, _n_chunks(s, chunk), n, d), dtype=_F32,
                       device=u.device) if with_states else None)
    fn = _fn("pt_selective_scan_fwd", [_P] * 7 + [_I] * 8 + [_P])
    with torch.cuda.device(u.device):
        plan = _card_plan(u.device, b, s, d, n, int(chunk), False)
        err = fn(u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
                 at.data_ptr(), y.data_ptr(), _ptr(h0s), b, s, d, n,
                 int(chunk), plan.warps, plan.ranks, plan.rank_len,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective scan forward failed to launch: CUDA "
                           f"error {err}")
    LAUNCHES["selective_scan_fwd_states" if with_states
             else "selective_scan_fwd"] += 1
    return (y, h0s) if with_states else y


def selective_scan_bwd(u, delta, B, C, at, h0s, g, chunk: int):
    """Row 11: du, ddelta, dB, dC, dat as ``selective_scan_bwd_plain``;
    the kernel's per-channel-tile dB/dC partials and per-(batch, rank) dat
    partials are summed here in a fixed order."""
    if not _device_ok(u):
        return selective_scan_bwd_plain(u, delta, B, C, at, h0s, g, chunk)
    _check(u, delta, B, C, at, chunk, (("h0s", h0s), ("g", g)))
    b, s, d = u.shape
    n = at.shape[0]
    if tuple(h0s.shape) != (b, _n_chunks(s, chunk), n, d) or \
            tuple(g.shape) != (b, s, d):
        raise ValueError(f"h0s {tuple(h0s.shape)} or g {tuple(g.shape)} do "
                         f"not match u {(b, s, d)}, n {n}, chunk {chunk}")
    with torch.cuda.device(u.device):
        plan = _card_plan(u.device, b, s, d, n, int(chunk), True)
        nct = -(-d // SCAN_LANES)
        du, ddelta = torch.empty_like(u), torch.empty_like(u)
        db_part = torch.empty((nct, b, s, n), dtype=_F32, device=u.device)
        dc_part = torch.empty_like(db_part)
        dat_part = torch.empty((b, plan.ranks, n, d), dtype=_F32,
                               device=u.device)
        # the forward state entering each time tile (the kernel's scratch)
        hst = torch.empty((b, plan.ranks * plan.tiles, n, d), dtype=_F32,
                          device=u.device)
        fn = _fn("pt_selective_scan_bwd", [_P] * 13 + [_I] * 8 + [_P])
        err = fn(u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
                 at.data_ptr(), h0s.data_ptr(), g.data_ptr(), du.data_ptr(),
                 ddelta.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
                 dat_part.data_ptr(), hst.data_ptr(), b, s, d, n, int(chunk),
                 plan.warps, plan.ranks, plan.rank_len,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective scan backward failed to launch: CUDA "
                           f"error {err}")
    LAUNCHES["selective_scan_bwd"] += 1
    return du, ddelta, db_part.sum(dim=0), dc_part.sum(dim=0), \
        dat_part.sum(dim=(0, 1))


def _blocks(n: int):
    """State blocks of at most MAX_STATE, in order."""
    return [(i, min(n, i + MAX_STATE)) for i in range(0, n, MAX_STATE)]


def split_scan_fwd(u, delta, B, C, at, chunk: int, with_states: bool):
    """Row 10 for any state size: one call of ``selective_scan_fwd`` per
    block of at most 16 states; y summed over the blocks in block order,
    h0s joined along the states."""
    blocks = _blocks(at.shape[0])
    if len(blocks) == 1:
        return selective_scan_fwd(u, delta, B, C, at, chunk, with_states)
    y, h0s = None, []
    for n0, n1 in blocks:
        out = selective_scan_fwd(u, delta, B[..., n0:n1].contiguous(),
                                 C[..., n0:n1].contiguous(),
                                 at[n0:n1].contiguous(), chunk, with_states)
        yb = out[0] if with_states else out
        y = yb if y is None else y + yb
        if with_states:
            h0s.append(out[1])
    return (y, torch.cat(h0s, dim=2)) if with_states else y


def split_scan_bwd(u, delta, B, C, at, h0s, g, chunk: int):
    """Row 11 for any state size: one call of ``selective_scan_bwd`` per
    block of at most 16 states; du and ddelta summed over the blocks in
    block order, dB, dC and dat joined along the states."""
    blocks = _blocks(at.shape[0])
    if len(blocks) == 1:
        return selective_scan_bwd(u, delta, B, C, at, h0s, g, chunk)
    du = ddelta = None
    dB, dC, dat = [], [], []
    for n0, n1 in blocks:
        dub, ddb, dBb, dCb, datb = selective_scan_bwd(
            u, delta, B[..., n0:n1].contiguous(), C[..., n0:n1].contiguous(),
            at[n0:n1].contiguous(), h0s[:, :, n0:n1].contiguous(), g, chunk)
        du = dub if du is None else du + dub
        ddelta = ddb if ddelta is None else ddelta + ddb
        dB.append(dBb)
        dC.append(dCb)
        dat.append(datb)
    return (du, ddelta, torch.cat(dB, dim=-1), torch.cat(dC, dim=-1),
            torch.cat(dat, dim=0))


# ---------------------------------------------------------------------------
# autograd and entry point
# ---------------------------------------------------------------------------
def _f32(t):
    return t.to(_F32).contiguous()


class _ChunkedScan(torch.autograd.Function):
    """The chunked scan with the kernels' backward (JAX ``_chunked_scan``
    with ``_chunked_fwd``/``_chunked_bwd``)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, chunk):
        at = A.t().to(_F32).contiguous()
        y, h0s = split_scan_fwd(_f32(u), _f32(delta), _f32(B), _f32(C), at,
                                chunk, with_states=True)
        ctx.save_for_backward(u, delta, A, B, C, D, h0s)
        ctx.chunk = chunk
        return y + u.to(_F32) * D.to(_F32)

    @staticmethod
    def backward(ctx, g):
        u, delta, A, B, C, D, h0s = ctx.saved_tensors
        at = A.t().to(_F32).contiguous()
        g32 = _f32(g)
        du, ddelta, db, dc, dat = split_scan_bwd(
            _f32(u), _f32(delta), _f32(B), _f32(C), at, h0s, g32, ctx.chunk)
        # the D-skip terms, outside the kernel (pure elementwise)
        du = du + g32 * D.to(_F32)
        dD = (g32 * u.to(_F32)).sum(dim=(0, 1))
        return (du.to(u.dtype), ddelta.to(delta.dtype),
                dat.t().to(A.dtype), db.to(B.dtype), dc.to(C.dtype),
                dD.to(D.dtype), None)


def chunked_selective_scan(u, delta, A, B, C, D, *, chunk: int = 128):
    """y [b, s, d] float32 for ``h_t = exp(delta_t A) h_{t-1} + delta_t
    u_t B_t``, ``y_t = C_t . h_t`` (+ ``u D``). Differentiable: under
    autograd the forward saves the chunk-boundary states (row 10 with
    states) for the recompute-based backward (row 11); otherwise row 10
    runs without states."""
    s = u.shape[1]
    if u.device.type == "cpu" and s % chunk:
        raise ValueError(f"seq len {s} not divisible by chunk {chunk}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, A, B, C, D)):
        return _ChunkedScan.apply(u, delta, A, B, C, D, chunk)
    at = A.t().to(_F32).contiguous()
    y = split_scan_fwd(_f32(u), _f32(delta), _f32(B), _f32(C), at, chunk,
                       with_states=False)
    return y + u.to(_F32) * D.to(_F32)
