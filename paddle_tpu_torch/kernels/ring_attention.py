"""Ring attention: context parallelism over the sequence (counterpart of
``paddle_tpu/kernels/ring_attention.py``; parity: PaddleNLP's
RingFlashAttention, context_parallel_degree).

Each rank of the ``sep`` group holds its chunk of the sequence of q, k
and v ([batch, seq/n, heads, head_dim]). The KV blocks go round the ring
by point-to-point while the queries stay; each block is one call of the
flash forward with LSE (row 6 of the kernel table, ``mha.flash_forward(
..., with_lse=True)``) and the partial results merge by logsumexp
(``_merge``, JAX's). Three layouts (``layout``), as in JAX: non-causal,
a ``"plain"`` ring; causal with an even local chunk, the ``"zigzag"``
ring (the sequence is 2n half-chunks and rank r owns r and 2n-1-r, moved
there and back by two permutations each way, so every step costs every
rank two full L x L blocks); causal with an odd local chunk, the
``"contiguous"`` ring, whose future blocks are skipped (JAX computes
them and masks them out).

The backward (``_Ring``, a ``torch.autograd.Function``) runs the reverse
ring with the merged output and LSE: each block's dq, dk, dv come from
the backward kernels (``mha.mha_backward``: the fused pass, row 8, or
the dq and dk/dv passes, rows 7 and 9), with ``p = exp(s - lse)`` of the
merged LSE, so no LSE cotangent needs folding; dk and dv accumulate in
float32 and travel with their KV block, and one more hop brings them
home.

Each layout is written once, as a generator of this rank's body
(``ring_forward_body``, ``ring_backward_body``): it yields every exchange
(``("ring", tensors)``: send to rank + 1, receive from rank - 1;
``("perm", tensors, pairs)``: send along a permutation) and is sent the
tensors it receives. ``ring_attention`` drives it over the group by
``batch_isend_irecv``; ``run_ring_virtual`` drives the bodies of n
virtual ranks in one process, in lockstep, passing the tensors over a
list (how ``chip_smoke.py`` holds the ring against one whole-sequence
call on one card). On the card every block launches its kernel or
raises; on the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import flags
from . import mha as _mha

NEG_INF = -1e30


def _merge(o_a, lse_a, o_b, lse_b):
    """Logsumexp merge of two normalized partials (o [b, s, h, d] float32,
    lse [b, h, s])."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    wb = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return o_a * wa + o_b.float() * wb, lse


def layout(n: int, local_len: int, causal: bool) -> str:
    """JAX's choice: ``plain`` when not causal, ``zigzag`` for an even
    local chunk, else ``contiguous``."""
    if not causal:
        return "plain"
    return "zigzag" if local_len % 2 == 0 else "contiguous"


def _plan(kind: str, i: int, src: int, rank: int, L: int):
    """The blocks of step ``i`` (holding rank ``src``'s KV): (q rows, kv
    rows, causal) as slices of dim 1 of this rank's chunks."""
    full = slice(None)
    if i == 0:
        return [(full, full, kind != "plain")]
    if kind == "plain":
        return [(full, full, False)]
    if kind == "contiguous":
        return [(full, full, False)] if src < rank else []
    # zigzag: chunks (rank, 2n-1-rank) against (src, 2n-1-src)
    if src < rank:
        return [(full, slice(0, L), False)]
    return [(slice(L, None), full, False)]


def _owner(c: int, n: int) -> int:
    """Zigzag owner rank of global half-chunk ``c`` (of 2n)."""
    return c if c < n else 2 * n - 1 - c


def _zig_perms(n: int):
    even = [(s, _owner(2 * s, n)) for s in range(n)]
    odd = [(s, _owner(2 * s + 1, n)) for s in range(n)]
    return even, odd


def _to_zigzag(ts, rank, n):
    """Contiguous chunks -> (half-chunk rank ; half-chunk 2n-1-rank)."""
    even, odd = _zig_perms(n)
    L = ts[0].shape[1] // 2
    a_even = yield ("perm", tuple(t[:, :L] for t in ts), even)
    a_odd = yield ("perm", tuple(t[:, L:] for t in ts), odd)
    first, second = (a_even, a_odd) if rank % 2 == 0 else (a_odd, a_even)
    return tuple(torch.cat([a, b], dim=1) for a, b in zip(first, second))


def _from_zigzag(ts, rank, n):
    even, odd = _zig_perms(n)
    inv_even = [(d, s) for s, d in even]
    inv_odd = [(d, s) for s, d in odd]
    L = ts[0].shape[1] // 2
    lo, hi = tuple(t[:, :L] for t in ts), tuple(t[:, L:] for t in ts)
    even_part, odd_part = (lo, hi) if rank % 2 == 0 else (hi, lo)
    h0 = yield ("perm", even_part, inv_even)   # half-chunk 2 rank
    h1 = yield ("perm", odd_part, inv_odd)     # half-chunk 2 rank + 1
    return tuple(torch.cat([a, b], dim=1) for a, b in zip(h0, h1))


def _block_fwd(q, k, v, causal, scale):
    return _mha.flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal, scale, with_lse=True)


def _block_bwd(q, k, v, o, lse, do, causal, scale):
    return _mha.mha_backward(
        q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous(),
        lse.contiguous(), do.to(q.dtype).contiguous(), None, causal, scale,
        k_block=int(flags.flag("flash_attention_block_k")))


def ring_forward_body(kind, q, k, v, rank: int, n: int, scale: float):
    """This rank's forward (a generator; see the module docstring).
    Returns ``(out in q's layout and dtype, saved)``, ``saved`` the
    (zigzag-ordered where ``kind`` is zigzag) q, k, v, float32 output
    and LSE the backward takes."""
    if kind == "zigzag":
        q, k, v = yield from _to_zigzag((q, k, v), rank, n)
    b, s, h, d = q.shape
    L = s // 2
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = (k, v)
    for i in range(n):
        if i:
            kv = yield ("ring", kv)
        for qs, ks, causal in _plan(kind, i, (rank - i) % n, rank, L):
            ob, lb = _block_fwd(q[:, qs], kv[0][:, ks], kv[1][:, ks],
                                causal, scale)
            o[:, qs], lse[:, :, qs] = _merge(o[:, qs], lse[:, :, qs], ob,
                                             lb)
    out = o.to(q.dtype)
    if kind == "zigzag":
        (out,) = yield from _from_zigzag((out,), rank, n)
    return out, (q, k, v, o, lse)


def ring_backward_body(kind, saved, do, rank: int, n: int, scale: float):
    """This rank's backward (a generator): the reverse ring over the
    saved forward; returns ``(dq, dk, dv)`` in the inputs' layout and
    dtype."""
    q, k, v, o, lse = saved
    if kind == "zigzag":
        (do,) = yield from _to_zigzag((do,), rank, n)
    L = q.shape[1] // 2
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
    kv = (k, v)
    for i in range(n):
        if i:
            got = yield ("ring", kv + acc)
            kv, acc = got[:2], got[2:]
        for qs, ks, causal in _plan(kind, i, (rank - i) % n, rank, L):
            dqb, dkb, dvb = _block_bwd(q[:, qs], kv[0][:, ks], kv[1][:, ks],
                                       o[:, qs], lse[:, :, qs], do[:, qs],
                                       causal, scale)
            dq[:, qs] += dqb.float()
            acc[0][:, ks] += dkb.float()
            acc[1][:, ks] += dvb.float()
    if n > 1:
        acc = yield ("ring", acc)  # each block's gradients come home
    grads = (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype))
    if kind == "zigzag":
        grads = yield from _from_zigzag(grads, rank, n)
    return grads


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------
def _drive(gen, exchange):
    try:
        req = next(gen)
        while True:
            req = gen.send(exchange(req))
    except StopIteration as stop:
        return stop.value


def _dests(req, n):
    """``(dst, src)`` maps of one exchange over n ranks."""
    if req[0] == "ring":
        return ({r: (r + 1) % n for r in range(n)},
                {r: (r - 1) % n for r in range(n)})
    dst = dict(req[2])
    return dst, {d: s for s, d in dst.items()}


class _P2P:
    """The exchanges of one rank of the sep group
    (``mp_layers.p2p_exchange``)."""

    def __init__(self, grp):
        self.grp = grp

    def __call__(self, req):
        from ..distributed.parallel_layers.mp_layers import p2p_exchange

        g = self.grp
        dst, src = _dests(req, g.size)
        ts = [t.contiguous() for t in req[1]]
        bufs = [torch.empty_like(t) for t in ts]
        p2p_exchange(g, [(dst[g.rank], t, i) for i, t in enumerate(ts)],
                     [(src[g.rank], b, i) for i, b in enumerate(bufs)])
        return tuple(bufs)


def run_ring_virtual(bodies: List):
    """Drive the generators of n virtual ranks in lockstep in this
    process, passing each exchange's tensors over a list; returns their
    results in rank order."""
    n = len(bodies)
    reqs = [next(b) for b in bodies]
    while True:
        dst, _ = _dests(reqs[0], n)
        got = [None] * n
        for r in range(n):
            got[dst[r]] = tuple(reqs[r][1])
        out = []
        for r in range(n):
            try:
                reqs[r] = bodies[r].send(got[r])
            except StopIteration as stop:
                out.append(stop.value)
        if out:
            if len(out) != n:
                raise RuntimeError("ring bodies out of step")
            return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kind, scale, grp):
        out, saved = _drive(ring_forward_body(kind, q, k, v, grp.rank,
                                              grp.size, scale), _P2P(grp))
        ctx.save_for_backward(*saved)
        ctx.attrs = (kind, scale, grp)
        return out

    @staticmethod
    def backward(ctx, do):
        kind, scale, grp = ctx.attrs
        dq, dk, dv = _drive(ring_backward_body(
            kind, ctx.saved_tensors, do.contiguous(), grp.rank, grp.size,
            scale), _P2P(grp))
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, mesh=None, axis: str = "sep",
                   causal: bool = True, scale: Optional[float] = None):
    """q, k, v: this rank's contiguous chunk [batch, seq/n, heads,
    head_dim] of a sequence cut over ``axis`` of ``mesh`` (default the
    ambient mesh); returns this rank's chunk of the attention output,
    differentiable. Where the axis is 1 (or there is no mesh) it is
    ``flash_attention``."""
    from ..distributed.parallel_layers.mp_layers import axis_group
    from ..distributed.sharding import current_mesh

    grp = axis_group(mesh if mesh is not None else current_mesh(), axis)
    if grp is None:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kind = layout(grp.size, q.shape[1], causal)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), kind,
                       scale, grp)
