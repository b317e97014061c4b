"""Ulysses (SEP) attention: an all-to-all swaps the sequence and the heads
around attention (counterpart of ``paddle_tpu/kernels/ulysses.py``;
parity: the "sep" axis of Fleet's HybridCommunicateGroup,
DeepSpeed-Ulysses).

Outside attention each rank of the ``sep`` group holds its chunk of the
sequence for its tp heads. ``all_to_all_single`` over the sep group
gives it the whole sequence for ``1/sep`` of those heads (the heads dim
cut over ``("tp", "sep")``, JAX's ``_head_entry``); ``flash_attention``
runs (rows 5-9 on the card); the inverse all-to-all restores the
sequence cut. Both exchanges are autograd functions whose backward is
the other. Where the kv heads do not divide over sep (JAX's head entry
falls back to tp alone) k and v are all-gathered over the sequence (the
backward reduce-scatters) and each rank takes the kv heads of its query
heads; where the query heads do not divide either, every rank attends
over the whole gathered sequence with all its heads and keeps its own
rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .flash_attention import _reference_attention, flash_attention


def _a2a(x, grp):
    from ..distributed.collective import _record

    _record("all_to_all", grp.axis, x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=grp.group)
    return out


def _seq_to_heads(x, grp):
    """[b, s/n, H, d] -> [b, s, H/n, d]."""
    b, sl, h, d = x.shape
    n = grp.size
    parts = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)
    out = _a2a(parts.contiguous(), grp)           # [src, b, sl, H/n, d]
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)


def _heads_to_seq(x, grp):
    """[b, s, H/n, d] -> [b, s/n, H, d]."""
    b, s, hl, d = x.shape
    n = grp.size
    parts = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4)
    out = _a2a(parts.contiguous(), grp)           # [src, b, s/n, H/n, d]
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _seq_to_heads(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.grp), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _heads_to_seq(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.grp), None


class _GatherSeq(torch.autograd.Function):
    """All-gather dim 1 over the group; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, grp):
        from ..distributed.collective import _record

        ctx.grp = grp
        xs = x.transpose(0, 1).contiguous()
        _record("all_gather", grp.axis, xs)
        out = xs.new_empty((grp.size * xs.shape[0],) + tuple(xs.shape[1:]))
        dist.all_gather_into_tensor(out, xs, group=grp.group)
        return out.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import _record

        grp = ctx.grp
        gs = g.transpose(0, 1).contiguous()
        _record("reduce_scatter", grp.axis, gs)
        out = gs.new_empty((gs.shape[0] // grp.size,) + tuple(gs.shape[1:]))
        dist.reduce_scatter_tensor(out, gs, op=dist.ReduceOp.SUM,
                                   group=grp.group)
        return out.transpose(0, 1).contiguous(), None


def ulysses_attention(q, k, v, causal: bool = True, scale=None,
                      training: bool = True, use_flash: bool = True):
    """[batch, seq/sep, heads, head_dim] attention with the sep
    all-to-all around it (the ambient mesh's sep axis; without one, plain
    attention). ``use_flash=False`` takes the dense reference."""
    from ..distributed.parallel_layers.mp_layers import axis_group
    from ..distributed.sharding import current_mesh

    def attend(q, k, v):
        if use_flash:
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   training=training)
        return _reference_attention(q, k, v, causal=causal, scale=scale)

    grp = axis_group(current_mesh(), "sep")
    if grp is None:
        return attend(q, k, v)
    n = grp.size
    hq, hk = q.shape[2], k.shape[2]
    if hq % n == 0 and hk % n == 0:
        out = attend(_SeqToHeads.apply(q, grp), _SeqToHeads.apply(k, grp),
                     _SeqToHeads.apply(v, grp))
        return _HeadsToSeq.apply(out, grp)
    k = _GatherSeq.apply(k.contiguous(), grp)
    v = _GatherSeq.apply(v.contiguous(), grp)
    if hq % n == 0:
        # this rank's query heads against the kv heads they read
        lo, hl = grp.rank * (hq // n), hq // n
        k = k.repeat_interleave(hq // hk, dim=2)[:, :, lo:lo + hl]
        v = v.repeat_interleave(hq // hk, dim=2)[:, :, lo:lo + hl]
        out = attend(_SeqToHeads.apply(q, grp), k, v)
        return _HeadsToSeq.apply(out, grp)
    sl = q.shape[1]
    out = attend(_GatherSeq.apply(q.contiguous(), grp), k, v)
    return out[:, grp.rank * sl:(grp.rank + 1) * sl]
