"""Mixture-of-Experts (counterpart of ``paddle_tpu/distributed/moe.py``;
parity: paddle's incubate ``MoELayer``): the GShard top-2 and Switch
top-1 gates with capacity, the batched expert FFN, the aux load-balance
loss, and dropless top-k routing, on one card or with the experts cut
over the mesh's ``ep`` axis.

The capacity path dispatches and combines through the ``[tokens,
experts, capacity]`` one-hot tensors, as the JAX layer does. The
dropless path sorts the (token, expert) assignments by expert (a stable
sort, as ``jnp.argsort``) and runs one ``torch.matmul`` per expert over
its segment where JAX runs ``lax.ragged_dot`` (an XLA primitive, not a
Pallas kernel); the segment sizes are read on the host, one sync a
layer. Ties between gate probabilities go to the lower expert index, as
``jnp.argmax`` and ``lax.top_k`` break them.

**Expert parallelism** (a mesh with ``ep`` > 1 in ``sharding.
current_mesh()``, which ``TrainStep`` makes its mesh). ``ExpertFFN``'s
parameters carry the JAX specs (``w1`` ``("ep", None, "tp")``, ``w2``
``("ep", "tp", None)``, ``b1`` ``("ep", "tp")``, ``b2`` ``("ep",
None)``), so ``sharding.place_params_on_mesh`` leaves each rank its
``E / ep`` experts, cut over tp as Megatron's column/row pair. The batch
is replicated over ep (cut over dp and fsdp), as JAX's ``batch_spec``
lays it out.

- ``MoELayer``: the gate runs on the tokens of the whole (dp, fsdp)
  batch, all-gathered (the backward reduce-scatters), so capacity and
  the positions within each expert are the global batch's, as GSPMD
  computes them; each rank runs its experts' slots of the dispatch and
  the outputs are all-gathered over ep.
- ``DroplessMoELayer`` (``dropless_moe_ep_apply``): each ep rank routes
  its ``t / ep`` rows of the tokens; after a count exchange the rows
  travel to the rank owning their expert by ``all_to_all_single`` with
  uneven split sizes (the ragged form JAX's docstring names; JAX
  exchanges static slots), are run there one expert at a time, and come
  back the same way; the outputs are all-gathered over ep. The tokens
  must divide by ep (``InvalidArgumentError``).

The aux loss is built from the global routing statistics: densities
and probabilities averaged over every rank that holds other tokens (dp,
fsdp and, on the dropless path, ep). Every collective is an autograd
function whose backward is its transpose; parameters replicated over ep
get whole gradients on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

import torch.distributed as dist

from .. import flags
from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import default_generator
from ..errors import InvalidArgumentError
from ..nn import functional as F
from .parallel_layers.mp_layers import (
    _all_reduce,
    axis_group,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    scatter_to_tp,
)


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _aux_loss(mask1, probs):
    """GShard's load-balance loss: e * sum(density * density proxy)."""
    return (mask1.mean(dim=0) * probs.mean(dim=0)).sum() * probs.shape[-1]


def _top2_gating(logits, capacity: int):
    """GShard top-2 gating over float32 ``logits`` [tokens, experts].
    Returns combine [t, e, c], the boolean dispatch mask [t, e, c], the
    aux loss and the dropped fraction (routed assignments past an
    expert's capacity)."""
    e = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    mask1 = _one_hot(torch.argmax(probs, dim=-1), e, probs.dtype)
    aux = _aux_loss(mask1, probs)
    probs_wo1 = probs * (1.0 - mask1)
    mask2 = _one_hot(torch.argmax(probs_wo1, dim=-1), e, probs.dtype)
    # positions within each expert (cumsum over tokens)
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1
    pos2 = (torch.cumsum(mask2, dim=0) - mask2
            + mask1.sum(dim=0, keepdim=True)) * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)
    g1 = (probs * keep1).sum(dim=-1)
    g2 = (probs * keep2).sum(dim=-1)
    denom = (g1 + g2).clamp(min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    routed = mask1.sum() + (
        mask2 * (probs_wo1.max(dim=-1).values > 0)[:, None]).sum()
    kept = keep1.sum() + keep2.sum()
    drop_fraction = 1.0 - kept / routed.clamp(min=1.0)
    cap1 = _one_hot((pos1 * keep1).sum(dim=-1).to(torch.int32), capacity,
                    probs.dtype)
    cap2 = _one_hot((pos2 * keep2).sum(dim=-1).to(torch.int32), capacity,
                    probs.dtype)
    combine = (g1[:, None, None] * keep1[:, :, None] * cap1[:, None, :]
               + g2[:, None, None] * keep2[:, :, None] * cap2[:, None, :])
    return combine, combine > 0.0, aux, drop_fraction


def _switch_gating(logits, capacity: int):
    """Switch-transformer top-1 gating; returns as ``_top2_gating``."""
    e = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    mask = _one_hot(torch.argmax(probs, dim=-1), e, probs.dtype)
    aux = _aux_loss(mask, probs)
    pos = torch.cumsum(mask, dim=0) * mask - mask
    keep = mask * (pos < capacity)
    drop_fraction = 1.0 - keep.sum() / mask.sum().clamp(min=1.0)
    g = (probs * keep).sum(dim=-1)
    cap = _one_hot((pos * keep).sum(dim=-1).to(torch.int32), capacity,
                   probs.dtype)
    combine = g[:, None, None] * keep[:, :, None] * cap[:, None, :]
    return combine, combine > 0.0, aux, drop_fraction


class ExpertFFN(Layer):
    """Batched expert FFN: weights [E, in, hidden] and [E, hidden, in],
    biases [E, hidden] and [E, in], with the JAX specs: the expert dim
    over ``expert_axis`` and hidden over tp (a column-parallel ``w1``, a
    row-parallel ``w2``: ``copy_to_tp`` before, ``reduce_from_tp`` after,
    ``b2`` once)."""

    tensor_parallel = True
    tp = None

    def __init__(self, num_experts, d_model, d_hidden, expert_axis="ep",
                 activation="gelu", init_std=0.02, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = current_device(device)
        gen = generator if generator is not None else default_generator(dev)
        init = I.Normal(0.0, init_std)
        kw = dict(device=dev, generator=gen)
        self.w1 = self.create_parameter(
            (num_experts, d_model, d_hidden), default_initializer=init,
            spec=(expert_axis, None, "tp"), **kw)
        self.w2 = self.create_parameter(
            (num_experts, d_hidden, d_model), default_initializer=init,
            spec=(expert_axis, "tp", None), **kw)
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        is_bias=True,
                                        spec=(expert_axis, "tp"), **kw)
        self.b2 = self.create_parameter((num_experts, d_model),
                                        is_bias=True,
                                        spec=(expert_axis, None), **kw)
        self.d_hidden = d_hidden
        self.act = getattr(F, activation)

    def check_tensor_parallel(self, tp: int):
        if self.d_hidden % tp:
            raise ValueError(f"tp = {tp} must divide the experts' hidden "
                             f"width {self.d_hidden}")

    def forward(self, x):
        # x: [E (this rank's experts), capacity, d_model]
        x = copy_to_tp(x, self.tp)
        h = torch.einsum("ecm,emh->ech", x, self.w1) + self.b1[:, None]
        h = self.act(h)
        y = reduce_from_tp(torch.einsum("ech,ehm->ecm", h, self.w2), self.tp)
        return y + self.b2[:, None]


# ---------------------------------------------------------------------------
# collectives of the mesh paths (autograd functions)
# ---------------------------------------------------------------------------
def _row_groups(mesh):
    """The groups of the axes that cut the batch rows, major first."""
    return [g for g in (axis_group(mesh, "dp"), axis_group(mesh, "fsdp"))
            if g is not None]


class _GatherRows(torch.autograd.Function):
    """All-gather dim 0 over the row groups (minor first, so the rows land
    in (dp, fsdp) block order); the backward reduce-scatters: every rank
    computed on all rows, and a row's gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, groups):
        from .collective import _record

        ctx.groups = groups
        for g in reversed(groups):
            _record("all_gather", g.axis, x)
            out = x.new_empty((g.size * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous(), group=g.group)
            x = out
        return x

    @staticmethod
    def backward(ctx, g):
        from .collective import _record

        g = g.contiguous()
        for grp in ctx.groups:
            _record("reduce_scatter", grp.axis, g)
            out = g.new_empty((g.shape[0] // grp.size,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM,
                                       group=grp.group)
            g = out
        return g, None


class _MeanOver(torch.autograd.Function):
    """The mean of ``x`` over every rank of ``groups`` (each holding other
    tokens); the backward sums the upstream gradient over ``summed`` (the
    groups whose losses the step adds; the others hold replicas) and
    divides by the same count."""

    @staticmethod
    def forward(ctx, x, groups, summed):
        n = 1
        x = x.clone()
        for g in groups:
            _all_reduce(x, g)
            n *= g.size
        ctx.n, ctx.summed = n, summed
        return x / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.summed:
            _all_reduce(g, grp)
        return g / ctx.n, None, None


def _global_aux(mask1, probs, groups, summed):
    """GShard's aux loss from the global routing statistics."""
    density = mask1.mean(dim=0)
    proxy = probs.mean(dim=0)
    if groups:
        density = _MeanOver.apply(density, groups, summed)
        proxy = _MeanOver.apply(proxy, groups, summed)
    return (density * proxy).sum() * probs.shape[-1]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` on dim 0 with split sizes (lists); the
    backward sends the gradients back with the splits swapped."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, grp):
        from .collective import _record

        ctx.splits, ctx.grp = (out_splits, in_splits), grp
        _record("all_to_all", grp.axis, x)
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits,
                               group=grp.group)
        return out

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return (_AllToAll.apply(g.contiguous(), in_splits, out_splits,
                                ctx.grp), None, None, None)


class MoELayer(Layer):
    """Parity: incubate ``MoELayer``. ``forward(x [b, s, d_model])``
    returns ``(y, aux_loss)``, the loss already times
    ``aux_loss_weight``, and keeps it as ``last_aux_loss`` and the dropped
    share as ``last_drop_fraction`` (0-d tensors). The capacity factor
    defaults to ``PT_FLAGS_moe_capacity_factor`` (1.25). ``device`` and
    ``generator`` as for ``ExpertFFN``."""

    def __init__(self, d_model: int, num_experts: int,
                 d_hidden: Optional[int] = None, gate: str = "gshard",
                 top_k: int = 2, capacity_factor: Optional[float] = None,
                 expert_axis: str = "ep", aux_loss_weight: float = 1e-2, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = current_device(device)
        gen = generator if generator is not None else default_generator(dev)
        self.d_model = d_model
        self.num_experts = num_experts
        self.gate_type = gate
        self.top_k = 1 if gate == "switch" else top_k
        if capacity_factor is None:
            capacity_factor = float(flags.flag("moe_capacity_factor"))
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.gate_weight = self.create_parameter(
            (d_model, num_experts), default_initializer=I.Normal(0.0, 0.02),
            device=dev, generator=gen)
        self.expert_axis = expert_axis
        self.experts = ExpertFFN(num_experts, d_model,
                                 d_hidden or 4 * d_model, expert_axis,
                                 device=dev, generator=gen)
        self.last_aux_loss = 0.0
        self.last_drop_fraction = 0.0

    def capacity(self, tokens: int) -> int:
        cap = int(self.capacity_factor * tokens * self.top_k
                  / self.num_experts)
        return max(cap, 4)

    def _gate_logits(self, xf):
        return xf.float() @ self.gate_weight.float()

    def forward(self, x):
        from .sharding import current_mesh

        b, s, m = x.shape
        xf = x.reshape(b * s, m)
        mesh = current_mesh()
        rows = _row_groups(mesh)
        ep = axis_group(mesh, self.expert_axis)
        if rows or ep is not None:
            y = self._mesh_forward(xf, rows, ep)
            return y.reshape(b, s, m), self.last_aux_loss
        logits = self._gate_logits(xf)
        cap = self.capacity(b * s)
        gating = _switch_gating if self.gate_type == "switch" \
            else _top2_gating
        combine, dispatch, aux, dropped = gating(logits, cap)
        # [t, e, c] x [t, m] -> [e, c, m]
        expert_in = torch.einsum("tec,tm->ecm", dispatch.to(x.dtype), xf)
        expert_out = self.experts(expert_in)
        y = torch.einsum("tec,ecm->tm", combine.to(x.dtype), expert_out)
        self.last_aux_loss = aux * self.aux_loss_weight
        self.last_drop_fraction = dropped
        return y.reshape(b, s, m), self.last_aux_loss

    def _mesh_forward(self, xf, rows, ep):
        """The gate over the whole (dp, fsdp) batch's tokens, this rank's
        experts' slots of the dispatch, the outputs all-gathered over ep,
        and this rank's rows of the combination."""
        t = xf.shape[0]
        full = _GatherRows.apply(xf, rows) if rows else xf
        logits = self._gate_logits(full)
        gating = _switch_gating if self.gate_type == "switch" \
            else _top2_gating
        combine, dispatch, aux, dropped = gating(
            logits, self.capacity(full.shape[0]))
        expert_in = torch.einsum("tec,tm->ecm", dispatch.to(xf.dtype), full)
        expert_out = gather_from_tp(
            self.experts(scatter_to_tp(expert_in, ep, 0)), ep, 0)
        y = torch.einsum("tec,ecm->tm", combine.to(xf.dtype), expert_out)
        self.last_aux_loss = aux * self.aux_loss_weight
        self.last_drop_fraction = dropped
        if not rows:
            return y
        idx = 0
        for g in rows:  # this rank's block of the (dp, fsdp) rows
            idx = idx * g.size + g.rank
        return y[idx * t:(idx + 1) * t]


def _dropless_topk_gating(logits, top_k: int):
    """Top-k gating with no capacity: every routed token is processed.
    Returns (expert_idx [t, k], gates [t, k] normalised, aux). Equal
    probabilities keep the lower expert first, as ``lax.top_k``."""
    e = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argsort(probs, dim=-1, descending=True,
                               stable=True)[:, :top_k]
    gates = probs.gather(-1, expert_idx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # load-balance aux on the top-1 assignment
    aux = _aux_loss(_one_hot(expert_idx[:, 0], e, probs.dtype), probs)
    return expert_idx, gates, aux


def dropless_moe_apply(x, expert_idx, gates, w1, b1, w2, b2, act):
    """Dropless dispatch: sort the (token, expert) assignments by expert
    and run one product per expert over its segment of the sorted rows.

    x: [t, m]; expert_idx / gates: [t, k]; w1: [E, m, h]; w2: [E, h, m].
    Returns [t, m], each token's expert outputs summed with its gates."""
    t, k = expert_idx.shape
    n_experts = w1.shape[0]
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)
    xs = x.repeat_interleave(k, dim=0)[order]    # [t*k, m] by expert
    group_sizes = torch.bincount(flat_e, minlength=n_experts)
    sizes = group_sizes.tolist()
    h = torch.cat([seg @ w1[e] for e, seg in enumerate(xs.split(sizes))])
    h = act(h + b1.repeat_interleave(group_sizes, dim=0))
    y = torch.cat([seg @ w2[e] for e, seg in enumerate(h.split(sizes))])
    y = y + b2.repeat_interleave(group_sizes, dim=0)
    y = y[inv].reshape(t, k, -1)                  # unsorted, [t, k, m]
    return (y * gates[..., None].to(y.dtype)).sum(dim=1)


def dropless_moe_apply(x, expert_idx, gates, w1, b1, w2, b2, act):
    """Dropless dispatch: sort the (token, expert) assignments by expert
    and run one product per expert over its segment of the sorted rows.

    x: [t, m]; expert_idx / gates: [t, k]; w1: [E, m, h]; w2: [E, h, m].
    Returns [t, m], each token's expert outputs summed with its gates."""
    t, k = expert_idx.shape
    n_experts = w1.shape[0]
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)
    xs = x.repeat_interleave(k, dim=0)[order]    # [t*k, m] by expert
    group_sizes = torch.bincount(flat_e, minlength=n_experts)
    sizes = group_sizes.tolist()
    h = torch.cat([seg @ w1[e] for e, seg in enumerate(xs.split(sizes))])
    h = act(h + b1.repeat_interleave(group_sizes, dim=0))
    y = torch.cat([seg @ w2[e] for e, seg in enumerate(h.split(sizes))])
    y = y + b2.repeat_interleave(group_sizes, dim=0)
    y = y[inv].reshape(t, k, -1)                  # unsorted, [t, k, m]
    return (y * gates[..., None].to(y.dtype)).sum(dim=1)


def _expert_ffn(xs, sizes, w1, b1, w2, b2, act, tp):
    """Rows ``xs`` grouped by expert (``sizes`` rows each) through their
    experts, one product an expert (hidden cut over ``tp``)."""
    group_sizes = torch.as_tensor(sizes, device=xs.device)
    xs = copy_to_tp(xs, tp)
    h = torch.cat([seg @ w1[e] for e, seg in enumerate(xs.split(sizes))])
    h = act(h + b1.repeat_interleave(group_sizes, dim=0))
    y = torch.cat([seg @ w2[e] for e, seg in enumerate(h.split(sizes))])
    y = reduce_from_tp(y, tp)
    return y + b2.repeat_interleave(group_sizes, dim=0)


def dropless_moe_ep_apply(xf, gate_weight, w1, b1, w2, b2, act, top_k,
                          mesh, ep_axis="ep"):
    """Dropless dispatch over the ``ep`` axis of ``mesh`` (parity: the
    reference's global_scatter -> expert FFN -> global_gather).

    ``xf`` [t, m] is this rank's tokens, the same on every ep rank
    (t % ep == 0); ``w1``/``b1``/``w2``/``b2`` are this rank's ``E / ep``
    experts (hidden cut over tp where the mesh has it). Each ep rank
    routes its ``t / ep`` rows; a count exchange sets the split sizes;
    the sorted rows go to their experts' ranks by ``all_to_all_single``,
    are regrouped by local expert, run, and return the same way; the
    outputs are all-gathered over ep. Returns ``(y [t, m], aux)``, aux
    from the global routing statistics (averaged over dp, fsdp and
    ep)."""
    from .collective import _record

    ep = axis_group(mesh, ep_axis)
    tp = axis_group(mesh, "tp")
    n_ep = ep.size if ep is not None else 1
    e_loc = w1.shape[0]
    n_exp = e_loc * n_ep
    if xf.shape[0] % n_ep:
        raise InvalidArgumentError(
            f"dropless EP: token count {xf.shape[0]} must be divisible by "
            f"ep degree {n_ep}")
    x = scatter_to_tp(xf, ep, 0)                     # this rank's rows
    gw = copy_to_tp(gate_weight, ep)                 # grads summed over ep
    logits = x.float() @ gw.float()
    expert_idx, gates, _ = _dropless_topk_gating(logits, top_k)
    probs = torch.softmax(logits, dim=-1)
    groups = _row_groups(mesh)
    aux = _global_aux(_one_hot(expert_idx[:, 0], n_exp, probs.dtype), probs,
                      groups + ([ep] if ep is not None else []), groups)

    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = x.repeat_interleave(top_k, dim=0)[order]    # by global expert
    counts = torch.bincount(flat_e, minlength=n_exp)
    if ep is None:
        sizes = counts.tolist()
        y = _expert_ffn(xs, sizes, w1, b1, w2, b2, act, tp)
    else:
        # recv[s, e]: rows rank s sends to this rank's local expert e
        recv = torch.empty_like(counts)
        _record("all_to_all", ep.axis, counts)
        dist.all_to_all_single(recv, counts.contiguous(), group=ep.group)
        send_rows = counts.reshape(n_ep, e_loc).sum(1).tolist()
        recv = recv.reshape(n_ep, e_loc)
        recv_rows = recv.sum(1).tolist()
        buf = _AllToAll.apply(xs, recv_rows, send_rows, ep)
        # received (source, expert) order -> (expert, source) groups
        labels = torch.arange(e_loc, device=buf.device).repeat(n_ep)
        labels = labels.repeat_interleave(recv.reshape(-1))
        order2 = torch.argsort(labels, stable=True)
        inv2 = torch.argsort(order2)
        y2 = _expert_ffn(buf[order2], recv.sum(0).tolist(), w1, b1, w2, b2,
                         act, tp)
        y = _AllToAll.apply(y2[inv2], send_rows, recv_rows, ep)
    y = y[torch.argsort(order)].reshape(x.shape[0], top_k, -1)
    y = (y * gates[..., None].to(y.dtype)).sum(dim=1)
    return gather_from_tp(y, ep, 0), aux


class DroplessMoELayer(MoELayer):
    """``MoELayer`` with exact (no-drop) routing through per-expert
    products, no ``[t, e, c]`` tensors; ``last_drop_fraction`` is always
    0. On a mesh (dp, fsdp, ep or tp above 1) the aux loss is the global
    batch's, the experts run their tp blocks, and with ``ep`` > 1 the
    tokens travel to their experts' ranks (``dropless_moe_ep_apply``;
    the tokens must divide by ep)."""

    def forward(self, x):
        from .sharding import current_mesh

        b, s, m = x.shape
        xf = x.reshape(b * s, m)
        ex = self.experts
        mesh = current_mesh()
        if _row_groups(mesh) or axis_group(mesh, self.expert_axis) \
                or axis_group(mesh, "tp"):
            y, aux = dropless_moe_ep_apply(
                xf, self.gate_weight, ex.w1, ex.b1, ex.w2, ex.b2, ex.act,
                self.top_k, mesh, self.expert_axis)
        else:
            expert_idx, gates, aux = _dropless_topk_gating(
                self._gate_logits(xf), self.top_k)
            y = dropless_moe_apply(xf, expert_idx, gates, ex.w1, ex.b1,
                                   ex.w2, ex.b2, ex.act)
        self.last_aux_loss = aux * self.aux_loss_weight
        self.last_drop_fraction = torch.zeros((), device=x.device)
        return y.reshape(b, s, m), self.last_aux_loss
