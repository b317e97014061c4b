"""Mixture-of-Experts on one card (counterpart of
``paddle_tpu/distributed/moe.py``; parity: paddle's incubate
``MoELayer``): the GShard top-2 and Switch top-1 gates with capacity,
the batched expert FFN, the aux load-balance loss, and dropless top-k
routing.

The capacity path dispatches and combines through the ``[tokens,
experts, capacity]`` one-hot tensors, as the JAX layer does (GSPMD turns
its dispatch einsum into the all-to-all there; here it is a plain
product on one card). The dropless path sorts the (token, expert)
assignments by expert (a stable sort, as ``jnp.argsort``) and runs one
``torch.matmul`` per expert over its segment where JAX runs
``lax.ragged_dot`` (an XLA primitive, not a Pallas kernel); the segment
sizes are read on the host, one sync a layer. Ties between gate
probabilities go to the lower expert index, as ``jnp.argmax`` and
``lax.top_k`` break them. Expert parallelism (``ep`` > 1) needs the
collectives: ``dropless_moe_ep_apply`` raises (ROADMAP.md Queue A7).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import flags
from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import default_generator
from ..nn import functional as F

_TODO = "see ROADMAP.md Queue A7, distributed"


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
    biases [E, hidden] and [E, in]. ``expert_axis`` is the mesh axis the
    JAX layer shards the expert dim over; one card shards nothing."""

    def __init__(self, num_experts, d_model, d_hidden, expert_axis="ep",
                 activation="gelu", init_std=0.02, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = current_device(device)
        gen = generator if generator is not None else default_generator(dev)
        init = I.Normal(0.0, init_std)
        kw = dict(device=dev, generator=gen)
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden),
                                        default_initializer=init, **kw)
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model),
                                        default_initializer=init, **kw)
        self.b1 = self.create_parameter((num_experts, d_hidden),
                                        is_bias=True, **kw)
        self.b2 = self.create_parameter((num_experts, d_model),
                                        is_bias=True, **kw)
        self.act = getattr(F, activation)

    def forward(self, x):
        # x: [E, capacity, d_model]
        h = torch.einsum("ecm,emh->ech", x, self.w1) + self.b1[:, None]
        h = self.act(h)
        return torch.einsum("ech,ehm->ecm", h, self.w2) + self.b2[:, None]


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
        b, s, m = x.shape
        xf = x.reshape(b * s, m)
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


def dropless_moe_ep_apply(xf, gate_weight, w1, b1, w2, b2, act, top_k,
                          mesh, ep_axis="ep"):
    """Dropless dispatch over an ``ep`` mesh axis: needs the collectives,
    which the port does not have yet."""
    raise NotImplementedError(
        f"expert-parallel dropless MoE needs the collectives ({_TODO}); "
        "one card runs DroplessMoELayer's single-shard path")


class DroplessMoELayer(MoELayer):
    """``MoELayer`` with exact (no-drop) routing through per-expert
    products, no ``[t, e, c]`` tensors; ``last_drop_fraction`` is always
    0. One card is one shard: the ``ep`` path
    (``dropless_moe_ep_apply``) raises."""

    def forward(self, x):
        b, s, m = x.shape
        xf = x.reshape(b * s, m)
        expert_idx, gates, aux = _dropless_topk_gating(
            self._gate_logits(xf), self.top_k)
        ex = self.experts
        y = dropless_moe_apply(xf, expert_idx, gates, ex.w1, ex.b1, ex.w2,
                               ex.b2, ex.act)
        self.last_aux_loss = aux * self.aux_loss_weight
        self.last_drop_fraction = torch.zeros((), device=x.device)
        return y.reshape(b, s, m), self.last_aux_loss
