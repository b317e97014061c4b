"""The train step (counterpart of
``paddle_tpu/trainer/train_step.py: TrainStep``), on one card or over a
mesh.

``TrainStep(model, optimizer)`` runs forward, backward, the optimizer's
clip and update, in that order, eagerly: PyTorch has no single compiled
program to build. ``donate`` must stay on (the update runs in place,
which is what donation gives the JAX step).

- ``loss_fn``: ``None`` calls ``model(**batch)`` for a scalar loss (a
  Llama batch ``{"input_ids", "labels"}``); otherwise
  ``loss_fn(model(batch["input"]), batch["label"])``.
- ``master_residency``: ``"paired"`` keeps the model's bf16/fp16
  parameters beside the optimizer's float32 masters; ``"master_only"``
  keeps the masters alone between steps (each low-precision parameter's
  storage is released) and casts them back into the model at the start
  of every step, as the JAX step casts them inside its program. The
  numbers are the same either way. Call ``sync_to_model()`` before using
  the model outside the step.
- ``strategy.gradient_merge`` with ``gradient_merge_k_steps = k``: the
  batch is split into k micro-batches along its first axis, their
  gradients summed into float32 accumulators, and one update applied
  with the mean gradient and the mean loss.
- ``rng_seed`` is taken for the JAX signature and has no effect: no
  operation of the port's step draws random numbers (Llama has no
  dropout; attention dropout draws from a generator its caller passes);
  the JAX step's key feeds only the model's random operations.

**Over a mesh** (``mesh=`` a ``DeviceMesh`` from
``distributed.build_mesh``; a strategy whose degrees multiply past 1
builds one when ``mesh`` is None) the step runs the strategy's dp, fsdp
(``sharding_degree``, ZeRO stage ``sharding_configs.stage``), tp, sep
(``sep_degree``, or ``cp_degree``, which maps onto the same axis) and
ep, one process a rank, with the model's forward under
``sharding.mesh_context(mesh)``.
A pp axis is replicated, as the JAX step leaves it: pipeline models run
through ``distributed.PipelineTrainStep``.
``sharding.place_params_on_mesh`` cuts the model's parameters to this
rank's blocks of ``param_partition_spec`` (names and
``state_dict`` keys stay JAX's), and the tensor-parallel layers run their
collectives. ``shard_batch`` gives each rank its ``("dp", "fsdp")`` rows
of the global batch (with gradient merge, the rows of each global
micro-batch, so micro-batch i is JAX's); ``run(sharded=True)`` takes a
batch that is already local. Each rank's loss is weighted by its share
of the global count, so the loss, the gradients and the returned loss
are the global batch's mean, as in JAX, however unevenly the ignored
labels fall. Called without ``loss_fn``, the model counts what its loss
averages over with ``loss_count(**batch)`` (Llama and GPT: the tokens
whose label is not -100); a model without one refuses dp x fsdp > 1.
With ``loss_fn`` the count is the rows, for a loss that is a mean over
rows. At sep > 1 (a model that declares ``sequence_parallel``, the
Llama; others refuse) ``shard_batch`` also cuts the sequence axis
(``batch_seq_axis``) over sep, after shifting the global labels by one
into ``shifted_labels`` (the last position -100), and the count and the
loss are taken over dp x fsdp x sep. At ep > 1 the experts are cut over
ep and the batch is not (JAX's ``batch_spec``): the MoE layers route
their tokens (``distributed/moe.py``). Gradients are merged, then
reduced over dp, fsdp and sep: all-reduced at stages 0-1,
reduce-scattered into the slot blocks at stages 2-3. At
stage 3 each parameter is kept as a block between steps; the step
all-gathers every block over fsdp once and binds the gathered tensors in
the model for all its micro-batches (so the step's peak holds the whole
parameters, as at stage 2), and their merged gradients are
reduce-scattered once after the last. From stage 1 the optimizer's
moments and masters are this rank's blocks of
``opt_slot_partition_spec``: the update runs on the block, and at stages
1-2 the parameter is all-gathered over fsdp after it. The global-norm
clip sums the squares of sharded gradients over their groups
and counts replicated ones once. Lamb and Lars (per-parameter norms) and
``ClipGradByNorm`` refuse sharded state. ``state_dict``/
``set_state_dict``/``sync_to_model`` gather and cut by the same specs, so
a JAX ``TrainStep.state_dict`` loads on any mesh; ``state_dict(
sharded=True)`` gives this rank's blocks as ``checkpoint.Sharded``
values, and ``state_shardings()`` their layout, so
``distributed.checkpoint`` saves and loads blocks without gathering.
Telemetry's tokens and MFU count this rank's tokens.

``abstract=True`` builds the step from a model whose parameters are
``meta`` tensors (``core.meta.meta_init``) or real ones, holds nothing
and refuses ``run``; ``lower(batch_shapes).compile().memory_analysis()``
gives the argument, output, temp and alias bytes of one step on this
rank (``trainer/memplan.py``; the temp of a step over a mesh is None).

``run`` returns the step's loss as a 0-d tensor without a host sync.
While the step's norm is live (telemetry on, or one of the debug flags
below) it keeps the global norm of the gradients before clipping, in
float32, as ``last_grad_norm``, and the global-norm clip uses that norm
and does not compute it again; otherwise ``last_grad_norm`` is None, as
the JAX step emits no norm then. Two debug flags, read at every ``run``,
add one host sync a step on the loss and that norm:
``PT_FLAGS_benchmark`` prints ``[pt-benchmark] step N: X ms loss=...
grad_norm=...`` (X the wall time of the step up to that sync), and
``PT_FLAGS_check_nan_inf`` raises ``FloatingPointError`` naming the step
and the value that is not finite, after the update and before the
scheduler steps, as in JAX. The JAX step decides on the norm when it is
built, and warns when a flag is turned on later; the port decides at
every ``run``, so it has no such warning.

``telemetry``: ``None`` wires an ``observability.TrainTelemetry`` in
when ``PT_FLAGS_telemetry`` is on, as JAX does; ``False`` disables it for
this step; a ``TrainTelemetry`` is used as given. Every step records its
host wall time; a sampled step (every ``PT_FLAGS_telemetry_sample_every``)
fetches the loss and the norm, publishes loss, grad norm, tokens/s, MFU
and memory through the registry, and feeds the flight recorder and the
anomaly watchdog. MFU's FLOPs come from one step counted by
``torch.utils.flop_counter.FlopCounterMode`` (aten operations only: the
port's flash-attention kernels, launched through their own autograd
functions, are not in the count), probed once and only where the card's
peak is known.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import flags, observability
from ..distributed import sharding as shd
from ..distributed.strategy import DistributedStrategy
from ..optimizer.clip import ClipGradByGlobalNorm, ClipGradByNorm, global_norm
from ..optimizer.optimizer import Lamb, Lars, Optimizer
from . import memplan
from .memplan import target_device as _target_device

_NOT_PORTED = "not in the port (ROADMAP.md Queue C)"


def _batch_tokens(batch) -> int:
    """Telemetry unit count: tokens for LM batches (the first integer
    2-D entry), else the leading batch dim (samples)."""
    sample = 0
    for v in batch.values():
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            continue
        if not sample:
            sample = int(v.shape[0])
        if v.dim() == 2 and not v.is_floating_point() \
                and not v.is_complex() and v.dtype != torch.bool:
            return int(v.shape[0]) * int(v.shape[1])
    return sample


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return torch.as_tensor(np.asarray(v), device=device)
    return v


def _sep_degree(strategy: DistributedStrategy) -> int:
    """sep and cp map onto the one sep axis; both above 1 is refused."""
    h = strategy.hybrid_configs
    if h.sep_degree > 1 and h.cp_degree > 1:
        raise ValueError(
            f"sep_degree {h.sep_degree} and cp_degree {h.cp_degree}: both "
            f"map onto the sep axis; set one")
    return max(h.sep_degree, h.cp_degree)


class _MeshPlan:
    """What the step over a mesh keeps for each parameter: its global
    shape, its parameter and slot specs, and the collectives between
    them."""

    def __init__(self, params: Dict[str, nn.Parameter], mesh, strategy):
        self.mesh = mesh
        self.params = params
        self.stage = strategy.sharding_stage
        self.fsdp = shd._size(mesh, "fsdp")
        # parameters whose blocks differ over an axis their specs do not
        # name (a pipeline stage's layers over pp): {name: axes}
        self.layer_axes: Dict[str, tuple] = {}
        self.info = {}
        for n, p in params.items():
            shape = tuple(getattr(p, "global_shape", None) or p.shape)
            lspec = getattr(p, "spec", None)
            pspec = shd.param_partition_spec(n, shape, lspec, strategy)
            sspec = shd.opt_slot_partition_spec(n, shape, lspec, strategy)
            if getattr(p, "placement", pspec) != pspec:
                raise ValueError(f"{n} was placed as {p.placement}, not as "
                                 f"this strategy's {pspec}")
            on_use = self.fsdp > 1 and "fsdp" in shd._axes_used(pspec)
            extra = self.fsdp > 1 and not on_use \
                and "fsdp" in shd._axes_used(sspec)
            rel = None
            if extra:
                d = shd.axis_dim(sspec, "fsdp")
                plo = shd.dim_range(shape[d], shd.entry_axes(pspec[d]),
                                    mesh)[0]
                slo, shi, _ = shd.dim_range(
                    shape[d], shd.entry_axes(sspec[d]), mesh)
                rel = (d, slo - plo, shi - slo)
            self.info[n] = dict(shape=shape, pspec=pspec, sspec=sspec,
                                on_use=on_use, rel=rel)

    def sharded_state(self) -> bool:
        return any(shd.is_sharded(i["sspec"], self.mesh)
                   for n, i in self.info.items()
                   if self.params[n].requires_grad)

    def slot_view(self, n, t):
        """The slot block of a parameter block (a view)."""
        rel = self.info[n]["rel"]
        return t if rel is None else t.narrow(*rel)

    def param_from_slot(self, n, blk):
        """The parameter block from every fsdp rank's slot block."""
        i = self.info[n]
        if i["rel"] is None:
            return blk
        return shd.gather_axis(blk, i["sspec"], i["shape"], self.mesh,
                               "fsdp")[0]

    def all_reduce(self, t, axes=("dp", "fsdp", "sep")):
        from ..distributed.collective import _record

        for a in axes:
            if shd._size(self.mesh, a) > 1:
                _record("all_reduce", a, t)
                dist.all_reduce(t, group=self.mesh.get_group(a))
        return t

    def reduce_grad(self, n, g):
        """The global gradient's slot block from this rank's gradient of
        its parameter block, or at stage 3 of its gathered tensor (summed
        over dp, fsdp and sep)."""
        i = self.info[n]
        g = g.contiguous()
        if i["on_use"] or (i["rel"] is not None and self.stage >= 2):
            # at stage 3 ``g`` is the gathered tensor's gradient
            g = shd.scatter_axis(g, i["sspec"], i["shape"], self.mesh,
                                 "fsdp")
            return self.all_reduce(g, ("dp", "sep"))
        g = self.all_reduce(g)
        return self.slot_view(n, g)

    def global_norm(self, grads) -> torch.Tensor:
        """The float32 norm of the global gradients from their slot
        blocks: each group of blocks sharded over the same axes sums its
        squares over those axes; replicated ones count once."""
        sums: Dict[tuple, torch.Tensor] = {}
        for n, g in grads.items():
            key = tuple(a for a in shd._axes_used(self.info[n]["sspec"])
                        if shd._size(self.mesh, a) > 1)
            key = tuple(sorted(key + self.layer_axes.get(n, ())))
            sq = torch.sum(torch.square(g.float()))
            sums[key] = sq if key not in sums else sums[key] + sq
        total = None
        for key in sorted(sums):
            s = self.all_reduce(sums[key].clone(), key)
            total = s if total is None else total + s
        return torch.sqrt(total)

    def gather(self, n, t, slot: bool):
        i = self.info[n]
        return shd.gather_full(t.contiguous(), i["sspec" if slot else "pspec"],
                               i["shape"], self.mesh)

    def cut(self, n, t, slot: bool):
        i = self.info[n]
        return shd.cut(t, i["sspec" if slot else "pspec"], self.mesh)


class TrainStep:
    """Usage::

        ts = TrainStep(model, AdamW(...))
        loss = ts.run({"input_ids": ids, "labels": ids})
        ts.sync_to_model()

    Over a mesh, in every rank's process::

        mesh = distributed.build_mesh(dp=2, tp=2)
        ts = TrainStep(model, AdamW(...), mesh, strategy)
        loss = ts.run(global_batch)   # each rank takes its rows
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh=None,
                 strategy: Optional[DistributedStrategy] = None,
                 loss_fn: Optional[Callable] = None,
                 batch_seq_axis: Optional[int] = 1, donate: bool = True,
                 rng_seed: int = 0, abstract: bool = False,
                 master_residency: str = "paired", telemetry=None):
        self.abstract = bool(abstract)
        if self.abstract:
            telemetry = False
        if not donate:
            raise NotImplementedError(
                "donate=False: the port's update writes the parameters "
                "and the optimizer state in place")
        if master_residency not in ("paired", "master_only"):
            raise ValueError(
                f"master_residency must be 'paired' or 'master_only', "
                f"got {master_residency!r}")
        self.strategy = strategy or DistributedStrategy()
        sep = _sep_degree(self.strategy)
        if mesh is None and self.strategy.hybrid_configs.total() > 1:
            from ..distributed.topology import build_mesh

            h = self.strategy.hybrid_configs
            mesh = build_mesh(dp=h.dp_degree, pp=h.pp_degree,
                              fsdp=h.sharding_degree, ep=h.ep_degree,
                              sep=sep, tp=h.mp_degree)
        self.mesh = mesh
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.batch_seq_axis = batch_seq_axis
        self.master_residency = master_residency
        if mesh is not None:
            self._check_model(mesh)
            self._refuse_uncounted_loss()
            shd.place_params_on_mesh(model, mesh, self.strategy)
        self._param_objs: Dict[str, nn.Parameter] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self._param_objs:
            raise ValueError("the model has no trainable parameters")
        self.device = _target_device(next(iter(self._param_objs.values())))
        self._plan = None
        self._bound = []
        if mesh is not None:
            # every parameter, frozen ones too (they are cut and gathered
            # alike; only the trainable ones have slots)
            self._plan = _MeshPlan(dict(model.named_parameters()), mesh,
                                   self.strategy)
            self._refuse_sharded_norms(optimizer)
        self.opt_state = optimizer.init(
            {n: self._slot_view(n, p.detach())
             for n, p in self._param_objs.items()})
        masters = self.opt_state.get("master", {})
        if master_residency == "master_only" and not masters:
            raise ValueError(
                "master_residency='master_only' needs fp32 masters: use "
                "an optimizer with multi_precision=True and bf16/fp16 "
                "parameters")
        self._master_dtypes: Dict[str, torch.dtype] = (
            {n: self._param_objs[n].dtype for n in masters}
            if master_residency == "master_only" else {})
        self._release_copies()
        self.gradient_merge_k = (self.strategy.gradient_merge_k_steps
                                 if self.strategy.gradient_merge else 1)
        if self.gradient_merge_k < 1:
            raise ValueError(f"gradient_merge_k_steps must be >= 1; got "
                             f"{self.gradient_merge_k}")
        self.step_count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        want_tel = (observability.enabled() if telemetry is None
                    else bool(telemetry))
        self.telemetry = None
        if want_tel:
            self.telemetry = (
                telemetry
                if isinstance(telemetry, observability.TrainTelemetry)
                else observability.TrainTelemetry())
        self._flops_per_step: Optional[float] = None
        self._flops_probed = False

    # ------------------------------------------------------------------
    # the mesh's parameter layout
    # ------------------------------------------------------------------
    def _check_model(self, mesh):
        """What a model refuses over ``mesh``: sep > 1 unless it declares
        ``sequence_parallel``; a pipeline model over pp > 1 (its schedules
        are ``PipelineTrainStep``'s)."""
        from ..distributed.pipeline import PipelineModule

        sep = shd._size(mesh, "sep")
        if sep > 1 and not getattr(self.model, "sequence_parallel", False):
            raise NotImplementedError(
                f"{type(self.model).__name__} does not run sequence "
                f"parallelism (sep = {sep}): only the Llama does "
                f"({_NOT_PORTED})")
        if isinstance(self.model, PipelineModule) \
                and shd._size(mesh, "pp") > 1:
            raise NotImplementedError(
                "a PipelineModule over pp > 1 trains through "
                "distributed.PipelineTrainStep, which runs its schedules")

    def _refuse_sharded_norms(self, optimizer):
        if not self._plan.sharded_state():
            return
        if isinstance(optimizer, (Lamb, Lars)):
            raise NotImplementedError(
                f"{type(optimizer).__name__} takes per-parameter norms, "
                f"which sharded state would need collectives for: "
                f"{_NOT_PORTED}")
        if isinstance(optimizer.grad_clip, ClipGradByNorm):
            raise NotImplementedError(
                f"ClipGradByNorm over sharded gradients is {_NOT_PORTED}")

    def _refuse_uncounted_loss(self):
        if self.loss_fn is not None or hasattr(self.model, "loss_count") \
                or self._batch_ranks() == 1:
            return
        raise NotImplementedError(
            f"{type(self.model).__name__} has no loss_count, so its loss "
            f"cannot be made the global batch's mean over dp x fsdp: "
            f"{_NOT_PORTED}")

    def _batch_ranks(self) -> int:
        return shd._size(self.mesh, "dp") * shd._size(self.mesh, "fsdp")

    def _bind_gathered(self) -> Dict[str, torch.Tensor]:
        """ZeRO-3: all-gather each parameter block of ``on_use`` over fsdp
        and bind the gathered tensor, a leaf of its own, in every module
        slot holding the block; returns them by name. ``_unbind`` puts
        the blocks back."""
        plan = self._plan
        full: Dict[str, torch.Tensor] = {}
        if plan is None:
            return full
        by_id = {}
        with torch.no_grad():
            for n, p in plan.params.items():
                i = plan.info[n]
                if i["on_use"]:
                    full[n] = shd.gather_axis(
                        p.detach(), i["pspec"], i["shape"], plan.mesh,
                        "fsdp")[0].requires_grad_(p.requires_grad)
                    by_id[id(p)] = full[n]
        for mod in self.model.modules():
            for local, p in mod._parameters.items():
                if p is not None and id(p) in by_id:
                    mod._parameters[local] = by_id[id(p)]
                    self._bound.append((mod, local, p))
        return full

    def _unbind(self):
        for mod, local, blk in self._bound:
            mod._parameters[local] = blk
        self._bound = []

    def _slot_view(self, n, t):
        return t if self._plan is None else self._plan.slot_view(n, t)

    def _param_value(self, n, slot_value):
        """A parameter block from its slot block."""
        if self._plan is None:
            return slot_value
        return self._plan.param_from_slot(n, slot_value)

    # ------------------------------------------------------------------
    def _release_copies(self):
        """master_only: free each master-backed parameter's storage (an
        abstract step holds none)."""
        if self.abstract:
            return
        for n, dt in self._master_dtypes.items():
            self._param_objs[n].data = torch.empty(0, dtype=dt,
                                                   device=self.device)

    def _cast_from_masters(self):
        for n, dt in self._master_dtypes.items():
            self._param_objs[n].data = self._param_value(
                n, self.opt_state["master"][n].to(dt))

    def _loss(self, batch):
        if self.loss_fn is None:
            return self.model(**batch)
        return self.loss_fn(self.model(batch["input"]), batch["label"])

    def _loss_count(self, batch) -> torch.Tensor:
        """What this rank's loss averages over: the model's
        ``loss_count`` (tokens), else the rows of the batch."""
        count = getattr(self.model, "loss_count", None)
        if self.loss_fn is None and count is not None:
            return count(**batch).float()
        rows = next(v.shape[0] for v in batch.values()
                    if isinstance(v, torch.Tensor) and v.dim() > 0)
        return torch.tensor(float(rows), device=self.device)

    def _micro_batches(self, batch):
        k = self.gradient_merge_k
        if k == 1:
            return [batch]
        parts = [{} for _ in range(k)]
        for name, v in batch.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                if v.shape[0] % k:
                    raise ValueError(f"gradient_merge: batch {v.shape[0]} "
                                     f"not divisible by k_steps {k}")
                for part, chunk in zip(parts, v.chunk(k, dim=0)):
                    part[name] = chunk
            else:
                for part in parts:
                    part[name] = v
        return parts

    def shard_batch(self, batch: Dict, device=None) -> Dict:
        """This rank's part of a global batch: block ``(dp, fsdp)`` of
        dim 0 (with gradient merge, that block of each of the k global
        micro-batches, in order) and, at sep > 1, block ``sep`` of the
        sequence axis, after ``labels`` became ``shifted_labels`` (a
        model's own loss only), on ``device`` (the step's by default).
        Without a mesh, the batch as given."""
        device = self.device if device is None else device
        batch = {n: _as_tensor(v, device) for n, v in batch.items()}
        if self.mesh is None:
            return batch
        sep = shd._size(self.mesh, "sep")
        if sep > 1 and self.loss_fn is None and "labels" in batch:
            labels = batch.pop("labels")
            pad = torch.full_like(labels[:, :1], -100)
            batch["shifted_labels"] = torch.cat([labels[:, 1:], pad], 1)
        k = self.gradient_merge_k
        n = self._batch_ranks()
        ax = self.batch_seq_axis
        out = {}
        for name, v in batch.items():
            if not (isinstance(v, torch.Tensor) and v.dim() > 0):
                out[name] = v
                continue
            if v.shape[0] % (n * k):
                raise ValueError(
                    f"batch {name}: {v.shape[0]} rows do not split over "
                    f"dp x fsdp = {n} ranks x {k} micro-batches")
            parts = v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
            lo, hi, _ = shd.dim_range(parts.shape[1], ("dp", "fsdp"),
                                      self.mesh)
            v = parts[:, lo:hi].reshape((k * (hi - lo),) + tuple(v.shape[1:]))
            if sep > 1 and ax is not None and v.dim() > ax:
                if v.shape[ax] % sep:
                    raise ValueError(
                        f"batch {name}: sequence {v.shape[ax]} does not "
                        f"split over sep = {sep}")
                lo, hi, _ = shd.dim_range(v.shape[ax], ("sep",), self.mesh)
                v = v.narrow(ax, lo, hi - lo)
            out[name] = v.contiguous()
        return out

    def run(self, batch: Dict, sharded: bool = False) -> torch.Tensor:
        """One optimizer step over ``batch`` (numpy arrays or tensors,
        moved to the model's device); returns the loss. It takes its
        gradients inside ``no_grad()`` or ``set_grad_enabled(False)``
        too, as the JAX step does. Over a mesh,
        ``batch`` is the global batch, or with ``sharded`` this rank's
        rows of it (``shard_batch``). An abstract step raises
        ``RuntimeError``: it holds no parameters (``lower`` plans it)."""
        if self.abstract:
            raise RuntimeError(
                "TrainStep(abstract=True) holds no real parameters; use "
                "lower() for its memory plan, or build the step without "
                "abstract to run it")
        tel = self.telemetry
        bench = bool(flags.flag("benchmark"))
        check = bool(flags.flag("check_nan_inf"))
        t0 = time.perf_counter() if tel is not None or bench else 0.0
        if sharded:
            batch = {n: _as_tensor(v, self.device) for n, v in batch.items()}
        else:
            batch = self.shard_batch(batch)
        params = self._param_objs
        self._cast_from_masters()
        for p in params.values():
            p.grad = None
        try:
            # a step trains inside no_grad() too, as the JAX step does
            with torch.enable_grad():
                if self._plan is None:
                    loss, grads = self._forward_backward(batch)
                else:
                    loss, grads = self._mesh_forward_backward(batch)
        finally:
            self._unbind()
        clip_norm = isinstance(self.optimizer.grad_clip,
                               ClipGradByGlobalNorm)
        with torch.no_grad():
            # the norm only while something reads it (the clip computes
            # its own otherwise, on one card)
            want = tel is not None or bench or check
            norm = None
            if self._plan is not None and (want or clip_norm):
                norm = self._plan.global_norm(grads)
            elif want:
                norm = global_norm(grads)
            self.last_grad_norm = norm if want else None
            carried = {n: self._slot_view(n, p.detach())
                       for n, p in params.items()
                       if n not in self._master_dtypes}
            self.optimizer.update(grads, self.opt_state, carried,
                                  grad_norm=norm)
            if self._plan is not None:
                for n, v in carried.items():
                    if self._plan.info[n]["rel"] is not None:
                        params[n].data.copy_(self._param_value(n, v))
        for p in params.values():
            p.grad = None
        del grads
        self._release_copies()
        self.step_count += 1
        if bench or check:
            self._debug_flags(loss, bench, check, t0)
        if tel is not None:
            # loss and norm stay on the device unless this step is
            # sampled (TrainTelemetry fetches them only then); over a
            # mesh the tokens are this rank's
            tel.on_step(self.step_count, loss, self.last_grad_norm,
                        tokens=_batch_tokens(batch),
                        wall_s=time.perf_counter() - t0,
                        flops_getter=lambda: self._cost_flops(batch))
        if self.optimizer._lr_scheduler is not None:
            self.optimizer._lr_scheduler.step()
        return loss

    def lower(self, batch_shapes: Dict) -> memplan.Lowered:
        """The step against abstract inputs (``batch_shapes``: arrays,
        tensors or anything with ``shape`` and ``dtype``, at the global
        batch's shapes); ``.compile().memory_analysis()`` gives this
        rank's argument, output, temp and alias bytes
        (``trainer/memplan.py``). Nothing is allocated on the device."""
        return memplan.Lowered(self, batch_shapes)

    def _forward_backward(self, batch):
        params = self._param_objs
        micro = self._micro_batches(batch)
        if len(micro) == 1:
            loss = self._loss(micro[0])
            loss.backward()
            grads = {n: p.grad for n, p in params.items()
                     if p.grad is not None}
            return loss.detach(), grads
        acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                              device=self.device)
               for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in micro:
            loss = self._loss(mb)
            loss.backward()
            with torch.no_grad():
                for n, p in params.items():
                    if p.grad is not None:
                        acc[n] += p.grad.float()
                        p.grad = None
                loss_sum += loss.detach().float()
        k = len(micro)
        return loss_sum / k, {n: a / k for n, a in acc.items()}

    def _mesh_forward_backward(self, batch):
        """The global batch's loss and this rank's slot blocks of the
        global gradients: each micro-batch's local mean is weighted by
        its share of the micro-batch's global count (a mean over no token
        is 0), the gradients merged, then reduced."""
        plan, params = self._plan, self._param_objs
        micro = self._micro_batches(batch)
        k = len(micro)
        counts = torch.stack([self._loss_count(mb) for mb in micro])
        totals = plan.all_reduce(counts.clone())
        weights = counts.clamp(min=1) / totals.clamp(min=1) / k
        full = self._bind_gathered()
        acc: Dict[str, torch.Tensor] = {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, mb in enumerate(micro):
            with shd.mesh_context(plan.mesh):
                loss = self._loss(mb).float() * weights[i]
                loss.backward()
            with torch.no_grad():
                for n, p in params.items():
                    src = full.get(n, p)
                    if src.grad is None:
                        continue
                    g = src.grad if k == 1 else src.grad.float()
                    acc[n] = g if n not in acc else acc[n] + g
                    src.grad = None
                loss_sum += loss.detach()
        self._unbind()
        with torch.no_grad():
            loss = plan.all_reduce(loss_sum)
            grads = {n: plan.reduce_grad(n, g) for n, g in acc.items()}
        return loss, grads

    def _debug_flags(self, loss, bench, check, t0):
        """``PT_FLAGS_benchmark`` and ``PT_FLAGS_check_nan_inf``: one host
        sync on the loss and the grad norm, then JAX's line and check."""
        loss_f, gnorm_f = torch.stack(
            [loss.float(), self.last_grad_norm.float()]).tolist()
        if bench:
            wall_ms = (time.perf_counter() - t0) * 1e3
            print(f"[pt-benchmark] step {self.step_count}: "
                  f"{wall_ms:.2f} ms  loss={loss_f:.6g}"
                  f"  grad_norm={gnorm_f:.6g}", flush=True)
        if check:
            bad = [n for n, v in (("loss", loss_f), ("grad_norm", gnorm_f))
                   if not math.isfinite(v)]
            if bad:
                raise FloatingPointError(
                    f"PT_FLAGS_check_nan_inf: non-finite {'/'.join(bad)} "
                    f"at step {self.step_count} (loss={loss_f}, "
                    f"grad_norm={gnorm_f})")

    def _cost_flops(self, batch) -> Optional[float]:
        """Per-step FLOPs of one forward and backward over ``batch``
        (this rank's), counted by ``FlopCounterMode`` and probed once
        (the parameters and the optimizer state are not touched; the
        gradients are dropped); None when nothing was counted."""
        if self._flops_probed:
            return self._flops_per_step
        self._flops_probed = True
        from torch.utils.flop_counter import FlopCounterMode

        self._cast_from_masters()
        try:
            self._bind_gathered()
            with FlopCounterMode(display=False) as counter, \
                    shd.mesh_context(self.mesh):
                for mb in self._micro_batches(batch):
                    self._loss(mb).backward()
            flops = counter.get_total_flops()
        except Exception:
            flops = 0
        finally:
            self._unbind()
            for p in self._param_objs.values():
                p.grad = None
            self._release_copies()
        self._flops_per_step = float(flops) if flops > 0 else None
        return self._flops_per_step

    # ------------------------------------------------------------------
    def _materialized_params(self):
        """Every trainable parameter at the model's dtype (this rank's
        blocks over a mesh); master-only ones cast from their masters."""
        out = {}
        for n, p in self._param_objs.items():
            if n in self._master_dtypes:
                out[n] = self._param_value(n, self.opt_state["master"][n].to(
                    self._master_dtypes[n]))
            else:
                out[n] = p.detach()
        return out

    def sync_to_model(self):
        """Write the current values into the model's parameters (under
        master_only, casts of the masters; a no-op otherwise). Over a mesh
        the model holds this rank's blocks; ``state_dict()["params"]``
        gives the global values."""
        self._cast_from_masters()

    def _slot_shaped(self, n, v) -> bool:
        """A slot laid out like its parameter's slot block (the others,
        such as scalars, are whole on every rank)."""
        blk = tuple(self.opt_state["master"][n].shape) \
            if n in self._master_dtypes else \
            tuple(self._plan.slot_view(n, self._param_objs[n].detach()).shape)
        return tuple(v.shape) == blk

    def state_dict(self, sharded: bool = False):
        """``{"params", "opt_state", "step"}`` at the global shapes (over
        a mesh, gathered by the parameter and slot specs: every rank
        takes part, every rank gets the whole). ``sharded=True``: over a
        mesh, this rank's blocks as ``checkpoint.Sharded`` values
        instead, nothing gathered (what ``checkpoint.save_state_dict``
        writes block by block)."""
        params = self._materialized_params()
        if self._plan is None:
            return {"params": params, "opt_state": self.opt_state,
                    "step": self.step_count}
        plan = self._plan
        if sharded:
            from ..distributed.checkpoint import Sharded

            def take(n, v, slot):
                i = plan.info[n]
                return Sharded(v, i["shape"], i["sspec" if slot else
                                                 "pspec"], plan.mesh)
        else:
            def take(n, v, slot):
                return plan.gather(n, v, slot=slot)
        st = self.opt_state
        slots = {n: {k: (take(n, v, True) if self._slot_shaped(n, v) else v)
                     for k, v in sl.items()}
                 for n, sl in st["slots"].items()}
        opt = {"step": st["step"], "slots": slots}
        if "master" in st:
            opt["master"] = {n: take(n, m, True)
                             for n, m in st["master"].items()}
        return {"params": {n: take(n, v, False) for n, v in params.items()},
                "opt_state": opt, "step": self.step_count}

    def state_shardings(self):
        """The layout of ``state_dict()``'s tensors on this mesh:
        ``sharding.Sharding(mesh, spec)`` for each parameter and each slot
        laid out like it, None for the rest (what
        ``checkpoint.load_state_dict(path, shardings=...)`` reads this
        rank's blocks by). None without a mesh."""
        plan = self._plan
        if plan is None:
            return None

        def sh(n, slot):
            i = plan.info[n]
            return shd.Sharding(plan.mesh, i["sspec" if slot else "pspec"])

        st = self.opt_state
        out = {"params": {n: sh(n, False) for n in self._param_objs},
               "opt_state": {
                   "step": None,
                   "slots": {n: {k: (sh(n, True) if self._slot_shaped(n, v)
                                     else None) for k, v in sl.items()}
                             for n, sl in st["slots"].items()}},
               "step": None}
        if "master" in st:
            out["opt_state"]["master"] = {n: sh(n, True)
                                          for n in st["master"]}
        return out

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Restore from ``state_dict()``'s layout (tensors or numpy
        arrays, at the global shapes), copying into the held tensors
        (over a mesh, cut to this rank's blocks); a params-only restore
        refreshes the float32 masters too."""
        plan = self._plan

        def src(n, v, slot):
            t = _as_tensor(v, self.device)
            if plan is None or tuple(t.shape) != plan.info[n]["shape"]:
                return t
            return plan.cut(n, t, slot)

        for n, v in sd["params"].items():
            if n not in self._master_dtypes:
                self._param_objs[n].data.copy_(src(n, v, False))
        masters = self.opt_state.get("master", {})
        if "opt_state" not in sd:
            for n, m in masters.items():
                if n in sd["params"]:
                    m.copy_(src(n, sd["params"][n], True))
        else:
            s = sd["opt_state"]
            self.opt_state["step"].copy_(_as_tensor(s["step"], self.device))
            for n, slots in s["slots"].items():
                for k, v in slots.items():
                    self.opt_state["slots"][n][k].copy_(src(n, v, True))
            for n, v in s.get("master", {}).items():
                masters[n].copy_(src(n, v, True))
        self.step_count = int(sd.get("step", 0))
