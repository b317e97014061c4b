"""The train step on one card (counterpart of
``paddle_tpu/trainer/train_step.py: TrainStep``).

``TrainStep(model, optimizer)`` runs forward, backward, the optimizer's
clip and update, in that order, eagerly: PyTorch has no single compiled
program to build. Its arguments are the JAX ones, held to what one card
does: ``mesh`` must be ``None``, the strategy must ask for one device,
``batch_seq_axis`` may be 1 or ``None`` (nothing is sharded, so the two
are the same), ``donate`` must stay on (the update runs in place, which
is what donation gives the JAX step) and ``run(sharded=True)`` raises.

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
peak is known. ``abstract=True`` and ``lower()`` wait for the
distributed stack (ROADMAP.md Queue A7).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import flags, observability
from ..distributed.strategy import DistributedStrategy
from ..optimizer.clip import global_norm
from ..optimizer.optimizer import Optimizer

_TODO = "see ROADMAP.md Queue A"


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


class TrainStep:
    """Usage::

        ts = TrainStep(model, AdamW(...))
        loss = ts.run({"input_ids": ids, "labels": ids})
        ts.sync_to_model()
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, mesh=None,
                 strategy: Optional[DistributedStrategy] = None,
                 loss_fn: Optional[Callable] = None,
                 batch_seq_axis: Optional[int] = 1, donate: bool = True,
                 rng_seed: int = 0, abstract: bool = False,
                 master_residency: str = "paired", telemetry=None):
        if mesh is not None:
            raise NotImplementedError(
                f"TrainStep runs on one card: mesh must be None ({_TODO}, "
                "distributed)")
        if abstract:
            raise NotImplementedError(
                f"abstract=True (AOT lowering) is not ported ({_TODO})")
        if batch_seq_axis not in (1, None):
            raise NotImplementedError(
                f"batch_seq_axis={batch_seq_axis}: on one card the batch "
                f"is not sharded; 1 or None ({_TODO}, distributed)")
        if not donate:
            raise NotImplementedError(
                "donate=False: the port's update writes the parameters "
                "and the optimizer state in place")
        if master_residency not in ("paired", "master_only"):
            raise ValueError(
                f"master_residency must be 'paired' or 'master_only', "
                f"got {master_residency!r}")
        self.model = model
        self.optimizer = optimizer
        self.strategy = strategy or DistributedStrategy()
        self.strategy.check_one_device()
        self.loss_fn = loss_fn
        self.master_residency = master_residency
        self._param_objs: Dict[str, nn.Parameter] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self._param_objs:
            raise ValueError("the model has no trainable parameters")
        self.device = next(iter(self._param_objs.values())).device
        self.opt_state = optimizer.init(
            {n: p.detach() for n, p in self._param_objs.items()})
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
    def _release_copies(self):
        """master_only: free each master-backed parameter's storage."""
        for n, dt in self._master_dtypes.items():
            self._param_objs[n].data = torch.empty(0, dtype=dt,
                                                   device=self.device)

    def _cast_from_masters(self):
        for n, dt in self._master_dtypes.items():
            self._param_objs[n].data = self.opt_state["master"][n].to(dt)

    def _loss(self, batch):
        if self.loss_fn is None:
            return self.model(**batch)
        return self.loss_fn(self.model(batch["input"]), batch["label"])

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

    def run(self, batch: Dict, sharded: bool = False) -> torch.Tensor:
        """One optimizer step over ``batch`` (numpy arrays or tensors,
        moved to the model's device); returns the loss. ``sharded``
        (a batch already laid out over a mesh) has no meaning on one card
        and raises."""
        if sharded:
            raise NotImplementedError(
                f"run(sharded=True): the step runs on one card ({_TODO}, "
                "distributed)")
        tel = self.telemetry
        bench = bool(flags.flag("benchmark"))
        check = bool(flags.flag("check_nan_inf"))
        t0 = time.perf_counter() if tel is not None or bench else 0.0
        batch = {n: _as_tensor(v, self.device) for n, v in batch.items()}
        params = self._param_objs
        self._cast_from_masters()
        for p in params.values():
            p.grad = None
        micro = self._micro_batches(batch)
        if len(micro) == 1:
            loss = self._loss(micro[0])
            loss.backward()
            grads = {n: p.grad for n, p in params.items()
                     if p.grad is not None}
            loss = loss.detach()
        else:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=self.device)
                   for n, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
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
            grads = {n: a / k for n, a in acc.items()}
            loss = loss_sum / k
        with torch.no_grad():
            # the norm only while something reads it (the clip computes
            # its own otherwise)
            self.last_grad_norm = (global_norm(grads)
                                   if tel is not None or bench or check
                                   else None)
            carried = {n: p.detach() for n, p in params.items()
                       if n not in self._master_dtypes}
            self.optimizer.update(grads, self.opt_state, carried,
                                  grad_norm=self.last_grad_norm)
        for p in params.values():
            p.grad = None
        del grads
        self._release_copies()
        self.step_count += 1
        if bench or check:
            self._debug_flags(loss, bench, check, t0)
        if tel is not None:
            # loss and norm stay on the device unless this step is
            # sampled (TrainTelemetry fetches them only then)
            tel.on_step(self.step_count, loss, self.last_grad_norm,
                        tokens=_batch_tokens(batch),
                        wall_s=time.perf_counter() - t0,
                        flops_getter=lambda: self._cost_flops(batch))
        if self.optimizer._lr_scheduler is not None:
            self.optimizer._lr_scheduler.step()
        return loss

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
        """Per-step FLOPs of one forward and backward over ``batch``,
        counted by ``FlopCounterMode`` and probed once (the parameters
        and the optimizer state are not touched; the gradients are
        dropped); None when nothing was counted."""
        if self._flops_probed:
            return self._flops_per_step
        self._flops_probed = True
        from torch.utils.flop_counter import FlopCounterMode

        self._cast_from_masters()
        try:
            with FlopCounterMode(display=False) as counter:
                for mb in self._micro_batches(batch):
                    self._loss(mb).backward()
            flops = counter.get_total_flops()
        except Exception:
            flops = 0
        finally:
            for p in self._param_objs.values():
                p.grad = None
            self._release_copies()
        self._flops_per_step = float(flops) if flops > 0 else None
        return self._flops_per_step

    # ------------------------------------------------------------------
    def _materialized_params(self):
        """Every trainable parameter at the model's dtype; master-only
        ones cast from their masters."""
        out = {}
        for n, p in self._param_objs.items():
            if n in self._master_dtypes:
                out[n] = self.opt_state["master"][n].to(
                    self._master_dtypes[n])
            else:
                out[n] = p.detach()
        return out

    def sync_to_model(self):
        """Write the current values into the model's parameters (under
        master_only, casts of the masters; a no-op otherwise)."""
        self._cast_from_masters()

    def state_dict(self):
        return {"params": self._materialized_params(),
                "opt_state": self.opt_state, "step": self.step_count}

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Restore from ``state_dict()``'s layout (tensors or numpy
        arrays), copying into the held tensors; a params-only restore
        refreshes the float32 masters too."""
        for n, v in sd["params"].items():
            if n not in self._master_dtypes:
                p = self._param_objs[n]
                p.data.copy_(_as_tensor(v, self.device))
        masters = self.opt_state.get("master", {})
        if "opt_state" not in sd:
            for n, m in masters.items():
                if n in sd["params"]:
                    m.copy_(_as_tensor(sd["params"][n], self.device))
        else:
            src = sd["opt_state"]
            self.opt_state["step"].copy_(_as_tensor(src["step"],
                                                    self.device))
            for n, slots in src["slots"].items():
                for k, v in slots.items():
                    self.opt_state["slots"][n][k].copy_(
                        _as_tensor(v, self.device))
            for n, v in src.get("master", {}).items():
                masters[n].copy_(_as_tensor(v, self.device))
        self.step_count = int(sd.get("step", 0))
