"""Optimizers: the functional core (counterpart of
``paddle_tpu/optimizer/optimizer.py``: ``Optimizer.init``/``update``,
``Adam``, ``AdamW``).

An optimizer owns no tensors. ``init(params)`` returns a state dict
``{"step", "slots", "master"}``; ``update(grads, state, params)`` returns
``(new_params, new_state)``, with float32 math on the float32 master copy
of every bf16/fp16 parameter when ``multi_precision`` is on (or on the
parameter itself when it is float32), as in the JAX package.

Unlike the JAX arrays, the tensors here are mutable: ``update`` writes
the new values into the state's tensors and the given parameters in
place and returns those same tensors, so a step allocates no second copy
of the parameters, moments or masters. Call it on tensors that need no
gradient (it runs under ``torch.no_grad()``). The update is plain torch
ops: the JAX package leaves it to XLA, and no Pallas kernel carries it.
The other optimizers of the JAX module are listed in ROADMAP.md Queue A.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .clip import ClipGradBase
from .lr import LRScheduler, resolve_lr

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base. Subclasses implement ``_init_slot(param)`` and
    ``_apply(lr, step, name, pf, gf, slots, decay)``, which updates the
    float32 ``pf`` and the slots in place."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = True,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 name: Optional[str] = None):
        self.base_lr, self.lr_schedule = resolve_lr(learning_rate)
        self._lr_scheduler = (learning_rate
                              if isinstance(learning_rate, LRScheduler)
                              else None)
        self.weight_decay = float(weight_decay or 0.0)
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.apply_decay_param_fun = apply_decay_param_fun

    def init(self, params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device if params else "cpu"
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "slots": {n: self._init_slot(p) for n, p in params.items()}}
        if self.multi_precision:
            state["master"] = {n: p.detach().float().clone()
                               for n, p in params.items()
                               if p.dtype in _LOW}
        return state

    def _lr_value(self, step: torch.Tensor) -> torch.Tensor:
        if self.lr_schedule is not None:
            return self.lr_schedule(step).to(torch.float32)
        return torch.tensor(self.base_lr, dtype=torch.float32,
                            device=step.device)

    @torch.no_grad()
    def update(self, grads, state, params, scale=None, grad_norm=None):
        """One optimizer step; ``scale`` is an optional gradient divisor
        (GradScaler parity), and ``grad_norm`` the global norm of
        ``grads / scale`` where the caller already has it (the global-norm
        clip then uses it and does not compute its own). ``params`` may
        hold only some of the state's parameters: a name whose parameter
        is absent (the master-only residency of ``TrainStep``) is updated
        through its master alone, and its low-precision value is left to
        the caller. Returns ``(new_params, new_state)``, both updated in
        place."""
        step = state["step"]
        step += 1
        lr = self._lr_value(step)
        if scale is not None:
            grads = {n: g.float() / scale for n, g in grads.items()}
        if self.grad_clip is not None:
            grads = self.grad_clip(grads, norm=grad_norm)
        master = state.get("master", {})
        for name in state["slots"]:
            g = grads.get(name)
            p = params.get(name)
            if g is None:
                continue
            pf = master[name] if name in master else p
            if pf.dtype != torch.float32:  # no master: math in float32
                pf = pf.float()
            decay = self.weight_decay
            if decay and self.apply_decay_param_fun is not None \
                    and not self.apply_decay_param_fun(name):
                decay = 0.0
            self._apply(lr, step, name, pf, g.float(), state["slots"][name],
                        decay)
            if p is not None and pf is not p:
                p.copy_(pf)
        return params, state

    def _init_slot(self, p):
        raise NotImplementedError

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        raise NotImplementedError


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True, lazy_mode=False,
                 moment_dtype=None, **kw):
        """``moment_dtype``: storage dtype of the m/v slots (default
        float32); the math runs in float32 and only storage rounds."""
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.moment_dtype = _dtype(moment_dtype) if moment_dtype \
            else torch.float32

    def _init_slot(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=self.moment_dtype,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=self.moment_dtype,
                                       device=p.device)}

    def _decoupled(self):
        return False

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay and not self._decoupled():
            gf = gf + decay * pf  # L2-style (Adam)
        m = self.beta1 * slots["moment1"].float() + (1 - self.beta1) * gf
        v = self.beta2 * slots["moment2"].float() \
            + (1 - self.beta2) * torch.square(gf)
        stepf = step.float()
        mhat = m / (1 - torch.pow(self.beta1, stepf))
        vhat = v / (1 - torch.pow(self.beta2, stepf))
        upd = mhat / (torch.sqrt(vhat) + self.epsilon)
        if decay and self._decoupled():
            upd = upd + decay * pf  # decoupled (AdamW)
        pf.sub_(lr * upd)
        slots["moment1"].copy_(m)
        slots["moment2"].copy_(v)


class AdamW(Adam):
    """Decoupled weight decay (parity: paddle.optimizer.AdamW; phi
    fused_adamw semantics: decay applied decoupled, master weights when
    multi_precision)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None, moment_dtype=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         apply_decay_param_fun=apply_decay_param_fun,
                         moment_dtype=moment_dtype, **kw)

    def _decoupled(self):
        return True


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if str(name) not in table:
        raise ValueError(f"moment_dtype must be one of {sorted(table)}; "
                         f"got {name!r}")
    return table[str(name)]
