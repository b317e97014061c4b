"""Optimizers: the functional core and the eager API (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

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
ops in the JAX update's float32 order: the JAX package leaves it to XLA,
and no Pallas kernel carries it.

The eager API (``parameters=``, ``step``, ``set_gradients``,
``clear_grad``, ``state_dict``) drives the same core over parameters the
optimizer was given. ``parameters`` takes ``nn.Parameter``s or ``(name,
parameter)`` pairs such as ``model.named_parameters()``. A pair keeps its
name; a bare parameter is named ``param_<i>`` by its position ``i`` in the
list (JAX names it by ``Parameter.name``, which comes from a module
system the port does not have). Pass named pairs to resume from a JAX
optimizer's state.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..convert import _numpy
from .clip import ClipGradBase
from .lr import LRScheduler, resolve_lr

_LOW = (torch.bfloat16, torch.float16)


def _zeros(p, fill=0.0):
    return torch.full(p.shape, fill, dtype=torch.float32, device=p.device)


def _named(parameters):
    """``(name, parameter)`` pairs from parameters or pairs (see the
    module docstring for the naming rule)."""
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, (tuple, list)):
            name, p = item
        else:
            name, p = f"param_{i}", item
        out.append((str(name), p))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"parameter names repeat: {names}")
    return out


def _copy_into(own, src, path="state"):
    """Copy ``src`` (tensors, or numpy arrays such as a JAX optimizer's
    state given as numpy) into the tensors of ``own``, cast to each one's
    dtype and device. Names must match; dtypes numpy lacks (bfloat16)
    arrive as float32."""
    if isinstance(own, dict):
        if set(own) != set(src):
            raise KeyError(f"{path}: keys {sorted(src)} do not match "
                           f"{sorted(own)}")
        for k, v in own.items():
            _copy_into(v, src[k], f"{path}/{k}")
        return
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(_numpy(src))
    if tuple(src.shape) != tuple(own.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} does not match "
                         f"{tuple(own.shape)}")
    own.copy_(src.to(device=own.device, dtype=own.dtype))


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
        self._parameter_list = (_named(parameters)
                                if parameters is not None else None)
        self._eager_state = None
        self._accumulated_grads = None

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

    # ------------------------------------------------------------------
    # eager paddle-style API
    # ------------------------------------------------------------------
    def _eager_params(self) -> Dict[str, torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError("optimizer created without parameters=")
        return {n: p for n, p in self._parameter_list if p.requires_grad}

    def apply_gradients(self, grads: Dict[str, torch.Tensor]):
        """Apply a ``{name: grad}`` dict to the held parameters, in
        place."""
        params = {n: p.detach() for n, p in self._eager_params().items()}
        if self._eager_state is None:
            self._eager_state = self.init(params)
        self.update(grads, self._eager_state, params)

    def step(self):
        """Apply the gradients given by ``set_gradients`` if it was called
        since the last step, else each held parameter's ``.grad``."""
        grads = self._accumulated_grads
        if grads is None:
            grads = {n: p.grad for n, p in self._eager_params().items()
                     if p.grad is not None}
            if not grads:
                raise RuntimeError(
                    "no gradients: call loss.backward() or "
                    "opt.set_gradients(grads) first")
        self.apply_gradients(grads)
        self._accumulated_grads = None

    def set_gradients(self, grads: Dict[str, torch.Tensor]):
        self._accumulated_grads = grads

    def clear_grad(self):
        """Drop the gradients of ``set_gradients`` and every held
        parameter's ``.grad``."""
        self._accumulated_grads = None
        for _, p in self._parameter_list or ():
            p.grad = None

    def get_lr(self):
        if self._lr_scheduler is not None:
            return self._lr_scheduler.get_lr()
        return self.base_lr

    def set_lr(self, lr: float):
        self.base_lr = float(lr)
        self.lr_schedule = None

    def state_dict(self):
        out = {"base_lr": self.base_lr}
        if self._eager_state is not None:
            out["state"] = self._eager_state
        if self._lr_scheduler is not None:
            out["lr_scheduler"] = self._lr_scheduler.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, d):
        """Restore ``state_dict()``'s layout. The optimizer state may hold
        tensors or numpy arrays (a JAX optimizer's state, as numpy); it is
        copied into a fresh ``init`` of the held parameters, so its names,
        slots and shapes must match theirs."""
        self.base_lr = d.get("base_lr", self.base_lr)
        if "state" in d:
            state = self.init({n: p.detach() for n, p in
                               self._eager_params().items()})
            _copy_into(state, d["state"])
            self._eager_state = state
        if "lr_scheduler" in d and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(d["lr_scheduler"])


class SGD(Optimizer):
    def _init_slot(self, p):
        return {}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        pf.sub_(lr * gf)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=0.0, grad_clip=None,
                 multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        v = self.momentum * slots["velocity"] + gf
        upd = gf + self.momentum * v if self.use_nesterov else v
        pf.sub_(lr * upd)
        slots["velocity"].copy_(v)


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


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=0.0, grad_clip=None, multi_precision=True,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _init_slot(self, p):
        return {"moment": _zeros(p, self.initial_accumulator_value)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        acc = slots["moment"] + torch.square(gf)
        pf.sub_(lr * gf / (torch.sqrt(acc) + self.epsilon))
        slots["moment"].copy_(acc)


def _trust(w_norm, r_norm, ratio):
    """``ratio`` where both norms are positive, else 1 (as ``jnp.where``
    of a float32 tensor and a Python 1.0)."""
    return torch.where((w_norm > 0) & (r_norm > 0), ratio,
                       torch.ones((), dtype=ratio.dtype,
                                  device=ratio.device))


class Lamb(Optimizer):
    """Parity: paddle.optimizer.Lamb: Adam's normalised update plus the
    decay, scaled by the per-parameter trust ratio ||w|| / ||r||;
    ``exclude_from_weight_decay_fn(name)`` turns the decay off for a
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, lamb_weight_decay=0.01,
                 grad_clip=None, multi_precision=True,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if self.exclude_from_weight_decay_fn is not None and \
                self.exclude_from_weight_decay_fn(name):
            decay = 0.0
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * gf
        v = self.beta2 * slots["moment2"] \
            + (1 - self.beta2) * torch.square(gf)
        stepf = step.float()
        mhat = m / (1 - torch.pow(self.beta1, stepf))
        vhat = v / (1 - torch.pow(self.beta2, stepf))
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + decay * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = _trust(w_norm, r_norm, w_norm / r_norm)
        pf.sub_(lr * trust * r)
        slots["moment1"].copy_(m)
        slots["moment2"].copy_(v)


class Lars(Optimizer):
    """Layer-wise Adaptive Rate Scaling momentum (parity: the reference's
    lars_momentum kernel): local_lr = lr * coeff * ||w|| / (||g|| +
    decay * ||w|| + eps), then momentum on (g + decay * w). A parameter
    whose name contains one of ``exclude_from_weight_decay`` takes no
    decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=0.0,
                 exclude_from_weight_decay=None, grad_clip=None,
                 multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, multi_precision, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.epsilon = epsilon
        self.exclude_from_weight_decay = list(exclude_from_weight_decay or [])

    def _init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if any(tok in name for tok in self.exclude_from_weight_decay):
            decay = 0.0
        w_norm = torch.linalg.vector_norm(pf)
        g_norm = torch.linalg.vector_norm(gf)
        denom = g_norm + decay * w_norm + self.epsilon
        # the trust-ratio branch gates on g_norm as the reference kernel
        # does: an all-zero gradient falls back to the plain lr
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self.lars_coeff * w_norm / torch.clamp(denom, min=1e-20),
            lr)
        v = self.momentum * slots["velocity"] + local_lr * (gf + decay * pf)
        pf.sub_(v)
        slots["velocity"].copy_(v)


class RMSProp(Optimizer):
    """Parity: paddle.optimizer.RMSProp (rho/epsilon/momentum/centered;
    the denominator is sqrt(ms + eps), phi rmsprop_kernel semantics)."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=0.0, grad_clip=None, multi_precision=True,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _init_slot(self, p):
        s = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self.centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        ms = self.rho * slots["mean_square"] \
            + (1 - self.rho) * torch.square(gf)
        if self.centered:
            mg = self.rho * slots["mean_grad"] + (1 - self.rho) * gf
            denom = torch.sqrt(ms - torch.square(mg) + self.epsilon)
            slots["mean_grad"].copy_(mg)
        else:
            denom = torch.sqrt(ms + self.epsilon)
        mom = self.momentum * slots["momentum"] + lr * gf / denom
        pf.sub_(mom)
        slots["mean_square"].copy_(ms)
        slots["momentum"].copy_(mom)


class Adamax(Optimizer):
    """Parity: paddle.optimizer.Adamax (the infinity-norm Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        m = self.beta1 * slots["moment"] + (1 - self.beta1) * gf
        u = torch.maximum(self.beta2 * slots["inf_norm"], torch.abs(gf))
        lr_t = lr / (1 - torch.pow(self.beta1, step.float()))
        pf.sub_(lr_t * m / (u + self.epsilon))
        slots["moment"].copy_(m)
        slots["inf_norm"].copy_(u)


class Adadelta(Optimizer):
    """Parity: paddle.optimizer.Adadelta (running RMS of the gradients and
    of the updates)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.epsilon, self.rho = epsilon, rho

    def _init_slot(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        g2 = self.rho * slots["avg_squared_grad"] \
            + (1 - self.rho) * torch.square(gf)
        upd = gf * torch.sqrt((slots["avg_squared_update"] + self.epsilon)
                              / (g2 + self.epsilon))
        u2 = self.rho * slots["avg_squared_update"] \
            + (1 - self.rho) * torch.square(upd)
        pf.sub_(lr * upd)
        slots["avg_squared_grad"].copy_(g2)
        slots["avg_squared_update"].copy_(u2)


class NAdam(Optimizer):
    """Parity: paddle.optimizer.NAdam (Nesterov-momentum Adam with the
    momentum schedule mu_t = beta1 * (1 - 0.5 * 0.96^(t * psi)); each
    parameter's slots carry the running product ``mu_prod``)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=0.0, grad_clip=None, multi_precision=True,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.momentum_decay = momentum_decay

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def init(self, params):
        state = super().init(params)
        for name, slots in state["slots"].items():
            slots["mu_prod"] = torch.ones((), dtype=torch.float32,
                                          device=params[name].device)
        return state

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        stepf = step.float()
        psi = self.momentum_decay
        mu_t = self.beta1 * (1 - 0.5 * torch.pow(0.96, stepf * psi))
        mu_t1 = self.beta1 * (1 - 0.5 * torch.pow(0.96, (stepf + 1) * psi))
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * gf
        v = self.beta2 * slots["moment2"] \
            + (1 - self.beta2) * torch.square(gf)
        mu_prod = slots["mu_prod"] * mu_t
        mhat = (mu_t1 * m / (1 - mu_prod * mu_t1)
                + (1 - mu_t) * gf / (1 - mu_prod))
        vhat = v / (1 - torch.pow(self.beta2, stepf))
        pf.sub_(lr * mhat / (torch.sqrt(vhat) + self.epsilon))
        slots["moment1"].copy_(m)
        slots["moment2"].copy_(v)
        slots["mu_prod"].copy_(mu_prod)


class RAdam(Optimizer):
    """Parity: paddle.optimizer.RAdam (rectified Adam: momentum SGD until
    the variance-rectification term rho_t passes 5)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        m = self.beta1 * slots["moment1"] + (1 - self.beta1) * gf
        v = self.beta2 * slots["moment2"] \
            + (1 - self.beta2) * torch.square(gf)
        stepf = step.float()
        beta2_t = torch.pow(self.beta2, stepf)
        rho_inf = 2.0 / (1.0 - self.beta2) - 1.0
        rho_t = rho_inf - 2.0 * stepf * beta2_t / (1.0 - beta2_t)
        mhat = m / (1 - torch.pow(self.beta1, stepf))
        r = torch.sqrt(torch.clamp(
            (rho_t - 4) * (rho_t - 2) * rho_inf
            / torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t, min=1e-8),
            min=0.0))
        vhat = torch.sqrt(v / (1 - beta2_t)) + self.epsilon
        adam_step = lr * r * mhat / vhat
        sgd_step = lr * mhat
        pf.sub_(torch.where(rho_t > 5.0, adam_step, sgd_step))
        slots["moment1"].copy_(m)
        slots["moment2"].copy_(v)


class ASGD(Optimizer):
    """Parity: paddle.optimizer.ASGD as the JAX package keeps it: the
    running mean d_t = d_{t-1} + (g - d_{t-1}) / min(t, batch_num) in
    place of the reference's ring buffer of the last ``batch_num``
    gradients."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=0.0, grad_clip=None, multi_precision=True,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, **kw)
        self.batch_num = max(1, int(batch_num))

    def _init_slot(self, p):
        return {"d": _zeros(p)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        if decay:
            gf = gf + decay * pf
        n = torch.clamp(step.float(), max=float(self.batch_num))
        d = slots["d"] + (gf - slots["d"]) / n
        pf.sub_(lr * d)
        slots["d"].copy_(d)


class Rprop(Optimizer):
    """Parity: paddle.optimizer.Rprop (sign-based resilient propagation:
    per-weight step sizes grown or shrunk by the sign agreement of
    successive gradients; a sign flip skips that weight's update)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, **kw):
        super().__init__(learning_rate, parameters, 0.0, grad_clip,
                         multi_precision, **kw)
        self.lr_min, self.lr_max = learning_rate_range
        self.eta_neg, self.eta_pos = etas

    def _init_slot(self, p):
        return {"prev_grad": _zeros(p), "lrs": _zeros(p, self.base_lr)}

    def _apply(self, lr, step, name, pf, gf, slots, decay):
        sign = torch.sign(gf * slots["prev_grad"])
        one = torch.ones((), dtype=torch.float32, device=gf.device)
        factor = torch.where(sign > 0, self.eta_pos * one,
                             torch.where(sign < 0, self.eta_neg * one, one))
        lrs = torch.clamp(slots["lrs"] * factor, self.lr_min, self.lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(gf), gf)
        pf.sub_(lrs * torch.sign(g_eff))
        slots["prev_grad"].copy_(g_eff)
        slots["lrs"].copy_(lrs)


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if str(name) not in table:
        raise ValueError(f"moment_dtype must be one of {sorted(table)}; "
                         f"got {name!r}")
    return table[str(name)]
