"""Learning-rate schedulers (counterpart of
``paddle_tpu/optimizer/lr.py``).

Each scheduler is both a Paddle-style stateful object (``step()``,
``get_lr()``, ``state_dict()``) and a function of the step count,
``lr_at(step)``, which the optimizer calls with its own step. As in the
JAX package, ``lr_at`` computes in float32 and returns a 0-d float32
tensor on the step's device (the CPU for a Python int), so the two
packages give the same value for every step. This slice ports
``ConstantLR``, ``LinearWarmup``, ``CosineAnnealingDecay`` and
``PolynomialDecay``; the other schedulers of the JAX module are listed
in ROADMAP.md Queue A.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    """A float32 tensor of ``x`` (a number or a tensor), on its device."""
    return torch.as_tensor(x).to(torch.float32)


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = None
        self.step()

    def lr_at(self, step) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, step):
        return self.lr_at(step)

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        self.last_lr = float(self.lr_at(self.last_epoch))

    def get_lr(self):
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, d):
        self.last_epoch = d["last_epoch"]
        self.last_lr = d["last_lr"]


class ConstantLR(LRScheduler):
    def lr_at(self, step):
        return _f32(self.base_lr).to(_device(step))


class LinearWarmup(LRScheduler):
    """Warm up from start_lr to end_lr over warmup_steps, then follow the
    wrapped schedule (or stay at end_lr if wrapping a float)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.inner = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = (end_lr if isinstance(learning_rate, (int, float))
                else learning_rate.base_lr)
        super().__init__(base, last_epoch)

    def lr_at(self, step):
        step = _f32(step)
        warm = self.start_lr + (self.end_lr - self.start_lr) * torch.clamp(
            step / max(self.warmup_steps, 1), max=1.0)
        if isinstance(self.inner, (int, float)):
            after = _f32(self.inner).to(step.device)
        else:
            after = self.inner.lr_at(
                torch.clamp(step - self.warmup_steps, min=0))
        return torch.where(step < self.warmup_steps, warm, after)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        frac = torch.clamp(_f32(step) / self.T_max, 0.0, 1.0)
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1.0 + torch.cos(math.pi * frac))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        frac = torch.clamp(_f32(step) / self.decay_steps, 0.0, 1.0)
        return ((self.base_lr - self.end_lr) * torch.pow(1 - frac, self.power)
                + self.end_lr)


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else "cpu"


def resolve_lr(learning_rate):
    """Return (base_lr_float, schedule_fn|None)."""
    if isinstance(learning_rate, LRScheduler):
        return learning_rate.base_lr, learning_rate.lr_at
    return float(learning_rate), None
