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


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        step = torch.clamp(_f32(step), min=1.0)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * torch.minimum(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return self.base_lr * torch.pow(self.gamma, _f32(step))


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        k = torch.floor(_f32(step) / self.step_size)
        return self.base_lr * torch.pow(self.gamma, k)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch)

    def lr_at(self, step):
        step = _f32(step)
        lr = _f32(self.values[-1]).to(step.device)
        for b, v in zip(reversed(self.boundaries),
                        reversed(self.values[:-1])):
            lr = torch.where(step < b, _f32(v).to(step.device), lr)
        return lr


class MultiStepDecay(LRScheduler):
    """gamma applied at each milestone epoch."""

    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        step = torch.as_tensor(step)
        n = torch.sum(torch.tensor(self.milestones, device=step.device)
                      <= step)
        return self.base_lr * torch.pow(self.gamma, n.float())


class NaturalExpDecay(LRScheduler):
    """lr = base * e^(-gamma * epoch)."""

    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return self.base_lr * torch.exp(-self.gamma * _f32(step))


class InverseTimeDecay(LRScheduler):
    """lr = base / (1 + gamma * epoch)."""

    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return self.base_lr / (1.0 + self.gamma * _f32(step))


class LambdaDecay(LRScheduler):
    """lr = base * lr_lambda(epoch); the lambda is given the step as the
    optimizer passes it (a tensor) or as ``step()`` counts it (an int)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return _f32(self.base_lr * self.lr_lambda(step)).to(_device(step))


class MultiplicativeDecay(LRScheduler):
    """lr = base * prod_{e <= epoch} lr_lambda(e), kept on the host by
    ``step()`` (the product has no closed form for an arbitrary
    lambda)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        self._factor = 1.0
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return _f32(self.base_lr * self._factor).to(_device(step))

    def step(self, epoch=None):
        prev = self.last_epoch
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        if self.last_epoch > 0:
            for e in range(max(prev, 0) + 1, self.last_epoch + 1):
                self._factor *= float(self.lr_lambda(e))
        self.last_lr = float(self.lr_at(self.last_epoch))


class OneCycleLR(LRScheduler):
    """Warm up to ``max_learning_rate``, then anneal to ``end_lr`` (both
    phases cosine-shaped)."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=None, phase_pct=0.3, last_epoch=-1):
        self.max_lr = float(max_learning_rate)
        self.total_steps = int(total_steps)
        self.initial_lr = self.max_lr / divide_factor
        self.end_lr = (end_learning_rate if end_learning_rate is not None
                       else self.initial_lr / 1e4)
        self.up_steps = max(int(phase_pct * total_steps), 1)
        super().__init__(self.initial_lr, last_epoch)

    def lr_at(self, step):
        step = torch.clamp(_f32(step), 0, self.total_steps)
        up = step / self.up_steps
        lr_up = self.initial_lr + (self.max_lr - self.initial_lr) * \
            0.5 * (1 - torch.cos(math.pi * torch.clamp(up, 0, 1)))
        down = (step - self.up_steps) / max(
            self.total_steps - self.up_steps, 1)
        lr_down = self.end_lr + (self.max_lr - self.end_lr) * \
            0.5 * (1 + torch.cos(math.pi * torch.clamp(down, 0, 1)))
        return torch.where(step < self.up_steps, lr_up, lr_down)


class CyclicLR(LRScheduler):
    """The triangular cycle between the base and the max rate."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up, step_size_down=None, last_epoch=-1):
        self.max_lr = float(max_learning_rate)
        self.up = int(step_size_up)
        self.down = int(step_size_down or step_size_up)
        super().__init__(base_learning_rate, last_epoch)

    def lr_at(self, step):
        pos = torch.remainder(_f32(step), self.up + self.down)
        frac = torch.where(pos < self.up, pos / self.up,
                           1.0 - (pos - self.up) / self.down)
        return self.base_lr + (self.max_lr - self.base_lr) * frac


class ReduceOnPlateau(LRScheduler):
    """Metric-driven decay, kept on the host: call ``step(metrics=loss)``.
    The threshold is relative by default (``threshold_mode="rel"``), and
    a cooldown ticks down every epoch while active and suppresses the
    counting of bad epochs, as in the reference."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, last_epoch=-1):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._lr = float(learning_rate)
        self._best = None
        self._bad = 0
        self._cool = 0
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        return _f32(self._lr).to(_device(step))

    def _is_better(self, metric):
        if self._best is None:
            return True
        if self.threshold_mode == "rel":
            # best scaled by (1 -/+ threshold), not an abs() margin, which
            # would flip direction for negative metrics
            if self.mode == "min":
                return metric < self._best * (1.0 - self.threshold)
            return metric > self._best * (1.0 + self.threshold)
        if self.mode == "min":
            return metric < self._best - self.threshold
        return metric > self._best + self.threshold

    def step(self, metrics=None, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        if metrics is not None:
            m = float(metrics)
            if self._is_better(m):
                self._best = m
                self._bad = 0
            else:
                self._bad += 1
            if self._cool > 0:
                self._cool -= 1
                self._bad = 0
            elif self._bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self._bad = 0
                self._cool = self.cooldown
        self.last_lr = float(self._lr)


class CosineAnnealingWarmRestarts(LRScheduler):
    """SGDR: a cosine anneal over T_0 steps, then a restart with the
    period scaled by T_mult."""

    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1):
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("T_0 must be > 0 and T_mult >= 1")
        self.T_0 = T_0
        self.T_mult = int(T_mult)
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def lr_at(self, step):
        step = _f32(step)
        if self.T_mult == 1:
            t_cur = torch.remainder(step, self.T_0)
            t_i = _f32(self.T_0).to(step.device)
        else:
            # cycle n starts at T_0 * (T_mult^n - 1) / (T_mult - 1)
            m = self.T_mult
            n = torch.floor(torch.log1p(step * (m - 1) / self.T_0)
                            / torch.log(_f32(float(m)).to(step.device)))
            start = self.T_0 * (torch.pow(float(m), n) - 1.0) / (m - 1)
            t_i = self.T_0 * torch.pow(float(m), n)
            t_cur = step - start
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1.0 + torch.cos(math.pi * t_cur / t_i))


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else "cpu"


def resolve_lr(learning_rate):
    """Return (base_lr_float, schedule_fn|None)."""
    if isinstance(learning_rate, LRScheduler):
        return learning_rate.base_lr, learning_rate.lr_at
    return float(learning_rate), None
