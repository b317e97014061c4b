"""Incubate optimizer wrappers (counterpart of
``paddle_tpu/incubate/optimizer.py``: ``LookAhead``, ``ModelAverage``
and ``EMA``).

All three keep the JAX package's functional shape, ``init(params)`` and
``update(...)`` over dicts of tensors plus ``apply`` for the averages,
and like the port's ``Optimizer.update`` they write the state and the
parameters in place and return them. Each step is decided on the device
(``torch.where`` on the step count, as the JAX program's ``jnp.where``):
no update reads a value back to the host. ``TrainStep`` does not drive
them, as the JAX one cannot (they have no ``_lr_scheduler``).
"""

from __future__ import annotations

import torch


def _f32_copies(params):
    return {n: p.detach().float().clone() for n, p in params.items()}


class LookAhead:
    """k inner steps with the fast optimizer, then the slow weights move
    toward the fast ones, slow += alpha * (fast - slow), and the fast
    weights restart from them.

    The slow weights are float32. The fast weights they merge with are
    the inner optimizer's float32 masters where it keeps them (bf16/fp16
    parameters under ``multi_precision``), else the parameters; on a sync
    step the merged weights are written back into the masters and cast
    into the parameters. The JAX wrapper merges the bf16 parameters and
    leaves the inner masters at the fast weights, so its next update
    starts from them again (ROADMAP.md Queue C); with float32 parameters
    the two are the same function."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def init(self, params):
        dev = next(iter(params.values())).device if params else "cpu"
        return {"inner": self.inner.init(params),
                "slow": _f32_copies(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params, scale=None, grad_norm=None):
        params, inner = self.inner.update(grads, state["inner"], params,
                                          scale=scale, grad_norm=grad_norm)
        step = state["step"]
        step += 1
        sync = (step % self.k) == 0
        master = inner.get("master", {})
        for name, slow in state["slow"].items():
            p = params.get(name)
            fast = master.get(name, p)
            merged = slow + self.alpha * (fast.float() - slow)
            slow.copy_(torch.where(sync, merged, slow))
            fast.copy_(torch.where(sync, slow.to(fast.dtype), fast))
            if p is not None and p is not fast:
                p.copy_(torch.where(sync, slow.to(p.dtype), p))
        return params, state


class ModelAverage:
    """The running mean of the parameters after each inner step, restarted
    when it has counted ``max_average_window`` steps (the JAX package's
    cumulative form of the reference's sum_1/sum_2/sum_3 windows)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 inner_optimizer=None):
        self.inner = inner_optimizer
        self.max_window = int(max_average_window)

    def init(self, params):
        dev = next(iter(params.values())).device if params else "cpu"
        st = {"avg": _f32_copies(params),
              "count": torch.ones((), dtype=torch.float32, device=dev)}
        if self.inner is not None:
            st["inner"] = self.inner.init(params)
        return st

    @torch.no_grad()
    def update(self, grads, state, params, scale=None, grad_norm=None):
        if self.inner is None:
            raise ValueError("ModelAverage needs inner_optimizer for "
                             "functional update()")
        params, _ = self.inner.update(grads, state["inner"], params,
                                      scale=scale, grad_norm=grad_norm)
        count = state["count"]
        restart = count >= self.max_window
        count.copy_(torch.where(restart, torch.ones_like(count), count + 1.0))
        for name, avg in state["avg"].items():
            pf = params[name].float()
            avg.copy_(torch.where(restart, pf, avg + (pf - avg) / count))
        return params, state

    def apply(self, state, params):
        """The averaged weights cast to the parameters' dtypes (the
        reference's ``apply()`` for evaluation)."""
        return {n: a.to(params[n].dtype) for n, a in state["avg"].items()}


class EMA:
    """Exponential moving average of the parameters (paddle.static
    ExponentialMovingAverage): the constant ``decay``, or with
    ``thres_steps`` the warm-up min(decay, (1 + t) / (10 + t)). With
    ``zero_debias`` the average starts at zero and ``apply`` divides by
    1 - prod(decay_i)."""

    def __init__(self, decay=0.999, thres_steps=None, zero_debias=True):
        self.decay = float(decay)
        self.thres_steps = thres_steps
        self.zero_debias = zero_debias

    def init(self, params):
        dev = next(iter(params.values())).device if params else "cpu"
        ema = ({n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for n, p in params.items()} if self.zero_debias
               else _f32_copies(params))
        return {"ema": ema,
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "decay_prod": torch.ones((), dtype=torch.float32,
                                         device=dev)}

    @torch.no_grad()
    def update(self, state, params):
        step = state["step"]
        step += 1
        decay = torch.tensor(self.decay, dtype=torch.float32,
                             device=step.device)
        if self.thres_steps is not None:
            t = step.float()
            decay = torch.minimum(decay, (1.0 + t) / (10.0 + t))
        for name, e in state["ema"].items():
            e.copy_(decay * e + (1.0 - decay) * params[name].float())
        state["decay_prod"].mul_(decay)
        return state

    def apply(self, state, params):
        if self.zero_debias:
            corr = torch.clamp(1.0 - state["decay_prod"], min=1e-12)
            return {n: (e / corr).to(params[n].dtype)
                    for n, e in state["ema"].items()}
        return {n: e.to(params[n].dtype) for n, e in state["ema"].items()}
