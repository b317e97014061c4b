"""AMP (counterpart of ``paddle_tpu/amp``; parity: ``python/paddle/amp/``:
``auto_cast``, ``decorate``, ``GradScaler``).

``auto_cast`` is the JAX package's: a per-thread stack of AMP states
(``amp_state``, ``get_amp_dtype``), and no layer reads it, so it changes
no number (the port's numbers equal JAX's; it is not
``torch.autocast``). ``decorate(model, optimizer, level="O2")`` casts the
floating parameters to the compute dtype with ``Layer.to(dtype)`` and
sets the optimizers' ``multi_precision``, so they keep float32 masters:
the reference's O2 master-weight contract. ``GradScaler`` is the JAX
state machine: its counters, ``state_dict`` and ``found_inf`` as a 0-d
bool tensor.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtype_mod

_amp_state = threading.local()


def _stack():
    if not hasattr(_amp_state, "stack"):
        _amp_state.stack = []
    return _amp_state.stack


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Mark an AMP region: push a state that ``amp_state()`` and
    ``get_amp_dtype()`` read (no layer casts on it, as in JAX)."""
    state = {
        "enable": bool(enable),
        "level": level,
        "dtype": dtype_mod.convert_dtype(dtype),
        "white": set(custom_white_list or ()),
        "black": set(custom_black_list or ()),
    }
    _stack().append(state)
    try:
        yield
    finally:
        _stack().pop()


amp_guard = auto_cast


def amp_state():
    s = _stack()
    return s[-1] if s else None


def get_amp_dtype():
    s = amp_state()
    if s and s["enable"]:
        return s["dtype"]
    return None


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast the models' parameters to the compute dtype at O2; the
    optimizers keep float32 masters. Returns (models, optimizers) like
    ``paddle.amp.decorate``."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    dt = dtype_mod.convert_dtype(dtype)
    if level == "O2":
        for m in model_list:
            m.to(dt)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for o in opt_list:
        o.multi_precision = master_weight is not False
    return (
        models if single_model else model_list,
        optimizers if single_opt else opt_list,
    )


class GradScaler:
    """Dynamic loss scaling (parity: ``paddle.amp.GradScaler``), the JAX
    package's state machine: after ``decr_every_n_nan_or_inf`` steps with
    a non-finite gradient the scale shrinks by ``decr_ratio`` (not below
    1), after ``incr_every_n_steps`` finite ones it grows by
    ``incr_ratio``."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * torch.tensor(self._scale, dtype=loss.dtype,
                                   device=loss.device)

    def unscale_(self, grads):
        if not self._enable:
            return grads
        inv = 1.0 / self._scale
        return pytree.tree_map(lambda g: g * inv, grads)

    def found_inf(self, grads):
        """A 0-d bool tensor: whether any gradient has a non-finite
        entry."""
        bad = None
        for g in pytree.tree_leaves(grads):
            b = ~torch.isfinite(g.float()).all()
            bad = b if bad is None else (bad | b)
        return torch.zeros((), dtype=torch.bool) if bad is None else bad

    def update(self, found_inf: bool):
        if not (self._enable and self.use_dynamic):
            return
        if found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self.decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self.decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self.incr_every_n_steps:
                self._scale *= self.incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {
            "scale": self._scale,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d["good_steps"]
        self._bad_steps = d["bad_steps"]


def is_bfloat16_supported(device=None):
    """Parity: ``paddle.amp.is_bfloat16_supported``: the card's own
    answer where there is one (every H100 has bf16), else the CPU's
    (yes)."""
    if torch.cuda.is_available() and (device is None or "cpu" not in
                                      str(device)):
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None):
    """Parity: ``paddle.amp.is_float16_supported``."""
    return True
