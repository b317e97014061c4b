"""Carry weights and train states across from the JAX package.

Both packages name parameters alike and keep linear weights as
``[in_features, out_features]``, so a JAX model's ``state_dict`` loads
with no renaming and no transposes::

    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    load_numpy_state_dict(torch_model, state)

and a JAX ``TrainStep.state_dict()`` (params, optimizer state, step
count), as numpy arrays, resumes in the port's ``TrainStep``::

    load_numpy_train_state(torch_train_step,
                           jax.tree_util.tree_map(np.asarray,
                                                  jax_train_step.state_dict()))
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _numpy(value) -> np.ndarray:
    """A writable numpy copy; dtypes numpy lacks (ml_dtypes' bfloat16)
    become float32 first."""
    value = np.asarray(value)
    if value.dtype.kind not in "fiub":
        value = value.astype(np.float32)
    return np.array(value)


def load_numpy_state_dict(model: nn.Module,
                          state: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``state`` (name -> numpy array) into ``model``'s parameters
    and persistent buffers, cast to each one's dtype and device. Strict:
    missing keys, unexpected keys and shape mismatches raise."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, target in own.items():
        value = np.asarray(state[name])
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} does not "
                             f"match the model's {tuple(target.shape)}")
    with torch.no_grad():
        for name, target in own.items():
            src = torch.from_numpy(_numpy(state[name]))
            target.copy_(src.to(device=target.device, dtype=target.dtype))
    return model


def _same_keys(what, own, given):
    missing = sorted(set(own) - set(given))
    unexpected = sorted(set(given) - set(own))
    if missing or unexpected:
        raise KeyError(f"{what} mismatch: missing {missing}, unexpected "
                       f"{unexpected}")


def load_numpy_train_state(train_step, state: Mapping):
    """Copy a JAX ``TrainStep.state_dict()`` given as numpy arrays,
    ``{"params": {name: array}, "opt_state": {"step", "slots": {name:
    {slot: array}}, "master": {name: array}}, "step": int}``, into the
    port's ``train_step`` (``trainer.TrainStep``), cast to each held
    tensor's dtype and device. Strict: every name and slot must match and
    every shape agree; otherwise raises before copying anything."""
    own = train_step.state_dict()
    _same_keys("params", own["params"], state["params"])
    src_opt, own_opt = state["opt_state"], own["opt_state"]
    _same_keys("optimizer slots", own_opt["slots"], src_opt["slots"])
    _same_keys("masters", own_opt.get("master", {}),
               src_opt.get("master", {}))
    pairs = [(f"params/{n}", own["params"][n], state["params"][n])
             for n in own["params"]]
    for n, slots in own_opt["slots"].items():
        _same_keys(f"slots of {n}", slots, src_opt["slots"][n])
        pairs += [(f"slots/{n}/{k}", t, src_opt["slots"][n][k])
                  for k, t in slots.items()]
    pairs += [(f"master/{n}", t, src_opt["master"][n])
              for n, t in own_opt.get("master", {}).items()]
    for name, target, value in pairs:
        if tuple(np.shape(value)) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(value))} does "
                             f"not match {tuple(target.shape)}")
    def as_t(v):
        return torch.from_numpy(_numpy(v))

    train_step.set_state_dict({
        "params": {n: as_t(v) for n, v in state["params"].items()},
        "opt_state": {
            "step": as_t(src_opt["step"]),
            "slots": {n: {k: as_t(v) for k, v in slots.items()}
                      for n, slots in src_opt["slots"].items()},
            "master": {n: as_t(v)
                       for n, v in src_opt.get("master", {}).items()}},
        "step": int(np.asarray(state.get("step", 0)))})
    return train_step
