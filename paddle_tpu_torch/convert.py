"""Carry weights across from the JAX package.

Both packages name parameters alike and keep linear weights as
``[in_features, out_features]``, so a JAX model's ``state_dict`` loads
with no renaming and no transposes::

    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    load_numpy_state_dict(torch_model, state)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


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
            value = np.asarray(state[name])
            if value.dtype.kind not in "fiub":  # e.g. ml_dtypes' bfloat16
                value = value.astype(np.float32)
            src = torch.from_numpy(np.array(value))  # a writable copy
            target.copy_(src.to(device=target.device, dtype=target.dtype))
    return model
