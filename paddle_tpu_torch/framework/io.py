"""Single-process save/load (counterpart of ``paddle_tpu/framework/io.py``;
parity: ``paddle.save`` / ``paddle.load``).

The file format is the JAX package's: one pickle (protocol 4) of the
nested Python structure, every tensor in it stored as a numpy array, so
a ``.pdparams`` written by either package loads in the other. Sharded
checkpoints live in ``distributed.checkpoint``.

**bfloat16.** numpy has no bfloat16. Where ``ml_dtypes`` imports, a
bf16 tensor is stored as an ``ml_dtypes.bfloat16`` array, which is how a
JAX bf16 array pickles, so bf16 crosses between the packages both ways.
Where it does not, a bf16 tensor is stored as a ``BFloat16Bits`` holding
its 16-bit patterns: the port loads it back as the same bf16 tensor, bit
for bit (the JAX package cannot read that file). A load never changes a
dtype: each array becomes a tensor of its own dtype (a JAX file's int32
stays int32), and a file that holds ``ml_dtypes`` arrays raises
``ModuleNotFoundError`` where ``ml_dtypes`` is missing, as unpickling
does; ``load(return_numpy=True)`` of a ``BFloat16Bits`` without
``ml_dtypes`` raises ``TypeError`` (numpy cannot hold it).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.device import current_device


class BFloat16Bits:
    """The bit patterns of a bf16 tensor, saved where ``ml_dtypes`` is
    missing (``bits``: a uint16 array of the tensor's shape)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


def _ml_bfloat16():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes.bfloat16


def _tensor_to_host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    bf16 = _ml_bfloat16()
    if bf16 is None:
        return BFloat16Bits(bits.copy())
    return bits.view(bf16)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return _tensor_to_host(obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_host(v) for v in obj)
    return obj


def save(obj, path):
    """Pickle ``obj`` to ``path`` with its tensors as numpy arrays."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=4)


def _is_bf16_array(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.name == "bfloat16"


def _array_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if _is_bf16_array(a):
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy_of(obj):
    if isinstance(obj, BFloat16Bits):
        bf16 = _ml_bfloat16()
        if bf16 is None:
            raise TypeError("load(return_numpy=True): the file holds a "
                            "bfloat16 array and numpy has no bfloat16 "
                            "without ml_dtypes")
        return obj.bits.view(bf16)
    if isinstance(obj, dict):
        return {k: _numpy_of(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy_of(v) for v in obj)
    return obj


def load(path, return_numpy=False, device=None):
    """The object ``save`` wrote, its arrays as tensors on ``device`` (the
    card by default), or as numpy arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if return_numpy:
        return _numpy_of(obj)
    dev = current_device(device)

    def to_torch(o):
        if isinstance(o, BFloat16Bits):
            return torch.from_numpy(o.bits.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        if isinstance(o, np.ndarray):
            return _array_to_tensor(o, dev)
        if isinstance(o, dict):
            return {k: to_torch(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(to_torch(v) for v in o)
        return o

    return to_torch(obj)
