"""Dtype names and the default parameter dtype (counterpart of
``paddle_tpu/core/dtype.py``; parity: ``paddle.set_default_dtype`` /
``paddle.get_default_dtype``).

The default dtype is the port's own state: it sets the dtype of
parameters that ``Layer.create_parameter`` makes when the caller names
none. It never touches ``torch.set_default_dtype``, so plain PyTorch code
in the same process keeps float32.
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}
_DTYPE_TO_STR = {v: k for k, v in _STR_TO_DTYPE.items()}

_default_dtype = float32


def set_default_dtype(d) -> None:
    """Set the dtype of parameters created without one."""
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def convert_dtype(d) -> torch.dtype:
    """A Paddle dtype string ("bfloat16"), a numpy dtype or a
    ``torch.dtype`` as a ``torch.dtype``; ``None`` is the default dtype."""
    if d is None:
        return _default_dtype
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        if d not in _STR_TO_DTYPE:
            raise ValueError(f"unknown dtype string: {d!r}")
        return _STR_TO_DTYPE[d]
    return torch.from_numpy(np.empty(0, dtype=np.dtype(d))).dtype


def dtype_name(d) -> str:
    """The Paddle string of a dtype (``torch.bfloat16`` -> "bfloat16")."""
    return _DTYPE_TO_STR[convert_dtype(d)]


def is_dtype_name(s) -> bool:
    """Whether ``s`` is a string that names a dtype."""
    return isinstance(s, str) and s in _STR_TO_DTYPE


def is_floating_dtype(d) -> bool:
    return convert_dtype(d).is_floating_point
