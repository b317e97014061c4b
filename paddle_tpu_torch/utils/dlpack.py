"""DLPack interop (counterpart of ``paddle_tpu/utils/dlpack.py``; parity:
``paddle.utils.dlpack``): zero-copy exchange through
``torch.utils.dlpack``."""

from __future__ import annotations

import torch
import torch.utils.dlpack as _dlpack


def to_dlpack(x: torch.Tensor):
    """Export a tensor (a ``Parameter`` too) as a DLPack capsule."""
    return _dlpack.to_dlpack(x.detach())


def from_dlpack(capsule_or_tensor) -> torch.Tensor:
    """Import from a DLPack capsule or any object implementing
    ``__dlpack__`` (numpy, cupy and JAX arrays directly)."""
    return _dlpack.from_dlpack(capsule_or_tensor)
