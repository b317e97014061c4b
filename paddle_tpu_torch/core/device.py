"""Device resolution shared by the port's entry points.

Every entry point takes ``device=`` and defaults to the card. The CPU is
used only when the caller asks for it: with no CUDA device present, a
request for ``"cuda"`` raises instead of quietly running on the host.

``set_current`` (``paddle_tpu_torch.device.set_device``) chooses where
layers built without a ``device`` put their parameters; it starts as the
card, so ``current_device()`` raises without one until the caller asks
for the CPU. ``device_scope`` chooses it for a ``with`` block (a model
building its layers on its own device).
"""

from __future__ import annotations

import contextlib

import torch

_current = None  # a torch.device set by set_current, or None (the card)


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_current(device) -> None:
    """Make ``device`` (a ``torch.device``, or None for the card) the
    device of layers built without one."""
    global _current
    _current = None if device is None else torch.device(device)


def current_device(device=None) -> torch.device:
    """``device`` resolved, or with ``device`` None the current device
    (the card unless ``set_current`` chose another)."""
    if device is None:
        device = _current if _current is not None else "cuda"
    return resolve_device(device)


@contextlib.contextmanager
def device_scope(device):
    """Make ``device`` the current device inside the block, then restore
    the one before."""
    global _current
    prev = _current
    _current = resolve_device(device)
    try:
        yield _current
    finally:
        _current = prev
