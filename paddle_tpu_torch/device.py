"""paddle_tpu_torch.device (counterpart of ``paddle_tpu/device.py``;
parity: ``paddle.device``).

``set_device("gpu")``/``"gpu:N"`` or ``"cpu"`` chooses where layers built
without a ``device`` put their parameters (``Layer.create_parameter``,
the initializers, ``register_buffer`` of an array). The default is the
card: with none present and no ``set_device("cpu")``, creating a
parameter raises, as every entry point of the port does.
"""

from __future__ import annotations

import torch

from .core import device as _dev


def _parse(device: str):
    kind, _, idx = device.partition(":")
    kind = {"cuda": "gpu"}.get(kind, kind)
    if kind not in ("gpu", "cpu"):
        raise ValueError(f"set_device: unsupported device {device!r}")
    return kind, int(idx) if idx else 0


def set_device(device: str) -> str:
    """Parity: ``paddle.device.set_device('gpu:0'|'gpu'|'cpu')``."""
    kind, idx = _parse(device)
    if kind == "cpu":
        _dev.set_current(torch.device("cpu"))
        return device
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise ValueError(f"set_device: no {device!r} device is available")
    if not 0 <= idx < n:
        raise ValueError(f"set_device: index {idx} out of range for {n} "
                         "CUDA device(s)")
    _dev.set_current(torch.device("cuda", idx))
    return device


def get_device() -> str:
    """The current device as Paddle names it: ``"gpu:N"`` or ``"cpu"``
    (``"gpu:0"`` until ``set_device`` chose another)."""
    cur = _dev._current
    if cur is None:
        return "gpu:0"
    if cur.type == "cpu":
        return "cpu"
    return f"gpu:{cur.index or 0}"


def synchronize(device=None) -> None:
    """Wait for all work queued on the card (parity:
    ``paddle.device.synchronize``); nothing to wait for on the CPU."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    """Whether this PyTorch was built with CUDA."""
    return torch.backends.cuda.is_built()
