"""Device resolution shared by the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. The CPU
is used only when the caller asks for it: with no CUDA device present, a
request for ``"cuda"`` raises instead of quietly running on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
