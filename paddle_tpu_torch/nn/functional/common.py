"""Common functional ops (counterpart of
``paddle_tpu/nn/functional/common.py``)."""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """y = x @ W (+ b). The weight keeps the JAX package's layout
    ``[in_features, out_features]``, so parameters carry across 1:1.
    Mixed input dtypes promote as ``jnp.matmul`` promotes them."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        y = y + bias
    return y
