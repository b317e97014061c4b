"""Weight-only quantization for serving (counterpart of the weight-only
part of ``paddle_tpu/quantization/__init__.py``).

``quantize_model_weight_only`` swaps every linear of a model for a
``WeightOnlyLinear`` that keeps its weight as int8 (or int4 packed) with
float32 scales. Group-wise layers (``group_size`` set, as the serving
engine quantizes) run the Hopper weight-only matmul kernel on the card
(``kernels/quant_matmul.py``); the per-channel int8 layout
(``group_size=None``) is a plain dequantize-then-matmul, as it is outside
any Pallas kernel in the JAX package. ``qweight``, ``scale`` and
``act_scale`` are persistent buffers under the JAX package's names, so a
quantized JAX model's ``state_dict`` loads through
``convert.load_numpy_state_dict``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from ..kernels import quant_matmul as qmm


def quantize_weight_int8(w: torch.Tensor, axis: int = 0):
    """Symmetric per-channel int8: returns (q, scale). ``axis`` is the
    preserved (output-channel) axis."""
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    amax = w.float().abs().amax(dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def weight_only_linear(x, qweight, scale, bias=None, weight_dtype="int8",
                       group_size=None):
    """y = x @ dequant(qweight) (+ bias). Two scale layouts:
    per-output-channel (``group_size=None``): scale [1, out], qweight int8
    [in, out], a plain product; group-wise: scale [in // group_size,
    out], qweight int8 [in, out] or int4 packed [in // 2, out], the
    weight-only matmul kernel on CUDA tensors (every shape; its plain
    version on CPU tensors)."""
    if group_size is None:
        w = qweight.to(x.dtype) * scale.to(x.dtype)
        y = torch.matmul(x, w)
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = qmm.weight_only_matmul(x2, qweight, scale,
                                   group_size=group_size,
                                   weight_dtype=weight_dtype)
        y = y.reshape(*lead, qweight.shape[1])
    if bias is not None:
        y = y + bias
    return y


class WeightOnlyLinear(nn.Module):
    """Drop-in for a linear layer with int8/int4 weights (inference).

    Built from a linear layer (its weight ``[in, out]`` is quantized on
    the weight's device) or from ``in_features``/``out_features`` (zero
    weights, unit scales and a zero float32 bias, to be loaded).
    ``weight_dtype='int4'`` defaults to 128-row groups; a ``group_size``
    that does not divide ``in_features`` falls back to one whole-column
    group, as in the JAX package."""

    def __init__(self, linear_or_in, out_features: Optional[int] = None,
                 weight_dtype: str = "int8",
                 group_size: Optional[int] = None):
        super().__init__()
        if weight_dtype not in ("int8", "int4"):
            raise ValueError(f"weight_dtype must be int8 or int4; got "
                             f"{weight_dtype!r}")
        self.weight_dtype = weight_dtype
        if weight_dtype == "int4" and group_size is None:
            group_size = 128
        if not isinstance(linear_or_in, int):
            src = linear_or_in
            self.in_features = src.in_features
            self.out_features = src.out_features
            if group_size is not None and self.in_features % group_size:
                group_size = self.in_features  # degenerate single group
            w = src.weight.detach()
            if weight_dtype == "int4":
                q, s = qmm.quantize_weight_int4_grouped(w, group_size)
            elif group_size is not None:
                q, s = qmm.quantize_weight_int8_grouped(w, group_size)
            else:
                q, s = quantize_weight_int8(w, axis=1)
            bias = None if src.bias is None else src.bias.detach()
            device = w.device
        else:
            self.in_features = linear_or_in
            self.out_features = out_features
            if group_size is not None and self.in_features % group_size:
                group_size = self.in_features  # degenerate single group
            rows = self.in_features
            if weight_dtype == "int4":
                if self.in_features % 2:
                    raise ValueError(
                        "int4 packing needs an even in_features; got "
                        f"{self.in_features}")
                rows //= 2
            groups = 1 if group_size is None \
                else self.in_features // group_size
            q = torch.zeros((rows, self.out_features), dtype=torch.int8)
            s = torch.ones((groups, self.out_features), dtype=torch.float32)
            bias = torch.zeros((self.out_features,), dtype=torch.float32)
            device = None
        self.group_size = group_size
        self.register_buffer("qweight", q)
        self.register_buffer("scale", s)
        # calibrated activation scale (filled by post-training
        # calibration in the JAX package; kept so state dicts carry it)
        self.register_buffer("act_scale",
                             torch.zeros((), dtype=torch.float32,
                                         device=device))
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.scale, self.bias,
                                  weight_dtype=self.weight_dtype,
                                  group_size=self.group_size)


def replace_layers(model: nn.Module, match: Callable[[nn.Module], bool],
                   make: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """Swap every submodule where ``match`` holds for ``make(sub)``, in
    place (the JAX package's ``quantization.qat.replace_layers``)."""
    for parent in list(model.modules()):
        for name, sub in list(parent.named_children()):
            if match(sub):
                setattr(parent, name, make(sub))
    return model


def quantize_model_weight_only(model: nn.Module, weight_dtype: str = "int8",
                               group_size: Optional[int] = None
                               ) -> nn.Module:
    """Replace every ``ColumnParallelLinear`` and ``RowParallelLinear``
    (so the attention and MLP projections and ``lm_head``) with a
    ``WeightOnlyLinear``, in place; a tied embedding stays as it is. Each
    replaced layer's float weight is freed as it goes."""
    kinds = (ColumnParallelLinear, RowParallelLinear)
    return replace_layers(
        model, lambda s: type(s) in kinds,
        lambda s: WeightOnlyLinear(s, weight_dtype=weight_dtype,
                                   group_size=group_size))


__all__ = ["WeightOnlyLinear", "quantize_model_weight_only",
           "quantize_weight_int8", "replace_layers", "weight_only_linear"]
