"""Quantization (counterpart of ``paddle_tpu/quantization``): weight-only
int8/int4 layers for serving, ``FakeQuant`` for quantization-aware
training, and the QAT/PTQ workflows with their observers (``qat.py``,
``observer.py``).

``quantize_model_weight_only`` swaps every linear of a model for a
``WeightOnlyLinear`` that keeps its weight as int8 (or int4 packed) with
float32 scales. Group-wise layers (``group_size`` set, as the serving
engine quantizes) run the Hopper weight-only matmul kernel on the card
(``kernels/quant_matmul.py``); the per-channel int8 layout
(``group_size=None``) is a plain dequantize-then-matmul, as it is outside
any Pallas kernel in the JAX package. ``qweight``, ``scale`` and
``act_scale`` are persistent buffers under the JAX package's names, so a
quantized JAX model's ``state_dict`` loads through
``convert.load_numpy_state_dict``, as does a JAX QAT model's
(``source.weight``, ``*.amax``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import current_device
from ..core.module import Layer
from ..core.parameter import Parameter
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from ..kernels import quant_matmul as qmm
from .qat import replace_layers


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


class WeightOnlyLinear(Layer):
    """Drop-in for a linear layer with int8/int4 weights (inference).

    Built from a linear layer (its weight ``[in, out]`` is quantized on
    the weight's device) or from ``in_features``/``out_features`` (zero
    weights, unit scales and a zero float32 bias, to be loaded).
    ``weight_dtype='int4'`` defaults to 128-row groups; a ``group_size``
    that does not divide ``in_features`` falls back to one whole-column
    group, as in the JAX package. ``scale`` and ``act_scale`` stay float32
    through any cast of the layer (``to("bfloat16")``, ``half()``): row 4
    takes its scales in float32."""

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
                     else Parameter(bias, requires_grad=False))

    def _apply(self, fn, recurse=True):
        kept = {n: self._buffers[n] for n in ("scale", "act_scale")}
        super()._apply(fn, recurse)
        for name, old in kept.items():
            new = self._buffers[name]
            self._buffers[name] = old.to(new.device)
        return self

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.scale, self.bias,
                                  weight_dtype=self.weight_dtype,
                                  group_size=self.group_size)


def quantize_model_weight_only(model: Layer, weight_dtype: str = "int8",
                               group_size: Optional[int] = None
                               ) -> Layer:
    """Replace every ``ColumnParallelLinear`` and ``RowParallelLinear``
    (so the attention and MLP projections and ``lm_head``) with a
    ``WeightOnlyLinear``, in place; a tied embedding stays as it is. Each
    replaced layer's float weight is freed as it goes."""
    kinds = (ColumnParallelLinear, RowParallelLinear)
    return replace_layers(
        model, lambda s: type(s) in kinds,
        lambda s: WeightOnlyLinear(s, weight_dtype=weight_dtype,
                                   group_size=group_size))


class FakeQuant(Layer):
    """QAT fake-quant: uniform symmetric over ``bits``, round half to even,
    the straight-through estimator (``x + (q - x).detach()``: forward q,
    backward identity). A training forward scales by the batch's |x| max
    and moves the ``amax`` buffer's EMA toward it, in place on its device
    under ``no_grad`` and with no host sync (the JAX package's eager rule,
    in every training forward: the JAX jitted step never updates it); an
    eval forward scales by ``amax``. ``device`` None is the current
    device."""

    def __init__(self, bits: int = 8, observer_momentum: float = 0.9,
                 device=None):
        super().__init__()
        self.qmax = 2 ** (bits - 1) - 1
        self.momentum = observer_momentum
        self.register_buffer("amax", torch.ones(
            (), dtype=torch.float32, device=current_device(device)))

    def forward(self, x):
        xf = x.float()
        if self.training:
            amax_obs = xf.detach().abs().amax()
            with torch.no_grad():
                self.amax.copy_(self.momentum * self.amax
                                + (1 - self.momentum) * amax_obs)
            amax = torch.clamp_min(amax_obs, 1e-8)
        else:
            amax = torch.clamp_min(self.amax.float(), 1e-8)
        scale = amax / self.qmax
        q = torch.clamp(torch.round(xf / scale), -self.qmax,
                        self.qmax) * scale
        return x + (q - x).detach()


from .observer import (  # noqa: E402
    AbsmaxObserver,
    BaseObserver,
    EMAObserver,
    MSEObserver,
    PercentileObserver,
)
from .qat import PTQ, QAT, UNSET, QuantConfig, QuantedLinear  # noqa: E402

__all__ = ["AbsmaxObserver", "BaseObserver", "EMAObserver", "FakeQuant",
           "MSEObserver", "PTQ", "PercentileObserver", "QAT", "QuantConfig",
           "QuantedLinear", "UNSET", "WeightOnlyLinear",
           "quantize_model_weight_only", "quantize_weight_int8",
           "replace_layers", "weight_only_linear"]
