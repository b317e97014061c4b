"""QAT and PTQ (counterpart of ``paddle_tpu/quantization/qat.py``; parity:
python/paddle/quantization/{qat,ptq}.py and ``QuantConfig``).

    qat = QAT(QuantConfig())
    qmodel = qat.quantize(model)        # Linear -> QuantedLinear (STE)
    ... train (the FakeQuant EMAs update in every training forward) ...
    infer = qat.convert(qmodel, weight_dtype="int4")  # -> WeightOnlyLinear

    ptq = PTQ(QuantConfig(activation=AbsmaxObserver))
    pmodel = ptq.quantize(model)        # observers in front of each Linear
    for batch in calib: pmodel(batch)
    infer = ptq.convert(pmodel)         # act_scale from each observer

Only the plain ``nn.Linear`` of the port is matched (``type(s) is
Linear``), as in JAX: a Llama's tensor-parallel linears are left alone,
and Mamba's projections are quantized.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Type

import torch
from torch import nn

from ..core.module import Layer
from ..nn.layer.common import Linear
from .observer import AbsmaxObserver, BaseObserver


class _Unset:
    def __repr__(self):
        return "<UNSET>"


UNSET = _Unset()


class QuantConfig:
    """Which layers get quantized and with what quanter or observer.

    ``activation`` / ``weight`` take a factory (a class or zero-argument
    callable) or a template quanter instance, deep-copied for each layer so
    that no two layers share statistics. ``None`` leaves that side
    unquantized; an override field left unset inherits the global one.
    """

    def __init__(self, activation=UNSET, weight=UNSET):
        self.activation = activation
        self.weight = weight
        self._layer_overrides: Dict[int, dict] = {}
        self._type_overrides: Dict[Type, dict] = {}

    def add_layer_config(self, layer, activation=UNSET, weight=UNSET):
        for lyr in (layer if isinstance(layer, (list, tuple)) else [layer]):
            self._layer_overrides[id(lyr)] = {
                "activation": activation, "weight": weight}
        return self

    def add_type_config(self, layer_type, activation=UNSET, weight=UNSET):
        types = (layer_type if isinstance(layer_type, (list, tuple))
                 else [layer_type])
        for t in types:
            self._type_overrides[t] = {
                "activation": activation, "weight": weight}
        return self

    def _for(self, layer) -> dict:
        override = self._layer_overrides.get(id(layer)) or \
            self._type_overrides.get(type(layer)) or {}
        out = {"activation": self.activation, "weight": self.weight}
        for k, v in override.items():
            if v is not UNSET:
                out[k] = v
        return out

    @staticmethod
    def _make(factory, default=None):
        """UNSET: ``default``; None: None (disabled); a Layer instance: a
        deep copy of it; a class or callable: its result."""
        if factory is UNSET:
            factory = default
        if factory is None:
            return None
        if isinstance(factory, Layer):
            return copy.deepcopy(factory)
        return factory() if callable(factory) else factory


class QuantedLinear(Layer):
    """A linear with fake-quant on its input and its weight (QAT training);
    the quanters move to the linear's device."""

    def __init__(self, linear: Linear, act_quanter=None, wt_quanter=None):
        super().__init__()
        device = linear.weight.device
        self.source = linear
        self.act_quanter = None if act_quanter is None \
            else act_quanter.to(device)
        self.wt_quanter = None if wt_quanter is None \
            else wt_quanter.to(device)

    def forward(self, x):
        if self.act_quanter is not None:
            x = self.act_quanter(x)
        w = self.source.weight
        if self.wt_quanter is not None:
            w = self.wt_quanter(w)
        y = torch.matmul(x, w.to(x.dtype))
        if self.source.bias is not None:
            y = y + self.source.bias.to(y.dtype)
        return y


def replace_layers(model: nn.Module, match: Callable[[nn.Module], bool],
                   make: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """Swap every sublayer where ``match`` holds for ``make(sub)``, in
    place: the one tree walk every quantize and convert pass shares. The
    layers ``make`` returns are not visited again."""
    for parent in list(model.modules()):
        for name, sub in list(parent.named_children()):
            if match(sub):
                setattr(parent, name, make(sub))
    return model


class QAT:
    """Quantization-aware training (parity: ``paddle.quantization.QAT``)."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        """Every ``Linear`` becomes a ``QuantedLinear`` with the configured
        quanters (FakeQuant by default, on the linear's device);
        ``inplace=False`` works on a deep copy."""
        from . import FakeQuant

        if not inplace:
            model = copy.deepcopy(model)

        def make(linear):
            cfg = self.config._for(linear)

            def default():
                return FakeQuant(device=linear.weight.device)

            act = QuantConfig._make(cfg["activation"], default=default)
            wt = QuantConfig._make(cfg["weight"], default=default)
            if act is None and wt is None:
                return linear  # explicitly disabled for this layer
            return QuantedLinear(linear, act, wt)

        return replace_layers(model, lambda s: type(s) is Linear, make)

    def convert(self, model: nn.Module, inplace: bool = True,
                weight_dtype: str = "int8") -> nn.Module:
        """Drop the quanters: each ``QuantedLinear`` becomes a
        ``WeightOnlyLinear`` of its source (int8 per channel, or int4 in
        groups of 128 rows, one whole-column group where 128 does not
        divide the input width)."""
        from . import WeightOnlyLinear

        if not inplace:
            model = copy.deepcopy(model)
        return replace_layers(
            model, lambda s: isinstance(s, QuantedLinear),
            lambda s: WeightOnlyLinear(s.source, weight_dtype=weight_dtype))


class PTQ:
    """Post-training quantization (parity: ``paddle.quantization.PTQ``).

    ``quantize`` puts an activation observer in front of each Linear; run
    calibration batches through the model; ``convert`` replaces each pair
    with a ``WeightOnlyLinear`` whose ``act_scale`` buffer holds the
    observer's scale (the weight scales come from the weights)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig(activation=AbsmaxObserver)

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        if not inplace:
            model = copy.deepcopy(model)

        def make(linear):
            cfg = self.config._for(linear)
            obs = QuantConfig._make(cfg["activation"], default=AbsmaxObserver)
            if obs is None:
                return linear
            return _ObservedLinear(linear, obs)

        return replace_layers(model, lambda s: type(s) is Linear, make)

    def convert(self, model: nn.Module, inplace: bool = True,
                weight_dtype: str = "int8") -> nn.Module:
        from . import WeightOnlyLinear

        if not inplace:
            model = copy.deepcopy(model)

        def make(sub):
            wol = WeightOnlyLinear(sub.source, weight_dtype=weight_dtype)
            # a registered buffer: the float becomes a tensor on its device
            # and persists through state_dict
            wol.act_scale = sub.observer.scale()
            return wol

        return replace_layers(
            model, lambda s: isinstance(s, _ObservedLinear), make)


class _ObservedLinear(Layer):
    def __init__(self, linear: Linear, observer: BaseObserver):
        super().__init__()
        self.source = linear
        self.observer = observer

    def forward(self, x):
        self.observer.observe(x)
        return self.source(x)
