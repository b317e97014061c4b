"""Parameter and ParamAttr (counterpart of ``paddle_tpu/core/parameter.py``;
parity: paddle's ``EagerParamBase`` and ``paddle.ParamAttr``).

``Parameter`` is an ``nn.Parameter``: every torch module, optimizer and
autograd path takes it as it is. It adds Paddle's name, ``trainable``
(the same flag as ``requires_grad``), ``stop_gradient`` (its negation),
``optimize_attr`` and ``set_value``. A parameter made without a name gets
``param_<n>`` and takes its qualified name the first time
``Layer.named_parameters`` walks past it, as in JAX.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional

import numpy as np
import torch
from torch import nn

_counter = itertools.count(1)


class Parameter(nn.Parameter):
    def __new__(cls, data=None, requires_grad=True, name=None,
                trainable=None):
        if data is None:
            data = torch.empty(0)
        if trainable is not None:
            requires_grad = trainable
        return torch.Tensor._make_subclass(cls, data.detach(), requires_grad)

    def __init__(self, data=None, requires_grad=True,
                 name: Optional[str] = None, trainable=None):
        self._pname = name or f"param_{next(_counter)}"
        self.optimize_attr = {"learning_rate": 1.0}

    # Tensor has a read-only ``name``; the parameter's shadows it
    @property
    def name(self) -> str:
        return self._pname

    @name.setter
    def name(self, value: str):
        self._pname = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag: bool):
        self.requires_grad_(bool(flag))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag: bool):
        self.requires_grad_(not flag)

    def set_value(self, value):
        """Copy ``value`` (a tensor, numpy array or list of the same shape)
        into the parameter, cast to its dtype."""
        src = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value: shape {tuple(src.shape)} does not "
                             f"match {tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(src)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = type(self)(
            self.data.clone(memory_format=torch.preserve_format),
            self.requires_grad)
        memo[id(self)] = result
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result

    def __reduce_ex__(self, protocol):
        # nn.Parameter's own reduction rebuilds an nn.Parameter
        return (_rebuild, (self.data, self.requires_grad, self.__dict__))


def _rebuild(data, requires_grad, state):
    param = Parameter(data, requires_grad)
    param.__dict__.update(state)
    return param


class ParamAttr:
    """Parameter attributes carried by a layer's ``weight_attr`` and
    ``bias_attr``: ``initializer`` and ``trainable`` take effect in
    ``Layer.create_parameter``, ``learning_rate`` lands in
    ``Parameter.optimize_attr``; ``regularizer``, ``need_clip`` and
    ``do_model_average`` are kept for the API, as in JAX."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip
