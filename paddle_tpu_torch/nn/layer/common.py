"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``:
``Identity``, ``Linear``, ``Embedding``, ``Dropout``, ``Sequential``,
``LayerList``, ``ParameterList``, ``Flatten``, ``Upsample``,
``LayerDict``).

Layers that hold parameters take ``device`` (None: the current device,
the card unless ``set_device("cpu")`` chose the host; without a card
that raises) and ``generator`` (on that device; None: the port's
generator for it, which ``seed`` reseeds).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...core.parameter import ParamAttr
from ...core.random import default_generator
from ..functional.common import dropout, interpolate, linear
from ..functional.input import embedding


def _attr_and_init(attr, init):
    """A layer's ``weight_attr``/``bias_attr`` split into the ParamAttr and
    the initializer it names (``init`` where it names none)."""
    if isinstance(attr, ParamAttr):
        return attr, init
    return None, (attr if attr not in (None, True) else init)


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = x W + b with the weight ``[in_features, out_features]`` as in
    the JAX layer. The weight is drawn from ``weight_attr`` (an
    initializer or a ``ParamAttr``), else from Normal(0, ``std``), else
    from the JAX default XavierNormal (std = sqrt(2 / (in + out))); the
    bias starts at zeros, and ``bias_attr=False`` or ``has_bias=False``
    leaves it out."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 std: Optional[float] = None, has_bias: bool = True,
                 dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
        self.in_features = in_features
        self.out_features = out_features
        attr, init = _attr_and_init(
            weight_attr, None if std is None else I.Normal(0.0, std))
        self.weight = self.create_parameter(
            (in_features, out_features), default_initializer=init,
            attr=attr, device=device, generator=gen)
        if bias_attr is False or not has_bias:
            self.bias = None
        else:
            attr, init = _attr_and_init(bias_attr, None)
            self.bias = self.create_parameter(
                (out_features,), default_initializer=init, is_bias=True,
                attr=attr, device=device, generator=gen)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """Table ``[num_embeddings, embedding_dim]`` drawn from Normal(0, 1) (or
    ``weight_attr``); the ``padding_idx`` row starts at zeros and looks up
    as zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        attr, init = _attr_and_init(weight_attr, I.Normal(0.0, 1.0))
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), default_initializer=init,
            attr=attr, device=device, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """``nn.functional.dropout`` in training mode; the mask is drawn from
    ``generator`` given to the call, else from the port's generator for
    the input's device. The layer holds no generator, so it deep-copies."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.training and 0.0 < self.p < 1.0 and generator is None:
            generator = default_generator(x.device)
        return dropout(x, self.p, training=self.training, mode=self.mode,
                       generator=generator)

    def extra_repr(self):
        return f"p={self.p}"


class Sequential(Layer):
    """``Sequential(l0, l1, ...)``, ``Sequential(("name", layer), ...)`` or
    ``Sequential([("name", layer), ...])``."""

    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self._modules[str(i)] = sub

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        if idx < 0:
            idx += len(self._modules)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        shape = tuple(x.shape)
        stop = self.stop_axis if self.stop_axis >= 0 \
            else len(shape) + self.stop_axis
        return x.reshape(shape[:self.start_axis]
                         + (math.prod(shape[self.start_axis:stop + 1]),)
                         + shape[stop + 1:])


class Upsample(Layer):
    """Parity: paddle.nn.Upsample over ``F.interpolate`` (4-D nearest is
    ported)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 data_format: str = "NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.data_format = data_format

    def forward(self, x):
        return interpolate(x, self.size, self.scale_factor, self.mode,
                           self.data_format)


class LayerDict(Layer):
    """Dict-style sublayer container (parity: paddle.nn.LayerDict)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, sublayer):
        self.add_sublayer(str(key), sublayer)

    def __delitem__(self, key):
        del self._modules[str(key)]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for key, layer in sublayers:
            self.add_sublayer(str(key), layer)
