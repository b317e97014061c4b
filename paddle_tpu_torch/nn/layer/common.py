"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``:
``Identity``, ``Linear``, ``Embedding``, ``Dropout``, ``Sequential``,
``LayerList``, ``ParameterList``, ``Flatten``, ``Bilinear``, the pads,
pixel shuffles, channel dropouts, distances, ``Unflatten``, the
upsamplers, ``Unfold``/``Fold``, ``LayerDict``).

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
from ..functional import common as FC
from ..functional import vision as FV
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


class Bilinear(Layer):
    """``out[.., o] = x1 @ W[o] @ x2 + b``; W ``[out, in1, in2]`` from
    ``weight_attr``, else XavierUniform; the bias zeros (``bias_attr=
    False`` leaves it out)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, *, dtype=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
        attr, init = _attr_and_init(weight_attr, I.XavierUniform())
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features),
            default_initializer=init, attr=attr, device=device,
            generator=gen)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), is_bias=True, device=device, generator=gen)

    def forward(self, x1, x2):
        return FC.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return FV.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return FV.pixel_unshuffle(x, self.downscale_factor,
                                  self.data_format)


# Paddle's pad-mode names -> ``functional.pad``'s (jnp.pad's)
_PAD_MODE = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap", "edge": "edge",
             "wrap": "wrap"}


class _PadNd(Layer):
    """Paddle's pad layers: ``padding`` an int or the flat Paddle list
    (left, right, then top, bottom, then front, back), on the spatial
    axes of a channels-first or channels-last input; modes "constant"
    (``value``), "reflect", "replicate", "circular"."""

    NDIM = 2
    CHANNELS_FIRST = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self.NDIM)
        self.padding = list(padding)
        self.mode = mode
        self.value = value
        self.data_format = data_format or self.CHANNELS_FIRST

    def forward(self, x):
        if self.mode not in _PAD_MODE:
            raise ValueError(f"unsupported pad mode {self.mode!r}")
        spatial = [tuple(self.padding[2 * i:2 * i + 2])
                   for i in reversed(range(self.NDIM))]
        if self.data_format == self.CHANNELS_FIRST:
            pairs = [(0, 0), (0, 0)] + spatial
        else:
            pairs = [(0, 0)] + spatial + [(0, 0)]
        return FC.pad(x, pairs, _PAD_MODE[self.mode], self.value)


class Pad1D(_PadNd):
    """[left, right] on ``[N, C, L]`` ("NCL") or ``[N, L, C]``."""

    NDIM = 1
    CHANNELS_FIRST = "NCL"


class Pad2D(_PadNd):
    """[left, right, top, bottom] on NCHW or NHWC."""


class Pad3D(_PadNd):
    """[left, right, top, bottom, front, back] on NCDHW or NDHWC."""

    NDIM = 3
    CHANNELS_FIRST = "NCDHW"


class ZeroPad2D(Layer):
    """``padding`` = [left, right, top, bottom]."""

    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return FC.zeropad2d(x, self.padding, self.data_format)


class Dropout2D(Layer):
    """Drops whole channels of 4-D input (``functional.dropout2d``); the
    mask from ``generator`` given to the call, else from the port's
    generator for the input's device."""

    FN = staticmethod(FC.dropout2d)

    def __init__(self, p=0.5, data_format="NCHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.training and self.p > 0.0 and generator is None:
            generator = default_generator(x.device)
        return self.FN(x, self.p, training=self.training,
                       data_format=self.data_format, generator=generator)


class Dropout3D(Dropout2D):
    """Drops whole channels of 5-D input."""

    FN = staticmethod(FC.dropout3d)

    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__(p, data_format)


class AlphaDropout(Layer):
    """SELU-preserving dropout (``functional.alpha_dropout``)."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.training and 0.0 < self.p < 1.0 and generator is None:
            generator = default_generator(x.device)
        return FC.alpha_dropout(x, self.p, training=self.training,
                                generator=generator)


class CosineSimilarity(Layer):
    def __init__(self, axis=-1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return FC.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """``(sum |x - y| + epsilon) ** p) ** (1 / p)`` over the last axis: the
    JAX layer adds ``epsilon`` after the absolute value, where the
    functional adds it before."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        d = (x - y).abs() + self.epsilon
        out = (d ** self.p).sum(dim=-1) ** (1.0 / self.p)
        return out[..., None] if self.keepdim else out


class Unflatten(Layer):
    def __init__(self, axis, shape):
        super().__init__()
        self.axis = axis
        self.shape = tuple(shape)

    def forward(self, x):
        ax = self.axis % x.dim()
        return x.reshape(tuple(x.shape[:ax]) + self.shape
                         + tuple(x.shape[ax + 1:]))


class Upsample(Layer):
    """Parity: paddle.nn.Upsample over ``F.interpolate`` (every mode of
    it)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return interpolate(x, self.size, self.scale_factor, self.mode,
                           align_corners=self.align_corners,
                           align_mode=self.align_mode,
                           data_format=self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class Unfold(Layer):
    """im2col (``functional.unfold``)."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self._args
        return FC.unfold(x, k, strides=s, paddings=p, dilations=d)


class Fold(Layer):
    """col2im (``functional.fold``)."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        o, k, s, p, d = self._args
        return FC.fold(x, o, k, strides=s, paddings=p, dilations=d)


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
