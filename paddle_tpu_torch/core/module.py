"""Layer: Paddle's module API on ``nn.Module`` (counterpart of
``paddle_tpu/core/module.py``; parity: ``paddle.nn.Layer``).

``Layer`` keeps ``nn.Module``'s own registries (``_parameters``,
``_buffers``, ``_modules``) and its call path: it adds no second
registry, no ``__call__`` and no ``__getattr__``, so a forward costs what
it costs on ``nn.Module``. What it adds is the JAX ``Layer``'s API where
it differs from torch's, each difference chosen as JAX has it:

- ``create_parameter`` (bias zeros, weights XavierNormal, ``ParamAttr``,
  the layer's ``_dtype``, the current device and the port's generator);
  ``register_buffer(persistable=)``, ``add_sublayer``, ``add_parameter``;
- ``named_sublayers``/``sublayers``; ``parameters()`` and ``buffers()``
  return lists; ``named_parameters`` gives a parameter made without a
  name its qualified name;
- ``register_forward_post_hook`` (torch's forward hook: ``hook(layer,
  args, out)``; the pre-hook is torch's own); both return a handle with
  ``remove()``;
- ``apply`` visits the layer itself first, then its sublayers (torch
  visits the children first);
- ``to("bfloat16")``: a string that names a dtype is a dtype, and
  ``"gpu"``/``"gpu:N"`` are the card; ``to("cuda")`` and
  ``to(torch.float16)`` keep torch's meaning (floating parameters and
  buffers are cast, as in JAX); ``astype``;
- ``state_dict(include_sublayers=, structured_name_prefix=)`` beside
  torch's ``destination``/``prefix``/``keep_vars``;
  ``set_state_dict``/``load_dict`` return ``(missing, unexpected)``,
  raise ``ValueError`` on a shape mismatch, cast values to each
  parameter's dtype, load non-persistable buffers too, and list only
  parameters as missing;
- assigning a Python number or numpy array to a registered buffer makes
  it a tensor on the buffer's device (floating values at its dtype),
  where ``nn.Module`` raises ``TypeError``.

``train(mode=True)`` and ``eval()`` are torch's.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from . import dtype as dtype_mod
from . import initializer as init_mod
from .device import current_device
from .parameter import Parameter, ParamAttr


def _host_tensor(value) -> torch.Tensor:
    """A tensor from a tensor, numpy array, list or Python number; dtypes
    numpy lacks (ml_dtypes' bfloat16) become float32 first."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def _buffer_value(value, like):
    """``value`` as a new buffer tensor: on ``like``'s device and, when
    both are floating, at its dtype; without ``like`` on the current
    device, float64 as float32 (JAX's 32-bit arrays)."""
    t = _host_tensor(value)
    if like is not None:
        dt = like.dtype if (t.is_floating_point()
                            and like.is_floating_point()) else t.dtype
        return t.to(device=like.device, dtype=dt, copy=True)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device=current_device(), copy=True)


def _to_arg(a):
    """A Paddle argument of ``to`` in torch's terms: a dtype name as a
    ``torch.dtype``, ``"gpu"``/``"gpu:N"`` as the CUDA device."""
    if dtype_mod.is_dtype_name(a):
        return dtype_mod.convert_dtype(a)
    if isinstance(a, str) and a.split(":")[0] == "gpu":
        return "cuda" + a[3:]
    return a


class Layer(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self._dtype = dtype_mod.convert_dtype(dtype)

    def __setattr__(self, name, value):
        buffers = self.__dict__.get("_buffers")
        if (buffers is not None and name in buffers and value is not None
                and not isinstance(value, torch.Tensor)):
            value = _buffer_value(value, buffers[name])
        super().__setattr__(name, value)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         is_bias: bool = False, attr=None, name=None, *,
                         device=None, generator=None) -> Parameter:
        """A new trainable ``Parameter`` of ``shape``, drawn now: biases
        default to zeros and weights to XavierNormal. ``attr`` (a
        ``ParamAttr``, also accepted as ``default_initializer``) gives the
        initializer, name, trainability and learning-rate scale. The
        dtype defaults to the layer's, the device to the current one, and
        the draw comes from ``generator`` or the port's generator for the
        device."""
        if isinstance(default_initializer, ParamAttr):
            attr, default_initializer = default_initializer, None
        trainable, lr = True, 1.0
        if attr is not None:
            default_initializer = attr.initializer or default_initializer
            trainable, lr = attr.trainable, attr.learning_rate
            name = name or attr.name
        default = (init_mod.Constant(0.0) if is_bias
                   else init_mod.XavierNormal())
        init = init_mod.resolve(default_initializer, default)
        value = init(tuple(shape), dtype if dtype is not None
                     else self._dtype, device, generator)
        param = Parameter(value, trainable=trainable, name=name)
        param.optimize_attr["learning_rate"] = lr
        return param

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent=None):
        """torch's ``register_buffer``, with Paddle's ``persistable`` (a
        non-persistable buffer stays out of ``state_dict``) and any array
        or number taken as a tensor on the current device."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = _buffer_value(tensor, None)
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)

    def add_sublayer(self, name, sublayer: nn.Module) -> nn.Module:
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter) -> nn.Parameter:
        self.register_parameter(str(name), parameter)
        return parameter

    # ------------------------------------------------------------------
    # traversal
    # ------------------------------------------------------------------
    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None):
        for name, layer in self.named_modules(memo=layers_set,
                                              prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        for name, param in super().named_parameters(
                prefix=prefix, recurse=recurse,
                remove_duplicate=remove_duplicate):
            if isinstance(param, Parameter) \
                    and param.name.startswith("param_"):
                param.name = name
            yield name, param

    def parameters(self, include_sublayers: bool = True,
                   recurse=None) -> List[nn.Parameter]:
        recurse = include_sublayers if recurse is None else recurse
        return [p for _, p in self.named_parameters(recurse=recurse)]

    def buffers(self, include_sublayers: bool = True,
                recurse=None) -> List[torch.Tensor]:
        recurse = include_sublayers if recurse is None else recurse
        return [b for _, b in self.named_buffers(recurse=recurse)]

    # ------------------------------------------------------------------
    # hooks, mode, casts
    # ------------------------------------------------------------------
    def register_forward_post_hook(self, hook: Callable):
        """``hook(layer, args, out)`` after every forward; a value it
        returns replaces the output."""
        return self.register_forward_hook(hook)

    def apply(self, fn: Callable[[nn.Module], None]) -> "Layer":
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def to(self, *args, **kwargs):
        kwargs.pop("blocking", None)
        args = tuple(_to_arg(a) for a in args)
        for key in ("dtype", "device"):
            if key in kwargs:
                kwargs[key] = _to_arg(kwargs[key])
        out = super().to(*args, **kwargs)
        dt = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dt is not None:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dt
        return out

    def astype(self, dtype):
        return self.to(dtype)

    # ------------------------------------------------------------------
    # state dict
    # ------------------------------------------------------------------
    def state_dict(self, *args, destination=None, prefix: str = "",
                   keep_vars: bool = False, include_sublayers: bool = True,
                   structured_name_prefix: str = ""):
        if structured_name_prefix:
            prefix = f"{structured_name_prefix}.{prefix}"
        if include_sublayers:
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        out = collections.OrderedDict() if destination is None \
            else destination
        own = [*self._parameters.items(),
               *((n, b) for n, b in self._buffers.items()
                 if n not in self._non_persistent_buffers_set)]
        for name, value in own:
            if value is not None:
                out[prefix + name] = value if keep_vars else value.detach()
        return out

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Load values by qualified name; returns ``(missing,
        unexpected)``, ``missing`` listing parameters only."""
        params: Dict[str, nn.Parameter] = dict(self.named_parameters())
        owners = {}
        for layer_name, layer in self.named_modules():
            for bname in layer._buffers:
                owners[f"{layer_name}.{bname}" if layer_name
                       else bname] = (layer, bname)
        unexpected = []
        with torch.no_grad():
            for name, value in state_dict.items():
                if name in params:
                    p, src = params[name], _host_tensor(value)
                    if tuple(src.shape) != tuple(p.shape):
                        raise ValueError(
                            f"shape mismatch for {name}: got "
                            f"{tuple(src.shape)}, expected {tuple(p.shape)}")
                    p.copy_(src)
                elif name in owners:
                    layer, bname = owners[name]
                    old = layer._buffers[bname]
                    src = _host_tensor(value)
                    if old is not None and old.shape == src.shape:
                        old.copy_(src)
                    else:
                        layer._buffers[bname] = _buffer_value(src, old)
                else:
                    unexpected.append(name)
        missing = [n for n in params if n not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
