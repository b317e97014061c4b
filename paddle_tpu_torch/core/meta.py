"""Abstract ("meta") parameters (counterpart of
``paddle_tpu/core/meta.py``; parity: ``paddle.LazyGuard``).

Inside ``meta_init()``, ``Layer.create_parameter`` makes parameters on
torch's ``meta`` device: shapes and dtypes only, no memory and no
initializer run. Each keeps its initializer (``init_fn``) and the device
it was asked for (``target_device``), so ``materialize`` can draw it
later. Buffers (rope tables, norm statistics) stay concrete, as in JAX:
they are small and computed, not drawn. A model built so can be planned
by ``TrainStep(abstract=True)`` (``lower(...).compile()
.memory_analysis()``) without holding its parameters.
"""

from __future__ import annotations

import contextlib

import torch

from . import initializer as init_mod
from .module import Layer
from .parameter import Parameter, ParamAttr

_ACTIVE = [False]


def in_meta_init() -> bool:
    return _ACTIVE[0]


@contextlib.contextmanager
def meta_init():
    """Inside this block ``Layer.create_parameter`` makes ``meta``
    parameters that keep their initializer; nothing is drawn."""
    orig = Layer.create_parameter

    def create_abstract(self, shape, dtype=None, default_initializer=None,
                        is_bias=False, attr=None, name=None, spec=None, *,
                        device=None, generator=None):
        if isinstance(default_initializer, ParamAttr):
            attr, default_initializer = default_initializer, None
        trainable, lr = True, 1.0
        if attr is not None:
            default_initializer = attr.initializer or default_initializer
            trainable, lr = attr.trainable, attr.learning_rate
            name = name or attr.name
        default = (init_mod.Constant(0.0) if is_bias
                   else init_mod.XavierNormal())
        value = torch.empty(tuple(int(s) for s in shape),
                            dtype=dtype if dtype is not None
                            else self._dtype, device="meta")
        param = Parameter(value, trainable=trainable, name=name, spec=spec)
        param.optimize_attr["learning_rate"] = lr
        param.init_fn = init_mod.resolve(default_initializer, default)
        param.target_device = device
        return param

    Layer.create_parameter = create_abstract
    _ACTIVE[0] = True
    try:
        yield
    finally:
        Layer.create_parameter = orig
        _ACTIVE[0] = False


def is_abstract(value) -> bool:
    """True for a tensor (or parameter) on the ``meta`` device."""
    return isinstance(value, torch.Tensor) and value.device.type == "meta"


def _concrete(p: Parameter, value: torch.Tensor) -> Parameter:
    """A parameter like ``p`` (name, trainability, spec, learning rate)
    holding ``value``."""
    new = Parameter(value, trainable=p.requires_grad, name=p.name,
                    spec=p.spec, is_distributed=p.is_distributed)
    new.optimize_attr = dict(p.optimize_attr)
    return new


@torch.no_grad()
def materialize(layer, seed: int = 0, device=None) -> None:
    """Draw every abstract parameter of ``layer`` with its kept
    initializer, in ``named_parameters`` order, from the port's generator
    seeded with ``seed`` (one per device), on ``device`` (default: the
    device each was asked for, else the current one). Each is replaced
    in every module slot that holds it, so tied parameters stay tied."""
    from .device import current_device
    from .random import make_generator

    gens, drawn = {}, {}
    for name, p in layer.named_parameters():
        if not is_abstract(p):
            continue
        init = getattr(p, "init_fn", None)
        if init is None:
            raise RuntimeError(f"meta parameter {name!r} has no init_fn")
        dev = current_device(device if device is not None
                             else getattr(p, "target_device", None))
        if dev not in gens:
            gens[dev] = make_generator(seed, dev)
        drawn[id(p)] = _concrete(p, init(tuple(p.shape), p.dtype, dev,
                                         gens[dev]))
    for mod in layer.modules():
        for local, p in list(mod._parameters.items()):
            if p is not None and id(p) in drawn:
                mod._parameters[local] = drawn[id(p)]
