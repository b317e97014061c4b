"""Run a ``Layer`` as a function of its parameters (counterpart of
``paddle_tpu/core/functional.py``).

JAX needs this bridge for every jitted step; in PyTorch a layer's
parameters are live tensors and autograd tracks them eagerly, so here it
serves what is functional by nature: ``torch.func`` transforms over
parameter dicts, and evaluating a layer at other values without touching
it. The JAX ``rngs=`` argument has no counterpart: the port's random
operations take explicit generators.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
from torch import nn


def extract_params(layer: nn.Module, trainable_only: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """``{qualified name: detached value}`` of the layer's parameters."""
    return {name: p.detach() for name, p in layer.named_parameters()
            if p.requires_grad or not trainable_only}


def extract_param_objs(layer: nn.Module, trainable_only: bool = False
                       ) -> Dict[str, nn.Parameter]:
    return {name: p for name, p in layer.named_parameters()
            if p.requires_grad or not trainable_only}


def extract_buffers(layer: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(layer.named_buffers())


@contextlib.contextmanager
def bind_params(layer: nn.Module, params: Dict[str, Any], buffers=None):
    """Temporarily put ``params`` (and ``buffers``) in place of the
    layer's own, by qualified name; restored on exit."""
    saved = []
    try:
        for store, values in (("_parameters", params),
                              ("_buffers", buffers or {})):
            for name, value in values.items():
                owner_name, _, leaf = name.rpartition(".")
                owner = layer.get_submodule(owner_name)
                slots = getattr(owner, store)
                if leaf not in slots:
                    raise KeyError(f"unknown {store[1:-1]} {name!r}")
                saved.append((slots, leaf, slots[leaf]))
                slots[leaf] = value
        yield
    finally:
        for slots, leaf, value in reversed(saved):
            slots[leaf] = value


def functional_call(layer: nn.Module, params: Dict[str, Any], *args,
                    buffers=None, **kwargs):
    """``layer(*args, **kwargs)`` with ``params`` (and ``buffers``) in place
    of the layer's own (``torch.func.functional_call``)."""
    values = dict(params)
    values.update(buffers or {})
    return torch.func.functional_call(layer, values, args, kwargs)


def module_fn(layer: nn.Module, method: Optional[str] = None):
    """A pure ``fn(params, *args, **kwargs)`` calling the layer, or its
    ``method``, with ``params`` in place of its own."""

    def fn(params, *args, **kwargs):
        with bind_params(layer, params):
            target = getattr(layer, method) if method else layer
            return target(*args, **kwargs)

    return fn
