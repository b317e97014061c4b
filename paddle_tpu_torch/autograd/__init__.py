"""Autograd surface (counterpart of ``paddle_tpu/autograd``; parity:
``python/paddle/autograd/``).

PyTorch records a tape eagerly, as Paddle does; this module keeps the
JAX package's functional bridge beside it:

    loss, grads = backward(model, loss_fn, *inputs)
    optimizer.set_gradients(grads); optimizer.step()

``value_and_grad`` and ``backward`` evaluate the model at a parameter
dict through ``core.functional.functional_call`` and take gradients with
``torch.autograd.grad`` (the kernels' own backward passes run there).
``no_grad`` is ``torch.no_grad``: JAX's is an identity, and the numbers
are the same, since JAX differentiates only what it is asked to.
``PyLayer`` is a ``torch.autograd.Function``; ``functional`` holds the
``torch.func`` transforms.
"""

from __future__ import annotations

import types
from typing import Callable

import torch

from ..core.functional import extract_params, functional_call


def value_and_grad(model, loss_fn: Callable = None):
    """Build ``f(params, *inputs) -> (loss, grads)``.

    ``loss_fn(output, *extra)`` maps the model's output on ``inputs[0]``
    to a scalar; if None the model's own output on all inputs must be a
    scalar. ``rngs=`` is taken for the JAX signature and has no effect
    (the port's random operations take generators)."""

    def fn(params, *args, rngs=None):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        with torch.enable_grad():
            if loss_fn is None:
                loss = functional_call(model, leaves, *args)
            else:
                out = functional_call(model, leaves, args[0])
                loss = loss_fn(out, *args[1:])
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    return fn


def backward(model, loss_fn: Callable, *inputs, rngs=None):
    """Eager one-shot: the loss and the gradients of the trainable
    parameters, each also written to its parameter's ``.grad`` (parity:
    ``loss.backward()``), which closure-driven optimizers (LBFGS) read."""
    params = extract_params(model, trainable_only=True)
    loss, grads = value_and_grad(model, loss_fn)(params, *inputs, rngs=rngs)
    for name, p in model.named_parameters():
        if name in grads:
            p.grad = grads[name]
    return loss, grads


def no_grad(fn=None):
    """``torch.no_grad``, as a context (``no_grad()``) or a decorator
    (``no_grad(fn)``)."""
    if fn is None:
        return torch.no_grad()
    return torch.no_grad()(fn)


class PyLayer:
    """Custom autograd op (parity: ``paddle.autograd.PyLayer``).

    Subclass with static ``forward(ctx, *args)`` and ``backward(ctx,
    *grads)``; ``apply`` runs them as a ``torch.autograd.Function``.
    ``ctx`` is a plain namespace whose ``saved`` carries what ``forward``
    keeps for ``backward`` (the JAX residuals); ``backward`` returns one
    gradient per input (a tuple, or one tensor for one input)."""

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_autograd_function")
        if fn is not None:
            return fn
        layer = cls

        class _Function(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs):
                pctx = types.SimpleNamespace(saved=None)
                out = layer.forward(pctx, *xs)
                ctx.pyl = pctx
                return out

            @staticmethod
            def backward(ctx, *grads):
                out = layer.backward(ctx.pyl, *grads)
                return out if isinstance(out, tuple) else (out,)

        _Function.__name__ = f"{cls.__name__}Function"
        cls._autograd_function = _Function
        return _Function

    @classmethod
    def apply(cls, *args):
        return cls._function().apply(*args)

    @staticmethod
    def forward(ctx, *args):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError


from .functional import hessian, jacobian, jvp, vjp  # noqa: F401,E402
