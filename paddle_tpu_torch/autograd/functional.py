"""Functional autograd transforms (counterpart of
``paddle_tpu/autograd/functional.py``; parity: ``paddle.incubate.autograd``
/ ``paddle.autograd``: Jacobian, Hessian, jvp, vjp).

Each is a ``torch.func`` transform with the Paddle calling convention of
the JAX module (``xs`` a tensor or a tuple of tensors; ``v`` optional
cotangents or tangents, ones by default), and its result structure:
per input a tuple where ``xs`` is a tuple."""

from __future__ import annotations

import torch
import torch.func as tfunc


def _as_tuple(xs):
    return tuple(xs) if isinstance(xs, (tuple, list)) else (xs,)


def _argnums(xs):
    single = not isinstance(xs, (tuple, list))
    return single, (0 if single else tuple(range(len(xs))))


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """d func(xs) / d xs; a tuple over the inputs where ``xs`` is one."""
    _, argnums = _argnums(xs)
    return tfunc.jacrev(func, argnums=argnums)(*_as_tuple(xs))


def hessian(func, xs, create_graph=False):
    """The Hessian of a scalar-valued ``func``."""
    _, argnums = _argnums(xs)
    return tfunc.hessian(func, argnums=argnums)(*_as_tuple(xs))


def _ones_like_tree(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_ones_like_tree(o) for o in out)
    return torch.ones_like(out)


def vjp(func, xs, v=None):
    """``(func(xs), vjp)``: ``v`` the cotangent(s) of the output (ones by
    default)."""
    single, _ = _argnums(xs)
    out, pullback = tfunc.vjp(func, *_as_tuple(xs))
    grads = pullback(_ones_like_tree(out) if v is None else v)
    return out, (grads[0] if single else grads)


def jvp(func, xs, v=None):
    """``(func(xs), jvp)``: ``v`` the tangent(s) of the inputs (ones by
    default)."""
    xs_t = _as_tuple(xs)
    v_t = (tuple(torch.ones_like(x) for x in xs_t) if v is None
           else _as_tuple(v))
    return tfunc.jvp(func, xs_t, v_t)
