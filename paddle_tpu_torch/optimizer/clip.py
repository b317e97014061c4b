"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``:
ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue).

Functional: each clipper maps a ``{name: grad}`` dict to a new dict, in
float32 math cast back to each gradient's dtype, as the JAX clippers map
a pytree. A caller that already holds the gradients' global norm passes
it as ``norm``, and the global-norm clipper then does not compute it
again; the other clippers ignore it.
"""

from __future__ import annotations

from typing import Dict

import torch

Grads = Dict[str, torch.Tensor]


def _norm_sq(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.float()))


def global_norm(grads: Grads) -> torch.Tensor:
    """The float32 norm of all of ``grads`` together."""
    return torch.sqrt(sum(_norm_sq(g) for g in grads.values()))


class ClipGradBase:
    def __call__(self, grads: Grads, norm=None) -> Grads:
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float = 1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads: Grads, norm=None) -> Grads:
        if not grads:
            return grads
        if norm is None:
            norm = self.global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}

    def global_norm(self, grads: Grads) -> torch.Tensor:
        return global_norm(grads)


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def _one(self, g):
        norm = torch.sqrt(_norm_sq(g))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g.float() * scale).to(g.dtype)

    def __call__(self, grads: Grads, norm=None) -> Grads:
        return {n: self._one(g) for n, g in grads.items()}


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads: Grads, norm=None) -> Grads:
        return {n: torch.clamp(g, self.min, self.max)
                for n, g in grads.items()}
