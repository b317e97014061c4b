"""Explicit random generators (counterpart of ``paddle_tpu/core/random.py``
and the ``Normal`` and ``Uniform`` initializers of
``paddle_tpu/core/initializer.py``).

The JAX package threads ``jax.random`` keys; the port threads
``torch.Generator`` objects that the caller creates from a seed. Nothing
here touches PyTorch's global generator. The two frameworks give
different numbers from one seed, so tests that compare them make their
inputs with numpy and carry weights across (``convert.py``).
"""

from __future__ import annotations

import math

import torch

from .device import resolve_device


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` (the card unless the caller asks for the
    CPU) seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def normal_(tensor: torch.Tensor, mean: float, std: float,
            generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place from Normal(mean, std). As in the JAX
    initializer, the sample is drawn in float32 and then cast, since
    drawing straight in bfloat16 loses entropy."""
    if tensor.dtype == torch.float32:
        return tensor.normal_(mean, std, generator=generator)
    tmp = torch.empty(tensor.shape, dtype=torch.float32,
                      device=tensor.device)
    tmp.normal_(mean, std, generator=generator)
    return tensor.copy_(tmp)


def uniform_(tensor: torch.Tensor, low: float, high: float,
             generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place from Uniform(low, high), drawn in float32
    and then cast (the JAX ``Uniform`` initializer)."""
    if tensor.dtype == torch.float32:
        return tensor.uniform_(low, high, generator=generator)
    tmp = torch.empty(tensor.shape, dtype=torch.float32,
                      device=tensor.device)
    tmp.uniform_(low, high, generator=generator)
    return tensor.copy_(tmp)


def fan_in_out(shape):
    """The JAX initializers' fans: a 2-D weight is ``[in, out]``, a conv
    weight ``[out, in, *k]`` (``paddle_tpu/core/initializer.py``)."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive
