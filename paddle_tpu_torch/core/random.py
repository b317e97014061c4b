"""Random generators (counterpart of ``paddle_tpu/core/random.py``: ``seed``,
``get_seed``) and the float32 fills the initializers draw with.

The JAX package threads ``jax.random`` keys; the port threads
``torch.Generator`` objects. A caller may create one from a seed
(``make_generator``) and pass it; where it passes none, the draw comes
from the port's own generator for that device (``default_generator``),
which ``seed`` reseeds. Nothing here touches PyTorch's global generator.
The two frameworks give different numbers from one seed, so tests that
compare them make their inputs with numpy and carry weights across
(``convert.py``).
"""

from __future__ import annotations

import torch

from .device import resolve_device

_seed = 0
_generators = {}  # device string -> the port's generator on that device


def seed(s: int) -> None:
    """Reseed the port's generator on every device (parity:
    ``paddle.seed``); generators made later start from ``s`` too."""
    global _seed
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)


def get_seed() -> int:
    return _seed


def default_generator(device) -> torch.Generator:
    """The port's generator on ``device``, seeded from ``seed`` when first
    asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _generators.get(str(dev))
    if gen is None:
        gen = _generators[str(dev)] = make_generator(_seed, dev)
    return gen


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
