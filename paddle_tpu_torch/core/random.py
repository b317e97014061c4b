"""Random generators (counterpart of ``paddle_tpu/core/random.py``: ``seed``,
``get_seed``, the draws ``uniform``/``normal``/``randint``/``randperm``,
``shuffle_numpy`` and ``RNGStatesTracker``) and the float32 fills the
initializers draw with.

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

import contextlib
from typing import Dict

import numpy as np
import torch

from .device import resolve_device

_seed = 0
_generators = {}  # device string -> the port's generator on that device
_scoped = []  # generators ``generator_scope`` put before the port's own


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
    if _scoped and _scoped[-1].device == dev:
        return _scoped[-1]
    gen = _generators.get(str(dev))
    if gen is None:
        gen = _generators[str(dev)] = make_generator(_seed, dev)
    return gen


@contextlib.contextmanager
def generator_scope(generator: torch.Generator):
    """Inside the block, ``default_generator`` of ``generator``'s device
    returns ``generator`` (a model drawing all its layers from its own
    seed)."""
    _scoped.append(generator)
    try:
        yield generator
    finally:
        _scoped.pop()


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


# ---------------------------------------------------------------------------
# the tensor surface's draws (``tensor.rand`` .. ``tensor.randperm``) and the
# named generator states of tensor-parallel models
# ---------------------------------------------------------------------------
def _draw_generator(device) -> tuple:
    dev = resolve_device(device)
    return dev, default_generator(dev)


def uniform(shape, dtype=None, min=0.0, max=1.0,  # noqa: A002
            device="cuda") -> torch.Tensor:
    """U[min, max) of ``shape`` from the port's generator for ``device``
    (torch's numbers, not JAX's; JAX draws from its key stream)."""
    from .dtype import convert_dtype

    dev, gen = _draw_generator(device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    out.uniform_(float(min), float(max), generator=gen)
    return out.to(convert_dtype(dtype))


def normal(shape, dtype=None, mean=0.0, std=1.0,
           device="cuda") -> torch.Tensor:
    """``mean + std * N(0, 1)`` of ``shape``, as JAX composes it."""
    from .dtype import convert_dtype

    dev, gen = _draw_generator(device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    out.normal_(0.0, 1.0, generator=gen)
    return (mean + std * out).to(convert_dtype(dtype))


def randint(low, high=None, shape=(), dtype="int64",
            device="cuda") -> torch.Tensor:
    """Integers in [low, high) (``randint(n)`` is [0, n))."""
    from .dtype import convert_dtype

    if high is None:
        low, high = 0, low
    dev, gen = _draw_generator(device)
    return torch.randint(int(low), int(high), tuple(shape), generator=gen,
                         device=dev, dtype=convert_dtype(dtype))


def randperm(n: int, dtype="int64", device="cuda") -> torch.Tensor:
    from .dtype import convert_dtype

    dev, gen = _draw_generator(device)
    return torch.randperm(int(n), generator=gen, device=dev).to(
        convert_dtype(dtype))


def shuffle_numpy(arr: np.ndarray, epoch_seed: int) -> np.ndarray:
    """Host-side deterministic shuffle used by the data pipeline (numpy's
    generator: the same order as the JAX package's)."""
    rng = np.random.default_rng(epoch_seed)
    perm = rng.permutation(len(arr))
    return arr[perm]


class RNGStatesTracker:
    """Named generator states (parity: ``get_rng_state_tracker``).

    Tensor-parallel models register a "local_seed" (different per TP rank)
    and a "global_seed" (the same on every rank). ``add`` records a seed;
    ``rng_state(name)`` makes a generator seeded with it the port's
    generator for its device inside the block (JAX binds a key there).
    """

    def __init__(self):
        self.states_: Dict[str, int] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed_val: int):
        if seed_val in self.seeds_:
            raise ValueError(f"seed {seed_val} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed_val)
        self.states_[name] = seed_val

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)
        self.seeds_ = set(states.values())

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed", device="cuda"):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        with generator_scope(make_generator(self.states_[name], device)):
            yield


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed_val: int, tp_rank: int = 0):
    """Initialize the tracker the way Fleet does: a global stream shared by
    all TP ranks and a local stream offset by the TP rank."""
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("global_seed", seed_val)
    tracker.add("local_seed", seed_val + 1024 + tp_rank)
