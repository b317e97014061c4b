"""``paddle.static`` (counterpart of ``paddle_tpu/static.py``): the part
of it that survives where tracing owns the graph, ``InputSpec`` for the
signatures of ``jit.save`` and ``to_static``; ``Program`` and its guards
are structural stand-ins, as in JAX.

A ``None`` dim of an ``InputSpec`` is dynamic: ``to_symbolic_struct``
gives it a ``torch.export.Dim``, as the JAX package gives it a
``jax.export`` symbol. Unnamed specs share one dim per position (``d0``,
``d1``, ...), so two ``[None, 4]`` inputs have equal batches; a spec
with ``name=`` has its own dims (``<name>_0``, ...).
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .core.dtype import convert_dtype

__all__ = ["InputSpec", "name_scope", "program_guard", "Program",
           "default_main_program", "default_startup_program"]

# the example size of a dynamic dim: torch.export specializes dims of
# size 0 and 1, so a traced example uses 2
EXAMPLE_DIM = 2


class TensorStruct(NamedTuple):
    """A concrete signature (the counterpart of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class InputSpec:
    """Parity: ``paddle.static.InputSpec``: a tensor signature for
    ``jit.save`` / ``to_static``; ``None`` dims are dynamic."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name!r})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name)

    def to_symbolic_struct(self, prefix: str = "d",
                           scope: Optional[Dict[str, object]] = None):
        """``{axis: torch.export.Dim}`` for the ``None`` entries (the
        ``dynamic_shapes`` entry of this input), named ``<prefix><i>``.
        Every spec of one export passes the same ``scope`` dict, so equal
        names are one dim, as one ``jax.export`` scope makes them."""
        scope = {} if scope is None else scope
        dims = {}
        for i, d in enumerate(self.shape):
            if d is None:
                key = f"{prefix}{i}"
                if key not in scope:
                    scope[key] = torch.export.Dim(key)
                dims[i] = scope[key]
        return dims

    def example(self, device=None, batch_size=None) -> torch.Tensor:
        """A zero tensor of this signature: each ``None`` dim at
        ``EXAMPLE_DIM`` (a leading one at ``batch_size`` when given)."""
        shape = [(batch_size if i == 0 and batch_size is not None
                  else EXAMPLE_DIM) if d is None else d
                 for i, d in enumerate(self.shape)]
        return torch.zeros(shape, dtype=self.dtype, device=device)

    def to_struct(self, batch_size=None):
        """The concrete signature as a ``TensorStruct``; ``batch_size``
        fills a leading None dim (any other raises, as in JAX)."""
        shape = list(self.shape)
        for i, d in enumerate(shape):
            if d is None:
                if i == 0 and batch_size is not None:
                    shape[i] = batch_size
                else:
                    raise ValueError(
                        f"InputSpec {self!r}: dynamic dim {i} must be "
                        "resolved before export (pass batch_size, or "
                        "give a concrete shape)")
        return TensorStruct(tuple(shape), self.dtype)


@contextlib.contextmanager
def name_scope(prefix=None):
    """Parity: ``paddle.static.name_scope``: the prefix names a
    ``torch.profiler.record_function`` range, so it shows in profiles."""
    with torch.profiler.record_function(prefix or "scope"):
        yield


@contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    """Parity: ``paddle.static.program_guard``: there is no ProgramDesc,
    so this keeps legacy static-graph call sites importable."""
    yield main_program


class Program:
    """Parity stand-in for ``paddle.static.Program`` (a real class, so
    ``isinstance`` checks of migrating code hold)."""

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self


_MAIN = Program()
_STARTUP = Program()


def default_main_program():
    return _MAIN


def default_startup_program():
    return _STARTUP
