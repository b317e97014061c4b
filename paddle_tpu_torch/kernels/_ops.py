"""The kernel entries as ``torch.library`` ops in namespace ``paddle_tpu``.

Each launch entry of the kernel table is one op with three
implementations: ``CUDA`` (the ``ctypes`` launch, which adds one to the
entry's ``LAUNCHES`` count), ``CPU`` (the plain PyTorch version beside
it) and a fake (``register_fake``: the exact shapes, dtypes and strides
the launch writes, every output contiguous), so ``torch.export``, a
trace over fake tensors and ``torch.library.opcheck`` pass through the
kernels. The decode entries that append into the cache declare the
caches (and an int8 cache's scales) mutated.

The ops are defined through ``torch.library.Library`` rather than
``custom_op``: a call pays the dispatcher and one Python frame, not
``custom_op``'s Python autograd and view layers, which the decode path
would pay 32 times a token. Defining them builds nothing; the kernel
library is built at the first CUDA call, as before.

``OPS`` maps each op's name to ``(row of the kernel table, OpOverload)``;
``FAKE_CALLS`` counts each fake's calls. A fake notes the workspace its
launch holds inside the op (``workspace``), so the memory planner
(``trainer/memplan.py``) counts it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

LIB = torch.library.Library("paddle_tpu", "DEF")
OPS: Dict[str, Tuple[int, "torch._ops.OpOverload"]] = {}
# calls of each op's fake in this process (a trace over fake tensors, an
# export, the memory planner): which kernels a traced program reached
FAKE_CALLS: Dict[str, int] = {}
# bytes of the transient workspace the launches that the fakes stand for
# hold, added by each fake (the planner reads and resets it around an op)
WORKSPACE = [0]


def workspace(nbytes) -> None:
    """A fake notes the workspace its launch allocates and frees inside
    the op (concrete sizes only: a symbolic trace has no plan to feed)."""
    if isinstance(nbytes, int):
        WORKSPACE[0] += nbytes


def define(name: str, schema: str, row: int, cpu: Callable,
           cuda: Callable, fake: Callable):
    """Define ``paddle_tpu::<name><schema>`` with its CPU, CUDA and fake
    implementations; returns the op's default overload."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")

    def counted(*args):
        FAKE_CALLS[name] += 1
        return fake(*args)

    FAKE_CALLS[name] = 0
    torch.library.register_fake(f"paddle_tpu::{name}", counted, lib=LIB)
    op = getattr(torch.ops.paddle_tpu, name).default
    OPS[name] = (row, op)
    return op


def check_device(t, what: str) -> None:
    """Raises ``ValueError`` unless ``t`` lies on the CPU or the card (a
    fake tensor reports the device it stands for): a tensor elsewhere
    would reach no kernel and no plain version."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device} for {what}")
