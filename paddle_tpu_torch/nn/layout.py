"""Channels-last (NHWC) internal layout policy for conv models
(counterpart of ``paddle_tpu/nn/layout.py``).

The public API stays NCHW. A model that opts in transposes once at its
entry, opens ``channels_last_scope``, and every conv, norm and
interpolation inside resolves its declared "NCHW" to "NHWC"; it
transposes back once at its exit.

Policy, per model forward:

1. an explicit per-model setting (``UNetConfig.channels_last``) when not
   None;
2. the ``PT_FLAGS_conv_layout`` flag: "NHWC" forces on, "NCHW" off;
3. "auto" (default): NHWC for a model whose tensors are on the card,
   NCHW on the CPU. This is the port's reading of the JAX package's "NHWC
   on the TPU": cuDNN's tensor-core convolutions prefer channels-last
   too, and the NHWC GroupNorm is where the fused kernels (rows 12-13)
   run; the CPU tests keep the reference layout.

The scope is a process-level depth counter, as in JAX: the forward runs
on one thread, and the backward runs no forward code.
"""

from __future__ import annotations

import contextlib

import torch

from .. import flags

flags.define_flag(
    "conv_layout", "auto",
    "internal conv/pool/norm layout: NHWC | NCHW | auto (NHWC for "
    "tensors on the card, NCHW on the CPU)")

_scope_depth = 0

# declared channels-first formats a scope retargets to channels-last
_CHANNELS_LAST_OF = {"NCHW": "NHWC"}


def channels_last_preferred(device=None) -> bool:
    """The flag policy (no per-model override) for tensors on
    ``device``."""
    v = str(flags.flag("conv_layout")).upper()
    if v == "NHWC":
        return True
    if v == "NCHW":
        return False
    return device is not None and torch.device(device).type == "cuda"


def decide(explicit=None, device=None) -> bool:
    """Per-model policy: an explicit setting wins, else the flag/auto for
    a model whose tensors are on ``device``."""
    if explicit is not None:
        return bool(explicit)
    return channels_last_preferred(device)


def active() -> bool:
    return _scope_depth > 0


@contextlib.contextmanager
def channels_last_scope(enabled: bool = True):
    """While open (and ``enabled``), 4-D ops declared NCHW resolve to
    NHWC: the model has already transposed its activations."""
    global _scope_depth
    if not enabled:
        yield False
        return
    _scope_depth += 1
    try:
        yield True
    finally:
        _scope_depth -= 1


def resolve(declared: str) -> str:
    """The format of the tensors that actually flow through a layer
    declared ``declared``."""
    if _scope_depth > 0:
        return _CHANNELS_LAST_OF.get(declared, declared)
    return declared


@contextlib.contextmanager
def declared_scope():
    """Suspend scope resolution: inner calls see their declared format
    verbatim (an op that transposes explicitly and recurses into its own
    NCHW form)."""
    global _scope_depth
    prev = _scope_depth
    _scope_depth = 0
    try:
        yield
    finally:
        _scope_depth = prev


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """A contiguous NHWC copy, as ``jnp.transpose`` gives."""
    return x.permute(0, 2, 3, 1).contiguous()


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()
