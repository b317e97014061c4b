"""The memory plan of a train step without running it (counterpart of the
JAX step's ``lower(batch_shapes).compile().memory_analysis()``).

Eager PyTorch has no compiled program to ask, so the plan is counted:

- **arguments**: the exact bytes of what the real step holds on this
  rank between steps: the trainable parameters it carries (none of the
  master-backed ones under ``master_only``), the float32 masters, the
  optimizer's slots and step, and this rank's block of the batch. Shapes
  come from the (possibly ``meta``) tensors, so a step built under
  ``core.meta.meta_init`` is planned without its parameters.
- **temp**: the peak of live bytes over one run of the step (the masters'
  casts, forward, backward, clip and update) on fake tensors of the
  step's device (``FakeTensorMode``), through ``torch.func.
  functional_call``. Each fake storage counts from the operation that
  made it until a ``weakref`` finalizer sees it freed; eager frees follow
  Python's reference counts, so the fake run frees where the real one
  does. On the card the run passes through the kernel ops' fakes
  (``kernels/_ops.py``), which note the workspaces their launches hold
  inside the op, never through the plain attention's ``[b, h, s, s]``
  scores.
- **output**: what the step writes back (the carried state, updated in
  place) and its loss; **alias**: the state written in place, as the
  JAX step donates it.

XLA's temp is its buffer assignment of one program; this is the eager
step's own peak above its arguments, allocator rounding not included
(ROADMAP Queue C). Over a mesh the fake run would need collectives on
fake tensors, so ``temp_size_in_bytes`` is None there.
"""

from __future__ import annotations

import weakref
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


class MemoryAnalysis(NamedTuple):
    """Bytes of one step on this rank, with JAX's field names."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int]
    alias_size_in_bytes: int


def nbytes(tree) -> int:
    """Bytes of every tensor in a nested structure (``meta`` ones too)."""
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages that the operations under it make
    and that are still alive; ``peak`` is the most at once. Storages that
    existed before (the arguments) are not counted, but those ``watch``ed
    take their bytes off when they die: an update that replaces a state
    tensor by a new one holds both only until the old one is dropped."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.watched = set()
        self.current = 0
        self.peak = 0

    def _free(self, key):
        self.current -= self.live.pop(key, 0)

    def _drop(self, size):
        self.current -= size

    def watch(self, tensors) -> None:
        """Take each argument storage's bytes off ``current`` when it dies
        during the run."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata not in self.watched:
                self.watched.add(st._cdata)
                weakref.finalize(st, self._drop, st.nbytes())

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        size = st.nbytes()
        self.live[key] = size
        self.current += size
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..kernels import _ops

        _ops.WORKSPACE[0] = 0
        out = func(*args, **(kwargs or {}))
        # an output on one of the op's inputs' storages (a view, an
        # in-place result) is no new allocation
        inputs = {t.untyped_storage()._cdata
                  for t in pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" \
                    and t.untyped_storage()._cdata not in inputs:
                self._track(t)
        # a kernel op's workspace lives beside its outputs inside the op
        self.peak = max(self.peak, self.current + _ops.WORKSPACE[0])
        return out


class Compiled:
    """``Lowered.compile()``: holds the plan."""

    def __init__(self, analysis: MemoryAnalysis):
        self._analysis = analysis

    def memory_analysis(self) -> MemoryAnalysis:
        return self._analysis


class Lowered:
    """``TrainStep.lower(batch_shapes)``: ``compile()`` counts the plan
    (the fake run happens there)."""

    def __init__(self, step, batch_shapes: Dict):
        self.step = step
        self.batch = {
            k: torch.empty(tuple(v.shape), dtype=_dtype_of(v),
                           device="meta")
            for k, v in batch_shapes.items()}

    def compile(self) -> Compiled:
        return Compiled(plan(self.step, self.batch))


def _dtype_of(v):
    from ..core.dtype import convert_dtype

    dt = getattr(v, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt
    import numpy as np

    return convert_dtype(str(np.dtype(dt)))


def _state_bytes(step) -> int:
    carried = {n: step._slot_view(n, p.detach())
               for n, p in step._param_objs.items()
               if n not in step._master_dtypes}
    return nbytes(carried) + nbytes(step.opt_state)


def plan(step, batch_meta: Dict[str, torch.Tensor]) -> MemoryAnalysis:
    local = step.shard_batch(batch_meta, device="meta")
    state = _state_bytes(step)
    args = state + nbytes(local)
    loss_bytes = 4
    temp = None
    if step.mesh is None or step.mesh.size() == 1:
        temp = fake_step_peak(step, local)
    return MemoryAnalysis(args, state + loss_bytes, temp, state)


def fake_step_peak(step, local_batch: Dict[str, torch.Tensor]) -> int:
    """The peak of live bytes, above the arguments, of one run of
    ``step`` on fake tensors of its device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core.functional import functional_call
    from ..optimizer.clip import ClipGradByGlobalNorm, global_norm

    dev = step.device
    model = step.model
    masters = step._master_dtypes

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        def fake(t):
            if not isinstance(t, torch.Tensor):
                return t
            if t.device.type == "meta":
                return torch.empty_strided(tuple(t.shape), t.stride(),
                                           dtype=t.dtype, device=dev)
            return mode.from_tensor(t)

        opt_state = pytree.tree_map(fake, step.opt_state)
        carried = {n: fake(p.detach()) for n, p in step._param_objs.items()
                   if n not in masters}
        others = {n: fake(p.detach())
                  for n, p in model.named_parameters()
                  if n not in step._param_objs}
        buffers = {n: fake(b) for n, b in model.named_buffers()}
        batch = {k: fake(v) for k, v in local_batch.items()}
        with LiveBytes() as live:
            live.watch(pytree.tree_leaves([opt_state, carried, batch]))
            with torch.enable_grad():
                values = dict(others)
                for n in step._param_objs:
                    v = (opt_state["master"][n].to(masters[n])
                         if n in masters else carried[n])
                    values[n] = v.detach().requires_grad_(True)
                if step.loss_fn is None:
                    loss = functional_call(model, values, buffers=buffers,
                                           **batch)
                else:
                    out = functional_call(model, values, batch["input"],
                                          buffers=buffers)
                    loss = step.loss_fn(out, batch["label"])
                names = list(step._param_objs)
                grads = torch.autograd.grad(
                    loss, [values[n] for n in names], allow_unused=True)
            del values
            grads = {n: g for n, g in zip(names, grads) if g is not None}
            with torch.no_grad():
                norm = (global_norm(grads) if isinstance(
                    step.optimizer.grad_clip, ClipGradByGlobalNorm)
                    else None)
                step.optimizer.update(grads, opt_state, carried,
                                      grad_norm=norm)
            del grads, norm, loss
        return live.peak


def target_device(p) -> torch.device:
    """Where a parameter lives, or for a ``meta`` one the device it was
    asked for (``meta_init`` keeps it), else the current device."""
    from ..core.device import current_device

    if p.device.type != "meta":
        return p.device
    return current_device(getattr(p, "target_device", None))
