"""``paddle.jit`` on ``torch.export`` (counterpart of
``paddle_tpu/jit.py``): ``to_static``, ``save`` and ``load``.

``to_static(layer)`` traces the layer once for each input signature
(shapes, dtypes and devices of its tensor arguments), as ``jax.jit``
does, with ``torch.export`` under ``no_grad``, and runs the exported
module; no compiler (inductor) runs. The weights are those of the layer
when the program was traced, as the JAX ``TracedLayer`` holds the
parameters it extracted.

``save(layer, path, input_spec)`` writes ``torch.export.save``'s archive
to ``path + ".pdmodel"``, the weights embedded, and ``load(path)`` gives
a ``TranslatedLayer`` that runs it without the defining Python code: the
deployment contract of ``paddle.jit.save``. ``None`` dims of the
``InputSpec`` list stay dynamic (``static.InputSpec.to_symbolic_struct``:
unnamed specs share one dim per position). The traced example puts 2
in every ``None`` dim, since ``torch.export`` specializes dims of size
0 and 1; the saved program serves size 1 all the same.

Export is per device, as ``jax.export`` lowers for one platform: the
kernels' dispatch chooses by device while tracing, so a program
exported on the CPU holds the plain operations and one exported on the
card holds the ``paddle_tpu::*`` kernel ops. The archive records the
device type it was traced on, and ``load`` on another device type
raises. Files do not cross the two packages (StableHLO against an
``ExportedProgram``).
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .core.device import current_device
from .static import InputSpec

_META = "paddle_tpu_torch.json"
FORMAT = "paddle_tpu_torch.jit/1"


class _FnModule(nn.Module):
    """A plain function as a module, so ``torch.export`` takes it."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _signature(args, kwargs):
    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("T", tuple(x.shape), x.dtype, x.device)
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        return ("V", repr(x))

    return sig(tuple(args)), tuple(sorted((k, sig(v))
                                          for k, v in kwargs.items()))


_RANGE_FIX = re.compile(r"^\s*(\w+) = Dim\('\w+'((?:, (?:min|max)=\d+)*)\)",
                        re.M)


def _export(module, args, kwargs=None, dynamic_shapes=None):
    """``torch.export`` under ``no_grad``. Where tracing bounds a dynamic
    dim (the rope tables bound a sequence by the model's positions), the
    export is taken again with the ranges it suggests; any other
    violation (a dynamic dim the model fixes to one value) raises."""

    def run(shapes):
        with torch.no_grad():
            return torch.export.export(module, tuple(args), kwargs or {},
                                       dynamic_shapes=shapes)

    try:
        return run(dynamic_shapes)
    except torch._dynamo.exc.UserError as e:
        msg = str(e)
        fixes = {name: dict(kv.split("=") for kv in
                            bounds.replace(" ", "").split(",") if kv)
                 for name, bounds in _RANGE_FIX.findall(msg)}
        if dynamic_shapes is None or not fixes or \
                "Suggested fixes" not in msg:
            raise
        made = {}

        def refine(dim):
            name = dim.__name__
            if name not in fixes:
                return dim
            if name not in made:
                made[name] = torch.export.Dim(
                    name, **{k: int(v) for k, v in fixes[name].items()})
            return made[name]

        def refine_all(d):
            if d is None:
                return None
            if isinstance(d, dict):
                return {ax: refine(dim) for ax, dim in d.items()}
            return tuple(refine_all(x) for x in d)

        return run(refine_all(dynamic_shapes))


class TracedLayer:
    """``to_static``'s result: the layer traced once per input signature
    (``programs`` keeps them), each exported program then run."""

    def __init__(self, layer: nn.Module, input_spec=None):
        self.layer = layer
        self._input_spec = input_spec
        self.programs: Dict[tuple, torch.export.ExportedProgram] = {}
        self._modules: Dict[tuple, nn.Module] = {}

    def _check_spec(self, args, kwargs):
        n_spec = len(self._input_spec)
        if len(args) != n_spec:
            raise ValueError(
                f"to_static declared {n_spec} input_spec entries but got "
                f"{len(args)} positional inputs; pass spec'd tensors "
                "positionally (keyword tensors bypass the declared "
                "signature)")
        for i, (spec, arg) in enumerate(zip(self._input_spec, args)):
            if not isinstance(spec, InputSpec):
                continue
            shape = tuple(arg.shape)
            ok = len(shape) == len(spec.shape) and all(
                d is None or d == a for d, a in zip(spec.shape, shape))
            if not ok:
                raise ValueError(
                    f"to_static input {i}: shape {shape} does not match "
                    f"declared {spec}")

    def __call__(self, *args, **kwargs):
        if self._input_spec is not None:
            self._check_spec(args, kwargs)
        key = _signature(args, kwargs)
        if key not in self._modules:
            ep = _export(self.layer, args, kwargs)
            self.programs[key] = ep
            self._modules[key] = ep.module()
        return self._modules[key](*args, **kwargs)

    @property
    def params(self):
        return dict(self.layer.named_parameters())


def to_static(layer=None, input_spec=None, full_graph=True, **kw):
    """Decorator or wrapper: a ``TracedLayer`` of a layer (or of a plain
    function, wrapped in a module)."""

    def wrap(target):
        if isinstance(target, nn.Module):
            return TracedLayer(target, input_spec=input_spec)
        return TracedLayer(_FnModule(target), input_spec=input_spec)

    if layer is None:
        return wrap
    return wrap(layer)


def _device_of(layer: nn.Module) -> torch.device:
    for t in layer.parameters():
        return t.device
    for t in layer.buffers():
        return t.device
    return current_device()


def export_program(traced, input_spec: Sequence):
    """The layer's forward exported with its weights for ``input_spec``
    (``InputSpec``s, whose ``None`` dims stay dynamic, tensors or
    arrays): ``(ExportedProgram, meta)``, ``meta`` recording the device
    type and the specs (what ``save`` writes beside the program)."""
    layer = traced.layer if isinstance(traced, TracedLayer) else traced
    if not isinstance(layer, nn.Module):
        layer = _FnModule(layer)
    device = _device_of(layer)
    scope: Dict[str, object] = {}
    examples, dyn, in_specs = [], [], []
    for x in input_spec:
        if isinstance(x, InputSpec):
            prefix = f"{x.name}_" if x.name else "d"
            examples.append(x.example(device))
            dims = x.to_symbolic_struct(prefix=prefix, scope=scope)
            dyn.append(dims or None)
            in_specs.append((list(x.shape), str(x.dtype)))
        else:
            t = torch.as_tensor(x, device=device)
            examples.append(t)
            dyn.append(None)
            in_specs.append((list(t.shape), str(t.dtype)))
    shapes = tuple(dyn) if any(dyn) else None
    if shapes is not None and isinstance(layer, _FnModule):
        shapes = (shapes,)  # its forward takes them as one *args
    ep = _export(layer, examples, dynamic_shapes=shapes)
    return ep, {"format": FORMAT, "device_type": device.type,
                "in_specs": in_specs}


def write_program(program, meta: dict, path: str) -> None:
    """``torch.export.save``'s archive at ``path + ".pdmodel"``, ``meta``
    beside the program."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f, extra_files={_META: json.dumps(meta)})


def save(traced, path: str, input_spec: Optional[Sequence] = None):
    """Export the layer's forward with its weights to ``path +
    ".pdmodel"`` (``export_program`` then ``write_program``);
    ``input_spec`` is required. Returns the ``ExportedProgram``."""
    if input_spec is None:
        raise ValueError("input_spec required for jit.save")
    program, meta = export_program(traced, input_spec)
    write_program(program, meta, path)
    return program


class LoadedFunction:
    """A loaded program (parity: ``paddle.jit.TranslatedLayer``): call it
    with the inputs of its specs; ``program`` is the
    ``ExportedProgram``."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.program = program
        self.meta = meta
        self._module = program.module()

    def __call__(self, *args):
        with torch.no_grad():
            out = self._module(*args)
        return out[0] if isinstance(out, (tuple, list)) and len(out) == 1 \
            else out

    def op_counts(self) -> Counter:
        """The program's call nodes by target name (``paddle_tpu::*`` for
        the kernels)."""
        return op_counts(self.program)


def op_counts(program: torch.export.ExportedProgram) -> Counter:
    """Call nodes of an exported program by their target's name."""
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function")


def load(path: str, device=None) -> LoadedFunction:
    """Load ``path + ".pdmodel"``. The program runs on the device type it
    was exported on; ``device`` (default: the current device) of another
    type raises ``ValueError``."""
    # the modules that define the paddle_tpu ops a program may call (the
    # package's import leaves some of them, quant_matmul, to first use)
    from .kernels import (  # noqa: F401
        decode_attention,
        group_norm,
        mha,
        paged_attention,
        quant_matmul,
        selective_scan,
    )

    extra = {_META: ""}
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_META] or "{}")
    want = current_device(device).type
    if meta.get("device_type", want) != want:
        raise ValueError(
            f"{path}.pdmodel was exported on {meta['device_type']} and runs "
            f"there only (export is per device); asked for {want}")
    return LoadedFunction(program, meta)


def not_to_static(fn=None):
    """Parity: ``paddle.jit.not_to_static``: a marker (tracing runs the
    Python as it is, so nothing reads it)."""
    if fn is None:
        return not_to_static
    fn._paddle_tpu_not_to_static = True
    return fn


def ignore_module(modules):
    """Parity: ``paddle.jit.ignore_module``: records intent and returns
    (there is no AST pass to skip)."""
    return None


#: Parity: ``paddle.jit.TranslatedLayer``, the type ``load`` returns
TranslatedLayer = LoadedFunction
