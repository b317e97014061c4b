"""Rules of the PyTorch port: ``paddle_tpu_torch``, ``chip_smoke.py`` and
``chip_ab.py`` import neither JAX nor anything of the JAX package
(checked in the source and in a fresh interpreter), every name a function
of theirs loads is defined, and the entry points that default to the
card raise where there is none instead of running on the CPU."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import ast
import builtins
import json
import os
import subprocess
import symtable
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


SCRIPTS = ("chip_ab.py", "chip_smoke.py")


def _port_files():
    files = [os.path.join(REPO, name) for name in SCRIPTS]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _port_modules():
    mods = []
    for path in _port_files():
        if not path.startswith(PORT + os.sep):
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel.removesuffix(".__init__"))
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_sources_import_no_jax_and_no_jax_package():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(_port_files()) > 15


_MODULE_NAMES = {"__file__", "__name__", "__doc__", "__spec__", "__loader__",
                 "__package__", "__path__", "__builtins__"}


def _tables(table):
    yield table
    for child in table.get_children():
        yield from _tables(child)


def undefined_names(path):
    """``file:line function: name`` for each name a function (a lambda
    or comprehension too) loads that is not a local, a parameter, a
    variable of an enclosing function, a module global (assigned,
    imported, def or class at module level, or declared ``global`` and
    assigned in a function) or a builtin."""
    with open(path, encoding="utf-8") as f:
        top = symtable.symtable(f.read(), path, "exec")
    tables = list(_tables(top))
    known = {s.get_name() for s in top.get_symbols()
             if s.is_assigned() or s.is_imported() or s.is_namespace()}
    known |= set(dir(builtins)) | _MODULE_NAMES
    functions = [t for t in tables if t.get_type() == "function"]
    for t in functions:
        known |= {s.get_name() for s in t.get_symbols()
                  if s.is_declared_global() and s.is_assigned()}
    rel = os.path.relpath(path, REPO)
    return [f"{rel}:{t.get_lineno()} {t.get_name()}: {s.get_name()}"
            for t in functions for s in t.get_symbols()
            if s.is_referenced() and s.is_global()
            and not (s.is_local() or s.is_parameter() or s.is_free())
            and s.get_name() not in known]


def test_port_functions_load_no_undefined_name():
    """The check a ``NameError`` on the card would have needed: it runs
    over ``chip_smoke.py``, ``chip_ab.py`` and every port module."""
    files = _port_files()
    assert {os.path.basename(p) for p in files} >= set(SCRIPTS)
    bad = [line for path in files for line in undefined_names(path)]
    assert not bad, bad


def test_undefined_name_check_catches_a_planted_name(tmp_path):
    src = ("import time\n\n\ndef phase(fn):\n"
           "    t0 = time.perf_counter()\n"
           "    return fn() + lables_ms, t0, [x for x in range(2) if y]\n")
    path = tmp_path / "planted.py"
    path.write_text(src)
    got = [line.split(" ", 1)[1] for line in undefined_names(str(path))]
    # comprehensions are inlined into their function (Python 3.12)
    assert sorted(got) == ["phase: lables_ms", "phase: y"]


def test_importing_the_port_loads_no_jax_module():
    """A fresh interpreter imports every port module; the modules it adds
    to sys.modules include nothing of JAX or the JAX package."""
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    added = json.loads(res.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.inference.serving" in added
    assert "paddle_tpu_torch.serving_api.server" in added
    for mod in ("models.mamba", "models.unet", "kernels.selective_scan",
                "kernels.group_norm", "nn.layout", "nn.functional.conv"):
        assert f"paddle_tpu_torch.{mod}" in added
    assert [m for m in added if _forbidden(m)] == []


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paged import PagePool, init_paged_pool
    from paddle_tpu_torch.distributed.parallel_layers import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
    )
    from paddle_tpu_torch.kernels.rope import rope_frequencies
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import RMSNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.trainer import TrainStep

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    # the public layers default to the card too
    gen = torch.Generator()
    for make in (lambda **kw: RMSNorm(8, **kw),
                 lambda **kw: ColumnParallelLinear(8, 4, generator=gen, **kw),
                 lambda **kw: RowParallelLinear(8, 4, generator=gen, **kw),
                 lambda **kw: VocabParallelEmbedding(16, 8, generator=gen,
                                                     **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        layer = make(device="cpu")
        assert all(p.device.type == "cpu" and p.requires_grad
                   for p in layer.parameters())
    from paddle_tpu_torch.models import (
        MambaConfig,
        MambaForCausalLM,
        UNet2DConditionModel,
        UNetConfig,
    )
    from paddle_tpu_torch.nn import Conv2D, GroupNorm, LayerNorm, Linear

    for make in (lambda **kw: MambaForCausalLM(MambaConfig.tiny(), **kw),
                 lambda **kw: UNet2DConditionModel(UNetConfig.tiny(), **kw),
                 lambda **kw: Linear(8, 4, **kw),
                 lambda **kw: Conv2D(4, 8, 3, **kw),
                 lambda **kw: GroupNorm(2, 8, **kw),
                 lambda **kw: LayerNorm(8, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        layer = make(device="cpu")
        assert all(p.device.type == "cpu" and p.requires_grad
                   for p in layer.parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    # the helpers default to the card too, and give host tensors only
    # when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rope_frequencies(32, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_generator(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_pool(1, 4, 4, 1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagePool(4, 4, 1, 2).device_state([0])
    assert rope_frequencies(32, 16, device="cpu")[0].device.type == "cpu"
    assert make_generator(0, device="cpu").device.type == "cpu"
    cpu_model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    # a train step runs where its model lives: on the CPU only when the
    # model was asked for it
    ts = TrainStep(cpu_model, AdamW())
    assert ts.device.type == "cpu"
    assert all(t.device.type == "cpu"
               for t in ts.opt_state["slots"]["lm_head.weight"].values())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cpu_model)
    # the router passes its device to every replica: the card by default
    from paddle_tpu_torch.inference import EngineRouter

    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineRouter(cpu_model, n_replicas=2)
    router = EngineRouter(cpu_model, n_replicas=2, device="cpu")
    assert all(rep.engine.device.type == "cpu" for rep in router._replicas)
    # an engine asked for a device its model is not on refuses too
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(cpu_model, device="meta")
    # the observability layer changes none of it: with telemetry,
    # tracing, the profiler and the time series on, the engine and the
    # router still default to the card and build nothing before they
    # raise; a telemetered train step runs where its model lives, and
    # the profiler's mark on a host device is the host stamp (None)
    from paddle_tpu_torch import flags as tflags
    from paddle_tpu_torch import observability as tobs

    keys = ("telemetry", "trace_sample", "profile_programs", "timeseries")
    saved = {k: tflags.flag(k) for k in keys}
    tflags.set_flags({"telemetry": True, "trace_sample": 1.0,
                      "profile_programs": True, "timeseries": True})
    try:
        tracers = len(tobs.tracing.all_tracers())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatchingEngine(cpu_model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EngineRouter(cpu_model, n_replicas=2)
        assert len(tobs.tracing.all_tracers()) == tracers
        ts = TrainStep(cpu_model, AdamW(), telemetry=True)
        assert ts.device.type == "cpu"
        assert isinstance(ts.telemetry, tobs.TrainTelemetry)
        assert tobs.ProgramProfiler.mark(torch.device("cpu")) is None
    finally:
        tflags.set_flags(saved)
