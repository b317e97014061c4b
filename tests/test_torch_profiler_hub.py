"""``paddle_tpu_torch.profiler``, ``hub`` and ``onnx`` against the JAX
package's: ``make_scheduler`` steps through the same states step by step
for every closed / ready / record / repeat / skip_first combination
tried; ``Profiler`` opens one ``torch.profiler`` window per record span,
writes each as a chrome trace that parses, calls ``on_trace_ready`` as
often as JAX's does, and its ``summary`` counts the kernel ops a CPU run
calls (``paddle_tpu::flash_forward`` here) and ``RecordEvent`` ranges;
``timer_only`` writes nothing; ``hub`` lists, documents and loads the
entries of a local ``hubconf.py`` and refuses other sources; ``onnx``
raises and names ``jit.save``."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json

import pytest
import torch

from paddle_tpu import hub as jhub
from paddle_tpu import profiler as jprof
from paddle_tpu_torch import hub, onnx, profiler
from paddle_tpu_torch.kernels import mha as tm


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2), dict(record=3),
    dict(closed=2, ready=0, record=1, repeat=2),
    dict(closed=1, ready=2, record=2, skip_first=3)],
    ids=["1-1-2", "record3", "repeat2", "skip3"])
def test_make_scheduler_states_match_jax(kw):
    t, j = profiler.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [t(i).name for i in range(16)] == [j(i).name for i in range(16)]


def test_profiler_windows_traces_and_summary(tmp_path):
    calls = []
    q = torch.randn(1, 32, 2, 16)
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2,
                                          repeat=1),
        on_trace_ready=lambda p: calls.append(p.step_num),
        log_dir=str(tmp_path / "log"))
    with prof:
        for _ in range(6):
            with profiler.RecordEvent("my_range"):
                tm.mha(q, q, q, causal=True)
            prof.step()
    # one record window (steps 2-3), one trace, one callback at its end
    assert calls == [4] and len(prof.traces) == 1
    with open(prof.traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_range" in names and "paddle_tpu::flash_forward" in names
    ops = prof.op_summary()
    assert ops["paddle_tpu::flash_forward"]["calls"] == 2
    assert ops["my_range"]["calls"] == 2
    text = prof.summary()
    # six steps and the one in flight at stop(), as JAX records them
    assert "steps: 7" in text and "paddle_tpu::flash_forward" in text
    quiet = profiler.Profiler(timer_only=True, log_dir=str(tmp_path / "q"))
    with quiet:
        quiet.step()
    assert quiet.traces == [] and not (tmp_path / "q").exists()
    cb = profiler.export_chrome_tracing(str(tmp_path / "chrome"))
    with profiler.Profiler(scheduler=(0, 1), on_trace_ready=cb) as p2:
        p2.step()
        p2.step()
    assert p2.traces and p2.traces[0].startswith(str(tmp_path / "chrome"))


HUBCONF = '''
def tiny(scale=1):
    """A tiny entry."""
    return {"scale": scale}


def _private():
    return None
'''


def test_hub_loads_local_repos_as_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert hub.list(repo) == jhub.list(repo) == ["tiny"]
    assert hub.help(repo, "tiny") == jhub.help(repo, "tiny") == \
        "A tiny entry."
    assert hub.load(repo, "tiny", scale=3) == jhub.load(repo, "tiny",
                                                        scale=3)
    with pytest.raises(NotImplementedError, match="local"):
        hub.list(repo, source="github")
    with pytest.raises(FileNotFoundError):
        hub.list(str(tmp_path / "missing"))


def test_onnx_export_raises_and_names_jit_save():
    with pytest.raises(NotImplementedError, match="jit.save"):
        onnx.export(torch.nn.Linear(2, 2), "m")
