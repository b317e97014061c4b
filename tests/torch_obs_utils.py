"""Shared pieces of the port's observability tests
(``tests/test_torch_observability.py``, ``test_torch_tracing.py``,
``test_torch_profiling.py``, ``test_torch_flight_data.py``): both
packages' observability and serving flags set and restored together,
the JAX engine and the port's run on the same arrivals, and the
Prometheus text reduced to what is not a time.

The registries and tracer sets are process-wide and pytest-xdist runs
many files in one worker, so every comparison reads one engine's series
by its ``engine`` (or ``router``) label, and ``fresh_registries`` empties
both registries once a module."""

import re

import numpy as np
import pytest

import torch_resilience_utils as U
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import ContinuousBatchingEngine as TEngine

# both packages: observability on as in a default JAX process, and the
# serving flags of the port's other parity tests
BASE = {"telemetry": True, "trace_sample": 1.0, "trace_buffer": 8192,
        "cost_attribution": True, "recompile_watchdog": True,
        "recompile_warmup_ticks": 64, "profile_programs": False,
        "profile_sample_every": 16, "timeseries": False,
        "timeseries_cadence": 16, "timeseries_retention": 256,
        "alerts": True, "slo_degradation": False,
        "telemetry_dump_dir": "flight_records",
        "prefix_cache": True, "spec_decode": "off", "prefill_chunk": 16,
        "serve_recovery": "auto", "fault_inject": "", "sanitize": False,
        "degradation": True}


class ObsFlags:
    """Sets both packages' flags (``BASE`` plus overrides) and restores
    every one it touched."""

    def __init__(self):
        self.saved = ({k: jflags.flag(k) for k in BASE},
                      {k: tflags.flag(k) for k in BASE})

    def set(self, **kw):
        jflags.set_flags({**BASE, **kw})
        tflags.set_flags({**BASE, **kw})

    def restore(self):
        jflags.set_flags(self.saved[0])
        tflags.set_flags(self.saved[1])


@pytest.fixture(scope="module")
def fresh_registries():
    """Both process registries emptied once, at the module's start."""
    jobs.global_registry().reset()
    tobs.global_registry().reset()


def engines(paged, **ecfg):
    """(JAX engine, port engine) over the tiny Llama pair, with the
    current flags."""
    jmodel, tmodel = U.tiny_models()
    return (JEngine(jmodel, U.jax_ecfg(paged, **ecfg)),
            TEngine(tmodel, U.port_ecfg(paged, **ecfg), device="cpu"))


def run(eng, prompts, new_tokens=6, max_chunk=4, **req):
    """Submit every prompt and drive ``step_chunk`` to the end; the
    finished requests in submission order."""
    rids = [eng.add_request(p, new_tokens, **req) for p in prompts]
    U.drive(eng, max_chunk)
    return [eng._finished[r] for r in rids]


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def samples(text):
    """Prometheus text -> [(name, {label: value}, float)], in order."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, line
        labels = dict(_LABEL.findall(m.group(3) or ""))
        out.append((m.group(1), labels, float(m.group(4))))
    return out


def types(text):
    """metric name -> its ``# TYPE``."""
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def series_of(text, key, value):
    """One engine's (or router's) samples: ``key`` is the label that names
    it, ``value`` its id, replaced by ``"*"``; samples without that label
    are dropped."""
    out = []
    for name, labels, v in samples(text):
        if labels.get(key) != value:
            continue
        labels = dict(labels, **{key: "*"})
        out.append((name, tuple(sorted(labels.items())), v))
    return out


def untimed(text, key, value):
    """What of one engine's exposition is not a time: every sample's name
    and label set, every counter's value, every histogram's ``_count``
    and its buckets' ``le`` layout. Gauges and bucket counts of time
    histograms are left out (times), as are ``_sum`` values."""
    kinds = types(text)
    keys, values = [], {}
    for name, labels, v in series_of(text, key, value):
        keys.append((name, labels))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if kinds.get(name) == "counter" or (
                kinds.get(base) == "histogram" and name.endswith("_count")):
            values[(name, labels)] = v
    return sorted(keys), values


def request_events(tracer):
    """rid -> the names of its request events, in order."""
    out = {}
    for ev in tracer.events():
        if ev["kind"] == "request":
            out.setdefault(ev["rid"], []).append(ev["name"])
    return out


TIME_ARGS = ("t0", "t1", "ts", "dur", "ttft_ms", "tpot_ms", "schedule_ms",
             "dispatch_ms", "device_ms", "sync_wall_ms",
             "admit_dispatch_ms")


def event_args(ev):
    """An event's args without the time fields."""
    return {k: v for k, v in ev["args"].items() if k not in TIME_ARGS}


def prompts(n=6, seed=0):
    return U.prompts(n, seed=seed)


def mixed_prompts(seed=0):
    """Prompts with a repeated 16-token block (prefix-cache hits at block
    8), of ragged lengths."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, 256, 16)
    return [np.concatenate([sys_prompt, rng.integers(1, 256, n)])
            for n in (3, 9, 5)] + [rng.integers(1, 256, n) for n in (7, 12)]
