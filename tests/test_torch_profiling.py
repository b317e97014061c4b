"""The port's program profiler, dispatch-signature record, recompile
watchdog and device-memory accounting against the JAX package on the CPU
(the port's counterpart of ``tests/test_profiling.py``).

The JAX engine and the port's run the same arrivals on the tiny Llama
(weights carried across in float32) with ``profile_programs`` on at a
cadence of 2: each program's dispatch and sample counts are equal, each
sampled step event carries the measured decomposition (``profiled``,
``device_ms`` > 0 and no larger than the step's wall) where JAX's does,
and the unsampled ones the sync-wall fallback; the tokens equal a run
with the profiler off. The port's signature record counts, per program,
the specializations the JAX engine traced (``TRACE_COUNTS`` deltas), and
after the watchdog's seal a new decode-chunk length is one recompile on
both sides, with its flight record. ``hbm_snapshot()`` is equal for
float and int8 caches, paged and contiguous (the contiguous prefix
store's bytes included)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import collections
import json

import pytest

import torch_obs_utils as O
import torch_resilience_utils as U
from paddle_tpu import observability as jobs
from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch import observability as tobs

pytestmark = pytest.mark.usefixtures("fresh_registries")
fresh_registries = O.fresh_registries


def _traced(run):
    """Run ``run()`` and return its JAX ``TRACE_COUNTS`` growth."""
    before = collections.Counter(jserving.TRACE_COUNTS)
    run()
    grown = collections.Counter(jserving.TRACE_COUNTS)
    grown.subtract(before)
    return {k: v for k, v in grown.items() if v > 0}


@pytest.fixture(scope="module")
def prof_runs(tmp_path_factory):
    """paged: the profiler at cadence 2; contiguous: the watchdog sealed
    after two ticks of 4-step chunks, then one 2-step chunk. Each entry:
    (JAX engine, port engine, JAX trace-count growth, dump dirs)."""
    f = O.ObsFlags()
    out = {}
    try:
        f.set(profile_programs=True, profile_sample_every=2)
        jeng, teng = O.engines(True)
        grown = _traced(lambda: O.run(jeng, O.mixed_prompts()))
        O.run(teng, O.mixed_prompts())
        out["profile"] = (jeng, teng, grown, None)
        dirs = []
        for side in ("jax", "port"):
            d = tmp_path_factory.mktemp(f"recompile_{side}")
            dirs.append(d)
        f.set(recompile_warmup_ticks=2)
        jeng, teng = O.engines(False)
        grown = {}
        for eng, d in zip((jeng, teng), dirs):
            f.set(recompile_warmup_ticks=2, telemetry_dump_dir=str(d))

            def drive(eng=eng):
                for p in O.mixed_prompts():
                    eng.add_request(p, 12)
                eng.step_chunk(4)
                eng.step_chunk(4)
                eng.step_chunk(4)  # sealed: the same signature
                eng.step_chunk(2)  # a new chunk length
                U.drive(eng, 2)

            if eng is jeng:
                grown = _traced(drive)
            else:
                drive()
        out["recompile"] = (jeng, teng, grown, dirs)
    finally:
        f.restore()
    # the engines read their flags at construction: the rest of the
    # module runs with the flags it sets itself
    return out


def test_profiler_counts_and_decomposition_match_jax(prof_runs):
    jeng, teng, *_ = prof_runs["profile"]
    jp, tp = jeng.profile_snapshot(), teng.profile_snapshot()
    assert tp["enabled"] and tp["sample_every"] == jp["sample_every"] == 2
    assert {k: (v["dispatches"], v["sampled"])
            for k, v in tp["programs"].items()} \
        == {k: (v["dispatches"], v["sampled"])
            for k, v in jp["programs"].items()}
    assert tp["programs"]["decode_chunk"]["sampled"] >= 2
    for st in tp["programs"].values():
        if st["sampled"]:
            assert 0 < st["device_ms_p50"] <= st["device_ms_max"]
    jsteps = [e for e in jeng._tracer.events() if e["kind"] == "step"]
    tsteps = [e for e in teng._tracer.events() if e["kind"] == "step"]
    assert [(e["name"], sorted(e["args"])) for e in tsteps] \
        == [(e["name"], sorted(e["args"])) for e in jsteps]
    sampled = [e for e in tsteps if e["args"].get("profiled")]
    assert sampled
    for e in sampled:
        dec = e["args"]
        assert dec["device_ms"] > 0 and dec["schedule_ms"] >= 0
        # the device time sits inside the step's wall
        assert dec["device_ms"] <= (e["t1"] - e["t0"]) * 1e3
        assert "sync_wall_ms" not in dec
    for e in tsteps:
        if e["name"] == "decode_chunk" and not e["args"].get("profiled"):
            assert e["args"]["sync_wall_ms"] >= 0
    # cost attribution: prefill only from measured samples, as in JAX
    tc, jc = teng.cost_snapshot(), jeng.cost_snapshot()
    assert set(tc["attributed_ms"]) == set(jc["attributed_ms"])
    assert tc["profiled_ms"] > 0 and tc["estimated_ms"] > 0


def test_profiler_off_changes_no_token(prof_runs):
    jeng, _, *_ = prof_runs["profile"]
    f = O.ObsFlags()
    f.set(profile_programs=False)
    try:
        _, tmodel = U.tiny_models()
        eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        assert eng._prof is None
        reqs = O.run(eng, O.mixed_prompts())
    finally:
        f.restore()
    assert [r.output for r in reqs] \
        == [jeng._finished[r.rid].output for r in reqs]
    assert eng.profile_snapshot() == {"enabled": False}


def test_profiler_cadence_and_labels():
    tp = tobs.ProgramProfiler(engine_id="t", sample_every=3)
    jp = jobs.ProgramProfiler(engine_id="j", sample_every=3)
    assert [tp.want("decode_chunk") for _ in range(9)] \
        == [jp.want("decode_chunk") for _ in range(9)] \
        == [False, False, True] * 3
    with pytest.raises(ValueError, match="PROGRAM_LABELS"):
        tp.want("nope")
    assert set(tobs.PROGRAM_LABELS) == set(jobs.PROGRAM_LABELS)
    tp.window_reset()
    assert tp.snapshot()["programs"] == {}


@pytest.mark.parametrize("case", ["profile", "recompile"])
def test_signatures_count_what_jax_traces(prof_runs, case):
    """One signature per JAX specialization, program by program, and
    every program the engine dispatched has a timing label."""
    _, teng, grown, _ = prof_runs[case]
    assert dict(teng._sigs.counts) == grown
    assert set(teng._sigs.counts) <= set(tobs.PROGRAM_LABELS)


def test_watchdog_counts_a_new_chunk_length_like_jax(prof_runs):
    """After the seal a 2-step chunk is a new decode_chunk signature, and
    the first prefix-cache hit (after the seal too) the first
    prefix_insert: one recompile each on both sides, each with one
    flight record naming its arg shapes."""
    jeng, teng, _, dirs = prof_runs["recompile"]
    want = jeng.recompile_snapshot()
    got = teng.recompile_snapshot()
    assert got == want
    assert got["sealed"] and got["recompiles"]["decode_chunk"] == 1
    treg = tobs.global_registry().get("pt_serve_recompiles_total")
    for program, n in got["recompiles"].items():
        assert treg.value(engine=teng._tel.engine_id, program=program) == n
    records = []
    for d in dirs:
        recs = [json.load(open(p))["records"][-1]
                for p in sorted(d.glob("flight_*.json"))]
        assert all(r["kind"] == "serve_recompile" for r in recs)
        assert sorted(r["program"] for r in recs) \
            == sorted(got["recompiles"])
        # ("count" is TRACE_COUNTS' process-wide total on the JAX side)
        records.append(sorted((r["program"],
                               json.dumps(r["arg_shapes"], sort_keys=True))
                              for r in recs))
    assert records[1] == records[0]
    chunk = next(r for r in records[1] if r[0] == "decode_chunk")
    assert json.loads(chunk[1])["toks"] == [2, 1]


def test_watchdog_seal_and_off():
    f = O.ObsFlags()
    try:
        f.set(recompile_warmup_ticks=1)
        _, tmodel = U.tiny_models()
        eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        O.run(eng, O.prompts(3))
        snap = eng.recompile_snapshot()
        assert snap["sealed"] and snap["recompiles"] == {}
        f.set(recompile_watchdog=False)
        eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        assert eng._watchdog is None and eng._sigs is None
        eng.seal_programs()  # a no-op with the watchdog off
        assert eng.recompile_snapshot() == {"enabled": False}
        f.set(recompile_warmup_ticks=10 ** 6)
        eng = O.TEngine(tmodel, U.port_ecfg(True), device="cpu")
        eng.seal_programs()
        assert eng.recompile_snapshot()["sealed"]
    finally:
        f.restore()


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hbm_accounting_matches_jax(paged, dtype):
    import jax.numpy as jnp
    import torch

    f = O.ObsFlags()
    f.set()
    try:
        jmodel, tmodel = U.tiny_models()
        jeng = O.JEngine(jmodel, U.jax_ecfg(
            paged, cache_dtype=jnp.int8 if dtype == "int8" else jnp.float32))
        teng = O.TEngine(tmodel, U.port_ecfg(
            paged, cache_dtype=torch.int8 if dtype == "int8"
            else torch.float32), device="cpu")
        got, want = teng.hbm_snapshot(), jeng.hbm_snapshot()
    finally:
        f.restore()
    assert got == want
    assert (got["kv_scales"] > 0) == (dtype == "int8")
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    # the gauges carry the same components
    gauge = tobs.global_registry().get("pt_serve_hbm_bytes")
    assert gauge.value(engine=teng._tel.engine_id,
                       component="kv_pool") == got["kv_pool"]


def test_hbm_prefix_store_bytes_match_jax(prof_runs):
    jeng, teng, *_ = prof_runs["recompile"]
    got, want = teng.hbm_snapshot(), jeng.hbm_snapshot()
    assert got == want and got["prefix_store"] > 0
