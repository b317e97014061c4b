"""The port's distributed core against the JAX package on the CPU: every
collective, the groups and the hybrid group's queries, the spec
functions, the strategy's JSON, the tensor-parallel layers at tp 2 and
4, ``auto_parallel`` on DTensor, the elastic manager and the launcher.

The JAX package is single-controller: one process sees the CPU devices
and a collective takes a global array split over a mesh axis. The port
is SPMD, one gloo process a rank (``tests/torch_dist_pool.py``: four
workers started once for the file, a ``file://`` rendezvous in the
module's temporary directory). Rank r's tensor is block r of JAX's
global input along the axis, and rank r's output must be block r of
JAX's global output; the JAX side runs on ``jax.devices()[:4]``."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import flags as jflags
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.distributed import sharding as jshd
from paddle_tpu.distributed.parallel_layers import mp_layers as jmp
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.distributed.strategy import HybridConfig as JHybrid
from paddle_tpu.observability import comm as jcomm
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.launch import launch
from paddle_tpu_torch.distributed import sharding as tshd
from paddle_tpu_torch.distributed.strategy import (
    DistributedStrategy,
    HybridConfig,
)

import torch_dist_pool as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(N, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jmesh(**kw):
    return jdist.build_mesh(devices=jax.devices()[:N], **kw)


def _blocks(global_out, n, c):
    return np.split(np.asarray(global_out), n)[c]


# ------------------------------------------------------------ collectives
MESHES = [(dict(dp=4), "dp"), (dict(dp=2, tp=2), "dp"),
          (dict(dp=2, tp=2), "tp")]


def _data(n):
    rng = np.random.default_rng(3)
    n_loc = 6
    splits = np.zeros((n, n), np.int64)
    for r in range(n):
        cuts = np.sort(rng.integers(0, n_loc + 1, n - 1))
        splits[r] = np.diff(np.concatenate([[0], cuts, [n_loc]]))
    return {"x": np.arange(n * 3, dtype=np.float32) - 5.0,
            "pos": (np.arange(n * 3, dtype=np.float32) % 3) + 1.0,
            "rs": np.arange(n * n * 2, dtype=np.float32),
            "a2a": np.arange(n * n * 2, dtype=np.float32),
            "ragged": np.arange(n * n_loc, dtype=np.float32),
            "splits": splits}


def _jax_collectives(mesh_kw, axis, data):
    """JAX's global outputs of the same calls (the eager calls traced into
    one jitted program: one compile, and the same comm log, which JAX
    records at trace time), and its comm log."""
    mesh = _jmesh(**mesh_kw)
    n = mesh.shape[axis]
    prev = jflags.flag("telemetry")
    jflags.set_flags({"telemetry": True})
    jcomm.reset_comm_log()

    def core(x, pos, rs, a2a):
        out = {}
        for op in ("sum", "max", "min", "avg", "prod"):
            out[f"all_reduce_{op}"] = jdist.all_reduce(
                x if op != "prod" else pos, op=op, group=axis, mesh=mesh)
        out["all_gather"] = jdist.all_gather(x, group=axis, mesh=mesh)
        out["reduce_scatter"] = jdist.reduce_scatter(rs, group=axis,
                                                     mesh=mesh)
        out["alltoall"] = jdist.alltoall(a2a, group=axis, mesh=mesh)
        out["alltoall_single"] = jdist.alltoall_single(a2a, group=axis,
                                                       mesh=mesh)
        return out

    def rest(x):
        out = {}
        out["broadcast"] = jdist.broadcast(x, src=1, group=axis, mesh=mesh)
        out["reduce"] = jdist.reduce(x, dst=1, group=axis, mesh=mesh)
        out["scatter"] = jdist.scatter(
            None, [jnp.full((2,), float(i)) for i in range(n)], group=axis,
            mesh=mesh)
        out["gathered"] = jnp.stack(jdist.gather(x, group=axis, mesh=mesh))
        out["recv"] = jdist.recv(x, src=0, group=axis, mesh=mesh)
        out["isend"] = jdist.send(x, dst=n - 1, group=axis, mesh=mesh)
        # the even -> odd edges of the port's batch, one JAX call each
        out["batch_edges"] = jnp.stack([
            jdist.send(x, dst=e + 1, group=axis, mesh=mesh)
            for e in range(0, n, 2)])
        return out

    try:
        out = jax.jit(core)(*(jnp.asarray(data[k])
                              for k in ("x", "pos", "rs", "a2a")))
        ragged = jdist.alltoall_single(
            jnp.asarray(data["ragged"]), in_split_sizes=data["splits"],
            out_split_sizes=data["splits"].T, group=axis, mesh=mesh)
        log = _per_op([(e["op"], e["axis"], e["traced_calls"])
                       for e in jcomm.comm_log()])
        out.update(jax.jit(rest)(jnp.asarray(data["x"])))
    finally:
        jflags.set_flags({"telemetry": prev})
        jcomm.reset_comm_log()
    gathered = np.asarray(out.pop("gathered"))
    edges = np.asarray(out.pop("batch_edges"))
    batch = np.asarray(data["x"]).copy()
    per = len(batch) // n
    for i, e in enumerate(range(0, n, 2)):
        batch[(e + 1) * per:(e + 2) * per] = \
            edges[i][(e + 1) * per:(e + 2) * per]
    out["batch_p2p"] = batch
    return out, ragged, gathered, log


def _per_op(entries):
    """``{(op, axis): calls}`` summed over the call sites."""
    out = {}
    for op, axis, k in entries:
        out[(op, axis)] = out.get((op, axis), 0) + k
    return out


@pytest.mark.parametrize("mesh_kw,axis", MESHES)
def test_every_collective_matches_jax(pool, mesh_kw, axis):
    n = mesh_kw[axis]
    data = _data(n)
    got = pool.run(tdp.collectives_job, mesh_kw, axis, data)
    want, ragged, gathered, jlog = _jax_collectives(mesh_kw, axis, data)
    for res in got:
        c, out = res["coord"], res["out"]
        for name, g in want.items():
            w = _blocks(g, n, c)
            if name == "all_reduce_prod":
                # JAX takes exp(psum(log x)); the port the exact product
                np.testing.assert_allclose(out[name], w, rtol=1e-5)
                exact = np.prod(np.split(data["pos"], n), axis=0)
                np.testing.assert_array_equal(out[name], exact)
            else:
                np.testing.assert_array_equal(out[name], w, err_msg=name)
        # rank r's ragged output is JAX's out[r]; gather is JAX's list
        np.testing.assert_array_equal(out["ragged_matrix"], ragged[c])
        np.testing.assert_array_equal(out["ragged_row"], ragged[c])
        np.testing.assert_array_equal(out["gather"], gathered)
        # the list forms: Paddle's contract, every rank's tensor
        np.testing.assert_array_equal(out["all_gather_list"],
                                      np.stack(np.split(data["x"], n)))
        np.testing.assert_array_equal(out["alltoall_list"],
                                      out["alltoall"])
        np.testing.assert_array_equal(out["alltoall_single"],
                                      out["alltoall"])
        np.testing.assert_array_equal(out["stream_all_reduce"],
                                      out["all_reduce_sum"])
        np.testing.assert_array_equal(out["stream_all_gather"],
                                      out["all_gather"])
        assert res["objects"] == [{"c": i} for i in range(n)]
        assert res["broadcast_objects"] == ["from 1", 1]
        # the comm log of the calls both make: JAX's ops, axes and counts
        assert _per_op(res["core_log"]) == jlog
        log = _per_op(res["log"])
        assert log[("all_reduce", axis)] == 5 + 1  # + the stream call
        for op in ("broadcast", "reduce", "scatter", "gather"):
            assert log[(op, axis)] == 1, op
    # the source logs its sends, the destination its receives
    ops = {op for res in got for op, _, _ in res["log"]}
    assert {"send", "recv"} <= ops


def test_groups_fleet_and_hybrid_group_queries_match_jax(pool):
    got = pool.run(tdp.groups_job)
    s = JStrategy()
    s.hybrid_configs = JHybrid(dp_degree=2, mp_degree=2)
    for r, q in enumerate(got):
        hcg = jdist.HybridCommunicateGroup(s, devices=jax.devices()[:N],
                                           rank=r)
        for name in ("get_data_parallel_world_size",
                     "get_data_parallel_rank",
                     "get_model_parallel_world_size",
                     "get_model_parallel_rank",
                     "get_sharding_parallel_world_size",
                     "get_sharding_parallel_rank",
                     "get_pipe_parallel_world_size", "get_stage_id",
                     "get_sep_parallel_world_size", "get_sep_parallel_rank",
                     "get_expert_parallel_world_size",
                     "get_expert_parallel_rank"):
            assert q[name] == getattr(hcg, name)(), name
        assert q["is_first_stage"] == hcg.is_first_stage
        assert q["is_last_stage"] == hcg.is_last_stage
        assert q["topology"] == hcg.topology()
        for key, g in (("tp_group", hcg.get_model_parallel_group()),
                       ("dp_group", hcg.get_data_parallel_group())):
            assert q[key] == (g.axis, g.nranks, g.rank, g.ranks)
        assert q["axis_group"] == (2, True)
        assert q["ranks_group_axis"] == "tp"
        assert q["odd_group_axis"] is None
        if r in (0, 3):
            assert q["odd_sum"] == 3.0
        assert q["default_group_sum"] == 2.0
        assert q["destroyed"]
        assert q["fleet"] == (r, N, r == 0, True)
        assert q["passes"] == (True, True)
        assert q["env"] == (r, N, r, N, True)
        assert q["too_few"] == "PreconditionNotMetError"


# --------------------------------------------------------- spec functions
SHAPES = [(256, 512), (64, 64), (128,), (4096,), (8192,), (3, 4096),
          (5, 4000), (16, 32, 64), (1, 16384), (96, 100)]
LOGICAL = [None, (None, "tp"), ("tp", None), ("tp",), (("ep", "tp"),),
           ("fsdp", None)]


def _both(stage, fsdp, sharding):
    out = []
    for cls, hyb in ((JStrategy, JHybrid), (DistributedStrategy,
                                            HybridConfig)):
        s = cls()
        s.hybrid_configs = hyb(sharding_degree=fsdp)
        s.sharding = sharding
        s.sharding_configs.stage = stage
        out.append(s)
    return out


@pytest.mark.parametrize("stage,fsdp,sharding", [
    (1, 1, False), (1, 2, True), (2, 4, True), (3, 2, True), (3, 8, False),
    (3, 1, True)])
def test_spec_functions_match_jax(stage, fsdp, sharding):
    js, ts = _both(stage, fsdp, sharding)
    assert ts.sharding_stage == js.sharding_stage
    n = 0
    for shape in SHAPES:
        for lspec in LOGICAL:
            if lspec is not None and len(lspec) > len(shape):
                continue
            for fn in ("param_partition_spec", "opt_slot_partition_spec"):
                want = tuple(getattr(jshd, fn)("w", shape, lspec, js))
                assert getattr(tshd, fn)("w", shape, lspec, ts) == want
                n += 1
            full = tshd._normalize_logical_spec(lspec, len(shape))
            assert tshd.fsdp_augment(full, shape, "fsdp", fsdp) == \
                jshd.fsdp_augment(full, shape, "fsdp", fsdp)
    assert n > 80
    for ndim in (1, 2, 3):
        for seq in (None, 1, 2):
            assert tshd.batch_spec(ndim, seq, ts) == \
                tuple(jshd.batch_spec(ndim, seq, js))
            assert tshd.batch_spec(ndim, seq) == \
                tuple(jshd.batch_spec(ndim, seq))


def test_strategy_json_round_trips_both_ways():
    js = JStrategy()
    js.hybrid_configs = JHybrid(dp_degree=2, mp_degree=4,
                                sharding_degree=8, sep_degree=2)
    js.sharding = True
    js.sharding_configs.stage = 3
    js.recompute = True
    js.recompute_configs.policy = "full"
    js.amp_configs.dtype = "float16"
    js.pipeline_configs.schedule_mode = "VPP"
    js.moe_configs.top_k = 1
    js.gradient_merge = True
    js.gradient_merge_k_steps = 4
    js.find_unused_parameters = True
    ts = DistributedStrategy.deserialize(js.serialize())
    assert json.loads(ts.serialize()) == json.loads(js.serialize())
    back = JStrategy.deserialize(ts.serialize())
    assert back == js
    assert (ts.tp, ts.dp, ts.pp, ts.fsdp, ts.sep, ts.sharding_stage) == \
        (js.tp, js.dp, js.pp, js.fsdp, js.sep, js.sharding_stage)
    assert DistributedStrategy.deserialize(
        DistributedStrategy().serialize()) == DistributedStrategy()
    # unknown keys are skipped, as in JAX
    raw = json.loads(js.serialize())
    raw["future_knob"] = 1
    assert DistributedStrategy.deserialize(json.dumps(raw)) == ts
    t = tshd.group_sharded_parallel("m", "o", level="os_g")
    assert t[0] == "m" and t[1] == "o" and t[3] is None
    assert t[2].sharding_stage == 2
    with pytest.raises(ValueError):
        tshd.group_sharded_parallel(None, None, level="bogus")


# ---------------------------------------------------- tensor-parallel layers
def _jax_layer(kind, weights, x, dy, kw, tp):
    """JAX's layer on a tp mesh: output, parameter and input gradients."""
    pt.seed(0)
    if kind == "column":
        layer = jmp.ColumnParallelLinear(*weights["weight"].shape,
                                         has_bias="bias" in weights, **kw)
    elif kind == "row":
        layer = jmp.RowParallelLinear(*weights["weight"].shape,
                                      has_bias="bias" in weights, **kw)
    elif kind == "embedding":
        layer = jmp.VocabParallelEmbedding(*weights["weight"].shape)
    else:
        layer = jmp.ParallelCrossEntropy(**kw)
    if weights:
        layer.set_state_dict({k: jnp.asarray(v) for k, v in weights.items()})
    mesh = _jmesh(tp=tp)
    s = JStrategy()
    s.hybrid_configs = JHybrid(mp_degree=tp)
    jdist.place_params_on_mesh(layer, mesh, s)
    params = extract_params(layer)

    def f(p, xin):
        if kind == "cross_entropy":
            y = functional_call(layer, p, xin, jnp.asarray(x[1]))
        else:
            y = functional_call(layer, p, xin)
        return jnp.sum(y * jnp.asarray(dy)), y

    xin = jnp.asarray(x[0] if kind == "cross_entropy" else x)
    argnums = (0,) if kind == "embedding" else (0, 1)
    with jshd.mesh_context(mesh):
        (_, y), grads = jax.jit(jax.value_and_grad(
            f, argnums=argnums, has_aux=True))(params, xin)
    return (np.asarray(y), {k: np.asarray(v) for k, v in grads[0].items()},
            None if kind == "embedding" else np.asarray(grads[1]))


def _layer_case(kind, kw):
    rng = np.random.default_rng(11)
    b, s = 2, 3
    if kind in ("column", "row"):
        w = {"weight": rng.standard_normal((16, 8)).astype(np.float32)}
        if kw.pop("bias", True):
            w["bias"] = rng.standard_normal(8).astype(np.float32)
        x = rng.standard_normal((b, s, 16)).astype(np.float32)
        dy = rng.standard_normal((b, s, 8)).astype(np.float32)
    elif kind == "embedding":
        w = {"weight": rng.standard_normal((16, 8)).astype(np.float32)}
        x = rng.integers(0, 16, (b, s))
        dy = rng.standard_normal((b, s, 8)).astype(np.float32)
    else:
        w = {}
        logits = rng.standard_normal((b, s, 16)).astype(np.float32) * 3
        label = rng.integers(0, 16, (b, s))
        label[0, 1] = kw.get("ignore_index", -100)
        x = (logits, label)
        dy = rng.standard_normal((b, s)).astype(np.float32)
    return w, x, dy


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind,kw", [
    ("column", {}), ("column", dict(gather_output=True)),
    ("column", dict(bias=False)), ("row", {}),
    ("row", dict(input_is_parallel=False)), ("embedding", {}),
    ("cross_entropy", {}), ("cross_entropy", dict(ignore_index=3))])
def test_tensor_parallel_layers_match_jax(pool, kind, kw, tp):
    kw = dict(kw)
    weights, x, dy = _layer_case(kind, kw)
    wy, wgrads, wdx = _jax_layer(kind, weights, x, dy, kw, tp)
    got = pool.run(tdp.mp_layer_job, kind, tp, weights, x, dy, kw)
    spec = {"column": {"weight": 1, "bias": 0}, "row": {"weight": 0},
            "embedding": {"weight": 0}}.get(kind, {})
    for res in got:
        c = res["coord"]
        y = wy
        if kind == "column" and not kw.get("gather_output"):
            y = np.split(wy, tp, -1)[c]
        np.testing.assert_allclose(res["y"], y, rtol=1e-5, atol=1e-5)
        for name, g in wgrads.items():
            if name in spec:
                g = np.split(g, tp, spec[name])[c]
            np.testing.assert_allclose(res["grads"][name], g, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        if wdx is not None:
            dx = wdx
            if kind == "cross_entropy" or (
                    kind == "row" and kw.get("input_is_parallel", True)):
                dx = np.split(wdx, tp, -1)[c]
            np.testing.assert_allclose(res["dx"], dx, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ auto_parallel
def test_auto_parallel_blocks_are_the_jax_shards(pool):
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    got = pool.run(tdp.auto_parallel_job, x)
    pm = jdist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "tp"],
                           devices=jax.devices()[:N])
    y = jdist.shard_tensor(jnp.asarray(x), pm,
                           [jdist.Shard(0), jdist.Shard(1)])
    shards = {s.device.id: np.asarray(s.data) for s in y.addressable_shards}
    z = jdist.reshard(y, pm, [jdist.Replicate(), jdist.Shard(0)])
    zsh = {s.device.id: np.asarray(s.data) for s in z.addressable_shards}
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["local"], shards[r])
        np.testing.assert_array_equal(res["resharded_local"], zsh[r])
        np.testing.assert_array_equal(res["unsharded"], x)
        assert res["placements"] == [repr(p) for p in
                                     jdist.get_placements(y, pm)] == \
            ["Shard(dim=0)", "Shard(dim=1)"]
        np.testing.assert_array_equal(res["from_fn"], np.ones((2, 3)))
        assert res["param_spec"] == ("dp", None)
        assert res["layer_placements"] == ["Replicate()", "Replicate()"]
        # a Partial (sum) of two replicas, reduced by the reshard
        assert res["partial_placements"] == ["Partial(sum)", "Replicate()"]
        np.testing.assert_array_equal(res["partial_to_replicate"], 2 * x)
        assert res["get_mesh"]


# ------------------------------------------------------------------ elastic
def _mgr(tmp_path, node_id, np_range=(1, 4), **kw):
    store = elastic.FileStore(str(tmp_path), "job1")
    kw.setdefault("heartbeat_interval", 0.05)
    kw.setdefault("fault_timeout", 0.5)
    return elastic.ElasticManager(store, np_range, node_id=node_id, **kw)


def test_elastic_membership_faults_and_np_range(tmp_path):
    assert elastic.parse_np_range("2:4") == (2, 4)
    assert elastic.parse_np_range("3") == (3, 3)
    a = _mgr(tmp_path, "nodeA").register()
    b = _mgr(tmp_path, "nodeB").register()
    try:
        alive, faulted = a.scan()
        assert sorted(alive) == ["nodeA", "nodeB"] and not faulted
        sa, sb = a.plan(), b.plan()
        assert sa.nnodes == sb.nnodes == 2
        assert sa.node_rank == 0 and sb.node_rank == 1
        assert sa.hosts == sb.hosts
        # B's heartbeat stops (a crash) and its file ages
        b._stop.set()
        b._hb_thread.join(timeout=2)
        old = time.time() - 10
        os.utime(b.store._path("nodeB"), (old, old))
        alive, faulted = a.scan()
        assert alive == ["nodeA"] and faulted == ["nodeB"]
        assert a.evict_faulted() == ["nodeB"]
        assert a.plan() == elastic.WorldSpec(
            nnodes=1, node_rank=0, hosts=[socket.gethostname()],
            node_ids=["nodeA"])
    finally:
        a.deregister()
        b.deregister()
    c = _mgr(tmp_path / "r", "nodeA", np_range=(2, 3)).register()
    try:
        assert c.plan() is None  # below min_np
        more = [_mgr(tmp_path / "r", f"node{x}", np_range=(2, 3)).register()
                for x in "BCD"]
        assert c.plan() is None  # above max_np
        more.pop().deregister()
        assert c.plan() is not None
        for m in more:
            m.deregister()
    finally:
        c.deregister()


def test_elastic_wait_for_world_and_latest_checkpoint(tmp_path):
    import threading

    a = _mgr(tmp_path, "nodeA", np_range=(2, 2)).register()
    joined = []
    try:
        def join_later():
            time.sleep(0.3)
            joined.append(_mgr(tmp_path, "nodeB",
                               np_range=(2, 2)).register())

        t = threading.Thread(target=join_later)
        t.start()
        spec = a.wait_for_world(timeout=5.0, poll=0.05)
        t.join()
        assert spec is not None and spec.nnodes == 2
    finally:
        a.deregister()
        for m in joined:
            m.deregister()
    root = tmp_path / "ckpts"
    for step, how in [(10, "meta"), (20, "marker"), (30, None)]:
        d = root / f"step_{step}"
        d.mkdir(parents=True)
        if how == "meta":
            (d / "metadata.json").write_text(json.dumps({}))
        elif how == "marker":
            (d / elastic.COMMITTED_MARKER).write_text("")
    (root / "step_40.tmp").mkdir()
    assert elastic.latest_checkpoint(str(root)) == str(root / "step_20")
    assert elastic.latest_checkpoint(str(tmp_path / "missing")) is None


# ------------------------------------------------------------------ launch
_WORKER = """
import os
import torch
from paddle_tpu_torch import distributed as D
D.init_parallel_env(backend="gloo")
x = torch.tensor([float(D.get_rank() + 1)])
D.all_reduce(x)
print("rank", D.get_rank(), "of", D.get_world_size(), "sum", float(x),
      "local", os.environ["LOCAL_RANK"], os.environ["PADDLE_LOCAL_RANK"],
      flush=True)
"""


_FAILING = """
import os, sys, time
if os.environ["RANK"] == "1":
    sys.exit(7)
time.sleep(60)
"""


def _launch(tmp_path, *args):
    path = tmp_path / "worker.py"
    path.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *args, "--log_dir", str(tmp_path / "log"), str(path)],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)


def test_launcher_runs_two_gloo_workers_and_returns_their_exit_code(
        tmp_path, capsys):
    r = _launch(tmp_path, "--nproc_per_node", "2", "--poll_interval", "0.2")
    logs = {p.name: p.read_text() for p in (tmp_path / "log").iterdir()}
    assert r.returncode == 0, (r.stdout, r.stderr, logs)
    for rank in (0, 1):
        log = (tmp_path / "log" / f"workerlog.{rank}").read_text()
        assert f"rank {rank} of 2 sum 3.0 local {rank} {rank}" in log, log
    # a failing rank's exit code is the launcher's (in this process: the
    # script imports nothing, and the launcher's start-up is torch's)
    script = tmp_path / "failing.py"
    script.write_text(_FAILING)
    rc = launch(["--nproc_per_node", "2", "--poll_interval", "0.2",
                 "--log_dir", str(tmp_path / "bad"), str(script)])
    assert rc == 7
    assert "failed with [(1, 7)]" in capsys.readouterr().out


def test_launcher_elastic_restart_and_membership(tmp_path):
    """In this process: the script imports nothing."""
    script = tmp_path / "once.py"
    marker = tmp_path / "attempted"
    script.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write('x'); sys.exit(3)\n"
        "print('resumed ok', os.environ['PADDLE_TRAINERS_NUM'],"
        " os.environ['WORLD_SIZE'])\n")
    rc = launch(["--nproc_per_node", "1", "--elastic", "--max_restarts",
                 "2", "--np", "1:1", "--job_id", "t1", "--elastic_store",
                 str(tmp_path), "--elastic_settle", "0.2",
                 "--elastic_timeout", "1", "--poll_interval", "0.2",
                 "--log_dir", str(tmp_path / "log"), str(script)])
    assert rc == 0
    log = (tmp_path / "log" / "workerlog.0").read_text()
    assert "resumed ok 1 1" in log
    # the heartbeat is gone after the run: no ghost node
    assert not any(f.startswith("node_")
                   for f in os.listdir(tmp_path / "elastic_t1"))
