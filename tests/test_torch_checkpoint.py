"""The port's sharded checkpoint (``paddle_tpu_torch/distributed/
checkpoint.py``) and native I/O (``paddle_tpu_torch/io``) against the JAX
package's: every case of ``tests/test_checkpoint_io.py``'s checkpoint
half (replicated, a reshard across topologies, the model round trip,
bfloat16, one chunk a block of a replicated axis, a crashed save keeps
the previous checkpoint, an uncommitted directory is refused, async
saves and their errors, a crash between the commit's renames), each
written by one package and read by the other where a layout is written;
a JAX ``TrainStep`` state saved on a dp 4 mesh, loaded by the port at
fsdp 2 x tp 2 (ZeRO-3) and resumed, against JAX's own resumed run, and
the port's ZeRO-3 state saved block by block and resumed by JAX at dp 4
and by the port at dp 4; ``tests/test_native_loader.py``'s cases; and
``elastic.latest_checkpoint`` over checkpoints the port wrote
(``tests/test_elastic.py:107``).

Multi-rank cases run over a pool of 4 gloo ranks
(``tests/torch_dist_pool.py``, jobs in ``tests/torch_dist_jobs.py``).
Tolerances: tensors read back exactly; resumed losses rtol 1e-5 and
parameters rtol 1e-4 with atol 5e-6 (AdamW ``epsilon=1e-6``, as
``tests/test_torch_dist_train.py``; its normalised step moves near-zero
gradients' entries by float32 rounding)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import models as jmodels
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu.distributed.strategy import HybridConfig as JHybrid
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.io import native

import torch_dist_jobs as jobs
import torch_dist_pool as tdp

N = 4
OPT = dict(learning_rate=1e-3, weight_decay=0.01, epsilon=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tdp.GlooPool(N, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jmesh(**kw):
    need = int(np.prod(list(kw.values())))
    return jdist.build_mesh(devices=jax.devices()[:need], **kw)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def test_replicated_round_trip_both_ways(tmp_path):
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    b = np.ones((6,), np.float32)
    ckpt.save_state_dict({"w": torch.as_tensor(w), "b": torch.as_tensor(b)},
                         str(tmp_path / "t"))
    for loaded in (ckpt.load_state_dict(str(tmp_path / "t")),
                   jckpt.load_state_dict(str(tmp_path / "t"))):
        np.testing.assert_array_equal(_np(loaded["w"]), w)
        np.testing.assert_array_equal(_np(loaded["b"]), b)
    jckpt.save_state_dict({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          str(tmp_path / "j"))
    loaded = ckpt.load_state_dict(str(tmp_path / "j"))
    assert loaded["w"].dtype == torch.float32
    np.testing.assert_array_equal(loaded["w"].numpy(), w)
    # the same bytes on disk: metadata and chunk files
    for d in ("t", "j"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "COMMITTED", "b__0.npy", "metadata.json", "metadata_0.json",
            "w__0_0.npy"]
    for f in ("metadata.json", "w__0_0.npy", "b__0.npy", "COMMITTED"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def test_bf16_and_nested_state_both_ways(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2**15, (8, 8)).astype(
        np.uint16)
    t = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    sd = {"params": {"w": t}, "opt_state": {"step": torch.tensor(3),
                                            "slots": {}}, "step": 7}
    ckpt.save_state_dict(sd, str(tmp_path / "t"))
    meta = json.loads((tmp_path / "t" / "metadata.json").read_text())
    assert meta["params//w"]["dtype"] == "bfloat16"
    assert "opt_state//slots//__empty_dict__" in meta
    mine = ckpt.load_state_dict(str(tmp_path / "t"))
    assert mine["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(mine["params"]["w"].view(torch.int16),
                       t.view(torch.int16))
    assert mine["opt_state"]["slots"] == {} and int(mine["step"]) == 7
    theirs = jckpt.load_state_dict(str(tmp_path / "t"))
    assert theirs["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(theirs["params"]["w"]).view(np.uint16), bits)
    jckpt.save_state_dict({"w": jnp.full((8, 8), 1.5, jnp.bfloat16)},
                          str(tmp_path / "j"))
    back = ckpt.load_state_dict(str(tmp_path / "j"))["w"]
    assert back.dtype == torch.bfloat16 and float(back.float().min()) == \
        float(back.float().max()) == 1.5


def test_model_round_trip(tmp_path):
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return tnn.Sequential(tnn.Linear(8, 16, device="cpu", generator=g),
                              tnn.ReLU(),
                              tnn.Linear(16, 4, device="cpu", generator=g))

    m1, m2 = make(0), make(999)
    ckpt.save_model(m1, str(tmp_path / "m"))
    ckpt.load_model(m2, str(tmp_path / "m"))
    x = torch.ones((2, 8))
    torch.testing.assert_close(m1(x), m2(x), rtol=0, atol=0)


def test_crashed_save_keeps_the_previous(tmp_path, monkeypatch):
    path = str(tmp_path / "atom")
    ckpt.save_state_dict({"w": torch.ones((4, 4))}, path)

    def boom(snap, tmp):
        with open(os.path.join(tmp, "partial.npy"), "wb") as f:
            f.write(b"torn")
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(ckpt, "_write_snapshot", boom)
    with pytest.raises(RuntimeError):
        ckpt.save_state_dict({"w": torch.zeros((4, 4))}, path)
    assert ckpt.is_committed(path) and jckpt.is_committed(path)
    np.testing.assert_array_equal(ckpt.load_state_dict(path)["w"].numpy(),
                                  1.0)
    assert not ckpt.is_committed(path + ".tmp")


def test_uncommitted_directory_is_refused(tmp_path):
    d = tmp_path / "torn"
    d.mkdir()
    (d / "w__0.npy").write_bytes(b"junk")
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict(str(d))


def test_crash_between_the_commit_renames_recovers(tmp_path):
    path = str(tmp_path / "swap")
    ckpt.save_state_dict({"w": torch.ones((2, 2))}, path)
    os.rename(path, path + ".old")
    assert ckpt.is_committed(path)  # puts .old back
    np.testing.assert_array_equal(ckpt.load_state_dict(path)["w"].numpy(),
                                  1.0)
    assert not os.path.isdir(path + ".old")
    # the other window: the new one committed in .tmp, path moved aside
    ckpt.save_state_dict({"w": torch.full((2, 2), 2.0)}, path + "2")
    os.rename(path, path + ".old")
    os.rename(path + "2", path + ".tmp")
    assert ckpt.is_committed(path)  # promotes the committed .tmp
    np.testing.assert_array_equal(ckpt.load_state_dict(path)["w"].numpy(),
                                  2.0)
    assert not os.path.isdir(path + ".old")


def test_async_checkpointer_and_its_errors(tmp_path, monkeypatch):
    saver = ckpt.AsyncCheckpointer()
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    path = str(tmp_path / "a1")
    saver.save({"w": w}, path)
    saver.wait_until_finished()
    assert ckpt.is_committed(path)
    np.testing.assert_array_equal(np.asarray(jckpt.load_state_dict(path)["w"]),
                                  w.numpy())
    assert saver.last["bytes"] == 64 and saver.last["commit_s"] >= 0
    # back-to-back saves commit in order
    saver.save({"w": torch.zeros((2,))}, str(tmp_path / "a2"))
    saver.save({"w": torch.ones((2,))}, str(tmp_path / "a3"))
    saver.wait_until_finished()
    assert ckpt.is_committed(str(tmp_path / "a2"))
    assert ckpt.is_committed(str(tmp_path / "a3"))

    def boom(snap, tmp):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_snapshot", boom)
    saver.save({"w": torch.ones((2,))}, str(tmp_path / "err"))
    with pytest.raises(OSError):
        saver.wait_until_finished()
    assert not ckpt.is_committed(str(tmp_path / "err"))


def test_latest_checkpoint_over_port_checkpoints(tmp_path, monkeypatch):
    root = tmp_path / "ckpts"
    for step in (10, 20):
        ckpt.save_state_dict({"w": torch.ones((2,)) * step},
                             str(root / f"step_{step}"))

    def boom(snap, tmp):
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(ckpt, "_write_snapshot", boom)
    with pytest.raises(RuntimeError):
        ckpt.save_state_dict({"w": torch.ones((2,))}, str(root / "step_30"))
    assert elastic.latest_checkpoint(str(root)) == str(root / "step_20")
    assert elastic.latest_checkpoint(str(tmp_path / "missing")) is None
    assert elastic.COMMITTED_MARKER == jckpt.COMMITTED_MARKER


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "tokens.bin"
    arr = np.zeros((32, 16), np.uint16)
    for i in range(32):
        arr[i] = i * 100 + np.arange(16)
    arr.tofile(path)
    return str(path)


def test_token_loader_matches_jax(token_file):
    from paddle_tpu.io.native import TokenBinDataset as JDataset

    ds, jds = native.TokenBinDataset(token_file, 16), JDataset(token_file, 16)
    assert len(ds) == 32
    batches = list(ds.batches(batch_size=8, shuffle=False, seed=0))
    assert len(batches) == 4 and batches[0].dtype == np.int32
    np.testing.assert_array_equal(batches[0][0], np.arange(16))
    np.testing.assert_array_equal(batches[3][7], 3100 + np.arange(16))
    for kw in (dict(batch_size=8, seed=7, shuffle=True),
               dict(batch_size=8, seed=8, shuffle=True),
               dict(batch_size=5, shuffle=False, drop_last=False)):
        got = list(ds.batches(**kw))
        want = list(jds.batches(**kw))
        assert [b.shape for b in got] == [b.shape for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert [len(b) for b in ds.batches(5, shuffle=False, drop_last=False)] \
        == [5, 5, 5, 5, 5, 5, 2]
    a = np.concatenate([b[:, 0] for b in ds.batches(8, seed=7)])
    assert sorted(a.tolist()) == sorted((np.arange(32) * 100).tolist())
    ds.close()
    jds.close()


def test_native_writer_batch_and_its_failures(tmp_path):
    rng = np.random.default_rng(0)
    files = [(str(tmp_path / f"chunk_{i}.npy"),
              rng.standard_normal((32, 17)).astype(np.float32))
             for i in range(10)]
    files.append((str(tmp_path / "bits.npy"),
                  rng.integers(0, 2**16, (8, 8)).astype(np.uint16)))
    native.write_npy_batch(files)
    for path, ref in files:
        np.testing.assert_array_equal(np.load(path), ref)
        # the bytes np.save writes
        np.save(str(tmp_path / "ref.npy"), ref)
        assert open(path, "rb").read() == \
            open(str(tmp_path / "ref.npy"), "rb").read()
    # no fallback: a write that fails raises
    with pytest.raises(OSError, match="failed to write"):
        native.write_npy_batch([(str(tmp_path / "no" / "dir.npy"),
                                 np.zeros(3))])
    lib = native.build("ckptio.cpp")
    assert lib.parent.name == "_build" and lib.exists()


# ---------------------------------------------------------------------------
# over the gloo pool
# ---------------------------------------------------------------------------
def test_reshard_across_topologies_both_ways(pool, tmp_path):
    """Blocks written at (fsdp 4) and at (fsdp 2, tp 2) with a replicated
    axis (one chunk a block), read back at another layout by the port and
    by JAX; and JAX's sharded save read by the port's blocks."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    r = np.arange(64, dtype=np.float32).reshape(8, 8)
    path = str(tmp_path / "c")
    got = pool.run(jobs.ckpt_reshard_job, path, {"w": w, "r": r},
                   dict(fsdp=2, tp=2), {"w": ("fsdp", "tp"),
                                        "r": ("fsdp", None)},
                   dict(fsdp=2, tp=2), {"w": ("tp", "fsdp"), "r": (None,
                                                                 "tp")})
    for res in got:
        for n, a in (("w", w), ("r", r)):
            blk, sl, _ = res[n]
            np.testing.assert_array_equal(blk, a[tuple(slice(*s)
                                                       for s in sl)])
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    assert sorted(tuple(c["offset"]) for c in meta["r"]["chunks"]) == \
        [(0, 0), (4, 0)]
    assert len(meta["w"]["chunks"]) == 4
    mesh = _jmesh(fsdp=2, tp=2)
    loaded = jckpt.load_state_dict(path, shardings={
        "w": NamedSharding(mesh, P("tp", "fsdp")),
        "r": NamedSharding(mesh, P())})
    np.testing.assert_array_equal(np.asarray(loaded["w"]), w)
    np.testing.assert_array_equal(np.asarray(loaded["r"]), r)
    # JAX writes (fsdp 4), the port reads (fsdp 2, tp 2) blocks
    jpath = str(tmp_path / "j")
    jmesh = _jmesh(fsdp=4)
    jckpt.save_state_dict({"w": jax.device_put(
        jnp.asarray(w), NamedSharding(jmesh, P("fsdp", None)))}, jpath)
    got = pool.run(jobs.ckpt_reshard_job, str(tmp_path / "unused"),
                   {"w": w}, dict(fsdp=4), {"w": ("fsdp", None)},
                   dict(fsdp=2, tp=2), {"w": ("tp", "fsdp")})
    loaded = [ckpt.load_state_dict(jpath)["w"].numpy()]
    np.testing.assert_array_equal(loaded[0], w)
    for res in got:
        blk, sl, _ = res["w"]
        np.testing.assert_array_equal(blk, w[tuple(slice(*s) for s in sl)])


def test_bf16_blocks_both_ways(pool, tmp_path):
    w = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    path = str(tmp_path / "bf")
    got = pool.run(jobs.ckpt_reshard_job, path, {"w": w}, dict(dp=2, tp=2),
                   {"w": ("tp", None)}, dict(fsdp=4), {"w": (None, "fsdp")},
                   True)
    want = torch.as_tensor(w).to(torch.bfloat16).float().numpy()
    for res in got:
        blk, sl, dtype = res["w"]
        assert dtype == "torch.bfloat16"
        np.testing.assert_array_equal(blk, want[tuple(slice(*s)
                                                      for s in sl)])
    loaded = jckpt.load_state_dict(path)["w"]
    assert loaded.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(loaded.astype(jnp.float32)),
                                  want)


def _jax_llama(mesh_kw, steps):
    pt.seed(5)
    jmodel = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny())
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    s = JStrategy()
    s.hybrid_configs = JHybrid(dp_degree=mesh_kw.get("dp", 1))
    ts = JTrainStep(jmodel, jopt.AdamW(
        grad_clip=jopt.ClipGradByGlobalNorm(1.0), **OPT),
        _jmesh(**mesh_kw), s)
    losses = [float(ts.run(_batch())) for _ in range(steps)]
    return state, ts, losses


def _batch():
    ids = np.random.default_rng(0).integers(0, 256, (8, 16))
    labels = ids.copy()
    labels[0, 3:14] = -100
    labels[6, 2:4] = -100
    return {"input_ids": ids, "labels": labels}


def _params(ts):
    return {n: np.asarray(jnp.asarray(v, jnp.float32))
            for n, v in ts.state_dict()["params"].items()}


def _check(res, losses, params):
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    for n, w in params.items():
        np.testing.assert_allclose(res["params"][n], w, rtol=1e-4,
                                   atol=5e-6, err_msg=n)


def test_train_state_moves_between_the_packages_and_meshes(pool, tmp_path):
    """JAX at dp 4 saves after 2 steps; the port resumes it at fsdp 2 x tp
    2 (ZeRO-3, its blocks read from the chunks) and its 2 steps match
    JAX's next 2. The port saves that state block by block (async); JAX
    resumes it at dp 4 and the port at dp 4, and both match JAX's
    uninterrupted steps 5-6."""
    state, ts, _ = _jax_llama(dict(dp=4), 2)
    jpath = str(tmp_path / "jax_step2")
    jckpt.save_state_dict(ts.state_dict(), jpath)
    want = [float(ts.run(_batch())) for _ in range(2)]
    params4 = _params(ts)
    tpath = str(tmp_path / "port_step4")
    got = pool.run(jobs.ckpt_train_job, dict(fsdp=2, tp=2, stage=3), state,
                   _batch(), 2, OPT, jpath, tpath, True, True)
    for res in got:
        _check(res, want, params4)
        assert res["step"] == 4
    want = [float(ts.run(_batch())) for _ in range(2)]
    params6 = _params(ts)
    # JAX resumes the port's blocks
    _, js, _ = _jax_llama(dict(dp=4), 0)
    js.set_state_dict(jckpt.load_state_dict(tpath))
    assert js.step_count == 4
    np.testing.assert_allclose([float(js.run(_batch())) for _ in range(2)],
                               want, rtol=1e-5)
    # the port resumes its own blocks on another mesh (gathered save too)
    got = pool.run(jobs.ckpt_train_job, dict(dp=4), state, _batch(), 2, OPT,
                   tpath, str(tmp_path / "gathered"), False)
    for res in got:
        _check(res, want, params6)
    assert ckpt.is_committed(str(tmp_path / "gathered"))
