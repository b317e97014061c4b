"""The port's ``io`` and ``framework.io`` against the JAX package's on the
CPU: every sampler, the datasets, ``random_split``, the collate function
and ``DataLoader`` (no workers, thread workers, fork process workers)
give JAX's batches index for index over two epochs;
``DistributedBatchSampler`` at world size 1 and over four gloo ranks
(reading the group's size and rank where JAX reads its process count);
``prefetch_to_device`` on the CPU; and ``.pdparams`` files cross between
the packages in both directions (float32, int64, bfloat16 through
``ml_dtypes``, nested dicts and lists), with bf16 round-tripping bit
for bit through the port alone where ``ml_dtypes`` is missing.

Batches are compared exactly (numpy's generators on both sides, the
same gathers); values that cross the file format, exactly."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

import torch_dist_pool as tdp
from paddle_tpu import io as jio
from paddle_tpu.framework import io as jfio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import io as tfio


def _data(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.integers(0, 9, n).astype(np.int64))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w)
            _same_batches([g[k] for k in sorted(g)], [w[k] for k in sorted(w)])
        elif isinstance(w, (tuple, list)):
            assert type(g) is type(w) and len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _epochs(loader, n=2):
    out = []
    for e in range(n):
        if hasattr(loader, "batch_sampler") and hasattr(
                loader.batch_sampler, "set_epoch"):
            loader.batch_sampler.set_epoch(e)
        out += list(loader)
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=4, shuffle=True, num_workers=2),
    dict(batch_size=3, shuffle=True, num_workers=2, prefetch_factor=1),
    dict(batch_size=4, shuffle=True, num_workers=2,
         use_process_workers=True),
], ids=["plain", "shuffle", "drop_last", "threads", "threads_pf1",
        "fork_workers"])
def test_data_loader_batches_match_jax_over_two_epochs(kw):
    x, y = _data()
    got = _epochs(tio.DataLoader(tio.TensorDataset([x, y]), **kw))
    want = _epochs(jio.DataLoader(jio.TensorDataset([x, y]), **kw))
    _same_batches(got, want)
    assert all(isinstance(b[0], np.ndarray) for b in got)


def test_samplers_and_datasets_match_jax():
    x, y = _data(17)
    # RandomSampler: one persistent stream, reshuffled each epoch
    ts, js = (tio.RandomSampler(list(range(11)), generator=3),
              jio.RandomSampler(list(range(11)), generator=3))
    assert [list(ts) for _ in range(2)] == [list(js) for _ in range(2)]
    ts, js = (tio.RandomSampler(list(range(11)), replacement=True,
                                num_samples=6, generator=5),
              jio.RandomSampler(list(range(11)), replacement=True,
                                num_samples=6, generator=5))
    assert list(ts) == list(js) and len(ts) == len(js) == 6
    with pytest.raises(ValueError):
        list(tio.RandomSampler(list(range(3)), num_samples=5))
    assert list(tio.SequenceSampler(list(range(4)))) == [0, 1, 2, 3]
    assert sorted(tio.SubsetRandomSampler([5, 7, 9])) == [5, 7, 9]
    w = tio.WeightedRandomSampler([0.0, 1.0, 0.0, 2.0], 20)
    assert set(w) <= {1, 3} and len(w) == 20
    # batch samplers over a sampler and over a dataset, two epochs
    for kw in (dict(shuffle=True, batch_size=4),
               dict(shuffle=False, batch_size=5, drop_last=True)):
        tb = tio.BatchSampler(list(range(17)), seed=4, **kw)
        jb = jio.BatchSampler(list(range(17)), seed=4, **kw)
        for e in range(2):
            tb.set_epoch(e)
            jb.set_epoch(e)
            assert list(tb) == list(jb) and len(tb) == len(jb)
    tb = tio.BatchSampler(sampler=tio.SequenceSampler(list(range(7))),
                          batch_size=3)
    assert list(tb) == [[0, 1, 2], [3, 4, 5], [6]]
    # the datasets
    ds_t, ds_j = tio.TensorDataset([x, y]), jio.TensorDataset([x, y])
    for a, b in zip(tio.random_split(ds_t, [10, 7], generator_seed=2),
                    jio.random_split(ds_j, [10, 7], generator_seed=2)):
        assert a.indices == b.indices and len(a) == len(b)
        _same_batches([a[i] for i in range(len(a))],
                      [b[i] for i in range(len(b))])
    cat_t = tio.ConcatDataset([tio.Subset(ds_t, [1, 2]), ds_t])
    cat_j = jio.ConcatDataset([jio.Subset(ds_j, [1, 2]), ds_j])
    assert len(cat_t) == len(cat_j) == 19
    _same_batches([cat_t[i] for i in (0, 1, 2, 18, -1)],
                  [cat_j[i] for i in (0, 1, 2, 18, -1)])
    comp_t = tio.ComposeDataset([ds_t, tio.TensorDataset([y])])
    comp_j = jio.ComposeDataset([ds_j, jio.TensorDataset([y])])
    _same_batches([comp_t[3]], [comp_j[3]])
    assert len(comp_t[3]) == 3

    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(range(5))

    chain = tio.ChainDataset([Stream(), Stream()])
    assert list(chain) == [0, 1, 2, 3, 4] * 2
    loader = tio.DataLoader(Stream(), batch_size=2)
    assert [b.tolist() for b in loader] == [[0, 1], [2, 3], [4]]
    assert [b.tolist() for b in loader()] == [[0, 1], [2, 3], [4]]
    with pytest.raises(TypeError):
        len(loader)
    assert tio.get_worker_info() is None
    # TensorDataset takes tensors too (copied to the host)
    assert isinstance(tio.TensorDataset(torch.ones(3, 2))[0][0], np.ndarray)


def test_default_collate_matches_jax():
    rng = np.random.default_rng(1)
    samples = [{"a": rng.standard_normal(3).astype(np.float32),
                "b": (np.int64(i), rng.standard_normal(2))}
               for i in range(4)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    np.testing.assert_array_equal(got["a"], want["a"])
    for g, w in zip(got["b"], want["b"]):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_distributed_batch_sampler_at_world_size_one_matches_jax():
    for kw in (dict(shuffle=True), dict(shuffle=False, drop_last=True)):
        t = tio.DistributedBatchSampler(list(range(13)), 3, **kw)
        j = jio.DistributedBatchSampler(list(range(13)), 3, **kw)
        assert (t.nranks, t.local_rank) == (1, 0)
        for e in range(2):
            t.set_epoch(e)
            j.set_epoch(e)
            assert list(t) == list(j) and len(t) == len(j)
    for r in range(3):
        t = tio.DistributedBatchSampler(list(range(13)), 2, num_replicas=3,
                                        rank=r, shuffle=True)
        j = jio.DistributedBatchSampler(list(range(13)), 2, num_replicas=3,
                                        rank=r, shuffle=True)
        assert list(t) == list(j)


def test_distributed_batch_sampler_reads_the_gloo_group(tmp_path):
    pool = tdp.GlooPool(4, tmp_path)
    try:
        got = pool.run(tdp.batch_sampler_job, 18, 2, True, 2)
    finally:
        pool.close()
    for r, (n, rank, epochs) in enumerate(got):
        assert (n, rank) == (4, r)
        j = jio.DistributedBatchSampler(list(range(18)), 2, num_replicas=4,
                                        rank=r, shuffle=True)
        want = []
        for e in range(2):
            j.set_epoch(e)
            want.append([list(b) for b in j])
        assert epochs == want


def test_prefetch_to_device_on_the_cpu():
    x, y = _data(12)
    loader = tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                            shuffle=True)
    plain = list(loader)
    got = list(tio.prefetch_to_device(iter(loader), size=1, device="cpu"))
    assert len(got) == len(plain) == 3
    for g, w in zip(got, plain):
        assert all(isinstance(t, torch.Tensor) for t in g)
        for a, b in zip(g, w):
            assert torch.equal(a, torch.from_numpy(b))
    # a producer's error reaches the consumer
    def bad():
        yield (x,)
        raise KeyError("loader failed")

    with pytest.raises(KeyError):
        list(tio.prefetch_to_device(bad(), device="cpu"))


# ---------------------------------------------------------------- files
def _tree(rng):
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "step": np.int64(7),
        "ids": rng.integers(0, 100, (5,)).astype(np.int64),
        "nested": {"list": [rng.standard_normal(2).astype(np.float32),
                            {"k": np.arange(3, dtype=np.int32)}],
                   "tuple": (np.float32(1.5), "name", 3)},
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def test_pdparams_written_by_the_port_load_in_jax(tmp_path):
    import jax.numpy as jnp
    import ml_dtypes

    rng = np.random.default_rng(0)
    tree = _tree(rng)
    t = _torch_tree(tree)
    bf = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)
                          ).bfloat16()
    t["bf16"] = bf
    path = str(tmp_path / "port.pdparams")
    tfio.save(t, path)
    got = jfio.load(path)
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(got["ids"]), tree["ids"])
    assert got["nested"]["tuple"][1:] == ("name", 3)
    np.testing.assert_array_equal(np.asarray(got["nested"]["list"][1]["k"]),
                                  np.arange(3))
    assert got["bf16"].dtype == jnp.bfloat16
    bits = np.asarray(got["bf16"]).view(np.uint16)
    assert (bits == bf.view(torch.int16).numpy().view(np.uint16)).all()
    raw = jfio.load(path, return_numpy=True)
    assert raw["bf16"].dtype == ml_dtypes.bfloat16
    assert raw["ids"].dtype == np.int64


def test_pdparams_written_by_jax_load_in_the_port(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    tree = _tree(rng)
    j = {k: v for k, v in tree.items()}
    j["w"] = jnp.asarray(tree["w"])
    j["ids"] = jnp.asarray(tree["ids"])  # int32: x64 is off in JAX
    j["bf16"] = jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16)
    path = str(tmp_path / "jax.pdparams")
    jfio.save(j, path)
    got = tfio.load(path, device="cpu")
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], torch.from_numpy(tree["w"]))
    assert got["ids"].dtype == torch.int32  # a load keeps the file's dtype
    assert got["ids"].tolist() == tree["ids"].tolist()
    assert got["bf16"].dtype == torch.bfloat16
    want = np.asarray(j["bf16"]).view(np.uint16)
    assert (got["bf16"].view(torch.int16).numpy().view(np.uint16)
            == want).all()
    assert isinstance(got["nested"]["list"][0], torch.Tensor)
    assert got["nested"]["tuple"][1:] == ("name", 3)
    assert got["step"] == 7
    raw = tfio.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)


def test_bf16_round_trips_without_ml_dtypes(tmp_path, monkeypatch):
    monkeypatch.setattr(tfio, "_ml_bfloat16", lambda: None)
    t = {"p": torch.randn(4, 5).bfloat16(), "f": torch.randn(3)}
    path = str(tmp_path / "bits.pdparams")
    tfio.save(t, path)
    got = tfio.load(path, device="cpu")
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), t["p"].view(torch.int16))
    assert torch.equal(got["f"], t["f"])
    with pytest.raises(TypeError):
        tfio.load(path, return_numpy=True)
