"""Data pipeline (counterpart of ``paddle_tpu/io/__init__.py``; parity:
``python/paddle/io/``: datasets, samplers, ``DataLoader`` with thread or
process workers, ``BatchSampler``, ``DistributedBatchSampler``), with
``prefetch_to_device``, and the port's native I/O (``native.py``: the
token-bin data loader and the parallel checkpoint chunk writer, C++
built with ``g++`` at first use).

Every order comes from numpy's generators, as in the JAX package, so the
loader yields JAX's batches index for index; it yields host numpy
batches, as JAX's does, and ``prefetch_to_device`` is the device hop.
``DistributedBatchSampler`` reads the world size and rank of the
``torch.distributed`` group where one is initialised (else 1 and 0);
JAX reads its process count and index.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .native import TokenBinDataset, load_ckpt_writer  # noqa: F401


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Paddle's ``TensorDataset(tensors)`` (one list of arrays) or the
    starred torch spelling; the arrays are kept as numpy (tensors are
    copied to the host)."""

    def __init__(self, *tensors):
        if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
            tensors = tuple(tensors[0])
        self.tensors = [t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in tensors]
        assert all(len(t) == len(self.tensors[0]) for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator_seed: int = 0):
    total = len(dataset)
    assert sum(lengths) == total
    perm = np.random.default_rng(generator_seed).permutation(total)
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start:start + n].tolist()))
        start += n
    return out


class ComposeDataset(Dataset):
    """Parity: paddle.io.ComposeDataset: zip same-length datasets into
    one whose samples are the concatenated fields."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert self.datasets, "ComposeDataset needs at least one dataset"
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (tuple, list)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ConcatDataset(Dataset):
    """Parity: paddle.io.ConcatDataset: datasets end to end."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        lo = int(np.searchsorted(self.cum, idx, side="right"))
        prev = self.cum[lo - 1] if lo else 0
        return self.datasets[lo][idx - prev]

    def __len__(self):
        return self.cum[-1] if self.cum else 0


class ChainDataset(IterableDataset):
    """Parity: paddle.io.ChainDataset: chain iterable datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Sampler:
    """Parity: paddle.io.Sampler base."""

    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation per epoch from one persistent numpy generator: an
    int ``generator`` fixes the stream, and successive epochs reshuffle."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator  # int seed or None
        self._rng = np.random.default_rng(
            generator if isinstance(generator, int) else None)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._rng
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        if self.num_samples > n:
            raise ValueError(
                f"RandomSampler: num_samples={self.num_samples} exceeds "
                f"dataset size {n} without replacement")
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Parity: paddle.io.SubsetRandomSampler: a random permutation of
    the given index subset each epoch."""

    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)
        self._rng = np.random.default_rng()

    def __iter__(self):
        return iter(self.indices[i] for i in
                    self._rng.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        assert self.weights.ndim == 1 and (self.weights >= 0).all()
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng()
        return iter(
            rng.choice(
                len(self.weights), self.num_samples,
                replace=self.replacement, p=p,
            ).tolist()
        )

    def __len__(self):
        return self.num_samples


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    """Parity: paddle.io.get_worker_info: None in the main process; in a
    process worker, identifies the worker so IterableDatasets can shard
    their stream."""
    return _worker_state.get("worker_info")


class BatchSampler:
    def __init__(self, dataset=None, sampler=None, shuffle: bool = False,
                 batch_size: int = 1, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        else:
            indices = list(range(len(self.dataset)))
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                rng.shuffle(indices)
        batch = []
        for i in indices:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.dataset) if self.sampler is None else len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch


def _world():
    """(world size, rank) of the initialised ``torch.distributed`` group,
    else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Parity: paddle.io.DistributedBatchSampler: pads and splits the
    index space across data-parallel ranks deterministically per epoch."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, seed: int = 0):
        super().__init__(dataset, None, shuffle, batch_size, drop_last, seed)
        world, me = _world()
        if num_replicas is None:
            num_replicas = world
        if rank is None:
            rank = me
        self.nranks = num_replicas
        self.local_rank = rank
        self.num_samples = math.ceil(len(dataset) / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(indices)
        # pad to evenly divisible
        indices += indices[: self.total_size - len(indices)]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for i in local:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)


def default_collate_fn(batch):
    """Stack samples into numpy batches (dicts and tuples handled)."""
    elem = batch[0]
    if isinstance(elem, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in elem}
    if isinstance(elem, (tuple, list)):
        return type(elem)(
            default_collate_fn([b[i] for b in batch]) for i in range(len(elem))
        )
    return np.stack([np.asarray(b) for b in batch])


# --- process-worker plumbing (module level: fork children resolve these
# by reference) ---
_worker_state = {}


def _proc_worker_init(dataset, collate_fn, id_counter=None, num_workers=1):
    # Workers load numpy samples and nothing else: a fork child of a
    # process that holds a CUDA context cannot use the card (PyTorch
    # refuses to initialise CUDA in it), so nothing here touches torch's
    # device state.
    _worker_state["dataset"] = dataset
    _worker_state["collate"] = collate_fn
    if id_counter is not None:
        # fork-inherited shared counter: an atomic handout of worker ids
        with id_counter.get_lock():
            wid = id_counter.value
            id_counter.value += 1
        _worker_state["worker_info"] = WorkerInfo(
            id=wid, num_workers=num_workers, dataset=dataset
        )


def _proc_load_batch(idxs):
    ds = _worker_state["dataset"]
    return _worker_state["collate"]([ds[i] for i in idxs])


class DataLoader:
    """Parity: paddle.io.DataLoader. ``num_workers > 0`` loads samples on
    a thread pool by default; ``use_process_workers=True`` forks OS
    processes instead (the fork context, so scripts run from stdin work).
    Process workers inherit the dataset and must load numpy only: the
    parent may already hold a CUDA context, which a fork child cannot use,
    so a dataset that touches the card fails there. The loader yields
    host numpy batches; ``prefetch_to_device`` moves them."""

    def __init__(
        self,
        dataset,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        prefetch_factor: int = 2,
        use_process_workers: bool = False,
        **kw,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_process_workers = use_process_workers
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last,
            )

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _load_batch(self, idxs):
        return self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self) -> Iterator:
        if isinstance(self.dataset, IterableDataset):
            yield from self._iter_iterable()
            return
        if self.num_workers <= 0:
            for idxs in self.batch_sampler:
                yield self._load_batch(idxs)
            return
        # prefetch pipeline over a worker pool (threads or processes)
        if self.use_process_workers:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            ctx = mp.get_context("fork")
            id_counter = ctx.Value("i", 0)
            pool_cm = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_proc_worker_init,
                initargs=(self.dataset, self.collate_fn, id_counter,
                          self.num_workers),
            )
            submit = _proc_load_batch
        else:
            from concurrent.futures import ThreadPoolExecutor

            pool_cm = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = self._load_batch

        with pool_cm as pool:
            pending: "queue.Queue" = queue.Queue()
            it = iter(self.batch_sampler)
            depth = self.num_workers * self.prefetch_factor
            for idxs in itertools.islice(it, depth):
                pending.put(pool.submit(submit, idxs))
            for idxs in it:
                yield pending.get().result()
                pending.put(pool.submit(submit, idxs))
            while not pending.empty():
                yield pending.get().result()

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    def __call__(self):
        # the fluid-era spelling `for batch in loader():`
        return iter(self)


def _as_host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def prefetch_to_device(iterator: Iterable, size: Optional[int] = None,
                       sharding=None, device=None) -> Iterator:
    """Host-to-device prefetch (parity: the pinned-memory and stream H2D
    overlap in the reference's DataLoader), ``size`` batches ahead
    (``PT_FLAGS_io_prefetch_depth``, 2, by default), to ``device`` (the
    card by default; raises without one).

    A thread copies each batch from pinned host memory with
    ``non_blocking=True`` on a side CUDA stream and records an event after
    the copies; before a batch is handed out, the consumer's current
    stream waits on that event, and each tensor is marked used on that
    stream (``record_stream``), so no kernel reads a batch before its copy
    has finished and the allocator does not reuse its memory early. On
    the CPU the batches become tensors with no stream. ``sharding`` (a JAX
    sharding) has no counterpart: over a mesh, ``TrainStep.shard_batch``
    cuts the batch."""
    from ..core.device import current_device

    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...): the port places batches "
            "per rank (TrainStep.shard_batch)")
    if size is None:
        from .. import flags

        size = int(flags.flag("io_prefetch_depth"))
    dev = current_device(device)
    buf: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    if dev.type == "cuda":
        side = torch.cuda.Stream(device=dev)

        def put(item):
            def copy(a):
                if not isinstance(a, (np.ndarray, np.generic, torch.Tensor)):
                    return a
                host = _as_host_tensor(a)
                if host.device.type == "cpu":
                    host = host.pin_memory()
                return host.to(dev, non_blocking=True)

            # (the batch, the event that ends its copies on the side stream)
            with torch.cuda.device(dev), torch.cuda.stream(side):
                out = pytree.tree_map(copy, item)
                event = torch.cuda.Event()
                event.record(side)
            return out, event
    else:
        def put(item):
            return pytree.tree_map(
                lambda a: _as_host_tensor(a).to(dev)
                if isinstance(a, (np.ndarray, np.generic, torch.Tensor))
                else a, item), None

    def producer():
        try:
            for item in iterator:
                buf.put(put(item))
        except Exception as e:  # handed to the consumer, raised there
            buf.put(e)
            return
        buf.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = buf.get()
        if item is sentinel:
            return
        if isinstance(item, Exception):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for a in pytree.tree_leaves(batch):
                if isinstance(a, torch.Tensor):
                    a.record_stream(stream)
        yield batch
