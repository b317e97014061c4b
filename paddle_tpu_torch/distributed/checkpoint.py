"""Distributed sharded checkpoint: atomic, async, saved from one mesh and
loaded onto another (counterpart of ``paddle_tpu/distributed/
checkpoint.py``; parity: python/paddle/distributed/checkpoint/
save_state_dict.py / load_state_dict.py).

The on-disk layout is the JAX package's, byte for byte, so a checkpoint
written by either package loads in the other:

  metadata.json        {name: {shape, dtype, chunks: [{offset, shape,
                        file}]}}; nested state dicts flattened with
                        ``//`` (``_flatten_nested``), empty subtrees kept
                        as an ``__empty_dict__`` leaf
  chunk files (.npy)   one a unique block, named by ``_chunk_filename``;
                        bfloat16 stored as its raw uint16 bits with dtype
                        ``"bfloat16"`` in the metadata
  COMMITTED            the marker, written last

Every rank writes into ``<path>.tmp``; after a barrier rank 0 merges the
ranks' metadata parts, writes the marker and swaps the directory into
place (``path`` -> ``path.old``, tmp -> ``path``, drop ``.old``). A crash
at any point leaves the previous checkpoint at ``path`` or, between the
two renames, at ``path.old``, which ``_recover`` (run by every save and
load, on rank 0) puts back; a torn ``.tmp`` is never read.

SPMD, one process a rank: a value is either a whole tensor (a torch
tensor, numpy array or scalar, the same on every rank: rank 0 writes it)
or ``Sharded(local, shape, spec, mesh)``, this rank's block of a global
tensor of ``shape`` under the spec ``spec`` (``sharding.block_slices``).
A block is written at its global offset by the one rank whose coordinate
is 0 on every mesh axis that does not cut it (JAX's ``replica_id ==
0``); no rank gathers a tensor to save it. ``load_state_dict`` with
``shardings`` (``{name: sharding.Sharding(mesh, spec)}``) or a
``target`` of ``Sharded`` values returns this rank's block of each named
tensor, read from the overlapping chunks through ``np.load(...,
mmap_mode="r")``; the whole tensor is never built on one rank. Other
entries load whole, on the CPU.

Chunk files go through the native thread-pool writer (``io/native.py``,
``csrc/ckptio.cpp``, each file fsynced before the marker can land). The
port has no fallback: where the writer cannot be built or a write fails,
the save raises (the JAX package falls back to an ``np.save`` loop).

Barriers are ``torch.distributed.barrier`` on the world group (none at
world size 1): every rank of the job calls ``save_state_dict``,
``AsyncCheckpointer.save`` and ``load_state_dict``, in or out of the
mesh. ``AsyncCheckpointer`` copies the blocks to the host,
then writes and commits on a thread that calls no collective: rank 0
commits once every rank's metadata part is on disk.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import sharding as shd

COMMITTED_MARKER = "COMMITTED"
_NEST_SEP = "//"
_EMPTY_DICT_LEAF = "__empty_dict__"


class Sharded(NamedTuple):
    """This rank's block ``local`` of a global tensor of ``shape`` cut by
    ``spec`` (tuple of mesh-axis entries) over ``mesh``."""

    local: torch.Tensor
    shape: Tuple[int, ...]
    spec: Tuple
    mesh: object


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    if _world() > 1:
        dist.barrier()


def _chunk_filename(name: str, offset) -> str:
    off = "_".join(str(o) for o in offset) if offset else "scalar"
    safe = name.replace("/", "__").replace(".", "_")
    return f"{safe}__{off}.npy"


def _flatten_nested(d, prefix="", keep_empty=True):
    """``{"a//b//c": leaf}`` from nested dicts (the JAX flattening: a leaf
    is anything but a dict; an empty subtree becomes a marker leaf when
    ``keep_empty``)."""
    flat = {}
    for k, v in d.items():
        key = f"{prefix}{_NEST_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            if v:
                flat.update(_flatten_nested(v, key, keep_empty))
            elif keep_empty:
                flat[f"{key}{_NEST_SEP}{_EMPTY_DICT_LEAF}"] = np.zeros(
                    (), np.int8)
        else:
            flat[key] = v
    return flat


def _unflatten_nested(flat):
    out = {}
    for key, v in flat.items():
        parts = key.split(_NEST_SEP)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        if parts[-1] != _EMPTY_DICT_LEAF:
            cur[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# saving
# ---------------------------------------------------------------------------
def _host_array(t) -> Tuple[np.ndarray, str]:
    """``(numpy array, metadata dtype)``: bfloat16 as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def _writes(value: Sharded) -> bool:
    """This rank writes its block: coordinate 0 on every mesh axis that
    does not cut the tensor (and a member of the mesh)."""
    mesh = value.mesh
    if mesh.get_coordinate() is None:
        return False
    used = shd._axes_used(value.spec)
    return all(shd._coord(mesh, a) == 0 for a in mesh.mesh_dim_names
               if a not in used)


def _snapshot_to_host(flat) -> Dict:
    """``{name: (shape, dtype, [(offset, numpy block)])}``: host copies of
    the blocks this rank writes (the blocking part of a save)."""
    snap = {}
    rank0 = _rank() == 0
    for name, v in flat.items():
        if isinstance(v, Sharded):
            shape = tuple(int(n) for n in v.shape)
            a, dtype = _host_array(v.local)
            chunks = []
            if _writes(v) and (a.size or not int(np.prod(shape))):
                sl = shd.block_slices(shape, v.spec, v.mesh)
                chunks.append((tuple(s.start for s in sl), a))
            snap[name] = (list(shape), dtype, chunks)
            continue
        a, dtype = _host_array(v)
        chunks = [(tuple(0 for _ in a.shape), a)] if rank0 else []
        snap[name] = (list(a.shape), dtype, chunks)
    return snap


def _write_snapshot(snap, tmp_path: str) -> None:
    """Write this rank's chunk files (the native writer) and then its
    metadata part, renamed into place so that a poll never reads half."""
    from ..io.native import write_npy_batch

    meta, files = {}, []
    for name, (shape, dtype, chunks) in snap.items():
        entry = {"shape": shape, "dtype": dtype, "chunks": []}
        for offset, data in chunks:
            fname = _chunk_filename(name, offset)
            files.append((os.path.join(tmp_path, fname), data))
            entry["chunks"].append({"offset": list(offset),
                                    "shape": list(data.shape),
                                    "file": fname})
        meta[name] = entry
    write_npy_batch(files)
    part = os.path.join(tmp_path, f"metadata_{_rank()}.json")
    with open(part + ".part", "w") as f:
        json.dump(meta, f)
    os.replace(part + ".part", part)


def _merge_metadata(tmp_path: str) -> None:
    merged: Dict = {}
    for fn in sorted(os.listdir(tmp_path)):
        if fn.startswith("metadata_") and fn.endswith(".json"):
            with open(os.path.join(tmp_path, fn)) as f:
                part = json.load(f)
            for k, v in part.items():
                if k not in merged:
                    merged[k] = v
                    continue
                have = {tuple(c["offset"]) for c in merged[k]["chunks"]}
                merged[k]["chunks"] += [c for c in v["chunks"]
                                        if tuple(c["offset"]) not in have]
    with open(os.path.join(tmp_path, "metadata.json"), "w") as f:
        json.dump(merged, f, indent=1)


def _commit(tmp_path: str, path: str) -> None:
    """The marker, then the swap (rank 0 only)."""
    with open(os.path.join(tmp_path, COMMITTED_MARKER), "w") as f:
        f.write("1")
    old = path + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(tmp_path, path)
    if os.path.isdir(old):
        shutil.rmtree(old)


def _recover(path: str) -> None:
    """Heal a crash between ``_commit``'s renames (rank 0 only): a missing
    ``path`` is the committed ``.tmp`` promoted, else ``.old`` put
    back."""
    if _rank() != 0 or os.path.isdir(path):
        return
    tmp, old = path + ".tmp", path + ".old"
    if os.path.isfile(os.path.join(tmp, COMMITTED_MARKER)):
        os.rename(tmp, path)
        if os.path.isdir(old):
            shutil.rmtree(old)
    elif os.path.isdir(old):
        os.rename(old, path)


def _prepare(path: str) -> str:
    tmp_path = path + ".tmp"
    if _rank() == 0:
        _recover(path)
        if os.path.isdir(tmp_path):  # left by a crashed save
            shutil.rmtree(tmp_path)
        os.makedirs(tmp_path, exist_ok=True)
    _barrier()
    return tmp_path


def save_state_dict(state_dict: Dict, path: str) -> None:
    """Atomically save ``{name: value}`` (nested dicts flattened; values
    whole tensors, numpy arrays, scalars or ``Sharded`` blocks). Every
    rank calls it; returns once the checkpoint is committed."""
    snap = _snapshot_to_host(_flatten_nested(state_dict))
    tmp_path = _prepare(path)
    _write_snapshot(snap, tmp_path)
    _barrier()
    if _rank() == 0:
        _merge_metadata(tmp_path)
        _commit(tmp_path, path)
    _barrier()


class AsyncCheckpointer:
    """``save`` blocks only for the copy of this rank's blocks to the host;
    the writes and the commit run on a thread while training goes on. One
    save at a time: a new ``save`` waits for the previous one. The thread
    calls no collective; rank 0 commits once all ``world`` metadata parts
    exist (``commit_timeout`` seconds at most). Errors surface on the next
    ``save`` or ``wait_until_finished``. ``last`` holds the seconds of the
    last save's snapshot and of its write and commit, and its bytes."""

    def __init__(self, commit_timeout: float = 600.0):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.commit_timeout = commit_timeout
        self.last: Dict[str, float] = {}

    def save(self, state_dict: Dict, path: str) -> None:
        self.wait_until_finished()
        t0 = time.perf_counter()
        snap = _snapshot_to_host(_flatten_nested(state_dict))
        nbytes = sum(a.nbytes for _, _, chunks in snap.values()
                     for _, a in chunks)
        self.last = {"snapshot_s": time.perf_counter() - t0,
                     "bytes": float(nbytes)}
        tmp_path = _prepare(path)
        world, rank0 = _world(), _rank() == 0

        def worker():
            t1 = time.perf_counter()
            try:
                _write_snapshot(snap, tmp_path)
                if rank0:
                    deadline = time.monotonic() + self.commit_timeout
                    while True:
                        have = len([fn for fn in os.listdir(tmp_path)
                                    if fn.startswith("metadata_")
                                    and fn.endswith(".json")])
                        if have >= world:
                            break
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"async checkpoint commit: only {have}/"
                                f"{world} ranks wrote metadata within "
                                f"{self.commit_timeout} s; leaving "
                                f"{tmp_path} uncommitted")
                        time.sleep(0.05)
                    _merge_metadata(tmp_path)
                    _commit(tmp_path, path)
                self.last["commit_s"] = time.perf_counter() - t1
            except BaseException as e:  # surfaced on the next wait/save
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def is_committed(path: str) -> bool:
    """``path`` is a complete checkpoint (restored from ``.old`` first if
    a commit crashed between its renames): the marker, or merged metadata
    (the older layout)."""
    _recover(path)
    return os.path.isfile(os.path.join(path, COMMITTED_MARKER)) or \
        os.path.isfile(os.path.join(path, "metadata.json"))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
class _ChunkReader:
    def __init__(self, path: str, entry: dict):
        self.path = path
        self.entry = entry

    def read_slice(self, index) -> torch.Tensor:
        """``global[index]`` assembled from the overlapping chunks (mmap'd
        reads), as a CPU tensor of the entry's dtype."""
        shape = self.entry["shape"]
        bf16 = self.entry["dtype"] == "bfloat16"
        dtype = np.dtype(np.uint16 if bf16 else self.entry["dtype"])
        starts = [s.start for s in index]
        stops = [s.stop for s in index]
        out = np.zeros([b - a for a, b in zip(starts, stops)], dtype)
        for c in self.entry["chunks"]:
            coff, cshape = c["offset"], c["shape"]
            lo = [max(a, o) for a, o in zip(starts, coff)]
            hi = [min(b, o + s) for b, o, s in zip(stops, coff, cshape)]
            if shape and any(l >= h for l, h in zip(lo, hi)):
                continue
            data = np.load(os.path.join(self.path, c["file"]),
                           mmap_mode="r", allow_pickle=False)
            src = tuple(slice(l - o, h - o) for l, o, h in zip(lo, coff, hi))
            dst = tuple(slice(l - a, h - a)
                        for l, a, h in zip(lo, starts, hi))
            # (a scalar chunk the JAX package's writer stored as [1])
            out[dst] = np.asarray(data[src]).reshape(out[dst].shape)
        t = torch.from_numpy(out)
        return t.view(torch.bfloat16) if bf16 else t


def _layout(name, target, shardings):
    """``(spec, mesh)`` of the block to load for ``name``, or None."""
    if shardings and shardings.get(name) is not None:
        sh = shardings[name]
        return tuple(sh.spec), sh.mesh
    if target is not None and isinstance(target.get(name), Sharded):
        return tuple(target[name].spec), target[name].mesh
    return None


def load_state_dict(path: str, target: Optional[Dict] = None,
                    shardings: Optional[Dict] = None) -> Dict:
    """Load a committed checkpoint: this rank's block of each tensor that
    ``shardings`` (``{name: Sharding(mesh, spec)}``, nested like the saved
    dict or flattened) or a ``Sharded`` entry of ``target`` lays out, and
    the whole tensor of every other entry; CPU tensors, re-nested as
    saved. Raises ``FileNotFoundError`` for a directory that was never
    committed."""
    if target is not None:
        target = _flatten_nested(target, keep_empty=False)
    if shardings is not None:
        shardings = _flatten_nested(shardings, keep_empty=False)
    if _rank() == 0:
        is_committed(path)  # rank 0 heals a crashed commit first
    _barrier()
    if not is_committed(path):
        raise FileNotFoundError(
            f"{path!r} is not a committed checkpoint (no "
            f"{COMMITTED_MARKER} marker / metadata.json: a crashed save?)")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    out = {}
    for name, entry in meta.items():
        shape = tuple(entry["shape"])
        lay = _layout(name, target, shardings)
        if lay is None:
            index = tuple(slice(0, n) for n in shape)
        else:
            index = shd.block_slices(shape, lay[0], lay[1])
        out[name] = _ChunkReader(path, entry).read_slice(index)
    if any(_NEST_SEP in name for name in out):
        return _unflatten_nested(out)
    return out


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
def _model_entries(model, mesh):
    mesh = mesh if mesh is not None else shd.current_mesh()
    out = {}
    for name, p in model.state_dict(keep_vars=True).items():
        spec = getattr(p, "placement", None)
        if spec is not None and mesh is not None \
                and shd.is_sharded(spec, mesh):
            out[name] = Sharded(p.detach(), tuple(p.global_shape), spec,
                                mesh)
        else:
            out[name] = p.detach()
    return out


def save_model(model, path: str, mesh=None) -> None:
    """Save ``model.state_dict()``; parameters cut over ``mesh`` (or the
    ambient mesh) by ``sharding.place_params_on_mesh`` save as blocks."""
    save_state_dict(_model_entries(model, mesh), path)


def load_model(model, path: str, mesh=None):
    """Load into ``model`` in place: each parameter cut over the mesh
    takes its block of the saved tensor, the rest the whole tensor."""
    params = dict(model.named_parameters())
    entries = _model_entries(model, mesh)
    target = {n: v for n, v in entries.items() if isinstance(v, Sharded)}
    loaded = load_state_dict(path, target=target)
    with torch.no_grad():
        for name in list(loaded):
            if name in params:
                p = params[name]
                p.data.copy_(loaded.pop(name).to(p.dtype))
    model.set_state_dict(loaded)
    return model
