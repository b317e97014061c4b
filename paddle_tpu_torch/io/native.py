"""ctypes bindings for the port's two native libraries (counterpart of
``paddle_tpu/io/native.py``): the token data loader
(``csrc/dataloader.cpp``: ``TokenBinDataset``) and the parallel
checkpoint chunk writer (``csrc/ckptio.cpp``: ``load_ckpt_writer``).

The port keeps its own copy of both sources in ``io/csrc`` and builds
each with ``g++`` at first use into ``io/_build`` (one shared library a
source, named by the hash of its source and flags; concurrent builders
each compile to a private name and the first to finish publishes it). A
failed build raises; the JAX package's fallbacks (the pure-Python loader,
an ``np.save`` loop) are not taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]

_libs = {}


def find_cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found: the port's native "
                           "loader and checkpoint writer are built from "
                           "source at first use")
    return found


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library if this source hash
    has none yet; returns its path. Raises on a failed build."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + repr(CXX_FLAGS).encode())
    lib = BUILD_ROOT / f"{src.stem}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{src.stem}-", suffix=".so",
                               dir=BUILD_ROOT)
    os.close(fd)
    try:
        res = subprocess.run([find_cxx(), *CXX_FLAGS, "-o", tmp, str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {source} failed:\n{res.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load(source: str, bind) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        bind(lib)
        _libs[source] = lib
    return lib


def _bind_loader(lib):
    lib.ptdl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
    lib.ptdl_open.restype = ctypes.c_int
    lib.ptdl_num_seqs.argtypes = [ctypes.c_int]
    lib.ptdl_num_seqs.restype = ctypes.c_int64
    lib.ptdl_start_epoch.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.ptdl_start_epoch.restype = ctypes.c_int
    lib.ptdl_next_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ptdl_next_batch.restype = ctypes.c_int64
    lib.ptdl_close.argtypes = [ctypes.c_int]
    lib.ptdl_close.restype = ctypes.c_int


def _bind_writer(lib):
    lib.ptck_write_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ptck_write_batch.restype = ctypes.c_int


class TokenBinDataset:
    """Fixed-length sequences from a binary token shard (uint16 or uint32
    tokens, ``token_bytes`` 2 or 4). ``batches`` yields int32 numpy
    arrays ``[batch, seq_len]`` (with ``return_indices``, also the
    sequence indices), filled by the native prefetch threads."""

    def __init__(self, path: str, seq_len: int, token_bytes: int = 2):
        self._lib = _load("dataloader.cpp", _bind_loader)
        self.seq_len = seq_len
        self.handle = self._lib.ptdl_open(path.encode(), token_bytes,
                                          seq_len)
        if self.handle < 0:
            raise OSError(f"ptdl_open({path!r}) failed with code "
                          f"{self.handle}")
        self.num_seqs = self._lib.ptdl_num_seqs(self.handle)

    def __len__(self):
        return self.num_seqs

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_last: bool = True, num_threads: int = 2,
                return_indices: bool = False) -> Iterator[np.ndarray]:
        lib = self._lib
        rc = lib.ptdl_start_epoch(self.handle, seed, batch_size,
                                  int(drop_last), int(shuffle), num_threads)
        if rc != 0:
            raise OSError(f"ptdl_start_epoch failed: {rc}")
        buf = np.empty((batch_size, self.seq_len), np.int32)
        idx = np.empty((batch_size,), np.int64)
        while True:
            n = lib.ptdl_next_batch(
                self.handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if n <= 0:
                return
            if return_indices:
                yield buf[:n].copy(), idx[:n].copy()
            else:
                yield buf[:n].copy()

    def close(self):
        if self.handle >= 0:
            self._lib.ptdl_close(self.handle)
            self.handle = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_ckpt_writer() -> ctypes.CDLL:
    """The native parallel checkpoint chunk writer
    (``ptck_write_batch``), built at first use; raises when it cannot be
    built."""
    return _load("ckptio.cpp", _bind_writer)


def npy_header(arr: np.ndarray) -> bytes:
    """The .npy v1 header bytes ``np.save`` would write for ``arr``."""
    import io as _io

    buf = _io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue()


def write_npy_batch(files) -> None:
    """Write ``[(path, np.ndarray)]`` as .npy files from the native
    writer's pool of up to 8 threads, each file fsynced (the data is
    durable before a checkpoint's marker can land); raises ``OSError``
    naming how many files failed."""
    n = len(files)
    if n == 0:
        return
    lib = load_ckpt_writer()
    arrays = [np.asarray(a) for _, a in files]
    # (np.ascontiguousarray would make a 0-d array 1-d)
    arrays = [a if a.flags.c_contiguous else np.ascontiguousarray(a)
              for a in arrays]
    headers = [npy_header(a) for a in arrays]
    u8 = ctypes.POINTER(ctypes.c_uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p, _ in files])
    c_headers = (u8 * n)(*[ctypes.cast(ctypes.c_char_p(h), u8)
                           for h in headers])
    c_hlens = (ctypes.c_int64 * n)(*[len(h) for h in headers])
    c_datas = (u8 * n)(*[ctypes.cast(a.ctypes.data, u8) for a in arrays])
    c_dlens = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    failures = lib.ptck_write_batch(n, c_paths, c_headers, c_hlens, c_datas,
                                    c_dlens, min(n, 8), 1)
    if failures:
        raise OSError(f"native checkpoint writer: {failures}/{n} chunk "
                      f"files failed to write")
