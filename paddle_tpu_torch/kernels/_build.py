"""Build and load the port's CUDA kernels.

The sources in ``kernels/csrc`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ``ctypes``. The build runs at first use, never at import, and lands
in ``kernels/_build/<hash>/``, keyed on a hash of the sources and flags,
so a fresh checkout builds once and a changed source builds anew. Each
translation unit (one per cache element type) compiles in its own
``nvcc`` process, all started together, and the objects link into one
library. Headers in ``csrc`` (``*.cuh``) are part of the hash.
``nvcc`` keeps IEEE division and square roots (no ``--use_fast_math``):
the int8 quantize-on-append must round as the plain versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libpt_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (source, object name, extra defines): one object per cache element type
# and decode kernel (the block-table kernel of paged_attention.cu takes
# float pools only), one for the weight-only matmul, one per element type
# of the flash attention kernels, one for the selective scan (float32
# only: JAX casts every operand to float32) and one per activation type of
# the GroupNorm kernels
UNITS: List[Tuple[str, str, List[str]]] = [
    ("decode_attention.cu", "decode_attention_f32",
     ["-DPT_CACHE_T=float", "-DPT_CACHE_TAG=f32"]),
    ("decode_attention.cu", "decode_attention_f16",
     ["-DPT_CACHE_T=__half", "-DPT_CACHE_TAG=f16"]),
    ("decode_attention.cu", "decode_attention_bf16",
     ["-DPT_CACHE_T=__nv_bfloat16", "-DPT_CACHE_TAG=bf16"]),
    ("decode_attention.cu", "decode_attention_i8",
     ["-DPT_CACHE_T=int8_t", "-DPT_CACHE_TAG=i8"]),
    ("paged_attention.cu", "paged_attention_f32",
     ["-DPT_CACHE_T=float", "-DPT_CACHE_TAG=f32"]),
    ("paged_attention.cu", "paged_attention_f16",
     ["-DPT_CACHE_T=__half", "-DPT_CACHE_TAG=f16"]),
    ("paged_attention.cu", "paged_attention_bf16",
     ["-DPT_CACHE_T=__nv_bfloat16", "-DPT_CACHE_TAG=bf16"]),
    ("paged_attention.cu", "paged_attention_i8",
     ["-DPT_CACHE_T=int8_t", "-DPT_CACHE_TAG=i8", "-DPT_CACHE_INT8"]),
    ("paged_attention.cu", "paged_table_f32",
     ["-DPT_CACHE_T=float", "-DPT_CACHE_TAG=f32", "-DPT_PAGED_TABLE"]),
    ("paged_attention.cu", "paged_table_f16",
     ["-DPT_CACHE_T=__half", "-DPT_CACHE_TAG=f16", "-DPT_PAGED_TABLE"]),
    ("paged_attention.cu", "paged_table_bf16",
     ["-DPT_CACHE_T=__nv_bfloat16", "-DPT_CACHE_TAG=bf16",
      "-DPT_PAGED_TABLE"]),
    ("quant_matmul.cu", "quant_matmul", []),
    ("flash_attention.cu", "flash_attention_f32",
     ["-DPT_FA_T=float", "-DPT_FA_TAG=f32"]),
    ("flash_attention.cu", "flash_attention_f16",
     ["-DPT_FA_T=__half", "-DPT_FA_TAG=f16"]),
    ("flash_attention.cu", "flash_attention_bf16",
     ["-DPT_FA_T=__nv_bfloat16", "-DPT_FA_TAG=bf16"]),
    ("selective_scan.cu", "selective_scan", []),
    ("group_norm.cu", "group_norm_f32",
     ["-DPT_GN_T=float", "-DPT_GN_TAG=f32"]),
    ("group_norm.cu", "group_norm_f16",
     ["-DPT_GN_T=__half", "-DPT_GN_TAG=f16"]),
    ("group_norm.cu", "group_norm_bf16",
     ["-DPT_GN_T=__nv_bfloat16", "-DPT_GN_TAG=bf16"]),
]

# the last build of this process: seconds spent compiling (0.0 when the
# library was already built) and the compiler's output
BUILD_INFO: Dict[str, object] = {}
_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use on the card")
    return found


def _source_key() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(repr((NVCC_FLAGS, UNITS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    returns the library's path. Concurrent builders each compile in a
    private directory and the first to finish publishes it."""
    out_dir = BUILD_ROOT / _source_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, log="")
        return lib
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src, obj, defines in UNITS:
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", str(CSRC / src),
                   "-o", str(tmp / f"{obj}.o")]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                *[str(tmp / f"{obj}.o") for _, obj, _ in UNITS],
                "-o", str(tmp / LIB_NAME)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not lib.exists():  # not a concurrent builder's win
                raise
        log = "\n".join(logs)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log)
    return lib


def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB
