"""Collective accounting (counterpart of
``paddle_tpu/observability/comm.py``).

In the JAX package the in-jit collectives call ``record`` while JAX is
TRACING, so each entry reflects one collective op baked into one
compiled program — per call-site (op, axis, payload bytes). The port's
collectives are still to come (ROADMAP.md Queue A7): nothing calls
``record`` yet, and ``comm_log()`` stays empty until they do. The table,
its counters and the dump CLI's ``collectives`` key are in place for
them.

Bytes are the *input payload* of the collective (per participant);
multiply by the axis size for ring volume as needed.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Tuple

from .registry import enabled, get_registry

_lock = threading.Lock()
# (op, axis, site) -> [n_recorded_calls, total_bytes]
_log: Dict[Tuple[str, str, str], List[float]] = {}

_SKIP_DIRS = (
    os.path.join("paddle_tpu_torch", "distributed"),
    os.path.join("paddle_tpu_torch", "observability"),
    os.sep + "torch" + os.sep,
    "functools.py",
    "contextlib.py",
)


def _call_site() -> str:
    """First stack frame outside the collective/observability plumbing —
    the user code that asked for the collective."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(s in fn for s in _SKIP_DIRS):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def record(op: str, axis: str, x) -> None:
    """Account one collective: ``x`` is its input tensor — only its
    shape and dtype are read."""
    if not enabled():
        return
    try:
        nbytes = int(x.nelement() * x.element_size())
    except Exception:
        return
    site = _call_site()
    key = (op, str(axis), site)
    with _lock:
        ent = _log.get(key)
        if ent is None:
            _log[key] = [1, nbytes]
        else:
            ent[0] += 1
            ent[1] += nbytes
    reg = get_registry()
    reg.counter("pt_collective_traced_calls_total",
                "collective ops traced into compiled programs",
                labels=("op", "axis")).inc(op=op, axis=str(axis))
    reg.counter("pt_collective_traced_bytes_total",
                "per-participant payload bytes of traced collectives",
                labels=("op", "axis")).inc(nbytes, op=op, axis=str(axis))


def comm_log() -> List[dict]:
    """Queryable per-call-site communication table."""
    with _lock:
        items = sorted(_log.items())
    return [
        {"op": op, "axis": axis, "site": site,
         "traced_calls": int(n), "bytes": int(b)}
        for (op, axis, site), (n, b) in items
    ]


def reset_comm_log() -> None:
    with _lock:
        _log.clear()
