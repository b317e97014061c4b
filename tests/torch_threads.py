"""Torch's intra-op thread count in the port's tests.

Under pytest-xdist every worker process runs its own torch with one
intra-op thread per core by default, so six workers on eight cores run
48 torch threads against each other and against the JAX package's tests
in the other workers. Every ``tests/test_torch_*.py`` imports this module
first: each worker collects every file, so the cap holds before any test
runs. It is the CPU count divided by the number of workers
(``PYTEST_XDIST_WORKER_COUNT``), and at least 1; a run without xdist
keeps torch's default. It is a test setting only: the package itself
never sets torch's threads, and the JAX package's tests and threads are
not touched.
"""

import os

import torch


def thread_cap():
    """The intra-op thread count for this process, or None (no xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 1:
        return None
    cpus = (len(os.sched_getaffinity(0))
            if hasattr(os, "sched_getaffinity") else os.cpu_count()) or 1
    return max(1, cpus // workers)


_CAP = thread_cap()
if _CAP is not None and torch.get_num_threads() != _CAP:
    torch.set_num_threads(_CAP)
