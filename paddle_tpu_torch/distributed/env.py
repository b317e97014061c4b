"""Process-level distributed environment (counterpart of
``paddle_tpu/distributed/env.py``; parity: paddle.distributed.
init_parallel_env / get_rank / get_world_size / spawn).

One process per rank, on ``torch.distributed``: NCCL on the card, gloo
on the host when the caller asks for it (``backend="gloo"`` or
``device="cpu"``). The rank contract is the one the launcher writes
(``launch/main.py``): ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK`` and ``PADDLE_MASTER`` (``host:port``), with
torch's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT`` read where the Paddle names are missing. A single
process with no master gets a one-rank group on a free local port, so
the collectives always have a group.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device


def _env_int(*names, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _env_master() -> Optional[str]:
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return master
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env(backend: Optional[str] = None, device=None,
                      coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout: Optional[float] = None) -> None:
    """Join the job's process group (once; later calls return).

    ``backend`` defaults to NCCL, on the card, and raises without one;
    ``"gloo"`` (or ``device="cpu"``) runs on the host. The rank, world
    size and master come from the arguments, else from the launcher's
    environment; ``init_method`` (say ``file://...``) replaces the TCP
    master. ``timeout`` in seconds bounds every collective of the group.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "gloo" if (device is not None and
                             torch.device(device).type == "cpu") else "nccl"
    if backend == "nccl":
        resolve_device("cuda")  # raises without a card
    world = num_processes or _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                      default=1)
    rank = process_id if process_id is not None else _env_int(
        "PADDLE_TRAINER_ID", "RANK", default=0)
    if init_method is None:
        master = coordinator_address or _env_master()
        if master is None:
            if world != 1:
                raise RuntimeError(
                    f"init_parallel_env: {world} ranks need a master "
                    "address (PADDLE_MASTER, or run under python -m "
                    "paddle_tpu_torch.distributed.launch)")
            master = f"127.0.0.1:{free_port()}"
        init_method = f"tcp://{master}"
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)


def get_rank() -> int:
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def get_local_rank() -> int:
    return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=0)


def is_initialized() -> bool:
    return dist.is_initialized()


def device_count() -> int:
    """The job's devices: one a rank."""
    return get_world_size()


def local_device_count() -> int:
    """The cards this process sees (1 on a host without one)."""
    return max(torch.cuda.device_count(), 1)


class ParallelEnv:
    """Parity: paddle.distributed.ParallelEnv — rank/world/device
    queries as attributes (legacy dygraph DDP surface)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        return get_local_rank()

    @property
    def dev_id(self) -> int:  # legacy spelling
        return get_local_rank()

    @property
    def nranks(self) -> int:  # legacy spelling
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return get_rank()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Parity: paddle.distributed.spawn — run ``func(*args)`` in
    ``nprocs`` processes (``torch.multiprocessing``, start method
    ``spawn``) with the launcher's rank environment and one free master
    port, so each worker's ``init_parallel_env()`` joins one group.
    Returns the processes; with ``join`` waits for them and raises
    ``RuntimeError`` when one failed."""
    import torch.multiprocessing as mp

    if nprocs <= 0:
        nprocs = local_device_count()
    master = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_spawn_entry, args=(func, args, nprocs, master),
                             nprocs=nprocs, join=False, daemon=daemon,
                             start_method="spawn")
    if join:
        try:
            while not ctx.join():
                pass
        except Exception as e:
            raise RuntimeError(f"spawn: a worker failed: {e}") from e
    return ctx.processes


def _spawn_entry(rank, func, args, nprocs, master):
    host, port = master.rsplit(":", 1)
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_LOCAL_RANK": str(rank), "PADDLE_MASTER": master,
        "RANK": str(rank), "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": str(rank), "MASTER_ADDR": host, "MASTER_PORT": port})
    func(*args)
