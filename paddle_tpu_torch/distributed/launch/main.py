"""Launch CLI (counterpart of ``paddle_tpu/distributed/launch/main.py``;
parity: python -m paddle.distributed.launch — per-rank process
supervision with log capture and a master rendezvous).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
script.py [args]`` starts N workers of ``script.py``, one a card (or a
host rank over gloo), writes the ``PADDLE_*`` rank contract the port
reads (``distributed/env.py``) plus torch's ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, captures
each worker's output in ``log/workerlog.N``, supervises the exits and
returns the first non-zero exit code (0 when all succeed). ``--elastic``
re-spawns failed workers, so training resumes from the latest
checkpoint; ``--np min:max`` tracks membership through
``elastic.ElasticManager``. Node 0's launcher hosts the rendezvous store
on ``--master`` (default: a free local port) before the workers start.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional


class Container:
    def __init__(self, rank: int, cmd: List[str], env: dict, log_dir: str):
        self.rank = rank
        self.cmd = cmd
        self.env = env
        self.log_dir = log_dir
        self.proc: Optional[subprocess.Popen] = None
        self.log_file = None

    def start(self):
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"workerlog.{self.rank}")
        self.log_file = open(path, "ab")
        self.proc = subprocess.Popen(
            self.cmd, env=self.env, stdout=self.log_file,
            stderr=subprocess.STDOUT,
        )
        return self.proc

    def poll(self):
        return self.proc.poll() if self.proc else None

    def terminate(self):
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        if self.log_file:
            self.log_file.close()


class CollectiveController:
    def __init__(self, args, extra: List[str]):
        self.args = args
        self.extra = extra
        self.containers: List[Container] = []
        self.manager = None
        self.store = None
        if args.np:
            # elastic membership via the shared-store ElasticManager
            # (reference: fleet/elastic with etcd; SURVEY.md §5)
            from ..elastic import ElasticManager, FileStore, parse_np_range

            store = FileStore(args.elastic_store, args.job_id)
            self.manager = ElasticManager(
                store, parse_np_range(args.np),
                fault_timeout=args.elastic_timeout)
            self.manager.register()

    def _world(self, grace: bool = False):
        if self.manager is None:
            return self.args.nnodes, self.args.node_rank
        if grace:
            # restart path: let a dead peer's heartbeat go stale before
            # re-ranking, or the rebuilt world still contains it and the
            # respawn burns max_restarts against a doomed membership
            time.sleep(self.manager.fault_timeout)
        self.manager.evict_faulted()
        spec = self.manager.wait_for_world(
            timeout=self.args.elastic_timeout * 6,
            settle=self.args.elastic_settle)
        if spec is None:
            raise RuntimeError(
                "elastic: no viable membership within timeout "
                f"(need np in [{self.manager.min_np}, "
                f"{self.manager.max_np}])")
        return spec.nnodes, spec.node_rank

    def _host_store(self, node_rank: int) -> str:
        """The rendezvous master, ``host:port``. Node 0's launcher hosts
        the workers' TCP store itself (a fresh one each build: a restart
        starts a new rendezvous), bound before any worker starts, so no
        other process can take its port; the workers join it as clients
        (``TORCHELASTIC_USE_AGENT_STORE``)."""
        import datetime

        from torch.distributed import TCPStore

        host, port = (self.args.master.rsplit(":", 1) if self.args.master
                      else ("127.0.0.1", "0"))
        if node_rank == 0:
            self.store = None  # release a restart's old port first
            self.store = TCPStore(host_name=host, port=int(port),
                                  is_master=True, wait_for_workers=False,
                                  timeout=datetime.timedelta(minutes=30))
            port = str(self.store.port)
        return f"{host}:{port}"

    def build(self, grace: bool = False):
        nproc = self.args.nproc_per_node
        nnodes, node_rank = self._world(grace=grace)
        master = self._host_store(node_rank)
        self.containers = []
        for local_rank in range(nproc):
            rank = node_rank * nproc + local_rank
            env = dict(os.environ)
            host, port = master.rsplit(":", 1)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(nnodes * nproc),
                "PADDLE_LOCAL_RANK": str(local_rank),
                "PADDLE_MASTER": master,
                "MASTER_ADDR": host,
                "MASTER_PORT": port,
                "RANK": str(rank),
                "WORLD_SIZE": str(nnodes * nproc),
                "LOCAL_RANK": str(local_rank),
                "TORCHELASTIC_USE_AGENT_STORE": "True",
            })
            if self.args.devices:
                env["CUDA_VISIBLE_DEVICES"] = self.args.devices
            cmd = [sys.executable] + self.extra
            self.containers.append(
                Container(rank, cmd, env, self.args.log_dir)
            )
        return self

    def run(self) -> int:
        for c in self.containers:
            c.start()
        print(
            f"launched {len(self.containers)} worker(s); logs in "
            f"{self.args.log_dir}/workerlog.N"
        )
        restarts = 0
        try:
            while True:
                statuses = [c.poll() for c in self.containers]
                if all(s == 0 for s in statuses):
                    return 0
                failed = [
                    (i, s) for i, s in enumerate(statuses)
                    if s not in (None, 0)
                ]
                if failed:
                    if (self.args.elastic
                            and restarts < self.args.max_restarts):
                        restarts += 1
                        print(
                            f"worker(s) {[i for i, _ in failed]} failed; "
                            f"elastic restart {restarts}/"
                            f"{self.args.max_restarts}"
                        )
                        for c in self.containers:
                            c.terminate()
                        # re-rank over the surviving membership before
                        # respawning (no-op without --np)
                        try:
                            self.build(grace=self.manager is not None)
                        except RuntimeError as e:
                            print(f"elastic: {e}; tearing down")
                            for c in self.containers:
                                c.terminate()
                            return 1
                        for c in self.containers:
                            c.start()
                    else:
                        print(
                            f"worker(s) failed with {failed}; tearing down"
                        )
                        for c in self.containers:
                            c.terminate()
                        return failed[0][1]
                time.sleep(self.args.poll_interval)
        except KeyboardInterrupt:
            for c in self.containers:
                c.terminate()
            return 130

    def stop(self):
        for c in self.containers:
            c.terminate()
        self.store = None
        if self.manager is not None:
            self.manager.deregister()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="multi-process / multi-host job launcher",
    )
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER"))
    p.add_argument("--devices", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--elastic", action="store_true",
                   help="restart failed workers (checkpoint-resume)")
    p.add_argument("--np", type=str, default=None,
                   help="elastic node range 'min:max' (implies membership "
                        "tracking via --elastic_store)")
    p.add_argument("--job_id", type=str,
                   default=os.environ.get("PADDLE_JOB_ID", "default"))
    p.add_argument("--elastic_store", type=str,
                   default=os.environ.get("PADDLE_ELASTIC_STORE",
                                          tempfile.gettempdir()),
                   help="shared directory for membership (must be a "
                        "filesystem ALL nodes see; the temp-dir default only "
                        "works single-node)")
    p.add_argument("--elastic_timeout", type=float, default=5.0)
    p.add_argument("--elastic_settle", type=float, default=1.0,
                   help="membership must be stable this long before a "
                        "world forms (startup race debounce)")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--poll_interval", type=float, default=1.0)
    p.add_argument("training_script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv=None) -> int:
    args = parse_args(argv)
    if args.np and args.elastic_store == tempfile.gettempdir() and \
            parse_np_max(args.np) > 1:
        print("warning: the default --elastic_store is node-local; "
              "multi-node membership needs a shared filesystem path",
              file=sys.stderr)
    extra = [args.training_script] + list(args.script_args)
    controller = CollectiveController(args, extra)
    try:
        # build inside the try: a membership-wait timeout in the first
        # build must still deregister the heartbeat, or the ghost node
        # corrupts the next launch's world
        controller.build()
        return controller.run()
    finally:
        controller.stop()


def parse_np_max(np_arg: str) -> int:
    from ..elastic import parse_np_range

    return parse_np_range(np_arg)[1]
