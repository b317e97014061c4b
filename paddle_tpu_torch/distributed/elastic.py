"""Elastic node management (counterpart of
``paddle_tpu/distributed/elastic.py``; parity: python/paddle/distributed/
fleet/elastic/manager.py — ``ElasticManager``: node registry, fault
watch, scale up/down within ``--np min:max``, restart signaling).

Host file logic with no device in it: the registry is a directory of
per-node heartbeat files on a filesystem every node sees (the place
checkpoints go). Registration writes one, a daemon thread refreshes its
mtime, and the manager treats a stale mtime as node failure, the
liveness contract the reference implements with etcd leases. Recovery is
checkpoint-resume: workers exit and relaunch with re-ranked
environments (``launch/main.py``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .checkpoint import COMMITTED_MARKER, is_committed  # noqa: F401


@dataclass
class WorldSpec:
    """What a relaunch needs: the surviving membership, re-ranked.

    ``hosts`` carries actual hostnames (what a relaunch command / trainer
    endpoint list needs); ``node_ids`` the registry keys that determined
    the ranking (hostname_pid — unique even with several nodes per
    host)."""

    nnodes: int
    node_rank: int
    hosts: List[str]
    node_ids: List[str]


def parse_np_range(np_arg: str) -> Tuple[int, int]:
    """'2:4' → (2, 4); '4' → (4, 4) (reference --np syntax)."""
    if ":" in np_arg:
        lo, hi = np_arg.split(":")
        return int(lo), int(hi)
    return int(np_arg), int(np_arg)


class FileStore:
    """Heartbeat registry on a shared directory (etcd-lease analog)."""

    def __init__(self, root: str, job_id: str):
        self.dir = os.path.join(root, f"elastic_{job_id}")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, node_id: str) -> str:
        return os.path.join(self.dir, f"node_{node_id}.json")

    def write(self, node_id: str, payload: dict):
        path = self._path(node_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic on POSIX

    def touch(self, node_id: str):
        os.utime(self._path(node_id))

    def remove(self, node_id: str):
        try:
            os.remove(self._path(node_id))
        except FileNotFoundError:
            pass

    def nodes(self) -> Dict[str, dict]:
        out = {}
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("node_") and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    info = json.load(f)
                info["_mtime"] = os.path.getmtime(path)
                out[name[len("node_"):-len(".json")]] = info
            except (OSError, json.JSONDecodeError):
                continue  # racing writer; next poll sees it
        return out


class ElasticManager:
    """Node-membership watcher + re-ranker.

    One instance runs per node. ``register()`` announces the node and
    starts the heartbeat daemon; ``scan()`` classifies the membership;
    ``plan()`` returns the re-ranked WorldSpec when the membership is
    viable (min_np ≤ alive ≤ max_np), or None while waiting.
    """

    def __init__(self, store: FileStore, np_range: Tuple[int, int],
                 node_id: Optional[str] = None,
                 heartbeat_interval: float = 1.0,
                 fault_timeout: float = 5.0):
        self.store = store
        self.min_np, self.max_np = np_range
        self.node_id = node_id or f"{socket.gethostname()}_{os.getpid()}"
        self.heartbeat_interval = heartbeat_interval
        self.fault_timeout = fault_timeout
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- node side ----
    def register(self, host: Optional[str] = None):
        self.store.write(self.node_id, {
            "host": host or socket.gethostname(),
            "pid": os.getpid(),
            "registered_at": time.time(),
        })
        self._stop.clear()
        self._hb_thread = threading.Thread(target=self._beat, daemon=True)
        self._hb_thread.start()
        return self

    def _beat(self):
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self.store.touch(self.node_id)
            except FileNotFoundError:
                return  # deregistered under us

    def deregister(self):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        self.store.remove(self.node_id)

    # ---- watcher side ----
    def scan(self) -> Tuple[List[str], List[str]]:
        """→ (alive node ids, faulted node ids) by heartbeat age."""
        now = time.time()
        alive, faulted = [], []
        for nid, info in self.store.nodes().items():
            if now - info["_mtime"] > self.fault_timeout:
                faulted.append(nid)
            else:
                alive.append(nid)
        return alive, faulted

    def evict_faulted(self) -> List[str]:
        """Drop stale registrations (the etcd-lease-expiry analog)."""
        _, faulted = self.scan()
        for nid in faulted:
            self.store.remove(nid)
        return faulted

    def plan(self) -> Optional[WorldSpec]:
        """Re-ranked world over the live membership, or None if the job
        cannot (yet) run: ranks are assigned by sorted node id, so every
        node computes the identical assignment without coordination."""
        alive, _ = self.scan()
        if not (self.min_np <= len(alive) <= self.max_np):
            return None
        node_ids = sorted(alive)
        if self.node_id not in node_ids:
            return None
        registry = self.store.nodes()
        hosts = [
            registry.get(nid, {}).get("host", nid.rsplit("_", 1)[0])
            for nid in node_ids
        ]
        return WorldSpec(nnodes=len(node_ids),
                         node_rank=node_ids.index(self.node_id),
                         hosts=hosts,
                         node_ids=node_ids)

    def wait_for_world(self, timeout: float = 60.0,
                       poll: float = 0.5,
                       settle: float = 0.0) -> Optional[WorldSpec]:
        """Block until a viable membership forms (optionally stable for
        ``settle`` seconds — the reference's scale-up debounce)."""
        deadline = time.time() + timeout
        stable_since = None
        last = None
        while time.time() < deadline:
            spec = self.plan()
            if spec is not None:
                key = tuple(spec.node_ids)
                if key != last:
                    last, stable_since = key, time.time()
                if time.time() - stable_since >= settle:
                    return spec
            else:
                last, stable_since = None, None
            time.sleep(poll)
        return None


def latest_checkpoint(ckpt_root: str, prefix: str = "step_"
                      ) -> Optional[str]:
    """Newest complete checkpoint dir (the resume point after an elastic
    restart). A checkpoint counts only when it is committed (COMMITTED
    marker / merged metadata) — torn ``.tmp`` dirs from the killed
    incarnation are skipped."""
    if not os.path.isdir(ckpt_root):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_root):
        if not name.startswith(prefix):
            continue
        if not is_committed(os.path.join(ckpt_root, name)):
            continue
        try:
            step = int(name[len(prefix):])
        except ValueError:
            continue
        if step > best_step:
            best, best_step = os.path.join(ckpt_root, name), step
    return best
