"""Shared-prefix KV store of the serving engine (counterpart of
``paddle_tpu/inference/prefix_cache.py``).

Prefixes are keyed by a rolling hash over fixed-size prompt-token blocks:
block i's digest chains block i-1's, so one dict lookup per block walks
the longest cached block-aligned prefix. The digests are byte for byte
the JAX package's, so both engines agree on what a prompt shares.

Two stores, one per KV-cache mode:

- ``PagedPrefixStore`` (paged mode) maps digest -> page id. The store owns
  a refcount on each cached page (``PagePool.retain``); admission places
  matched pages at the front of the new slot's block table
  (``PagePool.adopt``, no copy), and the engine copies any shared page
  before a write can reach it. Eviction is LRU over entries whose page
  only the store owns (refcount 1), triggered by pool pressure.
- ``ContigPrefixStore`` (contiguous mode) maps digest -> the block's K/V
  rows stacked over layers, ``[n_layers, block, kv_heads, head_dim]``
  tensors in the cache dtype (``QuantizedKV`` with its scale rows for
  int8 caches). A hit copies the blocks into the slot's rows. Eviction is
  LRU over a block-count cap.

Host-side bookkeeping only: O(prompt blocks) Python per admission. The
port has no tenants, so entries carry no namespace; ``block_hashes``
keeps the namespace argument of the digest rule.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

_SEED = b"pt-prefix-v1"


def block_hashes(prompt, block: int, namespace: str = "") -> List[bytes]:
    """Chained digests of the prompt's full token blocks: ``h_i =
    blake2b(h_{i-1} || tokens[i*B:(i+1)*B] as int64)``, 16 bytes, the
    chain seeded with ``_SEED`` (followed by ``namespace`` when one is
    given). The partial tail block is never hashed."""
    toks = np.ascontiguousarray(np.asarray(prompt).reshape(-1), np.int64)
    out: List[bytes] = []
    prev = _SEED + namespace.encode() if namespace else _SEED
    for i in range(toks.size // block):
        h = hashlib.blake2b(prev + toks[i * block:(i + 1) * block].tobytes(),
                            digest_size=16).digest()
        out.append(h)
        prev = h
    return out


class PagedPrefixStore:
    """digest -> page id, refcount-pinned in the engine's ``PagePool``.
    Dict order is LRU order, least recent first."""

    def __init__(self):
        self._blocks: "OrderedDict[bytes, int]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, digest) -> bool:
        return digest in self._blocks

    @property
    def cached_pages(self) -> int:
        return len(self._blocks)

    def pages(self) -> List[int]:
        """The cached page ids, least recently used first."""
        return list(self._blocks.values())

    def match(self, hashes: List[bytes]) -> List[int]:
        """Pages of the longest cached prefix (LRU-refreshed)."""
        pages = []
        for h in hashes:
            page = self._blocks.get(h)
            if page is None:
                break
            self._blocks.move_to_end(h)
            pages.append(page)
        return pages

    def insert(self, digest: bytes, page: int, pool) -> bool:
        """Pin ``page`` under ``digest``; a digest already cached keeps its
        page (refreshed, False)."""
        if digest in self._blocks:
            self._blocks.move_to_end(digest)
            return False
        pool.retain(page)
        self._blocks[digest] = page
        return True

    def evictable_pages(self, pool, exclude=()) -> int:
        """How many pages ``evict`` could free now: entries only the store
        owns, less ``exclude`` (pages the caller is about to adopt)."""
        ex = set(exclude)
        return sum(1 for p in self._blocks.values()
                   if p not in ex and pool.ref.get(p, 0) == 1)

    def evict(self, pool, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, LRU first, skipping entries a live
        slot still borrows (refcount > 1). Evicting a block inside a chain
        strands its children until their own turn: lookups stop at the
        gap."""
        freed = 0
        for digest, page in list(self._blocks.items()):
            if freed >= n_pages:
                break
            if pool.ref.get(page, 0) != 1:
                continue
            del self._blocks[digest]
            pool.release(page)
            self.evictions += 1
            freed += 1
        return freed


class ContigPrefixStore:
    """digest -> (k, v) block rows stacked over layers, at most
    ``max_blocks`` entries. Dict order is LRU order, least recent
    first."""

    def __init__(self, max_blocks: int):
        self.max_blocks = max(int(max_blocks), 0)
        self._blocks: "OrderedDict[bytes, Tuple]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, digest) -> bool:
        return digest in self._blocks

    @property
    def cached_pages(self) -> int:
        return len(self._blocks)

    def match(self, hashes: List[bytes]) -> List[Tuple]:
        """(k, v) of the longest cached prefix's blocks (LRU-refreshed)."""
        out = []
        for h in hashes:
            ent = self._blocks.get(h)
            if ent is None:
                break
            self._blocks.move_to_end(h)
            out.append(ent)
        return out

    def insert(self, digest: bytes, k, v, protect=()) -> bool:
        """Store a block, evicting LRU entries over the cap. ``protect``:
        the digests of the chain being inserted, which eviction spares
        while anything else is left (evicting block 0 to make room for
        block 1 would leave a gap every lookup stops at)."""
        if self.max_blocks == 0:
            return False
        if digest in self._blocks:
            self._blocks.move_to_end(digest)
            return False
        keep = set(protect)
        while len(self._blocks) >= self.max_blocks:
            victim = next((h for h in self._blocks if h not in keep),
                          next(iter(self._blocks)))
            del self._blocks[victim]
            self.evictions += 1
        self._blocks[digest] = (k, v)
        return True
