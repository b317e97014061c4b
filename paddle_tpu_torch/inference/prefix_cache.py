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
  Entries remember the namespace (tenant) that published them, and
  ``evict(prefer_ns=...)`` spends the requesting tenant's cold entries
  before anyone else's.
- ``ContigPrefixStore`` (contiguous mode) maps digest -> the block's K/V
  rows stacked over layers, ``[n_layers, block, kv_heads, head_dim]``
  tensors in the cache dtype (``QuantizedKV`` with its scale rows for
  int8 caches). A hit copies the blocks into the slot's rows. Eviction is
  LRU over a block-count cap, the inserting namespace's entries first,
  never the chain being inserted while anything else is left.

Host-side bookkeeping only: O(prompt blocks) Python per admission.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

_SEED = b"pt-prefix-v1"


def block_hashes(prompt, block: int, namespace: str = "") -> List[bytes]:
    """Chained digests of the prompt's full token blocks: ``h_i =
    blake2b(h_{i-1} || tokens[i*B:(i+1)*B] as int64)``, 16 bytes, the
    chain seeded with ``_SEED`` (followed by ``namespace`` when one is
    given: two tenants' chains over the same prompt are disjoint). The
    partial tail block is never hashed."""
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
    """digest -> (page id, namespace), refcount-pinned in the engine's
    ``PagePool``. Dict order is LRU order, least recent first."""

    def __init__(self):
        self._blocks: "OrderedDict[bytes, Tuple[int, str]]" = OrderedDict()
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
        return [page for page, _ in self._blocks.values()]

    def match(self, hashes: List[bytes]) -> List[int]:
        """Pages of the longest cached prefix (LRU-refreshed)."""
        pages = []
        for h in hashes:
            ent = self._blocks.get(h)
            if ent is None:
                break
            self._blocks.move_to_end(h)
            pages.append(ent[0])
        return pages

    def match_len(self, hashes: List[bytes]) -> int:
        """The longest cached prefix, in blocks, without an LRU refresh:
        a probe that changes no eviction order."""
        return _match_len(self._blocks, hashes)

    def insert(self, digest: bytes, page: int, pool, ns: str = "") -> bool:
        """Pin ``page`` under ``digest`` for namespace ``ns``; a digest
        already cached keeps its page (refreshed, False)."""
        if digest in self._blocks:
            self._blocks.move_to_end(digest)
            return False
        pool.retain(page)
        self._blocks[digest] = (page, ns)
        return True

    def evictable_pages(self, pool, exclude=()) -> int:
        """How many pages ``evict`` could free now: entries only the store
        owns, less ``exclude`` (pages the caller is about to adopt)."""
        ex = set(exclude)
        return sum(1 for p, _ in self._blocks.values()
                   if p not in ex and pool.ref.get(p, 0) == 1)

    def evict(self, pool, n_pages: int,
              prefer_ns: Optional[str] = None) -> int:
        """Free up to ``n_pages`` pages, LRU first, skipping entries a live
        slot still borrows (refcount > 1). ``prefer_ns``: that namespace's
        entries go first, then the rest in LRU order. Evicting a block
        inside a chain strands its children until their own turn: lookups
        stop at the gap."""
        freed = 0
        for want_ns in ([prefer_ns, None] if prefer_ns is not None
                        else [None]):
            for digest, (page, ns) in list(self._blocks.items()):
                if freed >= n_pages:
                    return freed
                if want_ns is not None and ns != want_ns:
                    continue
                if pool.ref.get(page, 0) != 1:
                    continue
                del self._blocks[digest]
                pool.release(page)
                self.evictions += 1
                freed += 1
        return freed


class ContigPrefixStore:
    """digest -> (k, v, namespace), the block rows stacked over layers, at
    most ``max_blocks`` entries. Dict order is LRU order, least recent
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
            out.append(ent[:2])
        return out

    def match_len(self, hashes: List[bytes]) -> int:
        """The longest cached prefix, in blocks, without an LRU refresh."""
        return _match_len(self._blocks, hashes)

    def insert(self, digest: bytes, k, v, ns: str = "",
               protect=()) -> bool:
        """Store a block for namespace ``ns``, evicting over the cap: the
        LRU entry of ``ns`` first, else the LRU entry, sparing
        ``protect`` (the digests of the chain being inserted: evicting
        block 0 to make room for block 1 would leave a gap every lookup
        stops at) while anything else is left."""
        if self.max_blocks == 0:
            return False
        if digest in self._blocks:
            self._blocks.move_to_end(digest)
            return False
        keep = set(protect)
        while len(self._blocks) >= self.max_blocks:
            victim = next((h for h, ent in self._blocks.items()
                           if ent[2] == ns and h not in keep), None)
            if victim is None:
                victim = next((h for h in self._blocks if h not in keep),
                              next(iter(self._blocks)))
            del self._blocks[victim]
            self.evictions += 1
        self._blocks[digest] = (k, v, ns)
        return True


def _match_len(blocks, hashes: List[bytes]) -> int:
    n = 0
    for h in hashes:
        if h not in blocks:
            break
        n += 1
    return n
