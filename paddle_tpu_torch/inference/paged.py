"""Paged KV cache (counterpart of ``paddle_tpu/inference/paged.py``).

The pool is a fixed tensor ``[kv_heads, n_pages, page_size, head_dim]``
per layer, head-major as in the JAX package, and the indirection is
data: a ``block_tables`` [slots, max_pages] of page ids and per-slot
``seq_lens``. Page allocation is host-side bookkeeping in numpy
(``PagePool``); the device sees the block table as plain int32 data.

The JAX package returns updated pools; the port writes them in place
(the JAX engine donates them). Rows the JAX scatter drops (positions past
the block table's span, such as the engine's ``start = max_len`` "not
prefilling" sentinel) are redirected here to the sink page 0, which the
engine's pool keeps out of circulation (``reserve_sink``): torch has no
drop-mode scatter, and a boolean mask would sync the host.

Int8 pools carry per-row float32 scales ``[kv_heads, n_pages, page_size,
1]`` beside the payload, indexed by the same page ids, so a page's scale
rows travel with it. Rows are quantized on append and dequantized where
they are read (``gather_kv`` here, the fused decode kernels on the card).
Int8 contiguous caches are ``QuantizedKV`` pairs (``models/llama.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

NEG_INF = -1e30  # the JAX dense_paged_attention's mask fill
SINK_PAGE = 0    # write sink for inactive slots and dropped rows
# the JAX package's int8-KV quantization epsilon: scale = max(absmax /
# 127, eps), one constant for every append path and both fused kernels
KV_QUANT_EPS = 1e-8


class PagedLayerCache(NamedTuple):
    """Per-layer page pool, updated in place. ``k_scale``/``v_scale`` are
    present only for int8 pools: float32 ``[kv_heads, n_pages, page_size,
    1]``, one dequantization scale per stored row and head."""

    k_pages: torch.Tensor  # [kv_heads, n_pages, page_size, head_dim]
    v_pages: torch.Tensor  # [kv_heads, n_pages, page_size, head_dim]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class QuantizedKV(NamedTuple):
    """One side (K or V) of an int8 contiguous cache: ``q`` int8
    [slots, max_len, kv_heads, head_dim] and ``scale`` float32
    [slots, max_len, kv_heads], one symmetric scale per row and head
    (dequantized ``q * scale[..., None]``). ``shape``/``dtype`` mirror
    the payload, as in the JAX package."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


def quantize_kv_rows(x):
    """Symmetric per-row int8 over the last axis: x [..., d] -> (q int8
    [..., d], scale float32 [...]). The one quantization rule of every
    append path and of both fused kernels (absmax / 127, round half to
    even, clip), as JAX's ``quantize_kv_rows``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=KV_QUANT_EPS)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(c):
    """``QuantizedKV`` (or a plain tensor, returned as is) -> float32."""
    if isinstance(c, QuantizedKV):
        return c.q.float() * c.scale[..., None]
    return c


class PagedState(NamedTuple):
    """Cross-layer decode state passed with every layer's cache."""

    block_tables: torch.Tensor  # [slots, max_pages] int32 page ids
    seq_lens: torch.Tensor      # [slots] int32, tokens already in cache


def _quantized(cache: PagedLayerCache) -> bool:
    """Whether ``cache`` is an int8 pool; raises on a pool whose payload
    and scales disagree."""
    quant = cache.k_scale is not None
    if quant != (cache.v_scale is not None) \
            or quant != (cache.k_pages.dtype == torch.int8):
        raise ValueError("an int8 pool needs k_scale and v_scale, and a "
                         "float pool neither")
    return quant


def init_paged_pool(n_layers: int, n_pages: int, page_size: int,
                    kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                    device="cuda"):
    """Zeroed pools, one ``PagedLayerCache`` per layer, each
    ``[kv_heads, n_pages, page_size, head_dim]`` on ``device``. An int8
    ``dtype`` adds zeroed float32 scale arrays ``[kv_heads, n_pages,
    page_size, 1]`` (a zero payload times a zero scale reads as the zeros
    a float pool starts with; every row read is appended first)."""
    if dtype != torch.int8 and not dtype.is_floating_point:
        raise ValueError(f"pool dtype must be a float dtype or int8; got "
                         f"{dtype}")
    dev = resolve_device(device)
    shape = (kv_heads, n_pages, page_size, head_dim)
    sshape = (kv_heads, n_pages, page_size, 1)

    def scale():
        return (torch.zeros(sshape, dtype=torch.float32, device=dev)
                if dtype == torch.int8 else None)

    return [PagedLayerCache(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev),
                            scale(), scale())
            for _ in range(n_layers)]


def _store(cache: PagedLayerCache, pages, offs, k, v):
    """Write rows ``k``/``v`` [kvh, *idx, d] (head-major) at pool
    positions ``[:, pages, offs]``: rounded to a float pool's dtype, or
    quantized with their scales into an int8 pool."""
    if _quantized(cache):
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        cache.k_pages[:, pages, offs] = kq
        cache.v_pages[:, pages, offs] = vq
        cache.k_scale[:, pages, offs, 0] = ks
        cache.v_scale[:, pages, offs, 0] = vs
    else:
        cache.k_pages[:, pages, offs] = k.to(cache.k_pages.dtype)
        cache.v_pages[:, pages, offs] = v.to(cache.v_pages.dtype)


def append_kv(cache: PagedLayerCache, state: PagedState, k, v
              ) -> PagedLayerCache:
    """Write one token's K/V per slot at its current length, in place.

    k, v: [slots, 1, kv_heads, head_dim]. Slot i's row lands on page
    ``block_tables[i, len_i // page_size]`` at offset ``len_i %
    page_size``; a block index past the table reads its last entry, as
    JAX's gather clamps it. An int8 pool stores the quantized row and its
    scale at the same (page, offset)."""
    page_size = cache.k_pages.shape[2]
    bt = state.block_tables
    lens = state.seq_lens.long()
    page_idx = (lens // page_size).clamp(max=bt.shape[1] - 1)
    pages = bt[torch.arange(bt.shape[0], device=bt.device),
               page_idx].long()
    offs = lens % page_size
    # destination [kvh, pages[i], offs[i]] <- k[i, 0, h], head-major
    _store(cache, pages, offs, k[:, 0].transpose(0, 1),
           v[:, 0].transpose(0, 1))
    return cache


def append_kv_chunk(cache: PagedLayerCache, state: PagedState, k, v,
                    start) -> PagedLayerCache:
    """Write a chunk of tokens per slot through the block table, in place.

    k, v: [slots, s, kv_heads, head_dim]; ``start``: [slots], slot i's
    rows land at positions ``start[i] .. start[i]+s-1``. Rows past the
    block table's span (the engine's ``start = max_len`` sentinel, the
    tail of a chunk crossing ``max_len``) go to the sink page 0, scale
    rows included, where JAX drops them: without a host sync, and never
    onto a real page."""
    page_size = cache.k_pages.shape[2]
    bt = state.block_tables
    s = k.shape[1]
    max_pages = bt.shape[1]
    pos = start.long()[:, None] + torch.arange(s, device=k.device)[None, :]
    page_idx = pos // page_size
    offs = pos % page_size
    valid = page_idx < max_pages
    pages = torch.gather(bt.long(), 1, page_idx.clamp(max=max_pages - 1))
    pages = torch.where(valid, pages, SINK_PAGE)
    # value laid out head-major to match the pool: [kvh, slots, s, d]
    _store(cache, pages, offs, k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3))
    return cache


def gather_kv(cache: PagedLayerCache, state: PagedState
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's logical KV view, [slots, max_pages * page_size,
    kv_heads, d] (a dense copy; the attention mask hides the tail). An
    int8 pool is dequantized (payload times its row scale, float32)."""
    quant = _quantized(cache)
    bt = state.block_tables.long()
    slots, max_pages = bt.shape
    kvh, _, page_size, d = cache.k_pages.shape
    k = cache.k_pages[:, bt]  # [kvh, slots, max_pages, page_size, d]
    v = cache.v_pages[:, bt]
    if quant:
        k = k.float() * cache.k_scale[:, bt]
        v = v.float() * cache.v_scale[:, bt]
    k = k.reshape(kvh, slots, max_pages * page_size, d)
    v = v.reshape(kvh, slots, max_pages * page_size, d)
    return k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)


def paged_attention(q, cache: PagedLayerCache, state: PagedState,
                    scale=None):
    """Decode attention over the paged pool.

    q: [slots, 1, heads, head_dim] (heads a multiple of kv_heads). The
    current token's K/V must already be appended: slot i attends rows
    ``0..seq_lens[i]`` inclusive. Returns [slots, 1, heads, head_dim].
    Float pools launch the block-table kernel on CUDA tensors
    (``kernels/paged_attention.py: paged_decode_attention``) or raise, and
    run ``dense_paged_attention`` on CPU tensors. Int8 pools take
    ``dense_paged_attention`` on either device, as the JAX dispatch does:
    the block-table kernel has no dequantization path, and the fused
    kernel is the int8 decode path."""
    from ..kernels.paged_attention import paged_decode_attention

    if _quantized(cache):
        return dense_paged_attention(q, cache, state, scale=scale)
    slots, _, h, d = q.shape
    kvh = cache.k_pages.shape[0]
    if h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} "
                         "kv heads")
    out = paged_decode_attention(
        q[:, 0].reshape(slots, kvh, h // kvh, d).contiguous(),
        cache.k_pages, cache.v_pages, state.block_tables, state.seq_lens,
        scale=scale)
    return out.reshape(slots, 1, h, d)


def dense_paged_attention(q, cache: PagedLayerCache, state: PagedState,
                          scale=None):
    """Dense-gather decode attention: the plain version of the
    block-table kernel. Materializes each slot's whole view, masks rows
    past ``seq_lens[i]``, and attends in float32."""
    slots, _, h, d = q.shape
    k, v = gather_kv(cache, state)  # [slots, ctx, kvh, d]
    ctx, kvh = k.shape[1], k.shape[2]
    if h != kvh:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qf = q.float() * scale
    s = torch.einsum("sqhd,skhd->shqk", qf, k.float())
    mask = torch.arange(ctx, device=q.device)[None, :] \
        <= state.seq_lens.long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shqk,skhd->sqhd", p, v.float())
    return out.to(q.dtype)


class PagePool:
    """Host-side page allocator (free list) with refcounts, and the
    block-table mirror the engine uploads to the device.

    ``ref[p]`` counts owners (each slot holding p in its block table,
    plus a prefix store that retains it). A page returns to the free list
    only at refcount 0; a slot must never write a page with refcount > 1:
    the engine copies it first (``cow``)."""

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int, reserve_sink: bool = False):
        """``reserve_sink``: keep page 0 out of circulation as a write
        sink for inactive slots (their block tables point at it)."""
        self.n_pages = n_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages_per_slot = max_pages_per_slot
        self.reserve_sink = reserve_sink
        first = 1 if reserve_sink else 0
        self._free = list(range(n_pages - 1, first - 1, -1))
        self.block_tables = np.zeros((slots, max_pages_per_slot), np.int32)
        self.pages_of: dict = {i: [] for i in range(slots)}
        self.ref: dict = {}  # page id -> owner count (absent == 0)
        self.shared_pages = 0  # pages with ref > 1

    def _bump(self, page: int):
        n = self.ref.get(page, 0) + 1
        self.ref[page] = n
        if n == 2:
            self.shared_pages += 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Ensure slot has pages for n_tokens total; False if pool full."""
        have = len(self.pages_of[slot])
        need = self.pages_needed(n_tokens) - have
        if need > len(self._free) or \
                have + max(need, 0) > self.max_pages_per_slot:
            return False
        for _ in range(max(need, 0)):
            p = self._free.pop()
            self.block_tables[slot, len(self.pages_of[slot])] = p
            self.pages_of[slot].append(p)
            self.ref[p] = 1
        return True

    def adopt(self, slot: int, pages) -> bool:
        """Place already-populated ``pages`` at the front of an empty
        slot's block table (refcount + 1 each); the caller tops the rest
        up with ``alloc``. False if the list alone would exceed the
        per-slot maximum (nothing adopted)."""
        if self.pages_of[slot]:
            raise ValueError(f"adopt() needs an empty slot; slot {slot} "
                             f"holds {len(self.pages_of[slot])} pages")
        if len(pages) > self.max_pages_per_slot:
            return False
        for p in pages:
            self.block_tables[slot, len(self.pages_of[slot])] = p
            self.pages_of[slot].append(p)
            self._bump(p)
        return True

    def retain(self, page: int):
        """Add an owner (a prefix store pinning a page)."""
        self._bump(page)

    def release(self, page: int):
        """Drop an owner; the page frees at refcount 0. Releasing an
        un-owned page is a double free and raises."""
        was = self.ref.get(page, 0)
        if was <= 0:
            raise ValueError(f"release() of un-owned page {page}")
        if was == 2:
            self.shared_pages -= 1
        if was == 1:
            self.ref.pop(page, None)
            self._free.append(page)
        else:
            self.ref[page] = was - 1

    def cow(self, slot: int, block_idx: int) -> Optional[int]:
        """Copy-on-write bookkeeping: swap the (shared) page at
        ``block_idx`` of this slot for a fresh private one. Returns the
        new page id (the caller copies old to new on the device before
        any write), or None when the free list is empty."""
        if not self._free:
            return None
        old = self.pages_of[slot][block_idx]
        new = self._free.pop()
        self.pages_of[slot][block_idx] = new
        self.block_tables[slot, block_idx] = new
        self.ref[new] = 1
        self.release(old)
        return new

    def free(self, slot: int):
        for p in reversed(self.pages_of[slot]):
            self.release(p)
        self.pages_of[slot] = []
        self.block_tables[slot] = 0

    def device_state(self, seq_lens, device="cuda") -> PagedState:
        """A snapshot of the block table and ``seq_lens`` as int32 tensors
        on ``device``. ``torch.tensor`` copies, so later host-side
        ``alloc``/``free`` never reach work already queued."""
        dev = resolve_device(device)
        return PagedState(
            block_tables=torch.tensor(self.block_tables, device=dev),
            seq_lens=torch.tensor(np.asarray(seq_lens, np.int32),
                                  device=dev))
