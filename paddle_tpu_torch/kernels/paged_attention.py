"""Decode attention over the paged KV pool (counterpart of
``paddle_tpu/kernels/paged_attention.py``).

Two entry points, each with its plain PyTorch version beside it:

- ``fused_paged_decode_attention``: per decoder layer and decode step,
  RoPE of the new token's query and key, an in-place append of its K/V
  row through the block table, and attention over rows ``0..seq_lens[i]``;
  on int8 pools it quantizes the appended row and attends over the
  dequantized pool, as the JAX kernel's int8 branch does. Plain version:
  ``fused_paged_decode_plain``, a port of the JAX package's
  ``fused_paged_decode_reference`` (rope, ``append_kv``,
  ``dense_paged_attention``).
- ``paged_decode_attention``: block-table decode attention over an
  already-appended float pool, no RoPE or append. Plain version:
  ``paged_decode_plain`` (``dense_paged_attention`` on the
  ``[slots, kv_heads, group, d]`` view). Like the JAX kernel it has no
  int8 path and raises for int8 pools, which ``inference.paged.
  paged_attention`` sends to ``dense_paged_attention``.

On the card each wrapper launches its hand-written Hopper kernel in
``csrc/paged_attention.cu``; for tensors on the CPU it runs the plain
version. Both kernels are the split kernel of the contiguous wrapper over
the block table (the block-table one with no RoPE or append, every row
read from the pool), launched by the same plan
(``decode_attention._decode_plan``, asked of each kernel's own occupancy
entry). A CUDA tensor never falls back to the plain version: the wrapper
launches the kernel or raises. Unlike the
TPU kernels, whose tiling rule sends untiled shapes to the dense path,
the Hopper kernels take every supported shape (below) and the wrappers
raise for the rest.
"""

from __future__ import annotations

import ctypes

import torch

from . import _ops
from ..inference.paged import (  # noqa: F401  (KV_QUANT_EPS: re-export)
    KV_QUANT_EPS,
    PagedLayerCache,
    PagedState,
    append_kv,
    dense_paged_attention,
)
from .decode_attention import (
    _ACT_CODE,
    _CACHE_TAG,
    _card_plan,
    _check_scales,
    _ptr,
    _rope_rotate,
)

# kernel launches in this process, by wrapper: one per call on CUDA
# tensors, none for the plain versions
LAUNCHES = {"fused_paged_decode_attention": 0, "paged_decode_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUSED_ARGTYPES = [_P, _P, _P, _I] + [_P] * 10 + [_I] * 8 + [_F, _I, _P]
_DECODE_ARGTYPES = [_P, _I] + [_P] * 5 + [_I] * 7 + [_F, _I, _P]


def paged_decode_plain(q, k_pages, v_pages, block_tables, seq_lens,
                       scale=None):
    """Plain version of the block-table kernel: ``dense_paged_attention``
    on ``q`` [slots, kv_heads, group, d]."""
    slots, kvh, group, d = q.shape
    out = dense_paged_attention(
        q.reshape(slots, 1, kvh * group, d),
        PagedLayerCache(k_pages, v_pages),
        PagedState(block_tables, seq_lens), scale=scale)
    return out[:, 0].reshape(slots, kvh, group, d)


def fused_paged_decode_plain(q, k_new, v_new, k_pages, v_pages,
                             block_tables, seq_lens, positions, cos, sin,
                             scale=None, k_scale=None, v_scale=None):
    """Plain version of the fused kernel, ported from the JAX package's
    ``fused_paged_decode_reference``: rope, ``append_kv`` through the
    block table (quantize-on-append for an int8 pool), then dense
    gathered attention in float32 (over the dequantized pool). Pools and
    scales are updated in place (the JAX version returns updated copies);
    returns ``(out, k_pages, v_pages)``, plus ``(k_scale, v_scale)`` for
    an int8 pool."""
    slots, kvh, group, d = q.shape
    qr = _rope_rotate(q.reshape(slots, kvh * group, d), positions,
                      cos, sin).reshape(slots, kvh, group, d)
    # int8: the row is quantized from its float32 rotation, as the kernel
    # (and the JAX kernel) quantize it
    kr = _rope_rotate(k_new if k_scale is None else k_new.float(),
                      positions, cos, sin)
    cache = PagedLayerCache(k_pages, v_pages, k_scale, v_scale)
    state = PagedState(block_tables, seq_lens)
    append_kv(cache, state, kr[:, None], v_new[:, None])
    out = dense_paged_attention(qr.reshape(slots, 1, kvh * group, d),
                                cache, state, scale=scale)
    out = out[:, 0].reshape(slots, kvh, group, d)
    if k_scale is not None:
        return out, k_pages, v_pages, k_scale, v_scale
    return out, k_pages, v_pages


def _check(q, k_pages, v_pages, block_tables, seq_lens, k_scale=None,
           v_scale=None, **fused):
    """The shapes, dtypes and layouts the kernels take; raises
    ``ValueError`` for anything else. ``fused`` holds k_new, v_new,
    positions, cos and sin for the fused kernel; ``k_scale``/``v_scale``
    the float32 scales of an int8 pool."""
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                 block_tables=block_tables, seq_lens=seq_lens, **fused)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4:
        raise ValueError("q must be [slots, kv_heads, group, d]")
    slots, kvh, group, d = q.shape
    if q.dtype not in _ACT_CODE:
        raise ValueError(f"q must be one of {list(_ACT_CODE)}; got "
                         f"{q.dtype}")
    if k_pages.dtype not in _CACHE_TAG or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"k_pages/v_pages must share one of "
                         f"{list(_CACHE_TAG)}; got {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 in [32, 256]; "
                         f"got {d}")
    if not 1 <= group <= 16:
        raise ValueError(f"group must be in [1, 16]; got {group}")
    if k_pages.dim() != 4 or tuple(k_pages.shape[::3]) != (kvh, d) \
            or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages/v_pages must be [kv_heads, n_pages, "
                         "page_size, d]")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != slots:
        raise ValueError("block_tables must be int32 [slots, max_pages]")
    if seq_lens.dtype != torch.int32 or tuple(seq_lens.shape) != (slots,):
        raise ValueError("seq_lens must be int32 [slots]")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check_scales(k_pages, k_scale, v_scale, (*k_pages.shape[:3], 1),
                  "pools")
    if not fused:
        return
    for name in ("k_new", "v_new"):
        t = fused[name]
        if t.dtype != q.dtype or tuple(t.shape) != (slots, kvh, d):
            raise ValueError(f"{name} must be [slots, kv_heads, d] in q's "
                             "dtype")
    pos = fused["positions"]
    if pos.dtype != torch.int32 or tuple(pos.shape) != (slots,):
        raise ValueError("positions must be int32 [slots]")
    cos, sin = fused["cos"], fused["sin"]
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != d // 2:
            raise ValueError(f"{name} must be float32 [max_pos, d/2]")
    if cos.shape != sin.shape:
        raise ValueError("cos and sin must have one shape")


def _kernel(name: str, argtypes):
    from . import _build

    fn = getattr(_build.library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launched(wrapper: str, err: int):
    if err != 0:
        raise RuntimeError(f"{wrapper} kernel failed to launch: CUDA error "
                           f"{err}")
    LAUNCHES[wrapper] += 1


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           scale=None):
    """Block-table decode attention; slot i attends rows
    ``0..seq_lens[i]`` inclusive (the current token already appended).

    q: [slots, kv_heads, group, d] in f32, bf16 or f16; k_pages/v_pages:
    [kv_heads, n_pages, page_size, d] in bf16, f16 or f32, read only
    (int8 pools raise: this kernel has no dequantization path);
    block_tables: [slots, max_pages] int32 page ids; seq_lens: [slots]
    int32. Precondition (the engine guarantees it; the kernel clamps
    values outside): ``seq_lens[i] < max_pages * page_size`` and page ids
    lie in the pool. Returns [slots, kv_heads, group, d] in q's dtype.

    CPU tensors run ``paged_decode_plain``; CUDA tensors launch the
    kernel on the current stream without synchronising, or raise."""
    _ops.check_device(q, "the block-table decode kernel")
    return PAGED_OP(q, k_pages, v_pages, block_tables, seq_lens,
                    float(q.shape[-1] ** -0.5 if scale is None else scale))


def _paged_cuda(q, k_pages, v_pages, block_tables, seq_lens, scale):
    if k_pages.dtype == torch.int8:
        raise ValueError("the block-table decode kernel takes float pools "
                         "only; int8 pools decode through "
                         "fused_paged_decode_attention or "
                         "dense_paged_attention")
    _check(q, k_pages, v_pages, block_tables, seq_lens)
    slots, kvh, group, d = q.shape
    _, n_pages, page_size, _ = k_pages.shape
    fn = _kernel(f"pt_paged_decode_{_CACHE_TAG[k_pages.dtype]}",
                 _DECODE_ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        plan = _card_plan(q.device, "table", k_pages.dtype, slots, kvh,
                          group, d, block_tables.shape[1] * page_size)
        err = fn(q.data_ptr(), _ACT_CODE[q.dtype], k_pages.data_ptr(),
                 v_pages.data_ptr(), block_tables.data_ptr(),
                 seq_lens.data_ptr(), out.data_ptr(), slots, kvh, group, d,
                 n_pages, page_size, block_tables.shape[1], float(scale),
                 plan.ranks, torch.cuda.current_stream().cuda_stream)
    _launched("paged_decode_attention", err)
    return out


def _paged_plain(q, k_pages, v_pages, block_tables, seq_lens, scale):
    return paged_decode_plain(q, k_pages, v_pages, block_tables, seq_lens,
                              scale).contiguous()


PAGED_OP = _ops.define(
    "paged_decode",
    "(Tensor q, Tensor k_pages, Tensor v_pages, Tensor block_tables, "
    "Tensor seq_lens, float scale) -> Tensor", 3, _paged_plain, _paged_cuda,
    lambda q, *a: q.new_empty(q.shape))


def fused_paged_decode_attention(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, seq_lens, positions, cos,
                                 sin, scale=None, k_scale=None,
                                 v_scale=None):
    """RoPE(q, k_new) + append (k_new, v_new) through the block table +
    attention over rows ``0..seq_lens[i]``, one kernel per layer.

    q: [slots, kv_heads, group, d], unrotated; k_new/v_new:
    [slots, kv_heads, d] in q's dtype; k_pages/v_pages:
    [kv_heads, n_pages, page_size, d] in bf16, f16 or f32, UPDATED IN
    PLACE (JAX aliases them into its outputs); block_tables:
    [slots, max_pages] int32; seq_lens: [slots] int32, tokens already
    cached, so slot i's row lands on page ``block_tables[i, seq_lens[i] //
    page_size]`` at row ``seq_lens[i] % page_size``; positions: [slots]
    int32 RoPE positions; cos/sin: [max_pos, d/2] float32. The appended
    row is rounded to the pool dtype and attention reads the rounded
    values. An int8 pool needs ``k_scale``/``v_scale`` float32
    [kv_heads, n_pages, page_size, 1], updated in place: the appended row
    is quantized per head (``quantize_kv_rows``) and its scale stored at
    the same (page, row); attention reads ``q * scale``.

    Precondition (the engine guarantees it; the kernel clamps values
    outside): ``seq_lens[i] < max_pages * page_size``, page ids lie in the
    pool, and ``positions[i] < max_pos``.

    Returns ``(out [slots, kv_heads, group, d] in q's dtype, k_pages,
    v_pages)``, plus ``(k_scale, v_scale)`` for an int8 pool. CPU tensors
    run ``fused_paged_decode_plain``; CUDA tensors launch the kernel on
    the current stream without synchronising, or raise."""
    _ops.check_device(q, "the fused paged decode kernel")
    out = FUSED_PAGED_OP(q, k_new, v_new, k_pages, v_pages, block_tables,
                         seq_lens, positions, cos, sin,
                         float(q.shape[-1] ** -0.5 if scale is None
                               else scale), k_scale, v_scale)
    if k_scale is not None:
        return out, k_pages, v_pages, k_scale, v_scale
    return out, k_pages, v_pages


def _fused_paged_cuda(q, k_new, v_new, k_pages, v_pages, block_tables,
                      seq_lens, positions, cos, sin, scale, k_scale,
                      v_scale):
    _check(q, k_pages, v_pages, block_tables, seq_lens, k_scale, v_scale,
           k_new=k_new, v_new=v_new, positions=positions, cos=cos, sin=sin)
    slots, kvh, group, d = q.shape
    _, n_pages, page_size, _ = k_pages.shape
    fn = _kernel(f"pt_fused_paged_decode_{_CACHE_TAG[k_pages.dtype]}",
                 _FUSED_ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        plan = _card_plan(q.device, "paged", k_pages.dtype, slots, kvh,
                          group, d, block_tables.shape[1] * page_size)
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 _ACT_CODE[q.dtype], k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
                 seq_lens.data_ptr(), positions.data_ptr(), cos.data_ptr(),
                 sin.data_ptr(), out.data_ptr(), slots, kvh, group, d,
                 n_pages, page_size, block_tables.shape[1], cos.shape[0],
                 float(scale), plan.ranks,
                 torch.cuda.current_stream().cuda_stream)
    _launched("fused_paged_decode_attention", err)
    return out


FUSED_PAGED_OP = _ops.define(
    "fused_paged_decode",
    "(Tensor q, Tensor k_new, Tensor v_new, Tensor(a!) k_pages, "
    "Tensor(b!) v_pages, Tensor block_tables, Tensor seq_lens, "
    "Tensor positions, Tensor cos, Tensor sin, float scale, "
    "Tensor(c!)? k_scale, Tensor(d!)? v_scale) -> Tensor", 2,
    lambda *a: fused_paged_decode_plain(*a)[0].contiguous(),
    _fused_paged_cuda, lambda q, *a: q.new_empty(q.shape))
