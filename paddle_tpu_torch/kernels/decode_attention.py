"""Fused single-pass decode attention over contiguous per-slot KV caches
(counterpart of ``paddle_tpu/kernels/decode_attention.py``).

One call per decoder layer and decode step rotates the new token's query
and key (RoPE), appends its K/V row in place at each slot's length, and
attends over rows ``0..seq_lens[i]``. Int8 caches (``k_scale``/``v_scale``
set) quantize the appended row per head and attend over the dequantized
cache, as the JAX kernel's int8 branch does. On the card the wrapper
launches the hand-written Hopper kernel in ``csrc/decode_attention.cu``;
for tensors on the CPU it runs the plain PyTorch version beside it, a port
of the JAX package's unfused reference ``fused_contiguous_decode_reference``.
A CUDA tensor never falls back to the plain version: the wrapper launches
the kernel or raises.

The kernel (shared with the paged wrappers) splits each (slot, kv head,
head block) stream over a thread-block cluster of ``ranks`` CTAs. The
launch plan (``_decode_plan``) comes from the host's shapes and the card's
occupancy only, never from ``seq_lens`` (reading them would synchronise
every decode step); the rows each rank takes are computed on the device
from the slot's length (``csrc/decode_common.cuh: split_decode_kernel``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import flags
from ..inference.paged import quantize_kv_rows
from ._card import SMS, clusters_model, held_clusters, sm_count
from .rope import apply_rope

NEG_INF = -1e30  # paddle_tpu/kernels/paged_attention.py: NEG_INF

# kernel launches by ``fused_contiguous_decode_attention`` in this
# process: one per call on CUDA tensors, none for the plain version
LAUNCHES = 0

_ACT_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_CACHE_TAG = {torch.float32: "f32", torch.float16: "f16",
              torch.bfloat16: "bf16", torch.int8: "i8"}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
             + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# The split kernel's geometry (csrc/decode_common.cuh: SplitGeo): CTAs of
# 8 warps (4 where a cache row is over 512 bytes), each warp streaming
# 8-row tiles through a ring of 2-4 of them; clusters of 1, 2, 4 or 8 CTAs
# a stream
TILE_ROWS = 8
RING_BYTES = 8192  # a warp's ring of tiles, about
RANK_CHOICES = (1, 2, 4, 8)


def contiguous_chunk(max_len: int) -> int:
    """The JAX kernel's streaming granularity over the cache rows,
    gcd(max_len, 128). The Hopper kernel needs no chunk: it splits the
    rows over its plan's cluster ranks in 8-row tiles; tests use it to
    place ragged lengths on chunk boundaries of the reference."""
    return math.gcd(max_len, 128)


# ---------------------------------------------------------------------------
# launch plan of the split kernel (rows 1-3)
# ---------------------------------------------------------------------------
class DecodePlan(NamedTuple):
    ranks: int     # CTAs of a cluster along a stream's rows
    hpb: int       # query heads of a CTA
    warps: int     # warps of a CTA
    clusters: int  # streams: slots x kv heads x head blocks
    smem: int      # dynamic shared memory bytes of a CTA
    held: int      # clusters of this plan the card holds at once


def heads_per_block(group: int) -> int:
    """Query heads a CTA takes from a GQA group of ``group``: 1, 2, 4 or
    8 (a group of 16 takes two CTAs)."""
    return 1 if group <= 1 else 2 if group <= 2 else 4 if group <= 4 else 8


def split_warps(d: int, itemsize: int) -> int:
    """Warps of a split CTA: 8, or 4 where a cache row is over 512
    bytes (so that the rings fit)."""
    return 8 if d * itemsize <= 512 else 4


def _smem_bytes(d: int, itemsize: int, quant: bool, hpb: int) -> int:
    """A CTA's dynamic shared memory, as ``csrc/decode_common.cuh:
    SplitGeo::smem`` sizes it: a ring a warp of 2-4 stages (about
    ``RING_BYTES``) of an 8-row K tile, an 8-row V tile and, int8, their
    16 scales; or, if larger, the merge after the row loop (each warp's
    and the CTA's acc, m and l per query head)."""
    warps = split_warps(d, itemsize)
    stage = 2 * TILE_ROWS * d * itemsize + (2 * TILE_ROWS * 4 if quant else 0)
    stages = min(4, max(2, RING_BYTES // stage))
    merge = 4 * ((warps + 1) * hpb * d + 2 * (warps + 1) * hpb)
    return max(warps * stages * stage, merge)


def _decode_plan(slots: int, kvh: int, group: int, d: int, span: int,
                 itemsize: int, quant: bool, clusters=None,
                 sms: int = SMS) -> DecodePlan:
    """The geometry of one split launch over ``slots`` slots, ``kvh`` kv
    heads of ``group`` query heads, head dim ``d`` and streams of at most
    ``span`` rows (``max_len``, or ``max_pages * page_size``) of
    ``itemsize``-byte elements (``quant``: int8 with scales), on a card of
    ``sms`` SMs: the most ranks (of ``RANK_CHOICES``, each with at least a
    tile of the longest stream) whose clusters the card holds all at once
    (``clusters(plan)``, by default ``_card.clusters_model``), else one.
    A rank's rows run on its own warps at once, so more ranks shorten a
    stream until a second wave of clusters costs as much as the first.
    Only host shapes go in: never the lengths."""
    hpb = heads_per_block(group)
    warps = split_warps(d, itemsize)
    streams = slots * kvh * -(-group // hpb)
    smem = _smem_bytes(d, itemsize, quant, hpb)
    best = None
    for ranks in RANK_CHOICES:
        if ranks > 1 and span < ranks * TILE_ROWS:
            break
        plan = DecodePlan(ranks, hpb, warps, streams, smem, 0)
        held = (clusters(plan) if clusters else
                clusters_model(32 * warps, smem, ranks, sms))
        plan = plan._replace(held=held)
        if best is None or streams <= held:
            best = plan
    return best


# the occupancy entry of each layout's kernel: rows 1 ("contig") and 2
# ("paged"), and row 3 ("table", the block-table kernel), whose static
# shared memory and registers differ from row 2's
_PLAN_ENTRY = {"contig": "pt_fused_contig_decode_plan_",
               "paged": "pt_fused_paged_decode_plan_",
               "table": "pt_paged_decode_plan_"}


def _card_clusters(layout: str, cache_dtype, group: int, d: int):
    """``_decode_plan``'s ``clusters`` on the card: how many clusters of a
    plan the card holds at once (``_card.held_clusters`` through the
    layout's ``_PLAN_ENTRY``, which refuses a plan the kernels do not take
    and sizes its shared memory as the launch does)."""
    from . import _build

    out = ctypes.POINTER(ctypes.c_int)
    fn = getattr(_build.library(),
                 _PLAN_ENTRY[layout] + _CACHE_TAG[cache_dtype])
    fn.argtypes = [ctypes.c_int] * 3 + [out, out]
    fn.restype = ctypes.c_int

    def held(plan):
        return held_clusters(fn, (group, d, plan.ranks), plan,
                             f"{layout} decode")

    return held


_PLANS = {}  # the card's plans by their arguments: each found once


def _card_plan(device, layout: str, cache_dtype, slots: int, kvh: int,
               group: int, d: int, span: int) -> DecodePlan:
    """``_decode_plan`` for a launch on the card ``device`` (``layout``
    ``"contig"``, ``"paged"`` or ``"table"``: rows 1, 2 and 3), with its
    occupancy answers and SM count; computed once per shape and cache
    dtype."""
    key = (device, layout, cache_dtype, slots, kvh, group, d, span)
    if key not in _PLANS:
        itemsize = torch.empty((), dtype=cache_dtype).element_size()
        _PLANS[key] = _decode_plan(
            slots, kvh, group, d, span, itemsize,
            cache_dtype == torch.int8,
            _card_clusters(layout, cache_dtype, group, d), sm_count(device))
    return _PLANS[key]


def fused_decode_active() -> bool:
    """The ``PT_FLAGS_fused_decode`` gate. ``auto`` and ``on`` take the
    fused path: the kernel for CUDA tensors, the plain fused version for
    CPU tensors. ``off`` takes the unfused llama branch on either device,
    the JAX package's own parity oracle."""
    val = str(flags.flag("fused_decode")).lower()
    if val in ("off", "0", "false", "no"):
        return False
    if val in ("auto", "on", "1", "true", "yes"):
        return True
    raise ValueError(f"PT_FLAGS_fused_decode must be auto|on|off; got {val!r}")


def _rope_rotate(x, positions, cos, sin):
    """x: [slots, heads, d], one token per slot, rotated at each slot's
    position through ``rope.apply_rope`` (the model path's convention)."""
    x4 = x[:, None]
    out, _ = apply_rope(x4, x4, cos, sin, positions[:, None])
    return out[:, 0]


def fused_contiguous_decode_plain(q, k_new, v_new, ck, cv, seq_lens,
                                  positions, cos, sin, scale=None,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version of the fused kernel, ported from the JAX
    package's ``fused_contiguous_decode_reference``: rope, per-slot
    append, then dense masked attention in float32 over the whole
    ``[slots, max_len]`` cache. Int8 caches (``k_scale``/``v_scale``
    float32 [slots, max_len, kv_heads]): the appended row is quantized
    from its float32 rotation with ``quantize_kv_rows`` and attention
    reads the dequantized cache.
    Caches and scales are updated in place (the JAX version returns
    updated copies); returns ``(out, ck, cv)``, plus ``(k_scale,
    v_scale)`` for int8 caches."""
    slots, kvh, group, d = q.shape
    max_len = ck.shape[1]
    if scale is None:
        scale = d ** -0.5
    quant = k_scale is not None
    qr = _rope_rotate(q.reshape(slots, kvh * group, d), positions,
                      cos, sin).reshape(slots, kvh, group, d)
    # int8: the row is quantized from its float32 rotation, as the kernel
    # (and the JAX kernel) quantize it
    kr = _rope_rotate(k_new.float() if quant else k_new, positions, cos,
                      sin)
    lens = seq_lens.long()
    rows = torch.arange(slots, device=q.device)
    if quant:
        kq, ks = quantize_kv_rows(kr)
        vq, vs = quantize_kv_rows(v_new)
        ck[rows, lens] = kq
        cv[rows, lens] = vq
        k_scale[rows, lens] = ks
        v_scale[rows, lens] = vs
        kf = ck.float() * k_scale[..., None]
        vf = cv.float() * v_scale[..., None]
    else:
        ck[rows, lens] = kr.to(ck.dtype)
        cv[rows, lens] = v_new.to(cv.dtype)
        kf, vf = ck.float(), cv.float()
    k = kf.repeat_interleave(group, dim=2)
    v = vf.repeat_interleave(group, dim=2)
    qf = qr.reshape(slots, kvh * group, 1, d).float() * scale
    s = torch.einsum("shqd,skhd->shqk", qf, k)
    mask = torch.arange(max_len, device=q.device)[None, :] <= lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shqk,skhd->shqd", p, v)
    out = out[:, :, 0].reshape(slots, kvh, group, d).to(q.dtype)
    if quant:
        return out, ck, cv, k_scale, v_scale
    return out, ck, cv


def _check_scales(payload, k_scale, v_scale, shape, what):
    """Int8 payloads need float32 scales of ``shape``, float payloads
    none; raises ``ValueError`` otherwise."""
    if payload.dtype != torch.int8:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"k_scale/v_scale are for int8 {what} only")
        return
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None:
            raise ValueError(f"int8 {what} need k_scale and v_scale")
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be float32 {list(shape)}; got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on "
                             f"{payload.device}")


def _check(q, k_new, v_new, ck, cv, seq_lens, positions, cos, sin,
           k_scale=None, v_scale=None):
    slots, kvh, group, d = q.shape
    dev = q.device
    named = dict(q=q, k_new=k_new, v_new=v_new, ck=ck, cv=cv,
                 seq_lens=seq_lens, positions=positions, cos=cos, sin=sin)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _ACT_CODE or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise ValueError(
            f"q/k_new/v_new must share one of {list(_ACT_CODE)}; got "
            f"{q.dtype}, {k_new.dtype}, {v_new.dtype}")
    if ck.dtype not in _CACHE_TAG or cv.dtype != ck.dtype:
        raise ValueError(
            f"ck/cv must share one of {list(_CACHE_TAG)}; got {ck.dtype}, "
            f"{cv.dtype}")
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 in "
                         f"[32, 256]; got {d}")
    if not 1 <= group <= 16:
        raise ValueError(f"group must be in [1, 16]; got {group}")
    max_len = ck.shape[1]
    if tuple(k_new.shape) != (slots, kvh, d) \
            or tuple(v_new.shape) != (slots, kvh, d):
        raise ValueError("k_new/v_new must be [slots, kv_heads, d]")
    if tuple(ck.shape) != (slots, max_len, kvh, d) \
            or tuple(cv.shape) != tuple(ck.shape):
        raise ValueError("ck/cv must be [slots, max_len, kv_heads, d]")
    for name, t in (("seq_lens", seq_lens), ("positions", positions)):
        if t.dtype != torch.int32 or tuple(t.shape) != (slots,):
            raise ValueError(f"{name} must be int32 [slots]")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != d // 2:
            raise ValueError(f"{name} must be float32 [max_pos, d/2]")
    if cos.shape != sin.shape:
        raise ValueError("cos and sin must have one shape")
    for name, t in (("ck", ck), ("cv", cv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check_scales(ck, k_scale, v_scale, (slots, max_len, kvh), "caches")


def fused_contiguous_decode_attention(q, k_new, v_new, ck, cv, seq_lens,
                                      positions, cos, sin, scale=None,
                                      k_scale=None, v_scale=None):
    """RoPE(q, k_new) + append (k_new, v_new) at each slot's length +
    attention over rows ``0..seq_lens[i]``, one kernel per layer.

    q: [slots, kv_heads, group, d], unrotated; k_new/v_new:
    [slots, kv_heads, d]; ck/cv: [slots, max_len, kv_heads, d] in bf16,
    f16, f32 or int8, UPDATED IN PLACE (JAX gets the same effect from
    donation and ``input_output_aliases``); seq_lens: [slots] int32,
    tokens already cached; positions: [slots] int32 RoPE positions;
    cos/sin: [max_pos, d/2] float32. The appended row is rounded to the
    cache dtype and attention reads the rounded values. Int8 caches need
    ``k_scale``/``v_scale`` float32 [slots, max_len, kv_heads], also
    updated in place: the appended row is quantized per head
    (``quantize_kv_rows``) and attention reads ``q * scale``.

    Precondition (the serving engine guarantees it, and the wrapper
    cannot check it without a device sync): ``seq_lens[i] < max_len`` and
    ``positions[i] < max_pos``; the kernel clamps values outside.

    Returns ``(out [slots, kv_heads, group, d] in q's dtype, ck, cv)``,
    plus ``(k_scale, v_scale)`` for int8 caches. CPU tensors run
    ``fused_contiguous_decode_plain``; CUDA tensors launch the kernel on
    the current stream without synchronising, or raise.
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return fused_contiguous_decode_plain(q, k_new, v_new, ck, cv,
                                             seq_lens, positions, cos, sin,
                                             scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_new, v_new, ck, cv, seq_lens, positions, cos, sin, k_scale,
           v_scale)
    from . import _build

    slots, kvh, group, d = q.shape
    if scale is None:
        scale = d ** -0.5
    fn = getattr(_build.library(),
                 f"pt_fused_contig_decode_{_CACHE_TAG[ck.dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        plan = _card_plan(q.device, "contig", ck.dtype, slots, kvh, group,
                          d, ck.shape[1])
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 _ACT_CODE[q.dtype], ck.data_ptr(), cv.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), seq_lens.data_ptr(),
                 positions.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 out.data_ptr(), slots, kvh, group, d,
                 ck.shape[1], cos.shape[0], float(scale), plan.ranks,
                 stream)
    if err != 0:
        raise RuntimeError(
            f"fused decode attention kernel failed to launch: CUDA error "
            f"{err}")
    LAUNCHES += 1
    if k_scale is not None:
        return out, ck, cv, k_scale, v_scale
    return out, ck, cv


def _ptr(t):
    """A tensor's device address, or None (a null pointer) for no
    tensor."""
    return None if t is None else t.data_ptr()
