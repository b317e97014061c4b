"""Flash attention with its backward (counterpart of
``paddle_tpu/kernels/pallas_attention.py``).

``mha`` and ``mha_with_lse`` take ``[batch, seq, heads, head_dim]``
tensors with the JAX functions' arguments: ``causal``, ``sm_scale``,
``k_block``, ``segment_ids`` (one ``[b, s]`` array or a ``(q_ids,
kv_ids)`` pair; tokens attend only where ids match) and a sliding
``window``. The JAX ``q_block`` is not taken: it sets only the TPU's
tiling, and the CUDA tiles are the kernels' own. Any sequence lengths
are taken (the kernels mask their ragged last tiles). Grouped-query
attention (fewer kv heads) is native: K/V are never repeated in device
memory on the kernel path.

Four Hopper kernels (``csrc/flash_attention.cu``) carry it, each beside
its plain PyTorch version in this module:

- the forward, without LSE (row 5 of the kernel table,
  ``_fwd_kernel`` through ``mha``) and with LSE (row 6, the training
  forward and ``mha_with_lse``);
- the backward's dq pass (row 7) and dk/dv pass (row 9), and the fused
  pass (row 8) that writes dk, dv and float32 dq partials, one per kv span
  of ``k_block`` rows, summed here in span order.

``_FlashAttention`` (a ``torch.autograd.Function``) runs the forward with
LSE and saves ``q, k, v, o, lse`` as ``_mha_folded_fwd`` does; its
backward folds an LSE cotangent into ``delta = rowsum(do * o) - dlse``
(plain torch ops, as in JAX) and takes the fused pass when
``ceil(sk / k_block) <= 4`` (``_FUSED_BWD_MAX_KB``) and the two passes
otherwise, with ``k_block`` clamped to the sequence by ``fit_block`` (the
JAX ``_fit``). ``k_block`` only chooses the pass and the fused partials'
span: the CUDA tiles are the kernel's own.

The causal mask is aligned bottom-right, key j visible to query i iff
``j <= i + sk - sq``, as in the dense references
(``kernels/flash_attention.py: _reference_attention``). The JAX Pallas
kernel aligns it top-left; the two agree when ``sq == sk`` (ROADMAP.md
Queue C). A query row that sees no key at all is not defined.

Every wrapper runs its plain version for tensors on the CPU, and for
CUDA tensors launches its kernel on the current stream or raises; it
adds one to ``LAUNCHES[name]`` per launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_K_BLOCK = 1024
NEG_INF = -1e30
FUSED_BWD_MAX_KB = 4  # paddle_tpu/kernels/pallas_attention.py: _FUSED_BWD_MAX_KB

# kernel launches in this process, by kernel: rows 5 (forward without
# LSE), 6 (with LSE), 7 (dq pass), 8 (fused backward) and 9 (dk/dv pass)
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_fused": 0,
            "flash_attention_bwd_dkv": 0}

_TAG = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 11 + [ctypes.c_float, _P]
_PART_ROWS = 64  # the dq partials' rows are padded to a multiple of this


def fit_block(blk: int, sl: int) -> int:
    """The JAX ``_fit``: the requested block clamped to the sequence,
    halved until it divides it, else 128."""
    blk = min(blk, sl)
    while blk > 128 and sl % blk:
        blk //= 2
    if sl % blk:
        blk = 128
    return blk


def padded_head_dim(d: int) -> int:
    """The head dim the kernels pad to with zeros: 64, 128 or 256."""
    return 64 if d <= 64 else (128 if d <= 128 else 256)


def split_segments(segment_ids, q, k):
    """``segment_ids`` (None, one [b, s] array or a (q_ids, kv_ids) pair)
    as int32 ``(q_ids [b, sq], kv_ids [b, sk])`` on q's device."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        q_ids = kv_ids = segment_ids
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    q_ids = torch.as_tensor(q_ids, device=q.device).to(torch.int32)
    kv_ids = torch.as_tensor(kv_ids, device=q.device).to(torch.int32)
    if tuple(q_ids.shape) != (b, sq) or tuple(kv_ids.shape) != (b, sk):
        raise ValueError(f"segment ids must be [b, sq] = {(b, sq)} and "
                         f"[b, sk] = {(b, sk)}; got {tuple(q_ids.shape)} "
                         f"and {tuple(kv_ids.shape)}")
    return q_ids.contiguous(), kv_ids.contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _visible(sq, sk, causal, window, qseg, kseg, device):
    """Boolean [b | 1, 1, sq, sk] (True = attend), or None."""
    vis = None
    if causal or window:
        i = torch.arange(sq, device=device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=device)[None, :]
        vis = torch.ones((sq, sk), dtype=torch.bool, device=device)
        if causal:
            vis = vis & (j <= i)
        if window:
            vis = vis & ((i - j) < window)
        vis = vis[None, None]
    if qseg is not None:
        seg = qseg[:, None, :, None] == kseg[:, None, None, :]
        vis = seg if vis is None else vis & seg
    return vis


def _scores(q, k, scale, causal, window, qseg, kseg):
    """Masked scores [b, hq, sq, sk] in float32 (products of the inputs'
    values summed in float32, as the kernels' accumulators) and the kv
    heads repeated per query head."""
    rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    vis = _visible(q.shape[1], k.shape[1], causal, window, qseg, kseg,
                   q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    return s, kf


def mha_forward_plain(q, k, v, causal=False, sm_scale=None, qseg=None,
                      kseg=None, window=0):
    """Plain version of the forward kernel (rows 5-6): a dense masked
    softmax. Returns ``(o [b, sq, hq, d] in q's dtype, lse [b, hq, sq]
    float32)``; p is rounded to v's dtype before the product with V."""
    d = q.shape[-1]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    rep = q.shape[2] // k.shape[2]
    s, _ = _scores(q, k, scale, causal, window, qseg, kseg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vf = v.float().repeat_interleave(rep, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    o = o / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_ds(q, k, v, do, lse, delta, scale, causal, window, qseg, kseg):
    """p = exp(s - lse) [b, hq, sq, sk] float32 and ds = p * (dp - delta)
    * scale rounded to q's dtype, as in the backward kernels."""
    rep = q.shape[2] // k.shape[2]
    s, kf = _scores(q, k, scale, causal, window, qseg, kseg)
    p = torch.exp(s - lse[..., None])
    vf = v.float().repeat_interleave(rep, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    return p, ds, kf


def _group_sum(x, hk):
    """[b, sk, hq, d] float32 -> [b, sk, hk, d]: the GQA sum over each kv
    head's query heads."""
    b, sk, hq, d = x.shape
    return x.reshape(b, sk, hk, hq // hk, d).sum(dim=3)


def mha_bwd_dq_plain(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                     qseg=None, kseg=None, window=0):
    """Plain version of the dq pass (row 7): dq = ds k."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _, ds, kf = _p_ds(q, k, v, do, lse, delta, scale, causal, window, qseg,
                      kseg)
    return torch.einsum("bhqk,bkhd->bqhd", ds.float(), kf).to(q.dtype)


def mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                      qseg=None, kseg=None, window=0):
    """Plain version of the dk/dv pass (row 9): dv = p^T do and dk = ds^T
    q, summed over each kv head's query heads."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    p, ds, _ = _p_ds(q, k, v, do, lse, delta, scale, causal, window, qseg,
                     kseg)
    hk = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    return (_group_sum(dk, hk).to(q.dtype), _group_sum(dv, hk).to(q.dtype))


def mha_bwd_fused_plain(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None, qseg=None, kseg=None, window=0,
                        span=DEFAULT_K_BLOCK):
    """Plain version of the fused backward (row 8): p and ds once, dk and
    dv as the dk/dv pass, and dq as float32 partials over kv spans of
    ``span`` rows, summed in span order."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    p, ds, kf = _p_ds(q, k, v, do, lse, delta, scale, causal, window, qseg,
                      kseg)
    hk, sk = k.shape[2], k.shape[1]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dsf = ds.float()
    dq = None
    for s0 in range(0, sk, span):
        part = torch.einsum("bhqk,bkhd->bqhd", dsf[..., s0:s0 + span],
                            kf[:, s0:s0 + span])
        dq = part if dq is None else dq + part
    return (dq.to(q.dtype), _group_sum(dk, hk).to(q.dtype),
            _group_sum(dv, hk).to(q.dtype))


def attention_delta(o, do, dlse=None):
    """delta [b, hq, sq] float32 = rowsum(do * o) - dlse: the backward's
    per-row term, with an LSE cotangent folded in (JAX :518-521)."""
    delta = (o.float() * do.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(q, k, v, qseg, kseg, others=()):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(others):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _TAG or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_TAG)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [b, sq, hq, d] and k, v [b, sk, hk, d]")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    hk = k.shape[2]
    if hk < 1 or hq % hk:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hk}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 256]; "
                         f"got {d}")
    if b * hq > 65535:
        raise ValueError(f"batch * heads = {b * hq} exceeds 65535")
    for name, t, n in (("q segment ids", qseg, sq),
                       ("kv segment ids", kseg, k.shape[1])):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (b, n)
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {(b, n)} on "
                             f"{dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel, name, q, k, v, do, lse_in, delta, qseg, kseg, out0,
            out1, out2, lse, causal, window, span, sq_pad, scale):
    from . import _build

    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    fn = getattr(_build.library(), f"pt_flash_{kernel}_{_TAG[q.dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(do),
                 _ptr(lse_in), _ptr(delta), _ptr(qseg), _ptr(kseg),
                 _ptr(out0), _ptr(out1), _ptr(out2), _ptr(lse), b, sq, sk,
                 hq, hk, d, padded_head_dim(d), int(bool(causal)),
                 int(window), int(span), int(sq_pad), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {kernel} failed to "
                           f"launch: CUDA error {err}")
    LAUNCHES[name] += 1


def _device_ok(q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return True


def _check_rows(q, lse, delta):
    b, sq, hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq):
            raise ValueError(f"{name} must be float32 {(b, hq, sq)}")


def flash_forward(q, k, v, causal=False, sm_scale=None, qseg=None,
                  kseg=None, window=0, with_lse=False):
    """The forward (row 5, or row 6 with ``with_lse``): returns ``(o, lse
    or None)``, lse [b, hq, sq] float32."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if not _device_ok(q):
        o, lse = mha_forward_plain(q, k, v, causal, scale, qseg, kseg,
                                   window)
        return o, (lse if with_lse else None)
    _check(q, k, v, qseg, kseg)
    o = torch.empty_like(q)
    lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                       dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("fwd", "flash_attention_fwd_lse" if with_lse
            else "flash_attention_fwd", q, k, v, None, None, None, qseg,
            kseg, o, None, None, lse, causal, window, 0, 0, scale)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                 qseg=None, kseg=None, window=0):
    """dq of the two-pass backward (row 7)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if not _device_ok(q):
        return mha_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                qseg, kseg, window)
    _check(q, k, v, qseg, kseg, (("do", do), ("lse", lse),
                                 ("delta", delta)))
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    _launch("bwd_dq", "flash_attention_bwd_dq", q, k, v, do, lse, delta,
            qseg, kseg, dq, None, None, None, causal, window, 0, 0, scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                  qseg=None, kseg=None, window=0):
    """dk, dv of the two-pass backward (row 9)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if not _device_ok(q):
        return mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                 qseg, kseg, window)
    _check(q, k, v, qseg, kseg, (("do", do), ("lse", lse),
                                 ("delta", delta)))
    _check_rows(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_dkv", "flash_attention_bwd_dkv", q, k, v, do, lse, delta,
            qseg, kseg, dk, dv, None, None, causal, window, 0, 0, scale)
    return dk, dv


def flash_bwd_fused(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                    qseg=None, kseg=None, window=0, span=DEFAULT_K_BLOCK):
    """The fused backward (row 8): dk, dv and float32 dq partials, one per
    kv span of ``span`` rows, summed in span order. Returns dq, dk, dv."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if not _device_ok(q):
        return mha_bwd_fused_plain(q, k, v, do, lse, delta, causal, scale,
                                   qseg, kseg, window, span)
    _check(q, k, v, qseg, kseg, (("do", do), ("lse", lse),
                                 ("delta", delta)))
    _check_rows(q, lse, delta)
    if span < 1:
        raise ValueError(f"span must be positive; got {span}")
    b, sq, hq, d = q.shape
    n_span = -(-k.shape[1] // span)
    sq_pad = -(-sq // _PART_ROWS) * _PART_ROWS
    part = torch.zeros((n_span, b, sq_pad, hq, padded_head_dim(d)),
                       dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_fused", "flash_attention_bwd_fused", q, k, v, do, lse,
            delta, qseg, kseg, part, dk, dv, None, causal, window, span,
            sq_pad, scale)
    dq = part[0]
    for i in range(1, n_span):
        dq = dq + part[i]
    return dq[:, :sq, :, :d].to(q.dtype), dk, dv


def mha_backward(q, k, v, o, lse, do, dlse=None, causal=False,
                 sm_scale=None, qseg=None, kseg=None, window=0,
                 k_block=DEFAULT_K_BLOCK):
    """dq, dk, dv (JAX ``_mha_bwd_impl``): the fused pass when
    ``ceil(sk / fit_block(k_block, sk)) <= FUSED_BWD_MAX_KB``, else the dq
    and dk/dv passes."""
    kb = fit_block(k_block, k.shape[1])
    delta = attention_delta(o, do, dlse)
    if -(-k.shape[1] // kb) <= FUSED_BWD_MAX_KB:
        return flash_bwd_fused(q, k, v, do, lse, delta, causal, sm_scale,
                               qseg, kseg, window, span=kb)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale, qseg,
                      kseg, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale, qseg,
                           kseg, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with the kernels' backward: the forward with LSE saves
    ``q, k, v, o, lse``; returns ``(o, lse)``, both differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, scale, window, k_block):
        o, lse = flash_forward(q, k, v, causal, scale, qseg, kseg, window,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.attrs = (causal, scale, window, k_block)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        causal, scale, window, k_block = ctx.attrs
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = mha_backward(q, k, v, o, lse, do, dlse, causal, scale,
                                  qseg, kseg, window, k_block)
        return dq, dk, dv, None, None, None, None, None, None


def _prepare(q, k, v, sm_scale, k_block, segment_ids, causal, window):
    if window and not causal:
        raise ValueError("sliding window requires causal=True")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv "
                         f"heads {k.shape[2]}")
    kb = fit_block(k_block, k.shape[1])
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    qseg, kseg = split_segments(segment_ids, q, k)
    return (q.contiguous(), k.contiguous(), v.contiguous(), qseg, kseg,
            scale, kb)


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def mha(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
        k_block: int = DEFAULT_K_BLOCK, segment_ids=None,
        window: int = 0) -> torch.Tensor:
    """Flash attention over [batch, seq, heads, head_dim]; differentiable.
    Under autograd the forward runs with LSE (row 6) for the backward;
    otherwise without (row 5)."""
    q, k, v, qseg, kseg, scale, kb = _prepare(
        q, k, v, sm_scale, k_block, segment_ids, causal, window)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, qseg, kseg, causal, scale,
                                     window, kb)[0]
    return flash_forward(q, k, v, causal, scale, qseg, kseg, window)[0]


def mha_with_lse(q, k, v, causal: bool = False,
                 sm_scale: Optional[float] = None,
                 k_block: int = DEFAULT_K_BLOCK, segment_ids=None,
                 window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns logsumexp [b, heads, sq] (float32),
    the statistic ring/context-parallel callers merge partial results
    with; differentiable in both outputs."""
    q, k, v, qseg, kseg, scale, kb = _prepare(
        q, k, v, sm_scale, k_block, segment_ids, causal, window)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, qseg, kseg, causal, scale,
                                     window, kb)
    return flash_forward(q, k, v, causal, scale, qseg, kseg, window,
                         with_lse=True)
