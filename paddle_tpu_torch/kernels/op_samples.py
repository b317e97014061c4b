"""Small sample arguments for every ``paddle_tpu::*`` op, for
``torch.library.opcheck`` on the CPU implementations (the tests) and on
the card (``chip_smoke.py``), which checks each fake against its kernel.

``samples(device, dtypes)`` yields ``(op name, args)``: each op at the
activation dtypes given (float32 only by default) and, for the caches
and the weight-only product, every element type its kernels are built
for (the activation's own cache and an int8 cache, int8 and int4
weights); the scan at float32, the one type its kernels take. The
shapes are the kernels' smallest legal ones, with a ragged tile where a
kernel masks one.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

from ..inference.paged import quantize_kv_rows
from .rope import rope_frequencies


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _randn(g, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(device)


def _flash(g, dtype, device):
    b, sq, sk, hq, hk, d = 2, 40, 72, 4, 2, 64
    q = _randn(g, (b, sq, hq, d), dtype, device)
    k = _randn(g, (b, sk, hk, d), dtype, device)
    v = _randn(g, (b, sk, hk, d), dtype, device)
    do = _randn(g, (b, sq, hq, d), dtype, device)
    from .mha import attention_delta, mha_forward_plain

    o, lse = mha_forward_plain(q.cpu(), k.cpu(), v.cpu(), True, d ** -0.5)
    lse = lse.contiguous().to(device)
    delta = attention_delta(o.to(device), do)
    fwd = (q, k, v, None, None, True, d ** -0.5, 0)
    bwd = (q, k, v, do, lse, delta, None, None, True, d ** -0.5, 0)
    yield "flash_forward", fwd
    yield "flash_forward_lse", fwd
    yield "flash_bwd_dq", bwd
    yield "flash_bwd_fused", bwd + (32,)
    yield "flash_bwd_dkv", bwd


def _rope(device, d, max_pos=64):
    return rope_frequencies(d, max_pos, device=device)


def _int8_rows(g, shape, device):
    x = torch.randn(shape, generator=g)
    q, s = quantize_kv_rows(x)
    return q.to(device), s.to(device)


def _contiguous(g, dtype, cache_dtype, device):
    slots, kvh, group, d, max_len = 2, 2, 2, 64, 24
    q = _randn(g, (slots, kvh, group, d), dtype, device)
    kn = _randn(g, (slots, kvh, d), dtype, device)
    vn = _randn(g, (slots, kvh, d), dtype, device)
    lens = torch.tensor([5, 17], dtype=torch.int32, device=device)
    pos = lens.clone()
    cos, sin = _rope(device, d)
    if cache_dtype == torch.int8:
        ck, ks = _int8_rows(g, (slots, max_len, kvh, d), device)
        cv, vs = _int8_rows(g, (slots, max_len, kvh, d), device)
    else:
        ck = _randn(g, (slots, max_len, kvh, d), cache_dtype, device)
        cv = _randn(g, (slots, max_len, kvh, d), cache_dtype, device)
        ks = vs = None
    return ("fused_contiguous_decode",
            (q, kn, vn, ck, cv, lens, pos, cos, sin, d ** -0.5, ks, vs))


def _paged(g, dtype, cache_dtype, device, fused):
    slots, kvh, group, d, n_pages, page = 2, 2, 2, 64, 6, 8
    q = _randn(g, (slots, kvh, group, d), dtype, device)
    if cache_dtype == torch.int8:
        kp, ks = _int8_rows(g, (kvh, n_pages, page, d), device)
        vp, vs = _int8_rows(g, (kvh, n_pages, page, d), device)
        ks, vs = ks[..., None].contiguous(), vs[..., None].contiguous()
    else:
        kp = _randn(g, (kvh, n_pages, page, d), cache_dtype, device)
        vp = _randn(g, (kvh, n_pages, page, d), cache_dtype, device)
        ks = vs = None
    table = torch.tensor([[1, 3, 0], [2, 4, 5]], dtype=torch.int32,
                         device=device)
    lens = torch.tensor([9, 20], dtype=torch.int32, device=device)
    if not fused:
        return ("paged_decode", (q, kp, vp, table, lens, d ** -0.5))
    kn = _randn(g, (slots, kvh, d), dtype, device)
    vn = _randn(g, (slots, kvh, d), dtype, device)
    cos, sin = _rope(device, d)
    return ("fused_paged_decode", (q, kn, vn, kp, vp, table, lens,
                                   lens.clone(), cos, sin, d ** -0.5, ks,
                                   vs))


def _matmul(g, dtype, wdtype, device):
    from .quant_matmul import (
        quantize_weight_int4_grouped,
        quantize_weight_int8_grouped,
    )

    m, k, n, gs = 3, 256, 72, 128
    w = torch.randn((k, n), generator=g) * 0.05
    quant = (quantize_weight_int4_grouped if wdtype == "int4"
             else quantize_weight_int8_grouped)
    qw, sc = quant(w, gs)
    x = _randn(g, (m, k), dtype, device)
    return ("weight_only_matmul", (x, qw.to(device), sc.to(device), gs,
                                   wdtype))


def _scan(g, device):
    b, s, d, n, chunk = 2, 12, 32, 8, 8
    f = torch.float32
    u = _randn(g, (b, s, d), f, device)
    delta = (_randn(g, (b, s, d), f, device).abs() * 0.1).contiguous()
    B = _randn(g, (b, s, n), f, device)
    C = _randn(g, (b, s, n), f, device)
    at = (-_randn(g, (n, d), f, device).abs()).contiguous()
    from .selective_scan import selective_scan_fwd_plain

    _, h0s = selective_scan_fwd_plain(u.cpu(), delta.cpu(), B.cpu(),
                                      C.cpu(), at.cpu(), chunk, True)
    gy = _randn(g, (b, s, d), f, device)
    yield "selective_scan_fwd", (u, delta, B, C, at, chunk)
    yield "selective_scan_fwd_states", (u, delta, B, C, at, chunk)
    yield "selective_scan_bwd", (u, delta, B, C, at, h0s.to(device), gy,
                                 chunk)


def _group_norm(g, dtype, device):
    n, hw, c, groups = 2, 36, 64, 8
    x = _randn(g, (n, hw, c), dtype, device)
    dy = _randn(g, (n, hw, c), dtype, device)
    gamma = _randn(g, (c,), torch.float32, device)
    beta = _randn(g, (c,), torch.float32, device)
    from .group_norm import group_norm_fwd_plain

    _, mean, rstd = group_norm_fwd_plain(x.cpu(), gamma.cpu(), beta.cpu(),
                                         groups, 1e-5, "silu")
    yield "group_norm_fwd", (x, gamma, beta, groups, 1e-5, "silu")
    yield "group_norm_bwd", (x, dy, gamma, beta, mean.to(device),
                             rstd.to(device), groups, "silu")


def samples(device="cpu", dtypes: Sequence[torch.dtype] = (torch.float32,),
            seed: int = 0) -> Iterator[Tuple[str, tuple]]:
    """``(op name, args)`` for every op at each of ``dtypes``."""
    g = _gen(seed)
    for dt in dtypes:
        yield from _flash(g, dt, device)
        for cache in (dt, torch.int8):
            yield _contiguous(g, dt, cache, device)
            yield _paged(g, dt, cache, device, fused=True)
        yield _paged(g, dt, dt, device, fused=False)
        for wd in ("int8", "int4"):
            yield _matmul(g, dt, wd, device)
        yield from _group_norm(g, dt, device)
    yield from _scan(g, device)
