"""The decode kernels' card-test shapes (rows 1-3), shared by the card
tests (``test_torch_gpu_kernels.py``) and
the CPU tests of their launch plan (``test_torch_decode_attention.py``,
``test_torch_paged.py``). Import as ``import torch_decode_cases`` (pytest
puts tests/ on sys.path)."""

import torch

from paddle_tpu_torch.kernels import _card
from paddle_tpu_torch.kernels import decode_attention as tda

BF16, F16, F32, I8 = torch.bfloat16, torch.float16, torch.float32, torch.int8

# contiguous caches: 5 slots, 4 kv heads, max_len 200, lens [0, 63, 64,
# 199, 131]; (d, group, query dtype, cache dtype)
CONTIG_SHAPE = dict(slots=5, kvh=4, max_len=200)
CASES = [
    (128, 1, BF16, BF16),
    (128, 8, BF16, BF16),
    (128, 16, BF16, BF16),
    (64, 2, F32, F32),
    (32, 3, F32, BF16),
    (96, 4, F16, F16),
    (160, 5, BF16, F32),
    (256, 8, F32, F16),
    (224, 1, F16, BF16),
]

# paged pools: 7 slots, 2 kv heads, 200 // page_size + 1 pages a slot;
# (d, group, page_size, query dtype, pool dtype)
PAGED_SHAPE = dict(slots=7, kvh=2, rows=200)
PAGED_CASES = [
    (128, 1, 64, BF16, BF16),
    (128, 8, 16, BF16, BF16),
    (128, 16, 8, BF16, BF16),
    (64, 2, 16, F32, F32),
    (32, 3, 1, F32, BF16),
    (96, 4, 5, F16, F16),
    (256, 8, 32, F32, F16),
]

# int8 caches and pools at the contiguous and paged shapes above (paged:
# 16-row pages); (d, group, query dtype)
INT8_CASES = [
    (128, 1, BF16),
    (128, 8, F32),
    (64, 2, F16),
    (32, 3, F32),
    (96, 4, BF16),
    (256, 2, F32),
]

# Cases only a split across ranks exercises: (name, layout, slots, kvh,
# group, d, span, page_size, lens, sink slots, query dtype, cache dtype).
# layout "contig" is row 1, "paged" row 2 and "table" row 3 (the
# block-table kernel over a float pool); span is max_len (contiguous) or
# max_pages * page_size (paged, table); lens "bounds" are the rank and tile
# boundaries of the card's plan (``boundary_lens``); sink slots are
# inactive paged slots (an all-zero table row, length 0). Every paged pool
# is addressed through a permuted block table.
SPLIT_CASES = [
    ("one_slot_4095", "contig", 1, 32, 1, 128, 4096, 0, [4095], (),
     BF16, BF16),
    ("empty_and_full", "contig", 2, 4, 1, 128, 1024, 0, [0, 1023], (),
     BF16, BF16),
    ("bounds_contig", "contig", 10, 2, 1, 128, 1024, 0, "bounds", (),
     BF16, BF16),
    ("bounds_paged", "paged", 10, 2, 2, 64, 1024, 16, "bounds", (),
     F32, F32),
    ("gqa8_long", "contig", 2, 8, 8, 128, 4096, 0, [4095, 3000], (),
     BF16, BF16),
    ("gqa16", "contig", 3, 2, 16, 64, 512, 0, [511, 0, 200], (), F32, F32),
    ("gqa16_paged", "paged", 3, 2, 16, 128, 512, 32, [300, 0, 511], (1,),
     BF16, BF16),
    ("int8_long", "contig", 2, 8, 1, 128, 4096, 0, [4095, 3967], (),
     BF16, I8),
    ("int8_long_paged", "paged", 3, 8, 4, 128, 4096, 64, [4095, 0, 2500],
     (1,), F32, I8),
    ("paged_page1", "paged", 5, 2, 2, 128, 256, 1, [255, 0, 100, 7, 0],
     (1, 4), BF16, BF16),
    ("paged_page16", "paged", 5, 4, 1, 96, 1024, 16, [1023, 0, 16, 15, 0],
     (1, 4), F16, F16),
    ("paged_page64", "paged", 4, 32, 1, 128, 4096, 64, [4095, 0, 1000, 64],
     (1,), BF16, BF16),
    ("table_one_slot_4095", "table", 1, 32, 1, 128, 4096, 64, [4095], (),
     BF16, BF16),
    ("table_empty_and_full", "table", 2, 4, 1, 128, 1024, 64, [0, 1023],
     (), BF16, BF16),
    ("bounds_table", "table", 10, 2, 2, 64, 1024, 16, "bounds", (), F32,
     F32),
    ("table_gqa8_long", "table", 2, 8, 8, 128, 4096, 64, [4095, 3000], (),
     BF16, BF16),
    ("table_gqa16", "table", 3, 2, 16, 128, 512, 32, [300, 0, 511], (1,),
     BF16, BF16),
    ("table_page1", "table", 5, 2, 2, 128, 256, 1, [255, 0, 100, 7, 0],
     (1, 4), BF16, BF16),
    ("table_page16", "table", 5, 4, 1, 96, 1024, 16, [1023, 0, 16, 15, 0],
     (1, 4), F16, F16),
]


def boundary_lens(ranks, tile, span, slots):
    """``slots`` lengths at the rank and tile boundaries of a plan of
    ``ranks`` ranks over ``tile``-row tiles: one tile, one row past it,
    every rank full, one row past that (a tile more a rank, the last rank
    short), the last rank holding only the new row, two full rounds and
    the longest stream, and so on, each below ``span``."""
    rt = ranks * tile
    cands = [tile - 1, tile, rt - 1, rt, 2 * rt - 1, 2 * tile * (ranks - 1),
             3 * rt + 1, span - 1, 0, rt + tile - 1]
    return [min(c, span - 1) for c in cands][:slots]


# the CPU tests' plan geometry and plain-torch model of the split kernel
def rank_rows(seq_len, ranks):
    """The rows ``[r0, r1)`` of each rank of a stream whose slot holds
    ``seq_len`` cached rows (it attends rows 0..seq_len), as the kernel
    computes them on the device: ceil((seq_len + 1) / ranks) rounded up to
    whole tiles a rank, the last ranks possibly empty."""
    n = seq_len + 1
    T = tda.TILE_ROWS
    chunk = -(-(-(-n // ranks)) // T) * T
    out = []
    for r in range(ranks):
        r0 = min(r * chunk, n)
        out.append((r0, min(r0 + chunk, n)))
    return out


def plan_shapes(layout):
    """(cache dtype, slots, kvh, group, d, span) of every card-test shape
    of ``layout`` (``torch_decode_cases``: "contig", "paged" or "table"),
    and the serving shape (row 3: float pools only)."""
    out = []
    if layout == "contig":
        c = CONTIG_SHAPE
        out += [(cache, c["slots"], c["kvh"], group, d, c["max_len"])
                for d, group, _, cache in CASES]
        out += [(torch.int8, c["slots"], c["kvh"], group, d, c["max_len"])
                for d, group, _ in INT8_CASES]
    else:
        p = PAGED_SHAPE
        out += [(pool, p["slots"], p["kvh"], group, d,
                 (p["rows"] // ps + 1) * ps)
                for d, group, ps, _, pool in PAGED_CASES]
        if layout == "paged":
            out += [(torch.int8, p["slots"], p["kvh"], group, d,
                     (p["rows"] // 16 + 1) * 16)
                    for d, group, _ in INT8_CASES]
    out += [(cache, slots, kvh, group, d, span)
            for _, lay, slots, kvh, group, d, span, _, _, _, _, cache
            in SPLIT_CASES if lay == layout]
    out += [(torch.bfloat16, 8, 32, 1, 128, 1024)]
    if layout != "table":
        out += [(torch.int8, 8, 32, 1, 128, 1024)]
    return out


def check_plan_geometry(cache, slots, kvh, group, d, span):
    """The CPU model's plan of one shape: a rank count the kernels take,
    every rank at least a tile of the longest stream, the heads, warps and
    shared memory of a CTA as the kernel sizes them, and the most ranks
    whose clusters the card holds in one wave; and for lengths from 0 to
    span - 1 the ranks' rows are tile-aligned, in order, and cover rows
    0..L exactly once."""
    itemsize = torch.empty((), dtype=cache).element_size()
    quant = cache == torch.int8
    plan = tda._decode_plan(slots, kvh, group, d, span, itemsize, quant)
    assert plan.ranks in tda.RANK_CHOICES
    assert plan.ranks == 1 or span >= plan.ranks * tda.TILE_ROWS
    assert plan.hpb == tda.heads_per_block(group) and plan.hpb in (1, 2, 4, 8)
    assert plan.warps == (8 if d * itemsize <= 512 else 4)
    assert plan.clusters == slots * kvh * -(-group // plan.hpb)
    assert plan.smem == tda._smem_bytes(d, itemsize, quant, plan.hpb)
    assert plan.smem <= _card.SMEM_LIMIT and plan.held > 0
    held = {r: _card.clusters_model(32 * plan.warps, plan.smem, r)
            for r in tda.RANK_CHOICES if r == 1 or span >= r * tda.TILE_ROWS}
    assert plan.held == held[plan.ranks]
    # the most ranks whose clusters the card holds at once, else one
    fits = [r for r, n in held.items() if plan.clusters <= n]
    assert plan.ranks == max(fits, default=1)
    for L in sorted({0, 1, 7, 8, 9, span // 3, span - 2, span - 1}):
        if not 0 <= L < span:
            continue
        rows = rank_rows(L, plan.ranks)
        assert rows[0][0] == 0 and rows[-1][1] == L + 1
        for (a0, a1), (b0, b1) in zip(rows, rows[1:]):
            assert a1 == b0
        for r0, r1 in rows:  # an empty rank starts past row L
            assert r0 <= r1 and (r0 == r1 == L + 1
                                 or r0 % tda.TILE_ROWS == 0)
    return plan


def split_model(q, k, v, seq_len, ranks, scale, ks=None, vs=None,
                drop=None, warps=8):
    """The split kernel's arithmetic on one stream, in plain float32
    torch: q [ng, d] query rows (rows 1-2: rotated); k, v [rows, d] the
    stream's rows 0..seq_len (rows 1-2: the new row included; row 3: all
    from the pool), int8 payloads with scales ``ks``,
    ``vs`` [rows] folded into the score and p. Ranks take ``rank_rows``,
    a rank's tiles go to its ``warps`` warps in turn, each warp runs an online
    softmax a tile (one max, one rescale), the warps merge in warp order
    and the ranks in rank order. ``drop``: leave one rank's partial out
    of the merge (a broken merge the checks must catch)."""
    T = tda.TILE_ROWS
    ng, d = q.shape
    ranks_states = []
    for r, (r0, r1) in enumerate(rank_rows(seq_len, ranks)):
        ntiles = -(-(r1 - r0) // T)
        states = []
        for w in range(warps):
            m = torch.full((ng,), tda.NEG_INF)
            l = torch.zeros(ng)
            acc = torch.zeros(ng, d)
            for t in range(w, ntiles, warps):
                a, b = r0 + t * T, min(r0 + (t + 1) * T, r1)
                s = q @ k[a:b].T
                if ks is not None:
                    s = s * ks[a:b]
                s = s * scale
                m_new = torch.maximum(m, s.max(dim=1).values)
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * alpha + p.sum(dim=1)
                pv = p if vs is None else p * vs[a:b]
                acc = acc * alpha[:, None] + pv @ v[a:b]
                m = m_new
            states.append((m, l, acc))
        if r != drop:
            ranks_states.append(_merge_states(states))
    m, l, acc = _merge_states(ranks_states)
    return acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]


def _merge_states(states):
    mx = torch.stack([m for m, _, _ in states]).max(dim=0).values
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, li, ai in states:
        f = torch.exp(m - mx)
        l = l + li * f
        acc = acc + ai * f[:, None]
    return mx, l, acc
