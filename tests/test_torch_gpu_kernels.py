"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA H100 (compute capability 9.0) and
skips without one; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have; this file imports only torch, numpy and the
port)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels.rope import rope_frequencies
from torch_decode_cases import (CASES, INT8_CASES, PAGED_CASES, SPLIT_CASES,
                                boundary_lens)
from torch_gn_cases import GN_CASES
from torch_scan_cases import SCAN_CASES, TRAIN_SHAPE

pytestmark = pytest.mark.gpu

# tolerance of the kernel's output against the plain version, by the
# query's dtype: one ulp of an O(1) value, times a few (the plain version
# rounds the rotated query to that dtype where the kernel keeps float32,
# and the two sum the softmax in different orders)
TOL = {torch.float32: 1e-4, torch.float16: 5e-3, torch.bfloat16: 2e-2}
# the arguments of row 3 (block-table decode attention)
BLOCK_KEYS = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda")


def _inputs(slots, kvh, group, d, max_len, lens, act, cache, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cos, sin = rope_frequencies(d, 2 * max_len, device="cuda")
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return dict(q=randn(slots, kvh, group, d, dtype=act),
                k_new=randn(slots, kvh, d, dtype=act),
                v_new=randn(slots, kvh, d, dtype=act),
                ck=randn(slots, max_len, kvh, d, dtype=cache),
                cv=randn(slots, max_len, kvh, d, dtype=cache),
                seq_lens=lens_t, positions=lens_t + 3, cos=cos, sin=sin)


@pytest.mark.parametrize("d,group,act,cache", CASES)
def test_kernel_matches_plain_version(card, d, group, act, cache):
    slots, kvh, max_len = 5, 4, 200
    lens = [0, 63, 64, max_len - 1, 131]
    inp = _inputs(slots, kvh, group, d, max_len, lens, act, cache)
    ref_inp = {k: v.clone() for k, v in inp.items()}
    before = da.LAUNCHES
    out, ck, cv = da.fused_contiguous_decode_attention(**inp)
    assert da.LAUNCHES == before + 1
    ref, ckr, cvr = da.fused_contiguous_decode_plain(**ref_inp)
    torch.cuda.synchronize()
    assert out.dtype == act and out.shape == inp["q"].shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[act],
                               atol=TOL[act])
    rows = torch.arange(slots, device="cuda")
    lens_l = inp["seq_lens"].long()
    for a, b in ((ck, ckr), (cv, cvr)):
        # appended rows: within one bf16 ulp of the plain version's
        torch.testing.assert_close(a[rows, lens_l].float(),
                                   b[rows, lens_l].float(),
                                   rtol=2.0 ** -7, atol=1e-6)
        keep = torch.ones(a.shape[:2], dtype=torch.bool, device="cuda")
        keep[rows, lens_l] = False
        assert torch.equal(a[keep], b[keep])


def test_kernel_raises_on_shapes_it_does_not_take(card):
    inp = _inputs(2, 2, 2, 64, 16, [1, 2], torch.float32, torch.float32)
    bad = dict(inp, q=inp["q"][..., :48].contiguous(),
               k_new=inp["k_new"][..., :48].contiguous(),
               v_new=inp["v_new"][..., :48].contiguous())
    with pytest.raises(ValueError):
        da.fused_contiguous_decode_attention(**bad)
    with pytest.raises(ValueError):
        da.fused_contiguous_decode_attention(
            **dict(inp, seq_lens=inp["seq_lens"].long()))


def _paged_inputs(slots, kvh, group, d, page_size, max_pages, lens, act,
                  pool, sink_slots=(), seed=0):
    """A pool with one page more than the slots need (page 0, the sink),
    a permuted block table of the other pages, and ragged lengths; the
    slots in ``sink_slots`` are inactive (an all-zero table row and length
    0), as the engine leaves them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    n_pages = slots * max_pages + 1
    perm = np.random.default_rng(seed).permutation(n_pages - 1) + 1
    bt = perm.reshape(slots, max_pages).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for s in sink_slots:
        bt[s] = 0
        lens[s] = 0
    cos, sin = rope_frequencies(d, 2 * max_pages * page_size, device="cuda")
    lens_t = torch.tensor(lens, device="cuda")
    return dict(q=randn(slots, kvh, group, d, dtype=act),
                k_new=randn(slots, kvh, d, dtype=act),
                v_new=randn(slots, kvh, d, dtype=act),
                k_pages=randn(kvh, n_pages, page_size, d, dtype=pool),
                v_pages=randn(kvh, n_pages, page_size, d, dtype=pool),
                block_tables=torch.tensor(bt, device="cuda"),
                seq_lens=lens_t, positions=lens_t + 3, cos=cos, sin=sin)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("d,group,page_size,act,pool", PAGED_CASES)
def test_paged_kernels_match_plain_versions(card, fused, d, group, page_size,
                                            act, pool):
    """Rows 2 (fused) and 3 (block table) against their plain versions:
    outputs within TOL, the appended rows within one bf16 ulp, every other
    pool row bit-identical. Slots 5 and 6 are inactive: both append to the
    sink page's row 0 in one launch, and each attends its own new row."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    slots, kvh, max_pages = 7, 2, 200 // page_size + 1
    span = max_pages * page_size
    lens = [0, 63, 64, span - 1, 131, 0, 0]
    inp = _paged_inputs(slots, kvh, group, d, page_size, max_pages, lens,
                        act, pool, sink_slots=(5, 6) if fused else ())
    ref_inp = {k: v.clone() for k, v in inp.items()}
    name = ("fused_paged_decode_attention" if fused
            else "paged_decode_attention")
    before = pa.LAUNCHES[name]
    if fused:
        out, kp, vp = pa.fused_paged_decode_attention(**inp)
        ref, kpr, vpr = pa.fused_paged_decode_plain(**ref_inp)
    else:
        out = pa.paged_decode_attention(**{k: inp[k] for k in BLOCK_KEYS})
        ref = pa.paged_decode_plain(**{k: ref_inp[k] for k in BLOCK_KEYS})
        kp, vp, kpr, vpr = (inp["k_pages"], inp["v_pages"],
                            ref_inp["k_pages"], ref_inp["v_pages"])
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    assert out.dtype == act and out.shape == inp["q"].shape
    live = slice(0, 5)
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=TOL[act], atol=TOL[act])
    bt = inp["block_tables"].long()
    lens_l = inp["seq_lens"].long()
    rows = torch.arange(slots, device="cuda")
    page = bt[rows, lens_l // page_size]
    off = lens_l % page_size
    for a, b in ((kp, kpr), (vp, vpr)):
        if fused:
            torch.testing.assert_close(a[:, page[live], off[live]].float(),
                                       b[:, page[live], off[live]].float(),
                                       rtol=2.0 ** -7, atol=1e-6)
        keep = torch.ones(a.shape[1:3], dtype=torch.bool, device="cuda")
        keep[0] = False  # the sink page
        if fused:
            keep[page, off] = False
        assert torch.equal(a[:, keep], b[:, keep])
    if fused:
        # an inactive slot attends only its own appended row: the output
        # is its v_new rounded to the pool dtype
        want = inp["v_new"][5:].to(pool).float()[:, :, None, :]
        torch.testing.assert_close(out[5:].float(),
                                   want.expand_as(out[5:]).to(act).float(),
                                   rtol=TOL[act], atol=TOL[act])


def test_paged_kernels_raise_on_what_they_do_not_take(card):
    from paddle_tpu_torch.kernels import paged_attention as pa

    inp = _paged_inputs(2, 2, 2, 64, 16, 2, [1, 2], torch.float32,
                        torch.float32)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(**{k: inp[k] for k in BLOCK_KEYS}
                                  | {"seq_lens": inp["seq_lens"].long()})
    with pytest.raises(ValueError):
        pa.fused_paged_decode_attention(
            **dict(inp, block_tables=inp["block_tables"].long()))
    with pytest.raises(ValueError):
        pa.fused_paged_decode_attention(
            **dict(inp, k_pages=inp["k_pages"].transpose(1, 2)))


def _assert_pool_identity(eng):
    """After a run with the prefix cache on: every usable page is free or
    held by the store alone, and none is shared."""
    pool = eng.pool
    assert pool.free_pages + eng._prefix.evictable_pages(pool) \
        == pool.n_pages - 1
    assert pool.shared_pages == 0


def _serve_fused_and_unfused(paged):
    """The tiny model in float32 on the card, served with fused decode on
    and off: returns {mode: outputs} and asserts each mode's kernel ran
    once per layer per decode forward (row 1 contiguous, row 2 fused
    paged, row 3 unfused paged) and the other kernels not at all."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)  # head_dim 64
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (3, 40, 17, 9, 33)]
    # paged: 16-token pages and a pool of 9 pages, two requests' worth
    # and the sink, so admission waits on the pool
    extra = dict(paged=True, page_size=16, n_pages=9) if paged else {}
    saved = flags.flag("fused_decode")
    outs = {}
    try:
        for mode in ("on", "off"):
            flags.set_flags({"fused_decode": mode})
            eng = ContinuousBatchingEngine(
                model, EngineConfig(max_slots=2, max_len=128,
                                    cache_dtype=torch.float32, **extra))
            counts = lambda: (da.LAUNCHES,  # noqa: E731
                              pa.LAUNCHES["fused_paged_decode_attention"],
                              pa.LAUNCHES["paged_decode_attention"])
            before = counts()
            outs[mode] = [r.output for r in eng.run(
                prompts, max_new_tokens=12, max_chunk=4)]
            launched = [b - a for a, b in zip(before, counts())]
            want = [0, 0, 0]
            kernel = {(False, "on"): 0, (True, "on"): 1,
                      (True, "off"): 2}.get((paged, mode))
            if kernel is not None:
                want[kernel] = (cfg.num_hidden_layers
                                * eng.stats["decode_forwards"])
            assert launched == want
            if paged:  # every page free or held by the prefix store alone
                _assert_pool_identity(eng)
    finally:
        flags.set_flags({"fused_decode": saved})
    return outs


def test_engine_fused_and_unfused_agree_on_the_card(card):
    """Contiguous caches: greedy tokens through the row-1 kernel equal the
    unfused branch's."""
    outs = _serve_fused_and_unfused(paged=False)
    assert outs["on"] == outs["off"]


def test_paged_engine_fused_and_unfused_agree_on_the_card(card):
    """Paged pool: greedy tokens through the row-2 kernel equal those
    through the row-3 kernel."""
    outs = _serve_fused_and_unfused(paged=True)
    assert outs["on"] == outs["off"]


# ------------------------------------------- int8 branches of rows 1 and 2

def _int8_side(shape, seed):
    """A random int8 payload and float32 scales of ``shape[:-1]`` (the
    trailing 1 of a pool's scale kept by the caller)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.019 + 1e-3
    return q, s


def _check_int8_append(got_q, want_q, got_s, want_s):
    """The kernel quantizes the appended row from the same float32
    rotation as the plain version: payloads equal, scales equal to
    float32 rounding."""
    assert torch.equal(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d,group,act", INT8_CASES)
def test_int8_contiguous_kernel_matches_plain_version(card, d, group, act):
    slots, kvh, max_len = 5, 4, 200
    lens = [0, 63, 64, max_len - 1, 131]
    inp = _inputs(slots, kvh, group, d, max_len, lens, act, torch.float32)
    inp["ck"], inp["k_scale"] = _int8_side((slots, max_len, kvh, d), 1)
    inp["cv"], inp["v_scale"] = _int8_side((slots, max_len, kvh, d), 2)
    ref_inp = {k: v.clone() for k, v in inp.items()}
    before = da.LAUNCHES
    out, ck, cv, ks, vs = da.fused_contiguous_decode_attention(**inp)
    assert da.LAUNCHES == before + 1
    ref, ckr, cvr, ksr, vsr = da.fused_contiguous_decode_plain(**ref_inp)
    torch.cuda.synchronize()
    assert ks is inp["k_scale"] and ck is inp["ck"]  # in place
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[act],
                               atol=TOL[act])
    rows = torch.arange(slots, device="cuda")
    lens_l = inp["seq_lens"].long()
    for a, b, sa, sb in ((ck, ckr, ks, ksr), (cv, cvr, vs, vsr)):
        _check_int8_append(a[rows, lens_l], b[rows, lens_l],
                           sa[rows, lens_l], sb[rows, lens_l])
        keep = torch.ones(a.shape[:2], dtype=torch.bool, device="cuda")
        keep[rows, lens_l] = False
        assert torch.equal(a[keep], b[keep]) and torch.equal(sa[keep],
                                                             sb[keep])


@pytest.mark.parametrize("d,group,act", INT8_CASES)
def test_int8_paged_kernel_matches_plain_version(card, d, group, act):
    """Row 2 on an int8 pool of 16-row pages: outputs within TOL, the
    appended rows and their scales equal, every other row untouched.
    Slots 5 and 6 are inactive and append to the sink page's row 0."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    slots, kvh, page_size = 7, 2, 16
    max_pages = 200 // page_size + 1
    lens = [0, 63, 64, max_pages * page_size - 1, 131, 0, 0]
    inp = _paged_inputs(slots, kvh, group, d, page_size, max_pages, lens,
                        act, torch.float32, sink_slots=(5, 6))
    shape = tuple(inp["k_pages"].shape)
    inp["k_pages"], ks0 = _int8_side(shape, 3)
    inp["v_pages"], vs0 = _int8_side(shape, 4)
    inp["k_scale"], inp["v_scale"] = ks0[..., None], vs0[..., None]
    ref_inp = {k: v.clone() for k, v in inp.items()}
    before = pa.LAUNCHES["fused_paged_decode_attention"]
    out, kp, vp, ks, vs = pa.fused_paged_decode_attention(**inp)
    ref, kpr, vpr, ksr, vsr = pa.fused_paged_decode_plain(**ref_inp)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["fused_paged_decode_attention"] == before + 1
    live = slice(0, 5)
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=TOL[act], atol=TOL[act])
    bt = inp["block_tables"].long()
    lens_l = inp["seq_lens"].long()
    rows = torch.arange(slots, device="cuda")
    page = bt[rows, lens_l // page_size][live]
    off = (lens_l % page_size)[live]
    for a, b, sa, sb in ((kp, kpr, ks, ksr), (vp, vpr, vs, vsr)):
        _check_int8_append(a[:, page, off], b[:, page, off],
                           sa[:, page, off], sb[:, page, off])
        keep = torch.ones(a.shape[1:3], dtype=torch.bool, device="cuda")
        keep[0] = False  # the sink page
        keep[page, off] = False
        assert torch.equal(a[:, keep], b[:, keep])
        assert torch.equal(sa[:, keep], sb[:, keep])
    with pytest.raises(ValueError):  # row 3 has no int8 path
        pa.paged_decode_attention(inp["q"], kp, vp, inp["block_tables"],
                                  inp["seq_lens"])



# ---------------------- rows 1, 2 and 3 split across the ranks of a cluster
def _table_call(fn):
    """Row 3's kernel or plain version called as rows 1-2 are: on a whole
    input dict, returning (out, k_pages, v_pages)."""
    def call(**inp):
        out = fn(**{k: inp[k] for k in BLOCK_KEYS})
        return out, inp["k_pages"], inp["v_pages"]
    return call


def _split_inputs(layout, slots, kvh, group, d, span, page_size, lens,
                  sinks, act, cache, seed):
    """Inputs of one ``SPLIT_CASES`` case: a contiguous cache of ``span``
    rows, or a pool of ``span // page_size`` pages a slot with a permuted
    block table; int8 payloads with float32 scales for an int8 cache."""
    quant = cache == torch.int8
    base = torch.float32 if quant else cache
    if layout == "contig":
        inp = _inputs(slots, kvh, group, d, span, lens, act, base, seed)
        if quant:
            shape = (slots, span, kvh, d)
            inp["ck"], inp["k_scale"] = _int8_side(shape, seed + 1)
            inp["cv"], inp["v_scale"] = _int8_side(shape, seed + 2)
        return inp
    inp = _paged_inputs(slots, kvh, group, d, page_size, span // page_size,
                        lens, act, base, sink_slots=sinks, seed=seed)
    if quant:
        shape = tuple(inp["k_pages"].shape)
        inp["k_pages"], ks = _int8_side(shape, seed + 1)
        inp["v_pages"], vs = _int8_side(shape, seed + 2)
        inp["k_scale"], inp["v_scale"] = ks[..., None], vs[..., None]
    return inp


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_kernels_match_plain_versions(card, case):
    """Rows 1-3 where the card's plan splits streams over cluster ranks:
    one slot at 4095 rows, an empty slot beside a full one, the plan's
    rank and tile boundaries, GQA groups of 8 and 16, int8 at long
    lengths (rows 1-2), pages of 1, 16, 32 and 64 rows through permuted
    block tables with sink slots, lengths up to span - 1. Outputs within
    TOL of the plain version, appended rows within one bf16 ulp (int8:
    equal payloads), every other cache row bit-identical (row 3: every
    pool row, as it writes none), and a second run on the same inputs
    ``torch.equal`` to the first."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    (_, layout, slots, kvh, group, d, span, page_size, lens, sinks, act,
     cache) = case
    quant = cache == torch.int8
    if lens == "bounds":
        plan = da._card_plan(card, layout, cache, slots, kvh, group, d, span)
        assert plan.ranks > 1, plan
        lens = boundary_lens(plan.ranks, da.TILE_ROWS, span, slots)
    inp = _split_inputs(layout, slots, kvh, group, d, span, page_size, lens,
                        sinks, act, cache, seed=7)
    again = {k: v.clone() for k, v in inp.items()}
    ref_inp = {k: v.clone() for k, v in inp.items()}
    if layout == "contig":
        kernel = da.fused_contiguous_decode_attention
        plain = da.fused_contiguous_decode_plain
        count = lambda: da.LAUNCHES  # noqa: E731
    elif layout == "paged":
        kernel = pa.fused_paged_decode_attention
        plain = pa.fused_paged_decode_plain
        count = lambda: pa.LAUNCHES["fused_paged_decode_attention"]  # noqa
    else:
        kernel = _table_call(pa.paged_decode_attention)
        plain = _table_call(pa.paged_decode_plain)
        count = lambda: pa.LAUNCHES["paged_decode_attention"]  # noqa: E731
    before = count()
    got = kernel(**inp)
    second = kernel(**again)
    ref = plain(**ref_inp)
    torch.cuda.synchronize()
    assert count() == before + 2
    # run-to-run identical (the sink page excepted: inactive slots race
    # on its row 0, which nobody reads)
    assert torch.equal(got[0], second[0])
    for a, b in zip(got[1:], second[1:]):
        if layout == "paged":
            a, b = a[:, 1:], b[:, 1:]
        assert torch.equal(a, b)
    # row 3 appends nothing, so its sink slots attend the sink page's row 0
    live = [i for i in range(slots) if layout == "table" or i not in sinks]
    torch.testing.assert_close(got[0][live].float(), ref[0][live].float(),
                               rtol=TOL[act], atol=TOL[act])
    if layout == "table":  # the pool is only read
        for a, b in zip(got[1:], ref[1:]):
            assert torch.equal(a, b)
        return
    lens_l = inp["seq_lens"].long()
    rows = torch.arange(slots, device="cuda")
    if layout == "contig":
        at = (rows, lens_l)
        keep = torch.ones((slots, span), dtype=torch.bool, device="cuda")
        keep[at] = False
        new_at, old_at = at, keep
    else:
        page = inp["block_tables"].long()[rows, lens_l // page_size]
        off = lens_l % page_size
        keep = torch.ones(inp["k_pages"].shape[1:3], dtype=torch.bool,
                          device="cuda")
        keep[0] = False  # the sink page
        keep[page, off] = False
        new_at = (slice(None), page[live], off[live])
        old_at = (slice(None), keep)
    pairs = list(zip(got[1:3], ref[1:3]))
    scales = list(zip(got[3:], ref[3:]))
    for a, b in pairs:
        if quant:
            assert torch.equal(a[new_at], b[new_at])
        else:
            torch.testing.assert_close(a[new_at].float(), b[new_at].float(),
                                       rtol=2.0 ** -7, atol=1e-6)
        assert torch.equal(a[old_at], b[old_at])
    for a, b in scales:
        torch.testing.assert_close(a[new_at], b[new_at], rtol=1e-5, atol=0)
        assert torch.equal(a[old_at], b[old_at])


def test_decode_card_plans(card):
    """The card's launch plans for rows 1-3 (each kernel's own occupancy
    answers): every card-test shape gets a plan the kernels take, with the
    kernel's shared memory; at the serving shape (8 slots, 32 kv heads, d
    128, 1024 rows, bf16 and int8; row 3 bf16) the card holds the whole
    grid at once."""
    from torch_decode_cases import CONTIG_SHAPE, PAGED_SHAPE

    shapes = []
    for d, group, _, cache in CASES:
        shapes.append(("contig", cache, CONTIG_SHAPE["slots"],
                       CONTIG_SHAPE["kvh"], group, d,
                       CONTIG_SHAPE["max_len"]))
    for d, group, page_size, _, pool in PAGED_CASES:
        span = (PAGED_SHAPE["rows"] // page_size + 1) * page_size
        for layout in ("paged", "table"):
            shapes.append((layout, pool, PAGED_SHAPE["slots"],
                           PAGED_SHAPE["kvh"], group, d, span))
    for d, group, _ in INT8_CASES:
        shapes.append(("contig", torch.int8, CONTIG_SHAPE["slots"],
                       CONTIG_SHAPE["kvh"], group, d,
                       CONTIG_SHAPE["max_len"]))
    for (_, layout, slots, kvh, group, d, span, _, _, _, _,
         cache) in SPLIT_CASES:
        shapes.append((layout, cache, slots, kvh, group, d, span))
    for cache in (torch.bfloat16, torch.int8):
        for layout in ("contig", "paged"):
            shapes.append((layout, cache, 8, 32, 1, 128, 1024))
    shapes.append(("table", torch.bfloat16, 8, 32, 1, 128, 1024))
    for layout, cache, slots, kvh, group, d, span in shapes:
        plan = da._card_plan(card, layout, cache, slots, kvh, group, d, span)
        # raises if the kernel's shared memory differs from the plan's
        held = da._card_clusters(layout, cache, group, d)(plan)
        assert held == plan.held > 0, (layout, cache, d, group, plan)
        if (slots, kvh, group, d, span) == (8, 32, 1, 128, 1024):
            assert plan.clusters <= plan.held, plan

# ------------------------------------------------ row 4: weight-only matmul
QMM_CASES = [  # m, k, n, group, weight dtype, x dtype
    (8, 512, 384, 128, "int8", torch.bfloat16),
    (8, 512, 384, 128, "int4", torch.bfloat16),
    (3, 264, 200, 264, "int8", torch.float32),   # odd m, g = k
    (3, 264, 200, 264, "int4", torch.float16),
    (16, 1024, 96, 64, "int8", torch.float32),
    (37, 264, 200, 88, "int8", torch.bfloat16),  # tiled, ragged tiles
    (300, 512, 256, 128, "int4", torch.bfloat16),
    (300, 512, 256, 128, "int8", torch.float16),
    (40, 130, 100, 10, "int8", torch.bfloat16),  # n % 8, k % 8 != 0
    (64, 96, 72, 32, "int4", torch.float32),
    # the edges of the tensor-core prefill tiling (128 x rows by 128 W
    # columns, k stages of 64): m no multiple of 128 at both weight and
    # both 16-bit x types; g smaller than the k stage (32, 64) and g = 96,
    # no power of two; n a multiple of 8 but not of 128
    (200, 512, 384, 128, "int8", torch.bfloat16),
    (77, 1024, 256, 128, "int4", torch.float16),
    (129, 512, 136, 128, "int4", torch.bfloat16),
    (260, 768, 384, 128, "int8", torch.float16),
    (256, 512, 256, 32, "int8", torch.bfloat16),
    (130, 768, 384, 64, "int4", torch.bfloat16),
    (160, 576, 264, 96, "int8", torch.float16),
    (96, 576, 256, 96, "int4", torch.bfloat16),
    # decode over a cluster of 8 k splits whose stored rows do not divide
    # by 8 (1100 int8 rows, 550 int4 rows), at m 1 and m 16
    (1, 1100, 512, 100, "int8", torch.bfloat16),
    (16, 1100, 384, 110, "int4", torch.float16),
    (16, 1100, 256, 100, "int8", torch.float32),
    (1, 2200, 200, 110, "int4", torch.bfloat16),
    # the verify pass of speculative decoding at 8 slots x (spec_k + 1):
    # m = 40 at the 7B q/k/v/o shape
    (40, 4096, 4096, 128, "int8", torch.bfloat16),
    (40, 4096, 4096, 128, "int4", torch.bfloat16),
]


@pytest.mark.parametrize("m,k,n,g,wdt,act", QMM_CASES)
def test_weight_only_matmul_matches_plain_version(card, m, k, n, g, wdt,
                                                  act):
    """Row 4 against its plain version on the card, relative to the
    output's scale: float32 within 1e-5 (two summation orders), 16-bit
    x within 2e-2 (a few ulps of the rounded output, and cuBLAS may
    reduce in 16 bits)."""
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device="cuda")
    x = torch.randn((m, k), generator=gen, device="cuda").to(act)
    quant = (qmm.quantize_weight_int4_grouped if wdt == "int4"
             else qmm.quantize_weight_int8_grouped)
    qw, sc = quant(w, g)
    before = qmm.LAUNCHES
    y = qmm.weight_only_matmul(x, qw, sc, group_size=g, weight_dtype=wdt)
    assert qmm.LAUNCHES == before + 1
    ref = qmm.weight_only_matmul_plain(x, qw, sc, group_size=g,
                                       weight_dtype=wdt)
    again = qmm.weight_only_matmul(x, qw, sc, group_size=g,
                                   weight_dtype=wdt)
    torch.cuda.synchronize()
    assert y.dtype == act and tuple(y.shape) == (m, n)
    assert torch.equal(y, again)  # deterministic: no float atomics
    err = (y.float() - ref.float()).abs().max().item()
    tol = 1e-5 if act == torch.float32 else 2e-2
    assert err <= tol * ref.float().abs().max().item(), err


def test_weight_only_matmul_raises_on_what_it_does_not_take(card):
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    x = torch.randn((4, 256), device="cuda")
    qw, sc = qmm.quantize_weight_int8_grouped(
        torch.randn((256, 64), device="cuda"), 128)
    with pytest.raises(ValueError):  # a group that does not divide k
        qmm.weight_only_matmul(x, qw, sc, group_size=96)
    with pytest.raises(ValueError):
        qmm.weight_only_matmul(x.double(), qw, sc, group_size=128)
    with pytest.raises(ValueError):  # int4 needs k/2 packed rows
        qmm.weight_only_matmul(x, qw, sc, group_size=128,
                               weight_dtype="int4")


def _serve_quantized(paged, weight_dtype, cache_dtype):
    """The tiny float32 model served with quantized weights and/or cache,
    fused decode on and off; returns {mode: outputs} and asserts the
    launch counts: row 4 once per linear per forward (7 per layer and the
    head), the fused kernel of the cache once per layer per decode
    forward, and the block-table kernel never for an int8 pool."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)  # head_dim 64
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (3, 40, 17, 9, 33)]
    extra = dict(paged=True, page_size=16, n_pages=9) if paged else {}
    saved = flags.flag("fused_decode")
    outs = {}
    try:
        for mode in ("on", "off"):
            flags.set_flags({"fused_decode": mode})
            eng = ContinuousBatchingEngine(
                model, EngineConfig(max_slots=2, max_len=128,
                                    weight_dtype=weight_dtype,
                                    weight_group_size=64,
                                    cache_dtype=cache_dtype, **extra))
            counts = lambda: (qmm.LAUNCHES, da.LAUNCHES,  # noqa: E731
                              pa.LAUNCHES["fused_paged_decode_attention"],
                              pa.LAUNCHES["paged_decode_attention"])
            before = counts()
            outs[mode] = [r.output for r in eng.run(
                prompts, max_new_tokens=12, max_chunk=4)]
            launched = [b - a for a, b in zip(before, counts())]
            layers = cfg.num_hidden_layers
            decode = layers * eng.stats["decode_forwards"]
            forwards = eng.stats["decode_forwards"] \
                + eng.stats["prefill_chunk"]
            want = [0 if weight_dtype == "bf16"
                    else (7 * layers + 1) * forwards, 0, 0, 0]
            if mode == "on":
                want[2 if paged else 1] = decode
            elif paged and cache_dtype != "int8":
                want[3] = decode
            assert launched == want
    finally:
        flags.set_flags({"fused_decode": saved})
    return outs


@pytest.mark.parametrize("paged,weight_dtype,cache_dtype", [
    (True, "int8", torch.float32),
    (False, "int4", torch.float32),
    (True, "int8", "int8"),
    (False, "bf16", "int8"),
])
def test_quantized_engine_fused_and_unfused_agree_on_the_card(
        card, paged, weight_dtype, cache_dtype):
    outs = _serve_quantized(paged, weight_dtype, cache_dtype)
    assert outs["on"] == outs["off"]
    assert all(len(o) == 12 for o in outs["on"])


# --- prefix cache and speculative decoding over rows 1-2 --------------------

def _drain(eng, step=None):
    step = step or (lambda: eng.step_chunk(4))
    while step() or eng._queue or eng.active.any():
        pass


def _bf16_tiny():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, dtype="bfloat16")
    return LlamaForCausalLM(cfg, device="cuda", seed=1)


def test_paged_prefix_hits_run_row_2_on_adopted_pages(card):
    """bf16 on the card, 16-token pages: after one request publishes a
    32-token prefix, four requests over it adopt its two pages; the fused
    paged kernel (row 2) runs once per layer per decode forward over
    block tables that hold the adopted pages, the cached pages' bytes are
    unchanged after the run, and the first tokens equal those of an
    engine with the prefix cache off."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.kernels import paged_attention as pa

    model = _bf16_tiny()
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 256, 32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, n)])
               for n in (5, 16, 9, 1)]
    saved = {k: flags.flag(k) for k in ("prefix_cache", "prefill_chunk")}
    outs = {}
    try:
        for on in (True, False):
            flags.set_flags({"prefix_cache": on, "prefill_chunk": 16})
            eng = ContinuousBatchingEngine(model, EngineConfig(
                max_slots=4, max_len=128, paged=True, page_size=16))
            eng.run([np.concatenate([shared, [7]])], max_new_tokens=2)
            cached = eng._prefix.pages() if on else []
            held = [[t[:, p].clone() for t in layer if t is not None]
                    for layer in eng.caches for p in cached]
            before = pa.LAUNCHES["fused_paged_decode_attention"]
            forwards = eng.stats["decode_forwards"]
            rids = [eng.add_request(p, 12) for p in prompts]
            eng.step_chunk(4)  # admits all four
            tables = eng.pool.block_tables.copy()
            _drain(eng)
            launched = pa.LAUNCHES["fused_paged_decode_attention"] - before
            assert launched == model.config.num_hidden_layers * (
                eng.stats["decode_forwards"] - forwards) > 0
            outs[on] = [eng._finished[r].output for r in rids]
            if on:
                assert eng.prefix_snapshot()["hits"] == 4
                assert all(tables[s, :2].tolist() == cached[:2]
                           for s in range(4))
                now = [[t[:, p] for t in layer if t is not None]
                       for layer in eng.caches for p in cached]
                for a, b in zip(held, now):
                    assert all(torch.equal(x, y) for x, y in zip(a, b))
                _assert_pool_identity(eng)
    finally:
        flags.set_flags(saved)
    assert [o[0] for o in outs[True]] == [o[0] for o in outs[False]]


@pytest.mark.parametrize("paged", [False, True])
def test_spec_decode_first_tokens_equal_spec_off_on_the_card(card, paged):
    """bf16 on the card: repetitive prompts served with ``ngram`` drafting
    take verify passes, their first tokens equal spec-off's, and the
    decode kernel of the cache (row 1 or 2) runs once per layer per decode
    forward (verify passes launch neither)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.kernels import paged_attention as pa

    model = _bf16_tiny()
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([rng.integers(1, 256, 4)] * 6)
               for _ in range(4)]
    extra = dict(paged=True, page_size=16) if paged else {}
    saved = {k: flags.flag(k) for k in ("spec_decode", "prefill_chunk")}
    outs, snaps = {}, {}
    try:
        for mode in ("ngram", "off"):
            flags.set_flags({"spec_decode": mode, "prefill_chunk": 16})
            eng = ContinuousBatchingEngine(model, EngineConfig(
                max_slots=4, max_len=128, **extra))
            count = (lambda: pa.LAUNCHES["fused_paged_decode_attention"]) \
                if paged else (lambda: da.LAUNCHES)
            before = count()
            for step in (eng.step, lambda: eng.step_chunk(4)):
                rids = [eng.add_request(p, 16) for p in prompts]
                _drain(eng, step)
                outs.setdefault(mode, []).extend(
                    eng._finished[r].output for r in rids)
            assert count() - before == model.config.num_hidden_layers \
                * eng.stats["decode_forwards"]
            snaps[mode] = eng.spec_snapshot()
    finally:
        flags.set_flags(saved)
    assert snaps["ngram"]["verify_calls"] > 0
    assert snaps["off"]["verify_calls"] == 0
    assert [o[0] for o in outs["ngram"]] == [o[0] for o in outs["off"]]
    assert all(len(o) == 16 for o in outs["ngram"])


# --- flash attention (rows 5-9) ---------------------------------------------

from paddle_tpu_torch.kernels import mha as fa  # noqa: E402

# kernel vs plain version, row by row: the norm of each [d] row's
# difference over the norm of the plain version's row (taken as at least
# 1e-3 of the tensor's root-mean-square row norm). 16-bit: p and ds are
# rounded to the input dtype against different running maxima and summed
# in other orders, and the outputs rounded once more, a few ulps of bf16
# (2^-8) or fp16 (2^-11) in a row; float32: the kernel's FMA chains
# against the card's matmuls, about 1e-6. lse is float32 on both sides
# and held absolutely.
FA_TOL = {torch.float32: 1e-5, torch.float16: 4e-3, torch.bfloat16: 2e-2}
FA_LSE_TOL = 1e-5

FA_CASES = [  # b, sq, sk, hq, hk, d, dtype, causal, window, segments
    (2, 256, 256, 4, 4, 128, torch.bfloat16, True, 0, None),
    (1, 384, 384, 8, 2, 128, torch.bfloat16, True, 0, None),
    (1, 256, 256, 6, 2, 64, torch.float16, False, 0, None),
    (1, 256, 256, 5, 1, 96, torch.bfloat16, True, 0, None),
    (1, 512, 512, 2, 2, 128, torch.bfloat16, True, 64, None),
    (2, 256, 256, 2, 2, 128, torch.bfloat16, True, 0, "one"),
    (2, 256, 256, 4, 2, 64, torch.bfloat16, False, 0, "pair"),
    (1, 256, 256, 2, 1, 64, torch.float32, True, 0, None),
    (1, 256, 256, 2, 2, 128, torch.float32, False, 0, None),
    (1, 128, 128, 2, 2, 256, torch.float32, True, 32, None),
    (1, 128, 128, 4, 2, 256, torch.bfloat16, True, 0, None),
    (1, 200, 200, 3, 1, 8, torch.bfloat16, True, 0, None),
    (1, 100, 300, 2, 2, 40, torch.float16, True, 0, None),
    (2, 128, 320, 4, 4, 64, torch.float32, True, 0, None),
    # edges of the redesigned 16-bit tiling (forward q tiles of 128 rows,
    # kv tiles of 64; backward kv tiles of 128 keys, q tiles of 64): s no
    # multiple of either tile, a causal tile straddling the bottom-right
    # diagonal with sq != sk, a window edge inside a tile, and GQA with
    # the fused pass over three 128-key spans
    (2, 300, 300, 4, 4, 128, torch.bfloat16, True, 0, None),
    (1, 190, 333, 4, 2, 128, torch.bfloat16, True, 0, None),
    (1, 130, 333, 2, 2, 64, torch.float16, True, 0, None),
    (1, 512, 512, 2, 2, 128, torch.bfloat16, True, 100, None),
    (1, 384, 384, 8, 2, 64, torch.bfloat16, True, 0, None),
]


def _fa_inputs(b, sq, sk, hq, hk, d, dtype, segments, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = randn(b, sq, hq, d), randn(b, sk, hk, d), \
        randn(b, sk, hk, d), randn(b, sq, hq, d)
    qseg = kseg = None
    if segments is not None:
        # sorted segments; every query's segment has keys at or before it
        qseg = (torch.arange(sq, device="cuda") * 4 // sq).to(torch.int32)
        kseg = (torch.arange(sk, device="cuda") * 4 // sk).to(torch.int32)
        qseg, kseg = qseg.expand(b, sq).contiguous(), \
            kseg.expand(b, sk).contiguous()
    return q, k, v, do, qseg, kseg


def _fa_close(name, got, want, tol):
    """Every [d] row of ``got`` within ``tol`` of ``want``'s (FA_TOL)."""
    g, w = got.float(), want.float()
    den = w.norm(dim=-1)
    floor = 1e-3 * den.square().mean().sqrt()
    err = ((g - w).norm(dim=-1) / torch.maximum(den, floor)).max().item()
    assert err <= tol, f"{name}: row err {err} > {tol}"


def _lse_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= FA_LSE_TOL, f"lse: max abs err {err} > {FA_LSE_TOL}"


@pytest.mark.parametrize("b,sq,sk,hq,hk,d,dtype,causal,window,segments",
                         FA_CASES)
def test_flash_attention_kernels_match_plain_versions(
        card, b, sq, sk, hq, hk, d, dtype, causal, window, segments):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, qseg, kseg = _fa_inputs(b, sq, sk, hq, hk, d, dtype,
                                         segments)
    kw = dict(causal=causal, sm_scale=d ** -0.5, qseg=qseg, kseg=kseg,
              window=window)
    tol = FA_TOL[dtype]
    before = dict(fa.LAUNCHES)
    o5, none = fa.flash_forward(q, k, v, **kw)
    o6, lse = fa.flash_forward(q, k, v, with_lse=True, **kw)
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o5, o6)
    _fa_close("o", o6, o_ref, tol)
    _lse_close(lse, lse_ref)
    # the backward from the plain statistics, with an LSE cotangent
    dlse = torch.randn(lse_ref.shape, device="cuda")
    delta = fa.attention_delta(o_ref, do, dlse)
    args = (q, k, v, do, lse_ref, delta)
    dq7 = fa.flash_bwd_dq(*args, **kw)
    dk9, dv9 = fa.flash_bwd_dkv(*args, **kw)
    span = fa.fit_block(128, sk)
    dq8, dk8, dv8 = fa.flash_bwd_fused(*args, span=span, **kw)
    want_dq = fa.mha_bwd_dq_plain(*args, **kw)
    want_dk, want_dv = fa.mha_bwd_dkv_plain(*args, **kw)
    fq, fk, fv = fa.mha_bwd_fused_plain(*args, span=span, **kw)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq7, want_dq), ("dk", dk9, want_dk),
                            ("dv", dv9, want_dv), ("fused dq", dq8, fq),
                            ("fused dk", dk8, fk), ("fused dv", dv8, fv)):
        assert got.dtype == dtype and got.shape == want.shape
        _fa_close(name, got, want, tol)
    # the fused and the two-pass backward agree; dk/dv bit for bit (the
    # same sums in the same order)
    _fa_close("fused vs two-pass dq", dq8, dq7, tol)
    assert torch.equal(dk8, dk9) and torch.equal(dv8, dv9)
    # run-to-run identical
    again = fa.flash_bwd_fused(*args, span=span, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (dq8, dk8, dv8)))
    assert torch.equal(fa.flash_bwd_dq(*args, **kw), dq7)
    want_counts = {"flash_attention_fwd": 1, "flash_attention_fwd_lse": 1,
                   "flash_attention_bwd_dq": 2,
                   "flash_attention_bwd_fused": 2,
                   "flash_attention_bwd_dkv": 1}
    assert {n: fa.LAUNCHES[n] - before[n] for n in want_counts} \
        == want_counts


def test_flash_attention_autograd_matches_plain_gradients(card):
    """``mha_with_lse`` under autograd (row 6, then the fused or the
    two-pass backward by ``k_block``), with cotangents for both outputs,
    against the plain versions' gradients."""
    q, k, v, do, _, _ = _fa_inputs(2, 512, 512, 4, 2, 128, torch.bfloat16,
                                   None, seed=3)
    dlse = torch.randn((2, 4, 512), device="cuda")
    grads = {}
    # one kv span (fused), four spans (fused), eight (the two passes)
    for blk in (1024, 128, 64):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = fa.mha_with_lse(*ts, causal=True, k_block=blk)
        torch.autograd.backward((o, lse), (do, dlse))
        grads[blk] = [t.grad for t in ts]
    o, lse = fa.mha_forward_plain(q, k, v, causal=True)
    delta = fa.attention_delta(o, do, dlse)
    want = fa.mha_bwd_fused_plain(q, k, v, do, lse, delta, causal=True)
    for blk, got in grads.items():
        for name, g, w in zip("qkv", got, want):
            _fa_close(f"d{name} (k_block {blk})", g, w, FA_TOL[q.dtype])


@pytest.mark.parametrize("s", [1000, 1100])
def test_flash_attention_takes_ragged_lengths_on_the_card(card, s):
    """A sequence that is no multiple of 128 goes to the kernels, never to
    a dense reference: at 1000 the fused backward (one 1000-row span), at
    1100 the two passes (nine 128-row spans), as ``fit_block`` and the
    JAX selection rule give."""
    from paddle_tpu_torch.kernels import flash_attention as dispatch

    q, k, v, do, _, _ = _fa_inputs(2, s, s, 8, 2, 128, torch.bfloat16,
                                   None, seed=4)
    before = dict(fa.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = dispatch.flash_attention(*leaves, causal=True)
    o.backward(do)
    with torch.no_grad():
        o5 = dispatch.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    fused = s == 1000
    want_counts = {"flash_attention_fwd": 1, "flash_attention_fwd_lse": 1,
                   "flash_attention_bwd_fused": int(fused),
                   "flash_attention_bwd_dq": int(not fused),
                   "flash_attention_bwd_dkv": int(not fused)}
    assert {n: fa.LAUNCHES[n] - before[n] for n in want_counts} \
        == want_counts
    o_ref, lse_ref = fa.mha_forward_plain(q, k, v, causal=True)
    delta = fa.attention_delta(o_ref, do)
    want = fa.mha_bwd_fused_plain(q, k, v, do, lse_ref, delta, causal=True,
                                  span=fa.fit_block(1024, s))
    tol = FA_TOL[torch.bfloat16]
    _fa_close("o", o, o_ref, tol)
    assert torch.equal(o5, o.detach())
    for name, leaf, w in zip("qkv", leaves, want):
        _fa_close(f"d{name}", leaf.grad, w, tol)


@pytest.mark.parametrize("kind,causal,k_block", [
    ("zigzag", True, 1024), ("contiguous", True, 128), ("plain", False, 1024)])
def test_ring_attention_bodies_match_whole_attention_on_the_card(
        card, kind, causal, k_block):
    """The ring's bodies of 4 virtual ranks in one process
    (``run_ring_virtual``): each block is row 6, each block's backward row
    8 (k block 1024) or rows 7 and 9 (k block 128: eight spans of 1024
    kv rows); the output and LSE held against one whole-sequence row-6
    call (the LSE within n x ``FA_LSE_TOL``: each row merges up to n
    block LSEs, each rounded by the kernel), the gradients against its
    backward, row by row."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.kernels import ring_attention as ring

    n, s = 4, 4096
    q, k, v, do, _, _ = _fa_inputs(1, s, s, 8, 2, 128, torch.bfloat16,
                                   None, seed=9)
    scale = 128 ** -0.5
    sl = s // n
    parts = [[t[:, r * sl:(r + 1) * sl] for t in (q, k, v, do)]
             for r in range(n)]
    before = dict(fa.LAUNCHES)
    prev = flags.flag("flash_attention_block_k")
    flags.set_flags({"flash_attention_block_k": k_block})
    try:
        fwd = ring.run_ring_virtual([
            ring.ring_forward_body(kind, *parts[r][:3], r, n, scale)
            for r in range(n)])
        bwd = ring.run_ring_virtual([
            ring.ring_backward_body(kind, fwd[r][1], parts[r][3], r, n,
                                    scale) for r in range(n)])
    finally:
        flags.set_flags({"flash_attention_block_k": prev})
    torch.cuda.synchronize()
    blocks = {"zigzag": 16, "contiguous": 10, "plain": 16}[kind]
    two = k_block == 128
    want_counts = {"flash_attention_fwd_lse": blocks,
                   "flash_attention_bwd_fused": 0 if two else blocks,
                   "flash_attention_bwd_dq": blocks if two else 0,
                   "flash_attention_bwd_dkv": blocks if two else 0}
    assert {n_: fa.LAUNCHES[n_] - before[n_] for n_ in want_counts} \
        == want_counts
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.mha_with_lse(*leaves, causal=causal)
    o.backward(do)
    tol = FA_TOL[torch.bfloat16]
    _fa_close("o", torch.cat([f[0] for f in fwd], dim=1), o, tol)
    # the merged LSE, each rank's rows (zigzag: half-chunks r, 2n-1-r)
    for r in range(n):
        got = fwd[r][1][4]
        if kind == "zigzag":
            h = sl // 2
            rows = list(range(r * h, (r + 1) * h)) + list(
                range((2 * n - 1 - r) * h, (2 * n - r) * h))
        else:
            rows = list(range(r * sl, (r + 1) * sl))
        err = (got - lse.detach()[:, :, rows]).abs().max().item()
        assert err <= n * FA_LSE_TOL, f"lse: max abs err {err}"
    for i, name in enumerate("qkv"):
        _fa_close(f"d{name}", torch.cat([g[i] for g in bwd], dim=1),
                  leaves[i].grad, tol)


def test_flash_attention_kernels_raise_on_what_they_do_not_take(card):
    q, k, v, do, _, _ = _fa_inputs(1, 128, 128, 4, 2, 64, torch.bfloat16,
                                   None)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_forward(q, k[:, :, :1].expand(1, 128, 3, 64).contiguous(),
                         v[:, :, :1].expand(1, 128, 3, 64).contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous())
    big = torch.zeros((1, 128, 2, 264), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(big, big, big)
    # the dispatch sends such a head dim to the kernels too, which refuse
    # it: no dense fall-back on the card
    from paddle_tpu_torch.kernels import flash_attention as dispatch
    odd = q[..., :12].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        dispatch.flash_attention(odd, odd, odd, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="share one of"):
        fa.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="share one of"):
        fa.flash_forward(q, k.half(), v)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_forward(q, k.cpu(), v)


def test_flash_attention_dropout_takes_the_plain_sdpa_on_the_card(card):
    """``dropout_p > 0`` while training launches no flash kernel: the plain
    SDPA with the caller's generator, equal to it from the same generator
    state; the same call without dropout launches row 5."""
    from paddle_tpu_torch.kernels import flash_attention as dispatch
    from paddle_tpu_torch.kernels import mha
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    q, k, v, _, _, _ = _fa_inputs(2, 256, 256, 4, 2, 64, torch.bfloat16,
                                  None)
    before = dict(mha.LAUNCHES)
    got = dispatch.flash_attention(
        q, k, v, causal=True, dropout_p=0.2, window_size=64,
        generator=torch.Generator(device="cuda").manual_seed(3))
    assert mha.LAUNCHES == before
    i = torch.arange(256, device="cuda")
    band = ((i[:, None] - i[None, :]) < 64)[None, None]
    want = scaled_dot_product_attention(
        q, k, v, attn_mask=band, dropout_p=0.2, is_causal=True,
        generator=torch.Generator(device="cuda").manual_seed(3))
    assert torch.equal(got, want)
    dispatch.flash_attention(q, k, v, causal=True, window_size=64,
                             dropout_p=0.2, training=False)
    assert mha.LAUNCHES["flash_attention_fwd"] \
        == before["flash_attention_fwd"] + 1


def test_fused_linear_cross_entropy_on_the_card(card):
    """bf16 on the card, the untied and the tied layout: the chunked head
    + loss against the unfused head and ``cross_entropy`` (loss, dx, dW
    within bf16 tolerance by norm), with a lower peak of allocated
    memory."""
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_linear_cross_entropy)
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, V = 2, 1000, 256, 8192
    x0 = torch.randn((B, S, H), generator=gen, device="cuda").bfloat16()
    w0 = (torch.randn((H, V), generator=gen, device="cuda") * 0.05).bfloat16()
    y = torch.randint(0, V, (B, S), generator=gen, device="cuda")
    y[0, :7] = -100

    def run(fused, transpose):
        x = x0.clone().requires_grad_()
        w = (w0.T.contiguous() if transpose else w0.clone()).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if fused:
            loss = fused_linear_cross_entropy(
                x, w, y, transpose_weight=transpose, seq_chunk=256)
        else:
            loss = F.cross_entropy(F.linear(x, w.T if transpose else w), y)
        loss.backward()
        torch.cuda.synchronize()
        return loss, x.grad, w.grad, torch.cuda.max_memory_allocated() - base

    for transpose in (False, True):
        fl, fx, fw, fpeak = run(True, transpose)
        ul, ux, uw, upeak = run(False, transpose)
        assert fl.dtype == torch.float32 and fw.dtype == torch.bfloat16
        assert abs(float(fl) - float(ul)) <= 1e-2 * abs(float(ul))
        for got, want in ((fx, ux), (fw, uw)):
            err = ((got.float() - want.float()).norm()
                   / want.float().norm()).item()
            assert err <= 2e-2, err
        assert fpeak < upeak, (fpeak, upeak)


# ---------------------------------------------------------------------------
# rows 10-11: the selective scan
# ---------------------------------------------------------------------------
SCAN_TOL = 1e-5  # float32 on both sides: FMA contraction and expf only


def _row_err(got, want):
    """The largest error of a last-axis row over the plain row's norm
    (taken as at least 1e-3 of the tensor's root-mean-square row norm; an
    all-zero tensor is held exactly)."""
    g, w = got.float(), want.float()
    den = w.norm(dim=-1)
    floor = (1e-3 * den.square().mean().sqrt()).clamp_min(1e-30)
    return ((g - w).norm(dim=-1) / torch.maximum(den, floor)).max().item()


def _scan_inputs(b, s, d, n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, B, C = randn(b, s, d), randn(b, s, n), randn(b, s, n)
    delta = torch.nn.functional.softplus(randn(b, s, d) - 1.0)
    A = -torch.exp(randn(d, n) * 0.5)
    return u, delta, A, B, C, randn(d), randn(b, s, d)


@pytest.mark.parametrize("b,s,d,n,chunk", SCAN_CASES)
def test_selective_scan_kernels_match_plain_versions(card, b, s, d, n,
                                                     chunk):
    from paddle_tpu_torch.kernels import selective_scan as ss

    u, delta, A, B, C, _, g = _scan_inputs(b, s, d, n)
    at = A.t().contiguous()
    before = dict(ss.LAUNCHES)
    y0 = ss.split_scan_fwd(u, delta, B, C, at, chunk, False)
    y, h0s = ss.split_scan_fwd(u, delta, B, C, at, chunk, True)
    y_ref, h0s_ref = ss.selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                                 True)
    torch.cuda.synchronize()
    assert torch.equal(y0, y) and h0s.shape == h0s_ref.shape
    assert _row_err(y, y_ref) <= SCAN_TOL
    assert _row_err(h0s, h0s_ref) <= SCAN_TOL
    got = ss.split_scan_bwd(u, delta, B, C, at, h0s_ref, g, chunk)
    want = ss.selective_scan_bwd_plain(u, delta, B, C, at, h0s_ref, g,
                                       chunk)
    torch.cuda.synchronize()
    for name, x, w in zip(("du", "ddelta", "dB", "dC", "dat"), got, want):
        assert x.shape == w.shape, name
        assert _row_err(x, w) <= SCAN_TOL, (name, _row_err(x, w))
    # run-to-run identical (no atomics)
    again = ss.split_scan_bwd(u, delta, B, C, at, h0s_ref, g, chunk)
    assert all(torch.equal(x, z) for x, z in zip(got, again))
    blocks = -(-n // ss.MAX_STATE)  # one launch per block of <= 16 states
    assert {k: ss.LAUNCHES[k] - before[k] for k in before} == {
        "selective_scan_fwd": blocks, "selective_scan_fwd_states": blocks,
        "selective_scan_bwd": 2 * blocks}


def test_selective_scan_card_plans(card):
    """The card's launch plans (its own occupancy answers): every card-test
    shape gets a plan the kernels take, with the kernel's shared memory;
    at the Mamba-130m train shape the whole grid is resident at once with
    8 or more warps an SM, forward and backward."""
    from paddle_tpu_torch.kernels import _card
    from paddle_tpu_torch.kernels import selective_scan as ss

    dev = torch.device("cuda", torch.cuda.current_device())
    sms = _card.sm_count(dev)
    for b, s, d, n, chunk in SCAN_CASES:
        n = min(n, ss.MAX_STATE)
        for backward in (False, True):
            plan = ss._card_plan(dev, b, s, d, n, chunk, backward)
            # raises if the sizes differ
            held = ss._card_clusters(b, s, d, n, chunk)(plan, backward)
            assert held > 0, (b, s, d, n, chunk, backward, plan)
            if (b, s, d, n, chunk) == TRAIN_SHAPE:
                grid = b * -(-d // ss.SCAN_LANES) * plan.ranks
                assert grid <= held * plan.ranks, (backward, plan, held)
                assert ss.resident_warps(plan, b, d, held, sms) >= 8, plan


def test_selective_scan_autograd_matches_the_cpu(card):
    """``chunked_selective_scan`` under autograd on the card (rows 10 and
    11, the D-skip outside) against the same on the CPU (the plain
    versions): the output and all six gradients."""
    from paddle_tpu_torch.kernels import selective_scan as ss

    *args, g = _scan_inputs(2, 256, 96, 16, seed=1)
    dev = [a.clone().requires_grad_() for a in args]
    cpu = [a.detach().cpu().requires_grad_() for a in args]
    out = ss.chunked_selective_scan(*dev, chunk=64)
    ref = ss.chunked_selective_scan(*cpu, chunk=64)
    out.backward(g)
    ref.backward(g.cpu())
    assert _row_err(out.cpu(), ref) <= SCAN_TOL
    for name, a, c in zip("u delta A B C D".split(), dev, cpu):
        assert _row_err(a.grad.cpu(), c.grad) <= SCAN_TOL, name
    with torch.no_grad():
        y = ss.chunked_selective_scan(*args, chunk=64)
    assert torch.equal(y, out.detach())


def test_selective_scan_kernels_raise_on_what_they_do_not_take(card):
    from paddle_tpu_torch.kernels import selective_scan as ss

    u, delta, A, B, C, _, _ = _scan_inputs(1, 64, 32, 16)
    at = A.t().contiguous()
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros((1, 64, 17), device="cuda")
        ss.selective_scan_fwd(u, delta, big, big,
                              torch.zeros((17, 32), device="cuda"), 16,
                              False)
    with pytest.raises(ValueError, match="float32"):
        ss.selective_scan_fwd(u.half(), delta, B, C, at, 16, False)
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan_fwd(u.transpose(1, 2).contiguous().transpose(1, 2),
                              delta, B, C, at, 16, False)
    with pytest.raises(ValueError, match="is on"):
        ss.selective_scan_fwd(u, delta.cpu(), B, C, at, 16, False)


# ---------------------------------------------------------------------------
# rows 12-13: the fused GroupNorm
# ---------------------------------------------------------------------------
# outputs in x's dtype within one rounding of the same float32 value
# (2^-7 relative covers one bf16 ulp; float32: the sums' order), plus a
# floor of 1e-5 of the tensor's largest value; statistics and the dgamma /
# dbeta partials within 1e-5 of the largest value
GN_RTOL = {torch.float32: 1e-5, torch.float16: 2.0 ** -10,
           torch.bfloat16: 2.0 ** -7}


def _gn_close(name, got, want, rtol):
    g, w = got.float(), want.float()
    floor = 1e-5 * w.abs().max().item()
    bad = (g - w).abs() > rtol * w.abs() + floor
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements off, max "
                           f"abs err {(g - w).abs().max().item()}")


def _gn_inputs(n, hw, c, dtype, seed, offset=0):
    """x, dy [n, hw, c] in dtype (contiguous views ``offset`` elements into
    their storage), gamma and beta [c] float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def view(t):
        if not offset:
            return t.to(dtype)
        buf = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(t.shape)

    x = view(torch.randn((n, hw, c), generator=gen, device="cuda") * 2 + 0.5)
    dy = view(torch.randn((n, hw, c), generator=gen, device="cuda"))
    gamma = 1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x, dy, gamma, beta


def _gn_check(x, dy, gamma, beta, g, act):
    """Rows 12 and 13 against their plain versions, the backward run twice
    identically; one launch of row 12 and two of row 13."""
    from paddle_tpu_torch.kernels import group_norm as gn

    dtype = x.dtype
    before = dict(gn.LAUNCHES)
    y, mean, rstd = gn.group_norm_fwd(x, gamma, beta, g, 1e-5, act)
    y_ref, mean_ref, rstd_ref = gn.group_norm_fwd_plain(x, gamma, beta, g,
                                                        1e-5, act)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    _gn_close("y", y, y_ref, GN_RTOL[dtype])
    _gn_close("mean", mean, mean_ref, 0.0)
    _gn_close("rstd", rstd, rstd_ref, 0.0)
    got = gn.group_norm_bwd(x, dy, gamma, beta, mean_ref, rstd_ref, g, act)
    want = gn.group_norm_bwd_plain(x, dy, gamma, beta, mean_ref, rstd_ref,
                                   g, act)
    torch.cuda.synchronize()
    _gn_close("dx", got[0], want[0], GN_RTOL[dtype])
    _gn_close("dgamma", got[1], want[1], 0.0)
    _gn_close("dbeta", got[2], want[2], 0.0)
    again = gn.group_norm_bwd(x, dy, gamma, beta, mean_ref, rstd_ref, g, act)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert {k: gn.LAUNCHES[k] - before[k] for k in before} == {
        "group_norm_fwd": 1, "group_norm_bwd": 2}


@pytest.mark.parametrize("n,h,w,c,g,dtype,act", GN_CASES)
def test_group_norm_kernels_match_plain_versions(card, n, h, w, c, g, dtype,
                                                 act):
    x, dy, gamma, beta = _gn_inputs(n, h * w, c, dtype, seed=c + h)
    _gn_check(x, dy, gamma, beta, g, act)


# storage offsets that leave x and dy 2-byte (bf16: scalar accesses),
# 8-byte (bf16: 4-element vectors) and 8-byte (float32: 2 elements) aligned
@pytest.mark.parametrize("offset,dtype", [(1, torch.bfloat16),
                                          (4, torch.bfloat16),
                                          (2, torch.float32)])
def test_group_norm_kernels_on_unaligned_views(card, offset, dtype):
    from paddle_tpu_torch.kernels import group_norm as gn

    x, dy, gamma, beta = _gn_inputs(2, 256, 640, dtype, seed=offset,
                                    offset=offset)
    assert x.is_contiguous() and x.storage_offset() == offset
    plan = gn._launch_plan(2, 256, 640, 32, x.element_size(),
                           align=gn._alignment(x, dy))
    assert plan.vec * x.element_size() < 16
    _gn_check(x, dy, gamma, beta, 32, "silu")


def test_group_norm_card_plans(card):
    """On the card the launch plan asks the kernels' library how many
    clusters of each candidate the card holds, and the library sizes the
    candidate's shared memory as the launch does (a plan whose size
    differs raises): every candidate at every card-test shape. At every
    GroupNorm site of the SD UNet (sample_size 32, batch 4, bf16) the plan
    keeps its tiles resident and the card holds its whole grid of
    clusters at once."""
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.models import UNetConfig, unet_gn_sites

    for n, h, w, c, g, dtype, _ in GN_CASES:
        held = gn._card_clusters(gn._TAG[dtype], n, h * w, c, g)
        for backward in (False, True):
            gn._launch_plan(n, h * w, c, g, dtype.itemsize,
                            backward=backward, clusters=held)
    cfg = UNetConfig(sample_size=32)
    g = cfg.norm_num_groups
    for hw, c in sorted({(hw, c) for hw, c, _ in unet_gn_sites(cfg, 32)}):
        held = gn._card_clusters("bf16", 4, hw, c, g)
        for backward in (False, True):
            plan = gn._launch_plan(4, hw, c, g, 2, backward=backward,
                                   clusters=held)
            assert plan.resident
            assert 4 * (c // plan.slab) <= held(plan, backward), (
                hw, c, backward, plan)


def test_group_norm_autograd_and_dispatch_on_the_card(card):
    """``F.group_norm`` on an NHWC tensor on the card launches rows 12 and
    13 (over the JAX VMEM budget too) and gives the CPU's gradients."""
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1, 128, 128, 1024), generator=gen, device="cuda")
    wt = torch.randn(1024, generator=gen, device="cuda")
    bs = torch.randn(1024, generator=gen, device="cuda")
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, wt, bs)]
    cpu = [t.detach().cpu().requires_grad_() for t in (x, wt, bs)]
    before = dict(gn.LAUNCHES)
    out = F.group_norm(leaves[0], 32, leaves[1], leaves[2],
                       data_format="NHWC", activation="silu")
    out.backward(cot)
    assert {k: gn.LAUNCHES[k] - before[k] for k in before} == {
        "group_norm_fwd": 1, "group_norm_bwd": 1}
    ref = gn.fused_group_norm(*cpu, 32, 1e-5, "silu")
    ref.backward(cot.cpu())
    _gn_close("y", out.cpu(), ref, 1e-5)
    for name, a, c in zip(("dx", "dgamma", "dbeta"), leaves, cpu):
        _gn_close(name, a.grad.cpu(), c.grad, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        F.group_norm(x[..., :1000].contiguous(), 32, data_format="NHWC")


# ---------------------------------------------------------------------------
# io on the card: prefetch_to_device, fork workers, bf16 files
# ---------------------------------------------------------------------------
def test_prefetch_to_device_equals_synchronous_copies(card):
    """Every prefetched batch equals its synchronous copy, with a fast and
    a slow consumer. The fast one reads each batch on an idle stream the
    moment it is handed out, from a source slower than the copies (a
    batch read before its side-stream copy finished would differ). The
    slow one queues its reads behind a sleep on the card, so the producer
    runs ahead and a batch's memory must not be reused while a read of it
    is still queued."""
    import time

    from paddle_tpu_torch import io as tio

    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((64, 1024, 256)).astype(np.float32),
                rng.integers(0, 1000, (64, 1024)))
               for _ in range(6)]

    def slow_source():
        for b in batches:
            time.sleep(0.02)
            yield b

    for source, slow in ((slow_source(), False), (iter(batches), True)):
        got = []
        for x, y in tio.prefetch_to_device(source, size=2):
            assert x.device.type == "cuda" and y.device.type == "cuda"
            got.append((x.sum(dtype=torch.float64), x.clone(), y.clone()))
            if slow:
                torch.cuda._sleep(100_000_000)  # ~50 ms: the producer runs ahead
        assert len(got) == len(batches)
        for (s, x, y), (hx, hy) in zip(got, batches):
            want = torch.from_numpy(hx).to(card)
            assert torch.equal(x, want) and torch.equal(
                y, torch.from_numpy(hy).to(card)), slow
            assert float(s) == float(want.sum(dtype=torch.float64))


class _HostOnly:
    """A dataset that records, in the worker, whether torch there has a
    CUDA context (it must not: the worker loads numpy only)."""

    def __init__(self, n):
        self.x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)

    def __getitem__(self, i):
        import os

        return self.x[i], np.int64(os.getpid()), np.bool_(
            torch.cuda.is_initialized())

    def __len__(self):
        return len(self.x)


def test_fork_workers_stay_off_the_device(card):
    import os

    from paddle_tpu_torch import io as tio

    torch.ones(1, device=card).sum().item()  # the parent's CUDA context
    assert torch.cuda.is_initialized()
    ds = _HostOnly(16)
    loader = tio.DataLoader(ds, batch_size=4, shuffle=True, num_workers=2,
                            use_process_workers=True)
    seen = []
    for x, pid, cuda_on in loader:
        seen.append(x)
        assert (pid != os.getpid()).all()  # loaded in a forked worker
        assert not cuda_on.any()
    plain = list(tio.DataLoader(ds, batch_size=4, shuffle=True))
    for a, b in zip(seen, plain):
        np.testing.assert_array_equal(a, b[0])
    # the parent's context is unharmed
    assert float(torch.ones(2, device=card).sum()) == 2.0


def test_framework_io_round_trips_bf16_without_ml_dtypes(card, tmp_path,
                                                         monkeypatch):
    from paddle_tpu_torch.framework import io as fio

    monkeypatch.setattr(fio, "_ml_bfloat16", lambda: None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"w": torch.randn(64, 32, generator=gen,
                              device=card).bfloat16(),
             "step": torch.tensor(3, dtype=torch.int32, device=card)}
    path = str(tmp_path / "bf16.pdparams")
    fio.save(state, path)
    got = fio.load(path)
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       state["w"].view(torch.int16))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
