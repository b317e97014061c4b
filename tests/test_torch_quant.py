"""Quantized serving in the PyTorch port against the JAX package on the
CPU, on the same numpy inputs: the weight quantizers (bytes and scales),
the plain version of the weight-only matmul kernel (row 4) against the
Pallas kernel in interpret mode and the XLA reference, the int8 KV paths
(quantize-on-append, gather, dispatch), the int8 branches of the plain
fused decode versions (rows 1 and 2) against the Pallas kernels
(interpret mode) and the JAX references, a quantized JAX model's state
dict carried across, and greedy tokens of the quantized engines equal to
the JAX engine's (speculative decoding and prefix caching off). The
Hopper kernels themselves run only on the card
(``tests/test_torch_gpu_kernels.py`` and ``chip_smoke.py``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import serving_utils
from paddle_tpu import flags as jflags
from paddle_tpu import quantization as jquant
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import quant_matmul as jqmm
from paddle_tpu.kernels.rope import rope_frequencies as j_rope_frequencies
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.distributed.parallel_layers import (
    ColumnParallelLinear as TLinear,
)
from paddle_tpu_torch.inference import ContinuousBatchingEngine, EngineConfig
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import quant_matmul as tqmm
from paddle_tpu_torch.kernels.rope import rope_frequencies
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _raw(t):
    """The stored values as numpy, dtype kept (int8 payloads)."""
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _message(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


# ------------------------------------------------------------- quantizers
@pytest.mark.parametrize("wdt,g", [("int8", 64), ("int8", 128),
                                   ("int8", 256), ("int4", 32),
                                   ("int4", 128), ("int4", 256)])
def test_grouped_quantizers_give_jax_bytes(wdt, g):
    """Payload bytes identical and scales equal, the degenerate g = k
    included; the int4 nibbles unpack as JAX's do."""
    w = np.random.default_rng(g).standard_normal((256, 48)) \
        .astype(np.float32)
    jfn = getattr(jqmm, f"quantize_weight_{wdt}_grouped")
    tfn = getattr(tqmm, f"quantize_weight_{wdt}_grouped")
    jq, js = jfn(jnp.asarray(w), g)
    tq, ts = tfn(torch.tensor(w), g)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_raw(tq), _raw(jq))
    np.testing.assert_array_equal(_raw(ts), _raw(js))
    if wdt == "int4":
        np.testing.assert_array_equal(_raw(tqmm._unpack_int4(tq)),
                                      _raw(jqmm._unpack_int4(jq)))


def test_per_channel_quantizer_and_error_messages_match_jax():
    w = np.random.default_rng(4).standard_normal((64, 24)) \
        .astype(np.float32)
    jq, js = jquant.quantize_weight_int8(jnp.asarray(w), axis=1)
    tq, ts = tquant.quantize_weight_int8(torch.tensor(w), axis=1)
    np.testing.assert_array_equal(_raw(tq), _raw(jq))
    np.testing.assert_array_equal(_raw(ts), _raw(js))
    # odd k for int4, a group that does not divide k (int4 suggests one
    # that does: 64), and the int8 grouped message
    for name, shape, g in (("int4", (129, 8), 129), ("int4", (128, 8), 96),
                           ("int8", (128, 8), 96)):
        jmsg = _message(getattr(jqmm, f"quantize_weight_{name}_grouped"),
                        jnp.zeros(shape), g)
        tmsg = _message(getattr(tqmm, f"quantize_weight_{name}_grouped"),
                        torch.zeros(shape), g)
        assert tmsg == jmsg
    assert "group_size=64" in tmsg or "96" in tmsg


@pytest.mark.parametrize("m,n,k,dtype,body", [
    (8, 4096, 11008, torch.bfloat16, "decode_tc_kernel"),   # 7B decode
    (16, 4096, 4096, torch.float16, "decode_tc_kernel"),
    (17, 4096, 4096, torch.bfloat16, "prefill_kernel"),
    (2048, 11008, 4096, torch.bfloat16, "prefill_kernel"),  # 7B prefill
    (2048, 11008, 4096, torch.float32, "decode_kernel"),
    (40, 100, 130, torch.bfloat16, "decode_kernel"),
    (8, 4096, 4100, torch.bfloat16, "decode_kernel"),
])
def test_weight_only_matmul_body_by_shape(m, n, k, dtype, body):
    """The body a call launches on the card (csrc/quant_matmul.cu:
    launch_t): the tensor cores for 16-bit x with n and k multiples of 8,
    wgmma above 16 rows and mma.sync at or below; SIMT FMAs otherwise."""
    assert tqmm.kernel_body(m, n, k, dtype) == body


# ------------------------------------------- row 4's plain version vs JAX
@pytest.mark.parametrize("wdt", ["int8", "int4"])
@pytest.mark.parametrize("m,k,g", [(16, 256, 64), (256, 512, 128)])
def test_weight_only_matmul_plain_matches_jax(wdt, m, k, g):
    """Shapes that tile (n 256, k a multiple of 256, 256 % g == 0), so the
    Pallas kernel really runs (interpret mode). float32, rtol 1e-5 (and
    atol 1e-5 on outputs of order 1, weights drawn as a model's are): the
    same dequantized float32 weight, products summed in another order."""
    rng = np.random.default_rng(m + k)
    w = (rng.standard_normal((k, 256)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, js = getattr(jqmm, f"quantize_weight_{wdt}_grouped")(
        jnp.asarray(w), g)
    want_k = jqmm.weight_only_matmul_pallas(
        jnp.asarray(x), jq, js, group_size=g, weight_dtype=wdt)
    want_x = jqmm.weight_only_matmul_xla(jnp.asarray(x), jq, js,
                                         group_size=g, weight_dtype=wdt)
    before = tqmm.LAUNCHES
    got = tqmm.weight_only_matmul(torch.tensor(x), torch.tensor(_raw(jq)),
                                  torch.tensor(_raw(js)), group_size=g,
                                  weight_dtype=wdt)
    assert tqmm.LAUNCHES == before  # CPU tensors: the plain version
    for want in (want_k, want_x):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_weight_only_linear_layouts_match_jax():
    """``WeightOnlyLinear`` from a layer (grouped int8 and int4, a group
    that does not divide in_features, per-channel), on a 3-D input, and
    ``weight_only_linear`` with a bias: float32 within 1e-5 of JAX."""
    from paddle_tpu.distributed.parallel_layers import (
        ColumnParallelLinear as JLinear,
    )

    pt.seed(3)
    jlin = JLinear(96, 40, has_bias=False)
    tlin = TLinear(96, 40, has_bias=False, device="cpu",
                   generator=torch.Generator())
    load_numpy_state_dict(tlin, {"weight": np.asarray(jlin.weight.value)})
    x = np.random.default_rng(5).standard_normal((2, 3, 96)) \
        .astype(np.float32)
    for wdt, g in (("int8", 32), ("int4", 64), ("int8", None),
                   ("int8", 128)):  # 128 does not divide 96: one group
        jl = jquant.WeightOnlyLinear(jlin, weight_dtype=wdt, group_size=g)
        tl = tquant.WeightOnlyLinear(tlin, weight_dtype=wdt, group_size=g)
        assert tl.group_size == jl.group_size
        np.testing.assert_array_equal(_raw(tl.qweight), _raw(jl.qweight))
        if wdt == "int8" and g in (None, 128):
            np.testing.assert_allclose(_np(tl(torch.tensor(x))),
                                       _np(jl(jnp.asarray(x))), rtol=1e-5,
                                       atol=1e-5)
    bias = np.linspace(-1, 1, 40).astype(np.float32)
    want = jquant.weight_only_linear(jnp.asarray(x), jl.qweight, jl.scale,
                                     jnp.asarray(bias), group_size=96)
    got = tquant.weight_only_linear(torch.tensor(x), tl.qweight, tl.scale,
                                    torch.tensor(bias), group_size=96)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- int8 KV
SLOTS, KVH, D, PS, N_PAGES, MAX_PAGES = 3, 4, 32, 16, 32, 4


def _int8_pool(seed):
    """A random int8 pool with its scales (numpy), a block table drawn from
    pages 1.. (the engine keeps page 0 as the sink), lengths mid-page, on
    a page boundary and 0."""
    rng = np.random.default_rng(seed)
    shape = (KVH, N_PAGES, PS, D)
    pages = rng.permutation(N_PAGES - 1) + 1
    return dict(
        kp=rng.integers(-127, 128, shape).astype(np.int8),
        vp=rng.integers(-127, 128, shape).astype(np.int8),
        ks=rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32),
        vs=rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32),
        bt=pages[:SLOTS * MAX_PAGES].reshape(SLOTS, MAX_PAGES)
        .astype(np.int32),
        lens=np.asarray([37, 16, 0], np.int32))


def _pools(x):
    j = (jpaged.PagedLayerCache(*(jnp.asarray(x[k])
                                  for k in ("kp", "vp", "ks", "vs"))),
         jpaged.PagedState(jnp.asarray(x["bt"]), jnp.asarray(x["lens"])))
    t = (tpaged.PagedLayerCache(*(torch.tensor(x[k])
                                  for k in ("kp", "vp", "ks", "vs"))),
         tpaged.PagedState(torch.tensor(x["bt"]), torch.tensor(x["lens"])))
    return j, t


def _pools_equal(got, want, skip_sink):
    """Payloads bit-equal and scales equal, on every page or every page
    but the sink page 0 (where the port puts the rows JAX drops)."""
    lo = 1 if skip_sink else 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_raw(g)[:, lo:], _raw(w)[:, lo:])


def test_quantize_kv_rows_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 4, 32)) \
        .astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the eps scale
    jq, js = jpaged.quantize_kv_rows(jnp.asarray(x))
    tq, ts = tpaged.quantize_kv_rows(torch.tensor(x))
    np.testing.assert_array_equal(_raw(tq), _raw(jq))
    np.testing.assert_array_equal(_raw(ts), _raw(js))
    assert ts[0, 0, 0] == tpaged.KV_QUANT_EPS == jpa.KV_QUANT_EPS
    np.testing.assert_array_equal(
        _raw(tpaged.dequantize_kv(tpaged.QuantizedKV(tq, ts))),
        _raw(jpaged.dequantize_kv(jpaged.QuantizedKV(jq, js))))


@pytest.mark.parametrize("op", ["append_kv", "chunk_mid", "chunk_edge"])
def test_int8_append_and_gather_match_jax(op):
    """Quantize-on-append of one token (``append_kv``) and of 8-row chunks
    (``append_kv_chunk``: mid-page starts, and a chunk crossing max_len
    next to the ``start = max_len`` sentinel, whose rows JAX drops and the
    port sends to the sink page): payloads bit-equal, scales equal; then
    the dequantizing gather and the int8 dispatch of ``paged_attention``
    (the dense path, as in JAX) within 1e-5."""
    x = _int8_pool(1)
    (jc, js), (tc, ts) = _pools(x)
    rng = np.random.default_rng(2)
    s = 1 if op == "append_kv" else 8
    k = rng.standard_normal((SLOTS, s, KVH, D)).astype(np.float32)
    v = rng.standard_normal((SLOTS, s, KVH, D)).astype(np.float32)
    if op == "append_kv":
        want = jpaged.append_kv(jc, js, jnp.asarray(k), jnp.asarray(v))
        got = tpaged.append_kv(tc, ts, torch.tensor(k), torch.tensor(v))
    else:
        st = np.asarray([5, 20, 33] if op == "chunk_mid" else [60, 64, 0],
                        np.int32)
        want = jpaged.append_kv_chunk(jc, js, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(st))
        got = tpaged.append_kv_chunk(tc, ts, torch.tensor(k),
                                     torch.tensor(v), torch.tensor(st))
    assert got.k_scale is tc.k_scale  # in place
    _pools_equal(got, want, skip_sink=op == "chunk_edge")
    assert not np.array_equal(_raw(got.k_pages), x["kp"])
    for g, w in zip(tpaged.gather_kv(got, ts), jpaged.gather_kv(want, js)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), _np(w))
    q = rng.standard_normal((SLOTS, 1, 8, D)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tpaged.paged_attention(torch.tensor(q), got, ts)),
        _np(jpaged.paged_attention(jnp.asarray(q), want, js)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------- int8 branches of rows 1 and 2 (plain)
@pytest.mark.parametrize("kvh", [1, 4, 8])
def test_int8_fused_plain_versions_match_jax_kernels(kvh):
    """Both fused plain versions on int8 caches against the Pallas kernels
    (interpret mode) and the JAX references, as
    ``tests/test_quant_serving.py`` holds the kernels: group 4, lengths
    0, mid-page, a page boundary and the last row. Outputs within 2e-5,
    payloads bit-equal, scales within rtol 1e-5 (the in-kernel rope can
    move an absmax by an ulp)."""
    rng = np.random.default_rng(kvh)
    group, d, slots, ps, max_len = 4, 32, 4, 16, 32
    n_pages = slots * (max_len // ps) + 1
    lens = np.asarray([0, 17, 16, 31], np.int32)
    q = rng.standard_normal((slots, kvh, group, d)).astype(np.float32)
    kn = rng.standard_normal((slots, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((slots, kvh, d)).astype(np.float32)
    cos_j, sin_j = j_rope_frequencies(d, max_len + 1)
    cos_t, sin_t = rope_frequencies(d, max_len + 1, device="cpu")
    pshape = (kvh, n_pages, ps, d)
    cshape = (slots, max_len, kvh, d)
    bt = (1 + np.arange(slots * (max_len // ps))).reshape(slots, -1) \
        .astype(np.int32)
    cases = {
        "paged": (jpa.fused_paged_decode_attention,
                  jda.fused_paged_decode_reference,
                  tpa.fused_paged_decode_attention, pshape,
                  pshape[:3] + (1,), [bt]),
        "contig": (jda.fused_contiguous_decode_attention,
                   jda.fused_contiguous_decode_reference,
                   tda.fused_contiguous_decode_attention, cshape,
                   cshape[:3], []),
    }
    for name, (jkern, jref, tfn, shape, sshape, extra) in cases.items():
        kq = rng.integers(-127, 128, shape).astype(np.int8)
        vq = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, sshape).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, sshape).astype(np.float32)
        jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                 jnp.asarray(kq), jnp.asarray(vq),
                 *[jnp.asarray(e) for e in extra], jnp.asarray(lens),
                 jnp.asarray(lens), cos_j, sin_j)
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        want_k = jkern(*jargs, **jkw)
        want_r = jax.jit(jref)(*jargs, **jkw)  # one compile, not op by op
        targs = (torch.tensor(q), torch.tensor(kn), torch.tensor(vn),
                 torch.tensor(kq), torch.tensor(vq),
                 *[torch.tensor(e) for e in extra], torch.tensor(lens),
                 torch.tensor(lens), cos_t, sin_t)
        got = tfn(*targs, k_scale=torch.tensor(ks),
                  v_scale=torch.tensor(vs))
        assert len(got) == 5 and got[3] is not None
        for want in (want_k, want_r):
            np.testing.assert_allclose(_np(got[0]), _np(want[0]),
                                       rtol=2e-5, atol=2e-5, err_msg=name)
            for i in (1, 2):
                np.testing.assert_array_equal(_raw(got[i]), _raw(want[i]))
            for i in (3, 4):
                np.testing.assert_allclose(_raw(got[i]), _raw(want[i]),
                                           rtol=1e-5, atol=1e-8)


# --------------------------------------- a quantized JAX model carried over
@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jmodel = JModel(JConfig.tiny())
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


def test_quantized_jax_state_dict_loads_and_gives_its_logits(models):
    """The JAX tiny Llama quantized to int8 as its engine does it (128-row
    groups, one whole-column group where 128 does not divide
    in_features): its state dict (int8 qweights byte for byte, float32
    scales and act_scales) loads into a port model of other weights
    quantized the same way, and a no-cache forward gives the same logits
    within 1e-5 (float32)."""
    jmodel = jquant.quantize_model_weight_only(
        copy.deepcopy(models[0]), weight_dtype="int8", group_size=128)
    tmodel = tquant.quantize_model_weight_only(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3),
        weight_dtype="int8", group_size=128)
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    assert any(k.endswith("q_proj.qweight") for k in state)
    assert "lm_head.act_scale" in state
    load_numpy_state_dict(tmodel, state)
    for k, v in tmodel.state_dict().items():
        if v.dtype == torch.int8:
            np.testing.assert_array_equal(_raw(v), state[k])
    ids = np.random.default_rng(1).integers(1, 256, (2, 11))
    np.testing.assert_allclose(_np(tmodel(torch.as_tensor(ids))),
                               _np(jmodel(jnp.asarray(ids))), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ the engines' tokens
MAX_NEW = 8
ARMS = {  # name: (paged, EngineConfig fields)
    "int8w_contig": (False, dict(weight_dtype="int8")),
    "int8w_paged": (True, dict(weight_dtype="int8")),
    "int8kv_contig": (False, dict(cache_dtype="int8")),
    "int8kv_paged": (True, dict(cache_dtype="int8")),
    "int8w_int8kv_paged": (True, dict(weight_dtype="int8",
                                      cache_dtype="int8")),
}


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, n) for n in (3, 40, 17)]


@pytest.fixture(scope="module")
def jax_outputs(models):
    """The JAX engine's greedy tokens per arm, spec decoding and prefix
    caching off, 16-token prefill chunks, its default CPU decode path."""
    jmodel, _ = models
    keys = ("prefix_cache", "spec_decode", "prefill_chunk")
    saved = {k: jflags.flag(k) for k in keys}
    jflags.set_flags({"prefix_cache": False, "spec_decode": "off",
                      "prefill_chunk": 16})
    try:
        out = {}
        for name, (paged, kw) in ARMS.items():
            kw = dict(kw)
            if kw.get("cache_dtype") == "int8":
                kw["cache_dtype"] = jnp.int8
            eng = JEngine(jmodel, serving_utils.tiny_ecfg(paged, **kw))
            out[name] = [r.output for r in eng.run(
                _prompts(), max_new_tokens=MAX_NEW, max_chunk=4)]
        return out
    finally:
        jflags.set_flags(saved)


@pytest.mark.parametrize("arm,fused", [
    ("int8w_contig", "on"), ("int8w_paged", "on"),
    ("int8kv_contig", "on"), ("int8kv_contig", "off"),
    ("int8kv_paged", "on"), ("int8kv_paged", "off"),
    ("int8w_int8kv_paged", "on")])
def test_quantized_engine_tokens_identical_to_jax(models, jax_outputs, arm,
                                                  fused):
    """The port's engine on the tiny float32 model: greedy tokens equal to
    the JAX engine's, the int8 caches with the port's fused decode on and
    off; the caller's model stays unquantized (the engine quantizes a
    copy)."""
    _, tmodel = models
    paged, kw = ARMS[arm]
    saved = {k: tflags.flag(k)
             for k in ("prefill_chunk", "fused_decode", "prefix_cache")}
    tflags.set_flags({"prefill_chunk": 16, "fused_decode": fused,
                      "prefix_cache": False})
    try:
        eng = ContinuousBatchingEngine(
            tmodel, EngineConfig(max_slots=2, max_len=128, seq_buckets=(32,),
                                 page_size=8, paged=paged,
                                 cache_dtype=kw.get("cache_dtype",
                                                    torch.float32),
                                 weight_dtype=kw.get("weight_dtype", "bf16")),
            device="cpu")
        got = [r.output for r in eng.run(_prompts(), max_new_tokens=MAX_NEW,
                                         max_chunk=4)]
    finally:
        tflags.set_flags(saved)
    assert got == jax_outputs[arm]
    quant_w = "weight_dtype" in kw
    assert quant_w == any(isinstance(m, tquant.WeightOnlyLinear)
                          for m in eng.model.modules())
    assert not any(isinstance(m, tquant.WeightOnlyLinear)
                   for m in tmodel.modules())
    if paged:
        assert eng.pool.free_pages == eng.pool.n_pages - 1


def test_weight_dtype_resolution_and_inplace_quantization(models):
    """``weight_dtype="auto"`` follows PT_FLAGS_serve_weight_dtype;
    ``quantize_inplace`` swaps the caller's layers; int4 serves too."""
    from paddle_tpu_torch.inference.serving import _resolve_weight_dtype

    saved = tflags.flag("serve_weight_dtype")
    try:
        tflags.set_flags({"serve_weight_dtype": "int8"})
        assert _resolve_weight_dtype("auto") == "int8"
        assert _resolve_weight_dtype("bfloat16") == "bf16"
        tflags.set_flags({"serve_weight_dtype": "fp8"})
        with pytest.raises(ValueError, match="PT_FLAGS_serve_weight_dtype"):
            _resolve_weight_dtype("auto")
    finally:
        tflags.set_flags({"serve_weight_dtype": saved})
    mine = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=2)
    eng = ContinuousBatchingEngine(
        mine, EngineConfig(max_slots=2, max_len=64, weight_dtype="int4",
                           weight_group_size=32, quantize_inplace=True,
                           cache_dtype=torch.float32), device="cpu")
    assert eng.model is mine and eng.weight_dtype == "int4"
    assert isinstance(mine.lm_head, tquant.WeightOnlyLinear)
    assert mine.lm_head.qweight.shape == (32, 256)  # 64 rows packed
    out = eng.run([[5, 6, 7]], max_new_tokens=4, max_chunk=2)[0].output
    assert len(out) == 4 and all(0 <= t < 256 for t in out)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_cache_attention_keeps_the_model_dtype(paged):
    """A bf16 model over an int8 cache: the prefill attention reads
    dequantized float32 rows but returns bf16, so the rest of the forward
    stays in bf16, as the fused decode kernels keep it (the JAX model
    promotes it to float32 here: ROADMAP.md Queue C)."""
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"),
                             device="cpu", seed=4)
    cfg = model.config
    ids = torch.as_tensor(np.random.default_rng(2).integers(1, 256, (2, 8)))
    start = torch.as_tensor([0, 3])
    pos = start[:, None] + torch.arange(8)
    if paged:
        pool = tpaged.PagePool(2 * 4 + 1, 8, 2, 4, reserve_sink=True)
        assert pool.alloc(0, 16) and pool.alloc(1, 16)
        state = pool.device_state(start.numpy(), device="cpu")
        caches = [(c, state) for c in tpaged.init_paged_pool(
            cfg.num_hidden_layers, pool.n_pages, 8, cfg.num_key_value_heads,
            cfg.head_dim, dtype=torch.int8, device="cpu")]
    else:
        caches = model.init_kv_caches(2, 32, dtype=torch.int8)
    logits, _ = model(ids, position_ids=pos, kv_caches=caches,
                      cache_index=start)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()
