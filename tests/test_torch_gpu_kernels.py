"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA H100 (compute capability 9.0) and
skips without one; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have; this file imports only torch, numpy and the
port)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels.rope import rope_frequencies

pytestmark = pytest.mark.gpu

# tolerance of the kernel's output against the plain version, by the
# query's dtype: one ulp of an O(1) value, times a few (the plain version
# rounds the rotated query to that dtype where the kernel keeps float32,
# and the two sum the softmax in different orders)
TOL = {torch.float32: 1e-4, torch.float16: 5e-3, torch.bfloat16: 2e-2}


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


CASES = [  # d, group, query dtype, cache dtype
    (128, 1, torch.bfloat16, torch.bfloat16),
    (128, 8, torch.bfloat16, torch.bfloat16),
    (128, 16, torch.bfloat16, torch.bfloat16),
    (64, 2, torch.float32, torch.float32),
    (32, 3, torch.float32, torch.bfloat16),
    (96, 4, torch.float16, torch.float16),
    (160, 5, torch.bfloat16, torch.float32),
    (256, 8, torch.float32, torch.float16),
    (224, 1, torch.float16, torch.bfloat16),
]


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


def test_engine_fused_and_unfused_agree_on_the_card(card):
    """The tiny model in float32 on the card: greedy tokens through the
    kernel equal the unfused branch's, and the kernel ran once per layer
    per decode forward."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)  # head_dim 64
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (3, 40, 17, 9, 33)]
    saved = flags.flag("fused_decode")
    outs = {}
    try:
        for mode in ("on", "off"):
            flags.set_flags({"fused_decode": mode})
            eng = ContinuousBatchingEngine(
                model, EngineConfig(max_slots=2, max_len=128,
                                    cache_dtype=torch.float32))
            before = da.LAUNCHES
            outs[mode] = [r.output for r in eng.run(
                prompts, max_new_tokens=12, max_chunk=4)]
            launched = da.LAUNCHES - before
            want = (cfg.num_hidden_layers * eng.stats["decode_forwards"]
                    if mode == "on" else 0)
            assert launched == want
    finally:
        flags.set_flags({"fused_decode": saved})
    assert outs["on"] == outs["off"]
