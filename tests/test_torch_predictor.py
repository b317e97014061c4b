"""The port's Paddle Inference predictor (paddle_tpu_torch.inference:
``Config``, ``Predictor``, ``create_predictor``) and the Llama's shared
scalar ``cache_index`` branch it decodes with, against the JAX package on
the CPU. The tiny Llama of ``tests/test_generation.py::
TestPredictorIntegration`` (2 layers, plain attention; ``max_seq_len``
64, buckets (16, 32), float32 caches) with its weights carried across:
the shared-index prefill and decodes give the JAX logits to 1e-5, a
decode at or past ``max_len`` clamped onto the last row as
``lax.dynamic_update_slice`` clamps; greedy tokens identical to the JAX
``Predictor``'s (with and without the repetition penalty) and to naive
re-forward decoding; beam tokens identical and scores to 1e-5 (eos, a
length penalty, temperature); ``run`` logits to 1e-5 (plain attention and
flash attention, whose CPU path is the dense reference); ``Config.
summary()`` equal; the ``create_predictor`` error; sampling reproducible
from ``seed``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.inference import create_predictor as j_create_predictor
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.inference import Config, Predictor, create_predictor
from paddle_tpu_torch.inference.paged import PagedState, init_paged_pool
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM


def _pair(flash=False):
    pt.seed(0)
    jmodel = JModel(JLlamaConfig.tiny(num_hidden_layers=2,
                                      use_flash_attention=flash))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=2, use_flash_attention=flash), device="cpu")
    load_numpy_state_dict(
        tmodel, {k: np.asarray(v) for k, v in jmodel.state_dict().items()})
    return jmodel, tmodel


def _configs():
    jc, tc = JConfig(), Config()
    for c in (jc, tc):
        c.max_seq_len = 64
        c.seq_buckets = (16, 32)
    jc.decode_dtype = jnp.float32
    tc.decode_dtype = torch.float32
    return jc, tc


@pytest.fixture(scope="module")
def preds():
    """One JAX Predictor and one port Predictor over the same weights."""
    jmodel, tmodel = _pair()
    jc, tc = _configs()
    return JPredictor(jmodel, jc), Predictor(tmodel, tc)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_shared_index_branch_matches_jax(preds):
    """A prefill of 8 rows at 0 into a 16-row cache, decodes at 8..15,
    then decodes at 16 and 21: JAX clamps their write onto row 15 and
    their mask sees every row; the port must do the same."""
    jpred, tpred = preds
    jmodel, tmodel = jpred.model, tpred.model
    b, max_len, s = 2, 16, 8
    jc = jmodel.init_kv_caches(b, max_len, dtype=jnp.float32)
    tc = tmodel.init_kv_caches(b, max_len, dtype=torch.float32)
    rng = np.random.default_rng(4)
    steps = [(0, s)] + [(i, 1) for i in range(s, max_len)] + [(16, 1),
                                                               (21, 1)]
    for idx, n in steps:
        ids = rng.integers(1, 256, (b, n))
        pos = np.broadcast_to(idx + np.arange(n), (b, n))
        jl, jc = jmodel(jnp.asarray(ids), position_ids=jnp.asarray(pos),
                        kv_caches=jc, cache_index=idx)
        # the port takes a Python int or a 0-dim tensor
        tidx = torch.tensor(idx) if idx % 2 else idx
        tl, _ = tmodel(torch.as_tensor(ids), position_ids=torch.as_tensor(
            pos.copy()), kv_caches=tc, cache_index=tidx)
        _close(tl.numpy(), jl)
        for (jk, jv), (tk, tv) in zip(jc, tc):
            _close(tk.numpy(), jk)
            _close(tv.numpy(), jv)
    # the two clamped decodes rewrote row 15 only
    assert not np.array_equal(tc[0][0][:, 15].numpy(),
                              np.zeros_like(tc[0][0][:, 15].numpy()))


def test_shared_index_on_int8_or_paged_caches_raises(preds):
    _, tpred = preds
    tmodel = tpred.model
    ids = torch.ones((2, 4), dtype=torch.long)
    q8 = tmodel.init_kv_caches(2, 16, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel(ids, kv_caches=q8, cache_index=0)
    cfg = tmodel.config
    pool = init_paged_pool(cfg.num_hidden_layers, 5, 8,
                           cfg.num_key_value_heads, cfg.head_dim,
                           dtype=torch.float32, device="cpu")
    state = PagedState(torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel(ids, kv_caches=[(c, state) for c in pool], cache_index=0)


@pytest.mark.parametrize("penalty", [1.0, 5.0])
def test_greedy_tokens_identical_to_jax(preds, penalty):
    jpred, tpred = preds
    ids = _ids(2, (2, 7))
    want = jpred.generate(ids, max_new_tokens=12,
                          repetition_penalty=penalty)
    got = tpred.generate(ids, max_new_tokens=12, repetition_penalty=penalty)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)
    assert tpred.last_ttft_ms is not None and tpred.last_ttft_ms > 0


def test_greedy_matches_naive_reforward(preds):
    """The port's form of tests/test_inference.py::
    test_generate_matches_naive: greedy decoding through the cache equals
    a no-cache forward over the whole sequence at every step; a prompt
    longer than the buckets takes max_seq_len."""
    _, tpred = preds
    for prompt in (_ids(0, (2, 7)), _ids(1, (1, 40))):
        seq = torch.as_tensor(prompt)
        with torch.no_grad():
            for _ in range(6):
                nxt = tpred.model(seq)[:, -1].argmax(-1)
                seq = torch.cat([seq, nxt[:, None]], dim=1)
        got = create_predictor(tpred.model, tpred.config).generate(
            prompt, max_new_tokens=6)
        np.testing.assert_array_equal(got, seq[:, -6:].numpy())


def test_eos_stops_when_every_row_emitted_it(preds):
    jpred, tpred = preds
    ids = _ids(5, (2, 7))
    full = jpred.generate(ids, max_new_tokens=10)
    eos = int(full[0, 3])
    want = jpred.generate(ids, max_new_tokens=10, eos_token_id=eos)
    got = tpred.generate(ids, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    dict(num_beams=3),
    dict(num_beams=2, length_penalty=1.0, temperature=0.7, eos="greedy"),
    dict(decode_strategy="beam_search", length_penalty=0.6,
         repetition_penalty=1.5, eos="greedy"),
])
def test_beam_search_identical_to_jax(preds, case):
    jpred, tpred = preds
    ids = _ids(3, (2, 7))
    case = dict(case)
    if case.pop("eos", None):
        # an eos the beams will meet: the second greedy token of row 0
        case["eos_token_id"] = int(jpred.generate(ids, 3)[0, 1])
    want = jpred.generate(ids, max_new_tokens=6, **case)
    got = tpred.generate(ids, max_new_tokens=6, **case)
    np.testing.assert_array_equal(got, want)
    _close(tpred._last_beam_scores, jpred._last_beam_scores)
    assert tpred.last_ttft_ms > 0


@pytest.mark.parametrize("flash", [False, True])
def test_run_logits_match_jax(preds, flash):
    jpred, tpred = preds
    if flash:
        jmodel, tmodel = _pair(flash=True)
        jpred, tpred = JPredictor(jmodel), Predictor(tmodel)
    for ids in (np.array([[1, 2, 3]]), _ids(6, (2, 9))):
        got = tpred.run(ids)
        assert got.shape == (*ids.shape, 256) and not got.requires_grad
        _close(got.numpy(), jpred.run(ids))


def test_config_summary_and_defaults_match_jax():
    jc, tc = JConfig("/some/model/dir"), Config("/some/model/dir")
    for c in (jc, tc):
        c.enable_memory_optim()
        c.switch_ir_optim(False)
        c.enable_use_gpu(100, 0)
        c.set_cpu_math_library_num_threads(4)
    assert tc.summary() == jc.summary()
    assert tc.decode_dtype == torch.bfloat16
    assert tuple(tc.seq_buckets) == tuple(jc.seq_buckets)
    assert tc.max_seq_len == jc.max_seq_len and not tc._ir_optim


def test_create_predictor_refuses_what_jax_refuses(preds):
    _, tpred = preds
    with pytest.raises(TypeError) as jerr:
        j_create_predictor("/some/model/dir")
    with pytest.raises(TypeError) as terr:
        create_predictor("/some/model/dir")
    assert "program-file loading" in str(jerr.value) \
        and "program-file loading" in str(terr.value)
    assert isinstance(create_predictor(tpred.model), Predictor)


def test_sampling_reproducible_from_seed(preds):
    """Sampled tokens come from the port's generator, so they differ from
    the JAX Predictor's by design: the same seed gives the same tokens,
    another seed others."""
    _, tpred = preds
    ids = _ids(1, (2, 7))
    kw = dict(max_new_tokens=6, decode_strategy="sampling", top_k=8,
              top_p=0.9, temperature=1.3, repetition_penalty=1.2)
    a = tpred.generate(ids, seed=7, **kw)
    assert a.shape == (2, 6) and ((a >= 0) & (a < 256)).all()
    np.testing.assert_array_equal(a, tpred.generate(ids, seed=7, **kw))
    assert any(not np.array_equal(a, tpred.generate(ids, seed=s, **kw))
               for s in (8, 9))
