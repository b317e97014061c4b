"""The port's GPT (``paddle_tpu_torch/models/gpt.py``) against the JAX
package on the CPU, the tiny config's weights carried across: logits,
the loss and every gradient (flash attention, whose CPU path is the dense
reference; plain SDPA; the chunked head + loss), the Predictor's
scalar-index cache protocol (a prefill at 0, decodes, a chunk at a later
index, a decode past ``max_len`` clamped onto the last row), greedy
``Predictor.generate`` tokens, and a 3-step AdamW ``TrainStep``
trajectory. Inputs come from numpy seeds; tolerances as
``tests/torch_parity.py`` states them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import Config as JInferConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from torch_parity import (carry, check_grads, close, jax_call,
                          jax_value_and_grads, trajectory)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _pair(seed=5, **cfg):
    cfg = dict(NO_DROPOUT, **cfg)
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    return jmodel, carry(jmodel, GPTForCausalLM(GPTConfig.tiny(**cfg),
                                                device="cpu"))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, shape)


@pytest.mark.parametrize("cfg", [
    dict(), dict(use_flash_attention=False),
    # chunks that do not divide the 23 shifted positions
    dict(fused_head_loss_chunk=5)])
def test_tiny_gpt_logits_loss_and_every_gradient_match_jax(cfg):
    jmodel, tmodel = _pair(**cfg)
    ids = _ids(3, (2, 24))
    labels = ids.copy()
    labels[0, 5] = -100  # an ignored position
    with torch.no_grad():
        close(tmodel(torch.as_tensor(ids)),
              jax_call(jmodel, jnp.asarray(ids)))
    want_loss, want = jax_value_and_grads(jmodel, jnp.asarray(ids),
                                          labels=jnp.asarray(labels))
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    close(loss, want_loss)
    assert len(want) == 5 + 12 * 2
    check_grads(tmodel, want)


def test_shared_index_cache_steps_match_jax():
    """A prefill of 8 rows at 0 into a 16-row float32 cache, decodes at
    8..10, a 3-row chunk at 11 (the masked form), decodes at 14, 15 and
    16: JAX clamps the last write onto row 15 and its mask sees every
    row. Logits and caches within 1e-5 at every call."""
    jmodel, tmodel = _pair()
    b, max_len = 2, 16
    jc = jmodel.init_kv_caches(b, max_len, dtype=jnp.float32)
    tc = tmodel.init_kv_caches(b, max_len, dtype=torch.float32)
    calls = [(_ids(1, (b, 8)), 0)] + [(_ids(10 + i, (b, 1)), 8 + i)
                                      for i in range(3)]
    calls += [(_ids(20, (b, 3)), 11)] + [(_ids(30 + i, (b, 1)), i)
                                         for i in (14, 15, 16)]
    for chunk, idx in calls:
        pos = idx + np.arange(chunk.shape[1])[None].repeat(b, 0)
        want, jc = jmodel(jnp.asarray(chunk), position_ids=jnp.asarray(pos),
                          kv_caches=jc, cache_index=idx)
        got, tc = tmodel(torch.as_tensor(chunk),
                         position_ids=torch.as_tensor(pos), kv_caches=tc,
                         cache_index=idx)
        close(got, want)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        close(tk, jk)
        close(tv, jv)
    with pytest.raises(ValueError, match="scalar cache_index"):
        tmodel(torch.as_tensor(_ids(2, (b, 1))), kv_caches=tc,
               cache_index=torch.tensor([3, 4]))


def test_predictor_greedy_tokens_match_jax():
    """``create_predictor``'s generic Predictor over GPT: bucket-padded
    prefill, then one decode a token at the shared index; the greedy
    tokens equal the JAX Predictor's."""
    jmodel, tmodel = _pair()
    jc, tc = JInferConfig(), Config()
    for c in (jc, tc):
        c.max_seq_len = 64
        c.seq_buckets = (16, 32)
    jc.decode_dtype, tc.decode_dtype = jnp.float32, torch.float32
    ids = _ids(4, (2, 11))
    want = JPredictor(jmodel, jc).generate(ids, max_new_tokens=10)
    got = Predictor(tmodel, tc).generate(ids, max_new_tokens=10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_train_step_loss_trajectory_matches_jax():
    jmodel, tmodel = _pair(seed=7)
    ids = _ids(0, (2, 32))
    trajectory(jmodel, tmodel, {"input_ids": ids, "labels": ids})
