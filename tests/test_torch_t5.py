"""The port's T5 (``paddle_tpu_torch/models/t5.py``) against the JAX
package on the CPU, the tiny config's weights carried across: the
relative-position bucket table, exactly, for every relative position in
[-1024, 1024] in both directions; logits, the loss and every gradient of
the relu and the gated-gelu MLP, without masks (cross-attention on the
flash path, whose CPU path is the dense reference) and with encoder and
decoder padding masks (the plain SDPA); and greedy ``generate`` tokens,
cached and uncached, with and without an encoder mask, equal to JAX's
(an untied head, so that the tokens vary).
Tolerances as ``tests/torch_parity.py`` states them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import T5Config as JConfig
from paddle_tpu.models import T5ForConditionalGeneration as JModel
from paddle_tpu.models.t5 import _relative_position_bucket as jbucket
from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration
from paddle_tpu_torch.models.t5 import _relative_position_bucket as tbucket
from torch_parity import (carry, check_grads, close, jax_call,
                          jax_value_and_grads, to_jax, to_torch)


def _pair(seed=5, **cfg):
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    return jmodel, carry(jmodel, T5ForConditionalGeneration(
        T5Config.tiny(**cfg), device="cpu"))


def _masks(b, s, pad):
    mask = np.ones((b, s), np.int64)
    mask[1, s - pad:] = 0
    return mask


@pytest.mark.parametrize("buckets, distance", [(32, 128), (64, 256)])
def test_bucket_table_is_jax_exactly(buckets, distance):
    """float32 logs truncated to integers: a bucket that flips at a
    boundary would show here."""
    rp = np.arange(-1024, 1025)
    for bidirectional in (True, False):
        want = np.asarray(jbucket(jnp.asarray(rp), bidirectional, buckets,
                                  distance))
        got = tbucket(torch.as_tensor(rp), bidirectional, buckets,
                      distance).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_logits_loss_and_every_gradient_match_jax(ff, masked):
    jmodel, tmodel = _pair(feed_forward_proj=ff)
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(1, 512, (2, 20)),
             "decoder_input_ids": rng.integers(1, 512, (2, 12))}
    if masked:
        batch["attention_mask"] = _masks(2, 20, 6)
        batch["decoder_attention_mask"] = _masks(2, 12, 3)
    with torch.no_grad():
        close(tmodel(**to_torch(batch)), jax_call(jmodel, **to_jax(batch)))
    labels = rng.integers(0, 512, (2, 12))
    labels[0, :2] = 0  # pad_token_id: ignored
    batch["labels"] = labels
    want_loss, want = jax_value_and_grads(jmodel, **to_jax(batch))
    loss = tmodel(**to_torch(batch))
    loss.backward()
    close(loss, want_loss)
    check_grads(tmodel, want)


@pytest.mark.parametrize("masked", [False, True])
def test_generate_tokens_cached_and_uncached_match_jax(masked):
    """An untied head: the tied one, at random weights, only repeats the
    start token (its own embedding dominates the residual stream)."""
    jmodel, tmodel = _pair(tie_word_embeddings=False)
    ids = np.random.default_rng(4).integers(1, 512, (2, 14))
    kw = {"attention_mask": _masks(2, 14, 5)} if masked else {}
    for use_cache in (True, False):
        want = jmodel.generate(jnp.asarray(ids), max_length=10,
                               use_cache=use_cache, **to_jax(kw))
        got = tmodel.generate(torch.as_tensor(ids), max_length=10,
                              use_cache=use_cache, **to_torch(kw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
