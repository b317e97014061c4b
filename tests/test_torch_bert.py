"""The port's BERT/ERNIE (``paddle_tpu_torch/models/bert.py``) against the
JAX package on the CPU, the tiny config's weights carried across: the
classifier's logits, loss and every gradient on the flash path (the
padding mask as segment ids; on the CPU both packages take the dense
segment reference) without and with padded tails, and on the plain SDPA
path (the mask on the keys alone); the masked-LM head with ignored
labels; the ``Ernie*`` names; and a 3-step AdamW ``TrainStep``
trajectory of the classifier over a padded batch. The two JAX paths
differ at padded positions, so each port path is held to JAX's on the
same path. Tolerances as ``tests/torch_parity.py`` states them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from torch_parity import (carry, check_grads, close, jax_call,
                          jax_value_and_grads, to_jax, to_torch,
                          trajectory)

B, S = 2, 24


def _pair(head, seed=5, **cfg):
    pt.seed(seed)
    jmodel = getattr(jbert, head)(jbert.BertConfig.tiny(**cfg))
    tmodel = getattr(tbert, head)(tbert.BertConfig.tiny(**cfg),
                                  device="cpu")
    return jmodel, carry(jmodel, tmodel)


def _batch(padded, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(1, 256, (B, S)),
             "token_type_ids": (np.arange(S) >= S // 2)[None].repeat(B, 0)
             .astype(np.int64)}
    if padded:
        mask = np.ones((B, S), np.int64)
        mask[1, S - 7:] = 0  # a ragged tail
        batch["attention_mask"] = mask
    return batch


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("flash", [True, False])
def test_classifier_logits_loss_and_every_gradient_match_jax(flash,
                                                             padded):
    jmodel, tmodel = _pair("BertForSequenceClassification",
                           use_flash_attention=flash)
    batch = _batch(padded)
    with torch.no_grad():
        close(tmodel(**to_torch(batch)), jax_call(jmodel, **to_jax(batch)))
    labels = np.array([0, 1])
    want_loss, want = jax_value_and_grads(
        jmodel, **to_jax(batch), labels=jnp.asarray(labels))
    loss = tmodel(**to_torch(batch), labels=torch.as_tensor(labels))
    loss.backward()
    close(loss, want_loss)
    check_grads(tmodel, want)


def test_masked_lm_ignores_labels_and_ties_the_decoder():
    jmodel, tmodel = _pair("BertForMaskedLM")
    batch = _batch(padded=True)
    labels = np.full((B, S), -100)
    labels[:, 3:9] = batch["input_ids"][:, 3:9]
    want_loss, want = jax_value_and_grads(
        jmodel, **to_jax(batch), labels=jnp.asarray(labels))
    loss = tmodel(**to_torch(batch), labels=torch.as_tensor(labels))
    loss.backward()
    close(loss, want_loss)
    assert "decoder_bias" in want
    check_grads(tmodel, want)


def test_ernie_names_are_the_bert_classes():
    for name in ("Config", "Model", "ForSequenceClassification",
                 "ForMaskedLM"):
        assert getattr(tbert, f"Ernie{name}") is getattr(tbert,
                                                         f"Bert{name}")
    jmodel, tmodel = _pair("ErnieModel", hidden_dropout_prob=0.1)
    jmodel.eval()
    tmodel.eval()
    batch = _batch(padded=True)
    with torch.no_grad():
        got = tmodel(**to_torch(batch))
    for g, w in zip(got, jax_call(jmodel, **to_jax(batch))):
        close(g, w)


def test_train_step_loss_trajectory_matches_jax():
    jmodel, tmodel = _pair("BertForSequenceClassification", seed=7)
    batch = dict(_batch(padded=True), labels=np.array([1, 0]))
    trajectory(jmodel, tmodel, batch)
