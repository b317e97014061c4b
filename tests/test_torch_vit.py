"""The port's ViT (``paddle_tpu_torch/models/vit.py``) against the JAX
package on the CPU: the tiny config, the port's weights carried into the
JAX model, float32. Logits and the loss within 1e-5, every gradient
within 1e-4 of each tensor's largest entry, in the NCHW and the
channels-last patch embedding; and a 5-step AdamW ``TrainStep``
trajectory against the jitted JAX step within 1e-4 relative
(``tests/torch_parity.py``)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.models import ViT as JViT
from paddle_tpu.models import ViTConfig as JConfig
from paddle_tpu_torch.models import ViT, ViTConfig
from torch_parity import (close, jax_twin, jit_o0, scaled_close, to_torch,
                          trajectory)

BATCH = {"pixel_values": np.random.default_rng(0).standard_normal(
    (3, 3, 32, 32)).astype(np.float32),
    "labels": np.random.default_rng(1).integers(0, 10, (3,))}


def _pair(seed=0, **cfg):
    tmodel = ViT(ViTConfig.tiny(**cfg), device="cpu", seed=seed)
    return jax_twin(lambda: JViT(JConfig.tiny(**cfg)), tmodel), tmodel


@pytest.fixture(scope="module")
def want():
    """Both layouts' logits, loss and gradients in one jitted call."""
    pairs = {cl: _pair(channels_last=cl) for cl in (False, True)}
    x = jnp.asarray(BATCH["pixel_values"])
    y = jnp.asarray(BATCH["labels"])

    def body(params):
        out = {}
        for cl, (jm, _) in pairs.items():
            def loss(p, jm=jm):
                return functional_call(jm, p, x, labels=y)

            logits = functional_call(jm, params[cl], x)
            value, grads = jax.value_and_grad(loss)(params[cl])
            out[cl] = (logits, value, grads)
        return out

    params = {cl: extract_params(jm) for cl, (jm, _) in pairs.items()}
    return pairs, jax.tree_util.tree_map(np.asarray, jit_o0(body, params))


@pytest.mark.parametrize("channels_last", [False, True])
def test_tiny_vit_logits_loss_and_every_gradient_match_jax(channels_last,
                                                            want):
    pairs, out = want
    _, tmodel = pairs[channels_last]
    logits, loss, grads = out[channels_last]
    batch = to_torch(BATCH)
    with torch.no_grad():
        close(tmodel(batch["pixel_values"]), logits)
    got = tmodel(**batch)
    got.backward()
    close(got, loss)
    named = dict(tmodel.named_parameters())
    assert set(named) == set(grads) and len(grads) == 8 + 12 * 2
    for name, g in grads.items():
        scaled_close(named[name].grad, g)


def test_vit_l_config_matches_jax():
    assert ViTConfig.vit_l() == ViTConfig(**vars(JConfig.vit_l()))
    assert ViTConfig.vit_l().num_patches == 196


def test_train_step_loss_trajectory_matches_jax():
    jmodel, tmodel = _pair(seed=3)
    trajectory(jmodel, tmodel, BATCH, steps=5)
