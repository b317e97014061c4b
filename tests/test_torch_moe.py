"""The port's one-card MoE (``paddle_tpu_torch/distributed/moe.py``) and
ERNIE-MoE (``models/ernie_moe.py``) against the JAX package on the CPU:
the GShard top-2 and Switch top-1 gates (combine, dispatch, aux loss,
dropped fraction) and the dropless top-k gate on logits full of ties
(which expert wins a tie decides everything downstream) at capacities
that drop; ``MoELayer`` (both gates) and ``DroplessMoELayer`` outputs,
aux losses and gradients; the tiny ERNIE-MoE's loss and every gradient
on both arms, and a 3-step AdamW ``TrainStep`` trajectory. Tolerances as
``tests/torch_parity.py`` states them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models import ErnieMoEConfig as JConfig
from paddle_tpu.models import ErnieMoEForCausalLM as JModel
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.models import ErnieMoEConfig, ErnieMoEForCausalLM
from torch_parity import (FWD_TOL, carry, check_grads, close,
                          jax_value_and_grads, trajectory)

T, E = 48, 4


def _tied_logits(seed):
    """Integer logits in [0, 3): most rows hold ties, some whole rows
    are one value."""
    logits = np.random.default_rng(seed).integers(0, 3, (T, E))
    logits[:4] = 1
    return logits.astype(np.float32)


@pytest.mark.parametrize("gate, capacity", [
    ("top2", 16), ("top2", 40), ("switch", 10), ("switch", 48)])
def test_capacity_gating_matches_jax_with_ties(gate, capacity):
    logits = _tied_logits(1)
    jfn = getattr(jmoe, f"_{gate}_gating")
    tfn = getattr(tmoe, f"_{gate}_gating")
    want = jfn(jnp.asarray(logits), capacity)
    got = tfn(torch.as_tensor(logits), capacity)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])
    close(got[3], want[3])
    if capacity < T // 2:
        assert float(got[3]) > 0.0  # the small capacity drops tokens


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_dropless_gating_matches_jax_with_ties(top_k):
    logits = _tied_logits(2)
    want = jmoe._dropless_topk_gating(jnp.asarray(logits), top_k)
    got = tmoe._dropless_topk_gating(torch.as_tensor(logits), top_k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1], want[1])
    close(got[2], want[2])


def _layer_pair(kind, **kw):
    pt.seed(3)
    jlayer = getattr(jmoe, kind)(32, E, d_hidden=48, **kw)
    tlayer = getattr(tmoe, kind)(32, E, d_hidden=48, device="cpu", **kw)
    return jlayer, carry(jlayer, tlayer)


@pytest.mark.parametrize("kind, kw", [
    ("MoELayer", dict(gate="gshard", capacity_factor=0.75)),
    ("MoELayer", dict(gate="switch")),
    ("DroplessMoELayer", dict(top_k=2))])
def test_moe_layers_match_jax(kind, kw):
    """Output, aux loss, dropped fraction, and the gradients of
    ``sum(y * w) + aux`` by the input and every parameter."""
    jlayer, tlayer = _layer_pair(kind, **kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    w = rng.standard_normal((2, 12, 32)).astype(np.float32)

    def jloss(p, xj):
        y, aux = functional_call(jlayer, p, xj)
        return jnp.sum(y * w) + aux, (y, aux, jlayer.last_drop_fraction)

    (want_loss, (want_y, want_aux, want_drop)), (want_p, want_x) = \
        jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            extract_params(jlayer), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    y, aux = tlayer(xt)
    loss = (y * torch.as_tensor(w)).sum() + aux
    loss.backward()
    close(y, want_y)
    close(aux, want_aux)
    close(loss, want_loss)
    close(tlayer.last_drop_fraction, want_drop)
    close(xt.grad, want_x, 1e-4)
    check_grads(tlayer, want_p)


def test_capacity_factor_defaults_to_the_flag():
    layer = tmoe.MoELayer(8, 4, device="cpu")
    assert layer.capacity_factor == tflags.flag("moe_capacity_factor") \
        == 1.25
    assert layer.capacity(64) == 40 and layer.capacity(4) == 4
    with pytest.raises(NotImplementedError, match="collectives"):
        tmoe.dropless_moe_ep_apply(None, None, None, None, None, None, None,
                                   2, None)


def _model_pair(seed=5, **cfg):
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               **cfg)
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    return jmodel, carry(jmodel, ErnieMoEForCausalLM(
        ErnieMoEConfig.tiny(**cfg), device="cpu"))


@pytest.mark.parametrize("cfg", [dict(), dict(moe_dropless=True),
                                 dict(gate="switch", moe_every=2)])
def test_ernie_moe_loss_and_every_gradient_match_jax(cfg):
    jmodel, tmodel = _model_pair(**cfg)
    ids = np.random.default_rng(3).integers(0, 256, (2, 24))
    want_loss, want = jax_value_and_grads(jmodel, jnp.asarray(ids),
                                          labels=jnp.asarray(ids))
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(ids))
    loss.backward()
    close(loss, want_loss, FWD_TOL)
    check_grads(tmodel, want)


def test_ernie_moe_train_step_trajectory_matches_jax():
    jmodel, tmodel = _model_pair(seed=7)
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    trajectory(jmodel, tmodel, {"input_ids": ids, "labels": ids})
