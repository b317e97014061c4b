"""The port's Mamba (``paddle_tpu_torch/models/mamba.py``) against the JAX
package on the CPU: the tiny model's logits, loss and every parameter's
gradient after ``load_numpy_state_dict`` (the chunked scan and the
associative branch, and the chunked scan over 32 states), a 5-step ``TrainStep`` trajectory against the JAX
``TrainStep`` on a one-device CPU mesh, the new activations, and the
scan dispatch of the mixer. Inputs come from numpy with one seed."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.models import MambaConfig as JConfig
from paddle_tpu.models import MambaForCausalLM as JModel
from paddle_tpu.nn import functional as JF
from paddle_tpu.trainer import TrainStep as JTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_numpy_state_dict
from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.trainer import TrainStep

# the chunked branch needs s % scan_chunk == 0 on the CPU, as in JAX
CFGS = {"chunked": dict(use_chunked_scan=True, scan_chunk=16),
        "associative": dict(use_chunked_scan=False)}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(seed=5, **cfg):
    pt.seed(seed)
    jmodel = JModel(JConfig.tiny(**cfg))
    state = {k: np.asarray(v) for k, v in jmodel.state_dict().items()}
    tmodel = MambaForCausalLM(MambaConfig.tiny(**cfg), device="cpu")
    load_numpy_state_dict(tmodel, state)
    return jmodel, tmodel


@pytest.mark.parametrize("branch", list(CFGS))
def test_tiny_mamba_logits_loss_and_every_gradient_match_jax(branch):
    _check_logits_loss_and_gradients(**CFGS[branch])


def test_state_size_over_16_matches_jax():
    """32 states: the chunked scan splits them into two blocks of 16 (the
    kernels' limit; the plain versions here), sums y, du and ddelta over
    the blocks and joins the rest; the logits, loss and every gradient
    match JAX's chunked scan over all 32 at once."""
    _check_logits_loss_and_gradients(state_size=32, **CFGS["chunked"])


def _check_logits_loss_and_gradients(**cfg):
    jmodel, tmodel = _pair(**cfg)
    ids = np.random.default_rng(3).integers(0, 256, (2, 32))

    def jloss(p):
        logits = functional_call(jmodel, p, jnp.asarray(ids))
        return JF.cross_entropy(logits[:, :-1],
                                jnp.asarray(ids)[:, 1:]), logits

    (want_loss, want_logits), want = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(extract_params(jmodel))
    with torch.no_grad():
        _close(tmodel(torch.as_tensor(ids)), want_logits, 1e-5)
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(ids))
    loss.backward()
    _close(loss, want_loss, 1e-5)
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want) and len(got) == 22
    for name, g in want.items():
        _close(got[name].grad, g, 1e-5)


def test_train_step_loss_trajectory_matches_jax():
    """Five AdamW steps (float32, as ``bench_mamba``) on one fixed batch
    through the chunked scan: the losses within 1e-5 of JAX's."""
    jmodel, tmodel = _pair(seed=7, **CFGS["chunked"])
    opt = dict(learning_rate=3e-3, weight_decay=0.01, multi_precision=True)
    js = JTrainStep(jmodel, jopt.AdamW(**opt),
                    jdist.build_mesh(devices=jax.devices()[:1]))
    ts = TrainStep(tmodel, topt.AdamW(**opt))
    ids = np.random.default_rng(0).integers(0, 256, (2, 32))
    batch = {"input_ids": ids, "labels": ids}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(5):
        want = float(js.run(jbatch))
        losses.append(float(ts.run(batch)))
        np.testing.assert_allclose(losses[-1], want, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_activations_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 81),
                        np.random.default_rng(1).standard_normal(40) * 3])
    x = x.astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    _close(TF.silu(tx), JF.silu(jx), 1e-6)
    # beyond torch's softplus threshold too: logaddexp(x, 0) everywhere
    _close(TF.softplus(tx), JF.softplus(jx), 1e-6)
    _close(TF.softplus(tx, beta=2.0), JF.softplus(jx, beta=2.0), 1e-6)
    _close(TF.gelu(tx), JF.gelu(jx), 1e-6)


@pytest.mark.parametrize("branch", list(CFGS))
def test_mixer_sends_every_non_cpu_tensor_to_the_kernels(branch):
    """On the CPU the mixer takes JAX's branch (the chunked plain versions
    only when the chunk divides s); any other device reaches the kernel
    wrappers, whatever ``use_chunked_scan`` and s are (here a device that
    is not the card, which the wrappers refuse)."""
    from paddle_tpu_torch.kernels import selective_scan as tss

    model = MambaForCausalLM(MambaConfig.tiny(**CFGS[branch]), device="cpu")
    mixer = model.layers[0].mixer
    calls = []
    real = tss.selective_scan_fwd

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    tss.selective_scan_fwd = spy
    try:
        with torch.no_grad():
            for s in (32, 30):
                mixer(torch.randn(1, s, 64))
        want = [32] if branch == "chunked" else []
        assert calls == want
        mixer.to("meta")
        with pytest.raises(ValueError, match="unsupported device"):
            mixer(torch.empty((1, 30, 64), device="meta"))
        assert calls == want + [30]
    finally:
        tss.selective_scan_fwd = real
