"""The port's RWKV (``paddle_tpu_torch/models/rwkv.py``) against the JAX
package on the CPU: the odd-even WKV scan against JAX's
``associative_scan`` form and the float64 recurrence (odd and even
lengths, huge k, gradients), the tiny model's logits, loss and every
gradient after ``load_numpy_state_dict``, and a 5-step AdamW
``TrainStep`` trajectory against the JAX ``TrainStep``. Inputs come from
numpy seeds; float32, 1e-5 for forwards, 1e-4 for gradients."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    carry,
    check_grads,
    close,
    jit_o0,
    scaled_close,
    trajectory,
)

import paddle_tpu as pt
from paddle_tpu.core.functional import extract_params, functional_call
from paddle_tpu.nn import functional as JF
from paddle_tpu.models import rwkv as J
from paddle_tpu_torch.models import rwkv as T


def _wkv_inputs(seed, b, s, d):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, d)).astype(np.float32)
    v = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (np.abs(rng.standard_normal(d)) + 0.1).astype(np.float32)
    u = (rng.standard_normal(d) * 0.3).astype(np.float32)
    return k, v, w, u


# odd and even lengths take both arms of each level of the recursion
LENGTHS = (1, 2, 3, 7, 16, 33, 100)


@pytest.mark.parametrize("s", LENGTHS)
def test_wkv_matches_jax_and_the_float64_recurrence(s):
    args = _wkv_inputs(s, 2, s, 8)
    got = T.wkv_associative(*map(torch.as_tensor, args))
    close(got, jit_o0(J.wkv_associative, *args))
    close(got, T.wkv_reference(*args))
    np.testing.assert_array_equal(T.wkv_reference(*args),
                                  J.wkv_reference(*args))


def test_wkv_large_k_stays_finite_and_exact():
    """k of +-90 (e^90 overflows float32): the running max keeps every
    sum finite, within 1e-5 of the float64 recurrence and of JAX."""
    k = np.asarray([[[80.0], [-90.0], [85.0], [0.0]]], np.float32)
    v = np.ones((1, 4, 1), np.float32)
    w, u = np.asarray([0.5], np.float32), np.asarray([0.2], np.float32)
    got = T.wkv_associative(*map(torch.as_tensor, (k, v, w, u)))
    assert torch.isfinite(got).all()
    close(got, T.wkv_reference(k, v, w, u))
    close(got, jit_o0(J.wkv_associative, k, v, w, u))


def test_wkv_gradients_match_jax():
    args = _wkv_inputs(4, 2, 21, 8)
    cot = np.random.default_rng(5).standard_normal((2, 21, 8)).astype(
        np.float32)

    def jloss(*a):
        return jnp.sum(J.wkv_associative(*a) * cot)

    want = jit_o0(jax.grad(jloss, argnums=(0, 1, 2, 3)), *args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (T.wkv_associative(*ts) * torch.as_tensor(cot)).sum().backward()
    for t, g in zip(ts, want):
        scaled_close(t.grad, g)


def test_wkv_keeps_v_dtype_and_computes_in_float32():
    args = _wkv_inputs(6, 1, 9, 4)
    k, v, w, u = (torch.as_tensor(a).to(torch.bfloat16) for a in args)
    got = T.wkv_associative(k, v, w, u)
    assert got.dtype == torch.bfloat16
    want = T.wkv_associative(k.float(), v.float(), w.float(), u.float())
    torch.testing.assert_close(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_an_inclusive_scan(n):
    """Under integer addition the odd-even recursion is exactly cumsum;
    under a non-commutative combine (2 x 2 matrix products) it keeps the
    order of the operands."""
    x = torch.arange(3 * n).reshape(3, n) + 1
    (got,) = T.associative_scan(lambda a, b: (a[0] + b[0],), (x,))
    assert torch.equal(got, torch.cumsum(x, dim=1))
    mats = torch.as_tensor(np.random.default_rng(n).integers(
        -2, 3, (1, n, 2, 2)))
    (prod,) = T.associative_scan(lambda a, b: (a[0] @ b[0],), (mats,))
    acc = mats[:, 0]
    for t in range(1, n):
        acc = acc @ mats[:, t]
    assert torch.equal(prod[:, -1], acc)


def _pair(seed=5, **cfg):
    pt.seed(seed)
    jmodel = J.RWKVForCausalLM(J.RWKVConfig.tiny(**cfg))
    tmodel = T.RWKVForCausalLM(T.RWKVConfig.tiny(**cfg), device="cpu")
    return jmodel, carry(jmodel, tmodel)


def test_tiny_rwkv_logits_loss_and_every_gradient_match_jax():
    jmodel, tmodel = _pair()
    ids = np.random.default_rng(3).integers(0, 256, (2, 24))
    jids = jnp.asarray(ids)

    def jloss(p):
        logits = functional_call(jmodel, p, jids)
        return JF.cross_entropy(logits[:, :-1].reshape(-1, 256),
                                jids[:, 1:].reshape(-1)), logits

    (want_loss, want_logits), want = jit_o0(
        jax.value_and_grad(jloss, has_aux=True), extract_params(jmodel))
    with torch.no_grad():
        close(tmodel(torch.as_tensor(ids)), want_logits)
    loss = tmodel(torch.as_tensor(ids), torch.as_tensor(ids))
    close(loss, want_loss)
    loss.backward()
    # the embedding, two norms and the head: 6 tensors; 18 a block
    assert len(want) == 6 + 18 * 2
    check_grads(tmodel, want)


def test_tiny_rwkv_trains_like_jax():
    """Five AdamW steps (float32 masters) on one batch through both
    ``TrainStep``s: the losses within 1e-4 relative, and falling."""
    jmodel, tmodel = _pair(seed=7)
    ids = np.random.default_rng(0).integers(0, 256, (2, 24))
    trajectory(jmodel, tmodel, {"input_ids": ids, "labels": ids}, steps=5)


def test_initial_parameters_follow_the_jax_initializers():
    model = T.RWKVForCausalLM(T.RWKVConfig.tiny(num_hidden_layers=3),
                              device="cpu", seed=1)
    for i, blk in enumerate(model.blocks):
        assert torch.all(blk.att.time_decay == -1.0 - i / 2)
        assert torch.all(blk.att.time_first == 0.3)
        assert torch.all(blk.ffn.time_mix_r == 0.5)
    assert abs(float(model.head.weight.detach().std()) - 0.02) < 2e-3
    assert model.head.bias is None


def test_rwkv4_169m_widths_and_parameter_count():
    """The published widths, and their parameter count: the tiny model's
    count by the same formula as its built parameters, then 169M."""
    def count(c):
        h, f, v, n = (c.hidden_size, c.intermediate_size, c.vocab_size,
                      c.num_hidden_layers)
        block = 4 * h + 5 * h + 4 * h * h + 2 * h + 2 * h * f + h * h
        return 2 * v * h + 4 * h + n * block

    tiny = T.RWKVConfig.tiny()
    built = T.RWKVForCausalLM(tiny, device="cpu")
    assert count(tiny) == sum(p.numel() for p in built.parameters())
    cfg = T.RWKVConfig.rwkv4_169m()
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.vocab_size) == (12, 768, 3072, 50277)
    assert 168e6 < count(cfg) < 170e6
