"""The port's losses (``paddle_tpu_torch/nn/functional/loss.py``, the 19
layers of ``nn/layer/loss.py``) and ``one_hot``, ``maxout`` and ``swish``
against the JAX package on the CPU: every case's value and its gradient
with respect to every floating input (of a fixed weighting of the output)
through one jitted JAX program a family, float32, 1e-5 for values and 1e-4
of each gradient's largest entry. Ties sit on purpose at the hinges, the
clips and |0|, where ``jnp.maximum`` splits the gradient and ``jnp.abs``
gives 1. The independent witness: ``ctc_loss`` with ``reduction="none"``
against ``torch.nn.functional.ctc_loss`` on ``log_softmax``ed inputs."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import close, jit_o0, scaled_close

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

N, C = 6, 5


def _f(*shape, seed, scale=1.0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ids(*shape, seed, n=C):
    return np.random.default_rng(seed).integers(0, n, shape)


def _sign(*shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _log_probs(seed):
    x = _f(N, C, seed=seed)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _with_ties(x, y, idx=(0, 3)):
    """``x`` equal to ``y`` at ``idx``: |x - y| = 0 there."""
    x = x.copy()
    x.flat[list(idx)] = y.flat[list(idx)]
    return x


def _ce_label():
    lab = _ids(N, seed=2)
    lab[1] = -100
    return lab


def _margin_args():
    a, b, lab = _f(N, seed=1), _f(N, seed=2), _sign(N, seed=3)
    # -label * (a - b) + 0.1 == 0 at entry 0: the hinge's tie
    b[0] = a[0] - 0.1 / lab[0]
    return [a, b, lab]


def _hinge_args():
    x, lab = _f(N, seed=1), _sign(N, seed=2)
    lab[0], x[0] = -1.0, 1.0  # margin - x == 0
    return [x, lab]


def _prob_args(edges=()):
    """Probabilities and targets; ``edges`` put exact 0 and 1 first."""
    p, y = _f(N, C, seed=1, lo=0.02, hi=0.98), _f(N, C, seed=2, lo=0, hi=1)
    p.flat[:len(edges)] = edges  # at the 1e-12 clips
    return [p, y]


# (id, function, args builder, keyword arguments)
FUNCTIONAL = [
    ("ce_mean", "cross_entropy", lambda: [_f(N, C, seed=1), _ce_label()], {}),
    ("ce_sum", "cross_entropy", lambda: [_f(N, C, seed=1), _ce_label()],
     dict(reduction="sum")),
    ("ce_none_smooth", "cross_entropy",
     lambda: [_f(N, C, seed=1), _ids(N, seed=2)],
     dict(reduction="none", label_smoothing=0.1)),
    ("ce_soft_axis1", "cross_entropy",
     lambda: [_f(2, C, 3, seed=1), _f(2, C, 3, seed=2, lo=0, hi=1)],
     dict(soft_label=True, axis=1)),
    ("mse_mean", "mse_loss", lambda: [_f(N, C, seed=1), _f(N, C, seed=2)],
     {}),
    ("mse_none", "mse_loss", lambda: [_f(N, C, seed=1), _f(N, C, seed=2)],
     dict(reduction="none")),
    ("l1_mean_ties", "l1_loss",
     lambda: [_with_ties(_f(N, C, seed=1), _f(N, C, seed=2)),
              _f(N, C, seed=2)], {}),
    ("l1_sum", "l1_loss", lambda: [_f(N, C, seed=1), _f(N, C, seed=2)],
     dict(reduction="sum")),
    ("nll_mean", "nll_loss", lambda: [_log_probs(1), _ce_label()], {}),
    ("nll_none", "nll_loss", lambda: [_log_probs(1), _ids(N, seed=2)],
     dict(reduction="none")),
    ("bce_logits_mean", "binary_cross_entropy_with_logits",
     lambda: [np.concatenate([[0.0], _f(N - 1, seed=1)]).astype(np.float32),
              _f(N, seed=2, lo=0, hi=1)], {}),
    ("bce_logits_sum", "binary_cross_entropy_with_logits",
     lambda: [_f(N, C, seed=1, scale=4), _f(N, C, seed=2, lo=0, hi=1)],
     dict(reduction="sum")),
    ("kl_mean_zero_target", "kl_div",
     lambda: [_log_probs(1), np.where(np.arange(N * C).reshape(N, C) % 7 == 0,
                                      0.0, 0.3).astype(np.float32)], {}),
    ("kl_batchmean", "kl_div",
     lambda: [_log_probs(1), _f(N, C, seed=2, lo=0, hi=1)],
     dict(reduction="batchmean")),
    ("kl_none", "kl_div", lambda: [_log_probs(1), _f(N, C, seed=2, lo=0,
                                                     hi=1)],
     dict(reduction="none")),
    ("margin_ranking_tie", "margin_ranking_loss", _margin_args,
     dict(margin=0.1)),
    ("smooth_l1", "smooth_l1_loss",
     lambda: [_with_ties(_f(N, C, seed=1), _f(N, C, seed=2)),
              _f(N, C, seed=2)], {}),
    ("smooth_l1_delta", "smooth_l1_loss",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2)],
     dict(delta=0.5, reduction="sum")),
    ("triplet", "triplet_margin_loss",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _f(N, C, seed=3)], {}),
    ("triplet_swap_p1", "triplet_margin_loss",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _f(N, C, seed=3)],
     dict(p=1.0, swap=True, reduction="none")),
    ("cosine_embedding", "cosine_embedding_loss",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _sign(N, seed=3)],
     dict(margin=0.1)),
    ("cosine_embedding_pair", "cosine_embedding_loss",
     lambda: [_f(C, seed=1), _f(C, seed=2), np.asarray([1.0], np.float32)],
     dict(reduction="sum")),
    # past torch's softplus threshold of 20
    ("soft_margin_large", "soft_margin_loss",
     lambda: [_f(N, C, seed=1, scale=30), _sign(N, C, seed=2)], {}),
    ("hinge_embedding_tie", "hinge_embedding_loss", _hinge_args, {}),
    ("poisson_log", "poisson_nll_loss",
     lambda: [_f(N, seed=1), _f(N, seed=2, lo=0.2, hi=4)], {}),
    ("poisson_full", "poisson_nll_loss",
     lambda: [_f(N, seed=1, lo=0.5, hi=3), _f(N, seed=2, lo=0.2, hi=4)],
     dict(log_input=False, full=True, reduction="sum")),
    ("gaussian", "gaussian_nll_loss",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _f(N, C, seed=3, lo=0.1,
                                                     hi=2)], {}),
    ("gaussian_full_floor", "gaussian_nll_loss",
     lambda: [_f(N, seed=1), _f(N, seed=2),
              np.asarray([1e-8, 0.5, 1, 2, 1e-7, 3], np.float32)],
     dict(full=True, reduction="none")),
    ("multi_label", "multi_label_soft_margin_loss",
     lambda: [_f(N, C, seed=1), _ids(N, C, seed=2, n=2).astype(np.float32)],
     {}),
    ("multi_label_weight", "multi_label_soft_margin_loss",
     lambda: [_f(N, C, seed=1), _ids(N, C, seed=2, n=2).astype(np.float32),
              _f(C, seed=3, lo=0.5, hi=2)], dict(reduction="sum")),
    ("focal_sum", "sigmoid_focal_loss",
     lambda: [_f(N, C, seed=1, scale=2), _ids(N, C, seed=2, n=2)], {}),
    ("focal_normalizer_mean", "sigmoid_focal_loss",
     lambda: [_f(N, C, seed=1, scale=2), _ids(N, C, seed=2, n=2),
              np.asarray(3.0, np.float32)],
     dict(reduction="mean", gamma=1.5)),
    ("dice", "dice_loss",
     lambda: [_f(2, 4, C, seed=1, lo=0, hi=1), _ids(2, 4, 1, seed=2)], {}),
    ("log_loss", "log_loss",
     lambda: [_f(N, 1, seed=1, lo=0.01, hi=0.99), _ids(N, 1, seed=2,
                                                      n=2).astype(
                                                          np.float32)], {}),
    ("square_error_cost", "square_error_cost",
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2)], {}),
    ("bce_edges", "binary_cross_entropy", lambda: _prob_args((0.0, 1.0)),
     {}),
    ("bce_weight_none", "binary_cross_entropy",
     lambda: _prob_args() + [_f(C, seed=3, lo=0.5, hi=2)],
     dict(reduction="none")),
]

# (id, layer, constructor kwargs, args builder, forward kwargs)
LAYERS = [
    ("CrossEntropyLoss", "CrossEntropyLoss", dict(label_smoothing=0.05),
     lambda: [_f(N, C, seed=1), _ids(N, seed=2)], {}),
    ("MSELoss", "MSELoss", {}, lambda: [_f(N, C, seed=1), _f(N, C, seed=2)],
     {}),
    ("L1Loss", "L1Loss", dict(reduction="sum"),
     lambda: [_with_ties(_f(N, C, seed=1), _f(N, C, seed=2)),
              _f(N, C, seed=2)], {}),
    ("NLLLoss", "NLLLoss", {}, lambda: [_log_probs(1), _ce_label()], {}),
    ("BCEWithLogitsLoss", "BCEWithLogitsLoss", {},
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2, lo=0, hi=1)], {}),
    ("SmoothL1Loss", "SmoothL1Loss", dict(delta=0.5),
     lambda: [_with_ties(_f(N, C, seed=1), _f(N, C, seed=2)),
              _f(N, C, seed=2)], {}),
    ("HuberLoss", "HuberLoss", dict(delta=0.5),
     lambda: [_with_ties(_f(N, C, seed=1), _f(N, C, seed=2)),
              _f(N, C, seed=2)], {}),
    ("KLDivLoss", "KLDivLoss", dict(reduction="batchmean"),
     lambda: [_log_probs(1), _f(N, C, seed=2, lo=0, hi=1)], {}),
    ("MarginRankingLoss", "MarginRankingLoss", dict(margin=0.1),
     _margin_args, {}),
    ("RNNTLoss", "RNNTLoss", {},
     lambda: [_f(2, 4, 3, 5, seed=1), _ids(2, 2, seed=2, n=4) + 1,
              np.asarray([4, 3]), np.asarray([2, 1])], {}),
    ("CTCLoss", "CTCLoss", dict(reduction="sum"),
     lambda: [_f(6, 2, 4, seed=1), _ids(2, 2, seed=2, n=3) + 1,
              np.asarray([6, 5]), np.asarray([2, 1])], dict(
                  norm_by_times=True)),
    ("BCELoss", "BCELoss", {}, lambda: _prob_args((0.0,)), {}),
    ("CosineEmbeddingLoss", "CosineEmbeddingLoss", dict(margin=0.2),
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _sign(N, seed=3)], {}),
    ("TripletMarginLoss", "TripletMarginLoss", dict(swap=True),
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _f(N, C, seed=3)], {}),
    ("SoftMarginLoss", "SoftMarginLoss", {},
     lambda: [_f(N, C, seed=1, scale=30), _sign(N, C, seed=2)], {}),
    ("HingeEmbeddingLoss", "HingeEmbeddingLoss", dict(reduction="none"),
     _hinge_args, {}),
    ("PoissonNLLLoss", "PoissonNLLLoss", dict(full=True),
     lambda: [_f(N, seed=1), _f(N, seed=2, lo=0.2, hi=4)], {}),
    ("GaussianNLLLoss", "GaussianNLLLoss", dict(full=True),
     lambda: [_f(N, C, seed=1), _f(N, C, seed=2), _f(N, C, seed=3, lo=0.1,
                                                     hi=2)], {}),
    ("MultiLabelSoftMarginLoss", "MultiLabelSoftMarginLoss", {},
     lambda: [_f(N, C, seed=1), _ids(N, C, seed=2, n=2).astype(np.float32)],
     {}),
]


def _weights(shape, xp):
    """A fixed weighting of an output of ``shape``: the gradient of the
    weighted sum reaches every entry with a different factor."""
    n = int(np.prod(shape))
    return xp.cos(xp.arange(n, dtype=xp.float32) * 0.7).reshape(shape) + 1.5


def _is_diff(a):
    return np.issubdtype(getattr(a, "dtype", None) or np.asarray(a).dtype,
                         np.floating)


def _jax_value_and_grads(call, args):
    """``call(*args)`` and the gradient of its weighted sum with respect
    to each floating argument (None for the others)."""
    args = [jnp.asarray(a) for a in args]
    diff = [i for i, a in enumerate(args) if _is_diff(a)]

    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        out = call(*full)
        return jnp.sum(out * _weights(out.shape, jnp)), out

    (_, out), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(diff))), has_aux=True)(
            *[args[i] for i in diff])
    full = [None] * len(args)
    for i, g in zip(diff, grads):
        full[i] = g
    return out, full


def _torch_value_and_grads(call, args):
    ts = [torch.tensor(a, requires_grad=_is_diff(a)) for a in args]
    out = call(*ts)
    w = torch.as_tensor(_weights(tuple(out.shape), np))
    (out * w).sum().backward()
    return out, [t.grad if _is_diff(a) else None for t, a in zip(ts, args)]


@pytest.fixture(scope="module")
def jax_functional():
    """Every functional case's JAX value and gradients, one program."""
    built = {cid: fn_args() for cid, _, fn_args, _ in FUNCTIONAL}

    def run(args):
        return {cid: _jax_value_and_grads(
            lambda *a, fn=fn, kw=kw: getattr(JF, fn)(*a, **kw), args[cid])
            for cid, fn, _, kw in FUNCTIONAL}

    return built, jit_o0(run, built)


def _check(got, want):
    (out, grads), (jout, jgrads) = got, want
    assert out.dtype == torch.float32
    close(out, jout)
    for g, jg in zip(grads, jgrads):
        if jg is None:
            assert g is None
        else:
            # an input the loss only selects on (a sign label) has no
            # gradient in torch and zeros in JAX
            scaled_close(torch.zeros(jg.shape) if g is None else g, jg)


@pytest.mark.parametrize("cid", [c[0] for c in FUNCTIONAL])
def test_functional_loss_matches_jax(cid, jax_functional):
    built, want = jax_functional
    _, fn, _, kw = next(c for c in FUNCTIONAL if c[0] == cid)
    got = _torch_value_and_grads(
        lambda *a: getattr(TF, fn)(*a, **kw), built[cid])
    _check(got, want[cid])


def test_every_jax_loss_function_is_covered():
    names = {c[1] for c in FUNCTIONAL} | {"ctc_loss", "rnnt_loss"}
    assert names == set(TF.LOSSES) and len(names) == 22


@pytest.fixture(scope="module")
def jax_layers():
    built = {cid: fn_args() for cid, _, _, fn_args, _ in LAYERS}

    def run(args):
        return {cid: _jax_value_and_grads(
            lambda *a, n=name, ck=ck, fk=fk: getattr(jnn, n)(**ck)(*a, **fk),
            args[cid]) for cid, name, ck, _, fk in LAYERS}

    return built, jit_o0(run, built)


@pytest.mark.parametrize("cid", [c[0] for c in LAYERS])
def test_loss_layer_matches_jax(cid, jax_layers):
    built, want = jax_layers
    _, name, ck, _, fk = next(c for c in LAYERS if c[0] == cid)
    layer = getattr(tnn, name)(**ck)
    got = _torch_value_and_grads(lambda *a: layer(*a, **fk), built[cid])
    _check(got, want[cid])


def test_loss_layers_are_the_jax_ones():
    assert {c[1] for c in LAYERS} == set(tnn.layer.LOSSES)
    assert len(LAYERS) == 19
    assert not issubclass(tnn.HuberLoss, tnn.SmoothL1Loss)
    assert not issubclass(tnn.SmoothL1Loss, tnn.HuberLoss)


def test_cross_entropy_loss_ignores_weight_as_jax_does():
    """``CrossEntropyLoss(weight=)`` takes the class weights and drops
    them, in JAX as here: the loss is the unweighted one."""
    x, lab = _f(N, C, seed=1), _ids(N, seed=2)
    weight = _f(C, seed=3, lo=0.1, hi=3)
    got = tnn.CrossEntropyLoss(weight=torch.as_tensor(weight))(
        torch.as_tensor(x), torch.as_tensor(lab))
    close(got, tnn.CrossEntropyLoss()(torch.as_tensor(x),
                                      torch.as_tensor(lab)))
    close(got, jnn.CrossEntropyLoss(weight=jnp.asarray(weight))(
        jnp.asarray(x), jnp.asarray(lab)))


def test_bce_loss_layer_is_infinite_at_one_as_jax():
    """The JAX layer clips to 1 - 1e-12, which is 1.0 in float32: at an
    input of exactly 1 with a target below 1, ``log1p(-1)`` makes the loss
    infinite (ROADMAP.md Queue C). The port keeps the JAX layer's body,
    so it is infinite too; ``F.binary_cross_entropy`` stays finite."""
    p, y = _prob_args((1.0,))
    got = tnn.BCELoss()(torch.as_tensor(p), torch.as_tensor(y))
    want = jnn.BCELoss()(jnp.asarray(p), jnp.asarray(y))
    assert float(got) == float(want) == float("inf")
    assert torch.isfinite(TF.binary_cross_entropy(torch.as_tensor(p),
                                                  torch.as_tensor(y)))


# CTC: (id, T, B, C, L, kwargs); ragged input and label lengths, repeated
# labels (no skip between them), an empty label, blank other than 0
CTC = [("mean", {}), ("sum", dict(reduction="sum")),
       ("none", dict(reduction="none")),
       ("norm_by_times", dict(norm_by_times=True)),
       ("blank_last", dict(blank=5, reduction="none"))]


def _ctc_args(blank=0):
    T_, B, C_, L = 12, 4, 6, 4
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T_, B, C_)).astype(np.float32) * 2
    labels = rng.integers(1, C_, (B, L)) if blank == 0 \
        else rng.integers(0, C_ - 1, (B, L))
    labels[0, 1] = labels[0, 0]  # a repeat
    return [x, labels, np.asarray([12, 11, 9, 12]),
            np.asarray([4, 3, 0, 2])]


@pytest.fixture(scope="module")
def jax_ctc():
    built = {cid: _ctc_args(kw.get("blank", 0)) for cid, kw in CTC}

    def run(args):
        return {cid: _jax_value_and_grads(
            lambda *a, kw=kw: JF.ctc_loss(*a, **kw), args[cid])
            for cid, kw in CTC}

    return built, jit_o0(run, built)


@pytest.mark.parametrize("cid", [c[0] for c in CTC])
def test_ctc_loss_matches_jax(cid, jax_ctc):
    built, want = jax_ctc
    kw = dict(CTC)[cid]
    got = _torch_value_and_grads(lambda *a: TF.ctc_loss(*a, **kw),
                                 built[cid])
    _check(got, want[cid])


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_loss_matches_torch_ctc_loss(blank, jax_ctc):
    """The independent witness: ``torch.nn.functional.ctc_loss`` (its own
    alpha-beta recursion) on the ``log_softmax``ed logits, per sample,
    and its gradient with respect to the logits; JAX's values agree with
    it too."""
    cid = "none" if blank == 0 else "blank_last"
    built, want = jax_ctc
    x, labels, il, ll = built[cid]
    xt = torch.tensor(x, requires_grad=True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(xt, -1), torch.as_tensor(labels),
        torch.as_tensor(il), torch.as_tensor(ll), blank=blank,
        reduction="none")
    w = torch.as_tensor(_weights(tuple(ref.shape), np))
    (ref * w).sum().backward()
    out, grads = _torch_value_and_grads(
        lambda *a: TF.ctc_loss(*a, blank=blank, reduction="none"), built[cid])
    close(out, ref)
    scaled_close(grads[0], xt.grad)
    close(ref, want[cid][0])


# RNN-T: FastEmit on (the default 0.001), off and strong; ragged lengths
RNNT = [("mean", {}), ("sum_no_fastemit", dict(fastemit_lambda=0.0,
                                               reduction="sum")),
        ("none_fastemit", dict(fastemit_lambda=0.5, reduction="none")),
        ("blank_last", dict(blank=6, reduction="none"))]


def _rnnt_args(blank=0):
    B, T_, U, V = 3, 7, 4, 7
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, T_, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)) if blank == 0 \
        else rng.integers(0, V - 1, (B, U))
    return [x, labels, np.asarray([7, 5, 3]), np.asarray([4, 2, 0])]


@pytest.fixture(scope="module")
def jax_rnnt():
    built = {cid: _rnnt_args(kw.get("blank", 0)) for cid, kw in RNNT}

    def run(args):
        return {cid: _jax_value_and_grads(
            lambda *a, kw=kw: JF.rnnt_loss(*a, **kw), args[cid])
            for cid, kw in RNNT}

    return built, jit_o0(run, built)


@pytest.mark.parametrize("cid", [c[0] for c in RNNT])
def test_rnnt_loss_matches_jax(cid, jax_rnnt):
    built, want = jax_rnnt
    kw = dict(RNNT)[cid]
    got = _torch_value_and_grads(lambda *a: TF.rnnt_loss(*a, **kw),
                                 built[cid])
    _check(got, want[cid])


def test_rnnt_fastemit_keeps_the_value_and_scales_emission_gradients():
    x, labels, il, ll = _rnnt_args()
    outs = [_torch_value_and_grads(
        lambda *a, lam=lam: TF.rnnt_loss(*a, fastemit_lambda=lam,
                                         reduction="sum"),
        [x, labels, il, ll]) for lam in (0.0, 0.5)]
    close(outs[0][0], outs[1][0])
    assert not torch.allclose(outs[0][1][0], outs[1][1][0])


def test_rnnt_loss_rejects_a_label_width_other_than_u():
    x, labels, il, ll = _rnnt_args()
    with pytest.raises(ValueError, match="label width"):
        TF.rnnt_loss(torch.as_tensor(x), torch.as_tensor(labels[:, :3]),
                     il, ll)


def test_one_hot_maxout_and_swish_match_jax():
    ids = np.asarray([[0, 3, 4], [2, -1, 7]])  # out of range: zero rows
    close(TF.one_hot(torch.as_tensor(ids), 5),
          JF.one_hot(jnp.asarray(ids), 5))
    assert TF.one_hot(torch.as_tensor(ids), 5).dtype == torch.float32
    assert TF.one_hot(torch.as_tensor(ids), 5, "int32").dtype == torch.int32
    x = _f(2, 6, 3, seed=1)
    x[0, 1, 0] = x[0, 0, 0]  # a tied maximum shares the gradient
    x = np.round(x, 1)
    for axis in (1, -2):
        got = _torch_value_and_grads(lambda a: TF.maxout(a, 2, axis), [x])
        want = jit_o0(lambda a: _jax_value_and_grads(
            lambda b: JF.maxout(b, 2, axis), [a]), x)
        _check(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        TF.maxout(torch.as_tensor(x), 4, 1)
    xs = np.linspace(-30, 30, 61).astype(np.float32)
    close(TF.swish(torch.as_tensor(xs)), JF.swish(jnp.asarray(xs)))
