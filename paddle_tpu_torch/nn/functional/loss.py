"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``): the 22
functions, each with the JAX function's reduction rules, which differ
from function to function (``sigmoid_focal_loss`` sums by default,
``kl_div`` has ``"batchmean"``, ``ctc_loss``'s mean divides by the label
lengths first, ``log_loss``/``square_error_cost`` do not reduce), and
with ``jnp.maximum``'s and ``jnp.abs``'s gradients at ties and zeros.
``ctc_loss`` and ``rnnt_loss`` loop over time in Python: a few
operations a step, on the card as on the host."""

from __future__ import annotations

import math

import torch

from .activation import log_sigmoid, softplus
from .common import cosine_similarity
from .input import one_hot


def cross_entropy(logits, label, soft_label: bool = False,
                  ignore_index: int = -100, reduction: str = "mean",
                  axis: int = -1, label_smoothing: float = 0.0):
    """Parity: F.cross_entropy (softmax_with_cross_entropy), in at least
    float32 whatever the input dtype, as the JAX function computes it.

    ``label`` holds class ids (``soft_label=False``; entries equal to
    ``ignore_index`` count as zero loss and leave the mean's denominator)
    or a distribution over classes (``soft_label=True``).
    ``label_smoothing`` mixes the one-hot target with a uniform one (an
    ignored id has an all-zero one-hot row, as ``jax.nn.one_hot`` gives).
    ``reduction``: ``"none"``, ``"sum"``, or ``"mean"`` over the counted
    entries (at least 1)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if axis not in (-1, logits.dim() - 1):
        logits = logits.movedim(axis, -1)
        if soft_label:
            label = label.movedim(axis, -1)
    logp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        loss = -(label.to(logits.dtype) * logp).sum(dim=-1)
        valid = torch.ones(loss.shape, dtype=torch.float32,
                           device=loss.device)
    else:
        num_classes = logits.shape[-1]
        if label_smoothing > 0.0:
            classes = torch.arange(num_classes, device=label.device)
            onehot = (label[..., None] == classes).float()
            smooth = (onehot * (1.0 - label_smoothing)
                      + label_smoothing / num_classes)
            loss = -(smooth * logp).sum(dim=-1)
        else:
            safe = torch.where(label == ignore_index, 0, label).long()
            loss = -logp.gather(-1, safe[..., None]).squeeze(-1)
        valid = (label != ignore_index).float()
        loss = loss * valid
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp(min=1.0)


_NEG = -1e30  # the log zero of the CTC and RNN-T lattices (finite: -inf
# would turn gradients into nan)


def _f32up(x):
    """``x`` in at least float32 (float64 stays float64), as JAX's
    ``_f32up``."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _abs(x):
    """|x| with ``jnp.abs``'s gradient at 0 (1, where ``torch.abs`` gives
    0)."""
    return torch.where(x >= 0, x, -x)


def _max0(x, floor=0.0):
    """max(x, floor) with ``jnp.maximum``'s gradient: half to each side
    of a tie (``clamp`` gives all of it to x)."""
    return torch.maximum(x, torch.tensor(floor, dtype=x.dtype,
                                         device=x.device))


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _lengths(values, device):
    return torch.as_tensor(values, device=device).long()


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    d = (input - label) ** 2
    if reduction == "none":
        return d
    return d.sum() if reduction == "sum" else d.mean()


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    d = _abs(input - label)
    if reduction == "none":
        return d
    return d.sum() if reduction == "sum" else d.mean()


def nll_loss(log_probs, label, reduction="mean", ignore_index=-100):
    """``log_probs`` ``[..., C]``; ids equal to ``ignore_index`` count as
    zero loss and leave the mean's denominator (at least 1)."""
    safe = torch.where(label == ignore_index, 0, label).long()
    loss = -log_probs.gather(-1, safe[..., None]).squeeze(-1)
    valid = (label != ignore_index).to(loss.dtype)
    loss = loss * valid
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp(min=1.0)


def binary_cross_entropy_with_logits(logits, label, reduction="mean"):
    logits = _f32up(logits)
    label = label.to(logits.dtype)
    loss = (_max0(logits) - logits * label
            + torch.log1p(torch.exp(-_abs(logits))))
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Connectionist Temporal Classification loss (parity:
    paddle.nn.functional.ctc_loss over warpctc). ``log_probs`` are
    UNNORMALISED logits ``[max_time, batch, num_classes]``, normalised
    here by ``log_softmax`` in at least float32, as warpctc does;
    ``labels`` ``[batch, max_label_len]``.

    The JAX function's alpha recursion over the blank-interleaved labels
    ``[blank, l0, blank, l1, ..., blank]``, as a loop over time: each step
    a stabilised three-way log-sum-exp (stay, advance, skip a blank
    between two different labels) plus the emission, frozen past each
    sequence's input length; -1e30 is the log zero. The gradient is
    autograd's through the loop. ``reduction="mean"`` divides each loss
    by its label length (at least 1) before the mean, as Paddle does."""
    lp = torch.log_softmax(_f32up(log_probs), dim=-1)
    dev = lp.device
    labels = torch.as_tensor(labels, device=dev).long()
    input_lengths = _lengths(input_lengths, dev)
    label_lengths = _lengths(label_lengths, dev)
    T, B, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1

    s_idx = torch.arange(S, device=dev)
    lab_pos = torch.div(s_idx - 1, 2, rounding_mode="floor").clamp(0, L - 1)
    is_label = (s_idx % 2) == 1
    ext = torch.where(is_label[None, :], labels[:, lab_pos], blank)  # [B, S]
    # the skip s-2 -> s is allowed where ext[s] is a label that differs
    # from ext[s-2]
    ext_m2 = torch.cat([torch.full((B, 2), blank, device=dev,
                                   dtype=ext.dtype), ext[:, :S - 2]], 1)
    skip_ok = is_label[None, :] & (ext != ext_m2) & (s_idx[None, :] >= 2)
    emit = lp.gather(2, ext[None].expand(T, B, S))  # [T, B, S]

    neg = torch.tensor(_NEG, dtype=lp.dtype, device=dev)
    first = [emit[0, :, :1]]
    if S > 1:
        # the first label is reachable only if the sequence is non-empty
        first.append(torch.where(label_lengths > 0, emit[0, :, 1],
                                 neg)[:, None])
        first.append(neg.expand(B, S - 2))
    alpha = torch.cat(first, 1)

    def shift(a, k):
        return torch.cat([neg.expand(B, k), a[:, :S - k]], 1)

    for t in range(1, T):
        stacked = torch.stack([alpha, shift(alpha, 1),
                               torch.where(skip_ok, shift(alpha, 2), neg)])
        m = torch.amax(stacked, dim=0)
        new = m + torch.log(torch.exp(stacked - m).sum(0)) + emit[t]
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    last = 2 * label_lengths  # the final blank of each extended sequence
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = torch.where(
        label_lengths > 0,
        alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0], neg)
    m = torch.maximum(a_last, a_prev)
    loss = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
    if norm_by_times:
        loss = loss / input_lengths.clamp(min=1).to(loss.dtype)
    if reduction == "mean":
        return (loss / label_lengths.clamp(min=1).to(loss.dtype)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,  # noqa: A002
              fastemit_lambda=0.001, reduction="mean"):
    """RNN-T (transducer) loss (parity: paddle.nn.functional.rnnt_loss
    over warprnnt). ``input``: ``[B, T, U+1, V]`` unnormalised joint
    logits (``log_softmax`` inside, in at least float32); ``label``
    ``[B, U]``; per-sample ``input_lengths`` and ``label_lengths``.

    The JAX function's lattice recursion as one loop over time: row t is
    ``G + logcumsumexp(c - G)`` in closed form, with c the row before
    plus its blank scores and G the prefix sums of row t's emission
    scores, clamped at -1e30. FastEmit is the value-preserving
    reparametrisation ``emit * (1 + lam) - (emit * lam).detach()``: the
    loss is the lam = 0 one, the emission gradients scale by 1 + lam. The
    mean is over the batch."""
    lp = torch.log_softmax(_f32up(input), dim=-1)
    dev = lp.device
    label = torch.as_tensor(label, device=dev).long()
    input_lengths = _lengths(input_lengths, dev)
    label_lengths = _lengths(label_lengths, dev)
    B, T, U1, _ = lp.shape
    U = U1 - 1
    if label.shape[1] != U:
        raise ValueError(
            f"label width {label.shape[1]} must equal input's U axis - 1 "
            f"= {U} (input is [B, T, U+1, V])")
    neg = torch.tensor(_NEG, dtype=lp.dtype, device=dev)

    blank_lp = lp[..., blank]  # [B, T, U+1]
    if U > 0:
        emit_lp = lp[:, :, :U, :].gather(
            3, label[:, None, :, None].expand(B, T, U, 1))[..., 0]
        # tokens past each sample's label length cannot be emitted
        allowed = torch.arange(U, device=dev)[None, :] < label_lengths[:, None]
        emit_lp = torch.where(allowed[:, None, :], emit_lp, neg)
        if fastemit_lambda:
            lam = float(fastemit_lambda)
            emit_lp = emit_lp * (1.0 + lam) - (emit_lp * lam).detach()
    else:
        emit_lp = lp.new_zeros(B, T, 0)

    zero = lp.new_zeros(B, 1)

    def row_prefix(e_t):
        # G[u] = the sum of the emission scores before u: [B, U+1]
        return torch.cat([zero, torch.cumsum(e_t, dim=1)], dim=1)

    rows = [row_prefix(emit_lp[:, 0])]
    for t in range(1, T):
        c = rows[-1] + blank_lp[:, t - 1]
        G = row_prefix(emit_lp[:, t])
        # the clamp keeps the masked lattice finite, never nan
        rows.append(torch.maximum(G + torch.logcumsumexp(c - G, dim=1), neg))
    alpha = torch.stack(rows, dim=1)  # [B, T, U+1]

    # log Z = alpha[T_b - 1, U_b] + blank[T_b - 1, U_b]
    t_last = (input_lengths - 1).clamp(min=0)[:, None, None].expand(B, 1, U1)
    u_last = label_lengths.clamp(max=U)[:, None]
    a_final = alpha.gather(1, t_last)[:, 0].gather(1, u_last)[:, 0]
    b_final = blank_lp.gather(1, t_last)[:, 0].gather(1, u_last)[:, 0]
    return _reduce_loss(-(a_final + b_final), reduction)


def kl_div(input, label, reduction="mean"):  # noqa: A002
    """``input`` holds LOG-probabilities (Paddle's convention); the
    target is clipped at 1e-30 inside the log. ``"batchmean"`` divides the
    sum by the batch."""
    loss = label * (torch.log(_max0(label, 1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    return _reduce_loss(_max0(-label * (input - other) + margin), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = _abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean"):
    def dist(a, b):
        return torch.pow(
            torch.pow(_abs(a - b) + epsilon, p).sum(-1), 1.0 / p)

    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce_loss(_max0(d_pos - d_neg + margin), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    x1, x2 = input1, input2
    if x1.dim() == 1:  # Paddle takes a single [M] pair
        x1, x2 = x1[None], x2[None]
    cos = cosine_similarity(x1, x2, axis=1)
    loss = torch.where(label > 0, 1.0 - cos, _max0(cos - margin))
    return _reduce_loss(loss, reduction)


def soft_margin_loss(input, label, reduction="mean"):  # noqa: A002
    """log(1 + exp(-label * input)) through JAX's softplus (``logaddexp``,
    not torch's, which is x itself above 20)."""
    return _reduce_loss(softplus(-label * input), reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label > 0, input, _max0(margin - input))
    return _reduce_loss(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean"):
    x, t = input, label
    if log_input:
        loss = torch.exp(x) - t * x
    else:
        loss = x - t * torch.log(x + epsilon)
    if full:
        stirling = t * torch.log(t) - t + 0.5 * torch.log(2.0 * math.pi * t)
        loss = loss + torch.where(t > 1, stirling, torch.zeros_like(stirling))
    return _reduce_loss(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean"):
    var = _max0(variance, epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce_loss(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean"):
    loss = -(label * log_sigmoid(input) + (1 - label) * log_sigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss.mean(-1), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    """Parity: paddle.nn.functional.sigmoid_focal_loss (RetinaNet), in at
    least float32; the default reduction is ``"sum"``."""
    x, t = _f32up(logit), label.float()
    p = torch.sigmoid(x)
    ce = -(t * log_sigmoid(x) + (1 - t) * log_sigmoid(-x))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    """Parity: paddle.nn.functional.dice_loss — ``input`` ``[N, ..., C]``
    probabilities, ``label`` ``[N, ..., 1]`` class ids."""
    t = one_hot(label.squeeze(-1), input.shape[-1], dtype=input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * t).sum(dims)
    union = input.sum(dims) + t.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    """Parity: paddle.nn.functional.log_loss (probabilities in); not
    reduced."""
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label):  # noqa: A002
    """(input - label)^2, not reduced."""
    return torch.square(input - label)


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    """Parity: F.binary_cross_entropy — ``input`` holds PROBABILITIES (the
    post-sigmoid form), clipped at 1e-12 inside the logs, in at least
    float32."""
    p = _f32up(input)
    y = label.to(p.dtype)
    eps = 1e-12
    loss = -(y * torch.log(_max0(p, eps))
             + (1.0 - y) * torch.log(_max0(1.0 - p, eps)))
    if weight is not None:
        loss = loss * weight.to(loss.dtype)
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()
