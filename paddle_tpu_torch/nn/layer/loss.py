"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``; parity:
python/paddle/nn/layer/loss.py): the 19 layers over the functional
losses. ``CrossEntropyLoss`` takes ``weight=`` and ignores it, as the JAX
layer does; ``SmoothL1Loss`` and ``HuberLoss`` share ``_PiecewiseL1`` and
differ in their scales; ``BCELoss`` has its own body (inputs clipped to
[1e-12, 1 - 1e-12], ``log1p``), the JAX layer's, which differs from
``F.binary_cross_entropy``."""

import torch

from ...core.module import Layer
from .. import functional as F
from ..functional.loss import _abs, _reduce_loss as _reduce


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, label_smoothing=0.0, axis=-1):
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.label_smoothing = label_smoothing
        self.axis = axis

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(
            input, label,
            soft_label=self.soft_label,
            ignore_index=self.ignore_index,
            reduction=self.reduction,
            axis=self.axis,
            label_smoothing=self.label_smoothing,
        )


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, reduction="mean", ignore_index=-100):
        super().__init__()
        self.reduction = reduction
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.reduction, self.ignore_index)


class BCEWithLogitsLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.reduction)


class _PiecewiseL1(Layer):
    """Shared quadratic-below-delta / linear-above-delta loss body.
    ``quad_scale`` multiplies the 0.5·d² zone, ``lin_scale`` the linear
    zone — the only place SmoothL1 and Huber differ."""

    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def _scales(self):
        raise NotImplementedError

    def forward(self, input, label):  # noqa: A002
        quad_scale, lin_scale = self._scales()
        d = _abs(input - label)
        loss = torch.where(d < self.delta,
                           quad_scale * 0.5 * d * d,
                           lin_scale * (d - 0.5 * self.delta))
        return _reduce(loss, self.reduction)


class SmoothL1Loss(_PiecewiseL1):
    """Parity: paddle.nn.SmoothL1Loss. Quadratic zone scaled by 1/delta:
    0.5·d²/delta for d<delta, else d−0.5·delta. Coincides with Huber only
    at delta=1 — the two classes are intentionally NOT aliases."""

    def _scales(self):
        return 1.0 / self.delta, 1.0


class HuberLoss(_PiecewiseL1):
    """Classic Huber: 0.5·d² for d<delta, else delta·(d−0.5·delta)."""

    def _scales(self):
        return 1.0, self.delta


class KLDivLoss(Layer):
    """input is LOG-probabilities, label is probabilities (parity)."""

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class RNNTLoss(Layer):
    """Parity: paddle.nn.RNNTLoss (warprnnt upstream; here the lattice
    recursion of ``functional.rnnt_loss``)."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):  # noqa: A002
        return F.rnnt_loss(
            input, label, input_lengths, label_lengths,
            blank=self.blank, fastemit_lambda=self.fastemit_lambda,
            reduction=self.reduction,
        )


class CTCLoss(Layer):
    """Parity: paddle.nn.CTCLoss (warpctc upstream; here the alpha
    recursion of ``functional.ctc_loss``)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(
            log_probs, labels, input_lengths, label_lengths,
            blank=self.blank, reduction=self.reduction,
            norm_by_times=norm_by_times,
        )


def _clip(x, lo, hi):
    """``jnp.clip``'s max then min, each splitting a tie's gradient."""
    def bound(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


class BCELoss(Layer):
    """Parity: paddle.nn.BCELoss (input are probabilities)."""

    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        x = _clip(input, 1e-12, 1.0 - 1e-12)
        loss = -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))
        if self.weight is not None:
            loss = loss * self.weight
        return _reduce(loss, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       self.margin, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean"):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(
            input, positive, negative, self.margin, self.p,
            self.epsilon, self.swap, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.soft_margin_loss(input, label, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean"):
        super().__init__()
        self.log_input, self.full, self.epsilon = log_input, full, epsilon
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.poisson_nll_loss(input, label, self.log_input,
                                  self.full, self.epsilon,
                                  self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean"):
        super().__init__()
        self.full, self.epsilon = full, epsilon
        self.reduction = reduction

    def forward(self, input, label, variance):  # noqa: A002
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)
