"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""

from __future__ import annotations

import torch


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
