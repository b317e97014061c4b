"""Optimizers, clippers and learning-rate schedulers of the PyTorch port
(counterpart of ``paddle_tpu/optimizer``)."""

from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .lr import (
    ConstantLR,
    CosineAnnealingDecay,
    LinearWarmup,
    LRScheduler,
    PolynomialDecay,
)
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "ConstantLR", "CosineAnnealingDecay",
           "LinearWarmup", "LRScheduler", "Optimizer", "PolynomialDecay"]
