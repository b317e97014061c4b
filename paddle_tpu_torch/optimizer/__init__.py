"""Optimizers, clippers and learning-rate schedulers of the PyTorch port
(counterpart of ``paddle_tpu/optimizer``)."""

from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .lbfgs import LBFGS
from .lr import (
    ConstantLR,
    CosineAnnealingDecay,
    CosineAnnealingWarmRestarts,
    CyclicLR,
    ExponentialDecay,
    InverseTimeDecay,
    LambdaDecay,
    LinearWarmup,
    LRScheduler,
    MultiplicativeDecay,
    MultiStepDecay,
    NaturalExpDecay,
    NoamDecay,
    OneCycleLR,
    PiecewiseDecay,
    PolynomialDecay,
    ReduceOnPlateau,
    StepDecay,
)
from .optimizer import (
    ASGD,
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Lars,
    Momentum,
    NAdam,
    Optimizer,
    RAdam,
    RMSProp,
    Rprop,
)

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Lamb",
    "Lars", "RMSProp", "Adamax", "Adadelta", "NAdam", "RAdam", "ASGD",
    "Rprop", "LBFGS",
    "lr", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
    "LRScheduler", "ConstantLR", "NoamDecay", "LinearWarmup",
    "CosineAnnealingDecay", "ExponentialDecay", "StepDecay",
    "PolynomialDecay", "PiecewiseDecay", "MultiStepDecay",
    "NaturalExpDecay", "InverseTimeDecay", "LambdaDecay",
    "MultiplicativeDecay", "OneCycleLR", "CyclicLR", "ReduceOnPlateau",
    "CosineAnnealingWarmRestarts",
]
