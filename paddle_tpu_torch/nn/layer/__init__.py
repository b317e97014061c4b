"""Layers of the PyTorch port."""

from .activation import (
    CELU,
    ELU,
    GELU,
    GLU,
    LeakyReLU,
    LogSigmoid,
    LogSoftmax,
    Mish,
    PReLU,
    ReLU,
    ReLU6,
    RReLU,
    SELU,
    Hardshrink,
    Hardsigmoid,
    Hardswish,
    Hardtanh,
    Sigmoid,
    SiLU,
    Softmax,
    Softplus,
    Softshrink,
    Softsign,
    Swish,
    Tanh,
    Tanhshrink,
    ThresholdedReLU,
)
from .common import (
    Dropout,
    Embedding,
    Flatten,
    Identity,
    LayerDict,
    LayerList,
    Linear,
    ParameterList,
    Sequential,
    Upsample,
)
from .conv import Conv2D
from .norm import GroupNorm, LayerNorm, RMSNorm

ACTIVATIONS = ("CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
               "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid",
               "LogSoftmax", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6",
               "SELU", "SiLU", "Sigmoid", "Softmax", "Softplus",
               "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
               "ThresholdedReLU")

__all__ = ["Conv2D", "Dropout", "Embedding", "Flatten", "GroupNorm",
           "Identity", "LayerDict", "LayerList", "LayerNorm", "Linear",
           "ParameterList", "RMSNorm", "Sequential", "Upsample",
           *ACTIVATIONS]
