"""Neural-network building blocks of the PyTorch port: ``Layer``,
``Parameter``, the layers, ``initializer``, ``utils`` and
``functional``; the gradient clippers of ``optimizer`` are re-exported
here, as the JAX ``nn`` re-exports them."""

from ..core.module import Layer
from ..core.parameter import Parameter, ParamAttr
from . import functional, initializer, layout, utils
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from ..optimizer.clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Layer", "ParamAttr", "Parameter", "functional", "initializer",
           "layout", "utils", *_layers]
