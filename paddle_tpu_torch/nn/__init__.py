"""Neural-network building blocks of the PyTorch port: ``Layer``,
``Parameter``, the layers, ``initializer``, ``utils`` and
``functional``."""

from ..core.module import Layer
from ..core.parameter import Parameter, ParamAttr
from . import functional, initializer, layout, utils
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["Layer", "ParamAttr", "Parameter", "functional", "initializer",
           "layout", "utils", *_layers]
