"""The port's core: devices, random generators, dtypes, initializers,
``Parameter`` and the ``Layer`` module system."""

from .device import current_device, resolve_device
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .initializer import _fan_in_out as fan_in_out
from .module import Layer
from .parameter import Parameter, ParamAttr
from .random import (
    default_generator,
    get_seed,
    make_generator,
    normal_,
    seed,
    uniform_,
)

__all__ = ["Layer", "ParamAttr", "Parameter", "convert_dtype",
           "current_device", "default_generator", "fan_in_out",
           "get_default_dtype", "get_seed", "make_generator", "normal_",
           "resolve_device", "seed", "set_default_dtype", "uniform_"]
