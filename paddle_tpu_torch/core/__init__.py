"""Device placement and explicit random generators of the PyTorch port."""

from .device import resolve_device
from .random import fan_in_out, make_generator, normal_, uniform_

__all__ = ["fan_in_out", "make_generator", "normal_", "resolve_device",
           "uniform_"]
