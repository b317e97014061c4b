"""Device placement and explicit random generators of the PyTorch port."""

from .device import resolve_device
from .random import make_generator, normal_

__all__ = ["resolve_device", "make_generator", "normal_"]
