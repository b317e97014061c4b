"""paddle.incubate.nn of the PyTorch port (counterpart of
``paddle_tpu/incubate/nn``)."""

from . import functional

__all__ = ["functional"]
