"""Training of the PyTorch port (counterpart of ``paddle_tpu/trainer``)."""

from .train_step import TrainStep

__all__ = ["TrainStep"]
