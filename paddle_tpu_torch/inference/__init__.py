"""Serving of the PyTorch port."""

from .serving import ContinuousBatchingEngine, EngineConfig, Request

__all__ = ["ContinuousBatchingEngine", "EngineConfig", "Request"]
