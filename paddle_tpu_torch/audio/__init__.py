"""Audio features and functions (counterpart of ``paddle_tpu/audio``;
parity: python/paddle/audio/ — features + functional)."""

from . import functional  # noqa: F401
from .features import (  # noqa: F401
    MFCC,
    LogMelSpectrogram,
    MelSpectrogram,
    Spectrogram,
)

__all__ = ["functional", "Spectrogram", "MelSpectrogram",
           "LogMelSpectrogram", "MFCC"]
