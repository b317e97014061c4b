"""Audio feature layers (counterpart of ``paddle_tpu/audio/features.py``;
parity: python/paddle/audio/features/layers.py — Spectrogram,
MelSpectrogram, LogMelSpectrogram, MFCC).

The front end is ``signal.stft``. The window, the mel filterbank and the
DCT basis are built on the host as in JAX and kept as buffers on the
layer's device (not persistable: the JAX layers keep them outside the
state dict too), so a call is ``|STFT|^power`` and two matmuls there.
The layers are built on ``device``, the current device (the card) by
default.
"""

from __future__ import annotations

import torch

from .. import signal as _signal
from ..core.device import current_device
from ..core.dtype import convert_dtype
from ..core.module import Layer
from . import functional as F


def _buffer(layer, name, value, dtype, device):
    layer.register_buffer(
        name, torch.as_tensor(value, dtype=convert_dtype(dtype),
                              device=current_device(device)),
        persistable=False)


class Spectrogram(Layer):
    def __init__(self, n_fft: int = 512, hop_length=None, win_length=None,
                 window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 dtype: str = "float32", device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        _buffer(self, "window", F.get_window(
            window, self.win_length, fftbins=True, dtype=dtype), dtype,
            device)

    def forward(self, x):
        spec = _signal.stft(
            x, self.n_fft, self.hop_length, self.win_length, self.window,
            center=self.center, pad_mode=self.pad_mode, onesided=True)
        return torch.abs(spec) ** self.power


class MelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 512, hop_length=None,
                 win_length=None, window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, norm="slaney", dtype: str = "float32",
                 device=None):
        super().__init__()
        self.spectrogram = Spectrogram(
            n_fft, hop_length, win_length, window, power, center, pad_mode,
            dtype, device)
        self.n_mels = n_mels
        # [n_mels, n_freq]
        _buffer(self, "fbank", F.compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype), dtype,
            device)

    def forward(self, x):
        spec = self.spectrogram(x)              # [..., n_freq, frames]
        return torch.matmul(self.fbank, spec)   # [..., n_mels, frames]


class LogMelSpectrogram(Layer):
    def __init__(self, sr: int = 22050, n_fft: int = 512, hop_length=None,
                 win_length=None, window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, norm="slaney", ref_value: float = 1.0,
                 amin: float = 1e-10, top_db=None, dtype: str = "float32",
                 device=None):
        super().__init__()
        self.mel_spectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype, device)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        mel = self.mel_spectrogram(x)
        return F.power_to_db(mel, self.ref_value, self.amin, self.top_db)


class MFCC(Layer):
    def __init__(self, sr: int = 22050, n_mfcc: int = 40, norm: str = "ortho",
                 n_fft: int = 512, hop_length=None, win_length=None,
                 window: str = "hann", power: float = 2.0,
                 center: bool = True, pad_mode: str = "reflect",
                 n_mels: int = 64, f_min: float = 50.0, f_max=None,
                 htk: bool = False, ref_value: float = 1.0,
                 amin: float = 1e-10, top_db=None, dtype: str = "float32",
                 device=None):
        super().__init__()
        self.log_mel = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, "slaney", ref_value, amin,
            top_db, dtype, device)
        # [n_mels, n_mfcc]
        _buffer(self, "dct", F.create_dct(n_mfcc, n_mels, norm, dtype),
                dtype, device)

    def forward(self, x):
        logmel = self.log_mel(x)                # [..., n_mels, frames]
        return torch.matmul(self.dct.T, logmel)  # [..., n_mfcc, frames]
