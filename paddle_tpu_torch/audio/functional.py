"""Audio functions (counterpart of ``paddle_tpu/audio/functional.py``;
parity: python/paddle/audio/functional/ — window_function.py +
functional.py: get_window, hz_to_mel, mel_to_hz, mel_frequencies,
fft_frequencies, compute_fbank_matrix, power_to_db, create_dct).

The windows, the mel scale, the filterbank and the DCT basis are the JAX
package's numpy code, copied: they are built once, on the host, when a
layer is made. ``power_to_db`` works on tensors, on the tensor's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_window(window, win_length: int, fftbins: bool = True,
               dtype="float32"):
    """Parity: paddle.audio.functional.get_window. ``window`` is a name or
    (name, param) tuple; ``fftbins=True`` gives the periodic variant used
    for STFT analysis."""
    if isinstance(window, tuple):
        name, param = window[0], window[1]
    else:
        name, param = window, None
    n = win_length + 1 if fftbins else win_length
    k = np.arange(n)
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * k / (n - 1))
             + 0.08 * np.cos(4 * np.pi * k / (n - 1)))
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * k / (n - 1) - 1.0)
    elif name in ("rect", "rectangular", "boxcar", "ones"):
        w = np.ones(n)
    elif name == "triang":
        m = (n + 1) // 2
        ramp = (np.arange(1, m + 1) - 0.5) / (n / 2.0) \
            if n % 2 == 0 else np.arange(1, m + 1) / ((n + 1) / 2.0)
        w = np.concatenate([ramp, ramp[::-1][n % 2 if n % 2 else 0:]])
        w = w[:n]
    elif name == "kaiser":
        beta = 12.0 if param is None else float(param)
        w = np.kaiser(n, beta)
    elif name == "gaussian":
        std = 7.0 if param is None else float(param)
        w = np.exp(-0.5 * ((k - (n - 1) / 2.0) / std) ** 2)
    else:
        raise ValueError(f"get_window: unknown window {name!r}")
    if fftbins:
        w = w[:-1]
    return w.astype(dtype)


def hz_to_mel(freq, htk: bool = False):
    """Hz → mel. htk=False uses the Slaney (librosa/paddle default)
    piecewise scale; htk=True the classic 2595·log10(1+f/700)."""
    freq = np.asarray(freq, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz)
        / logstep,
        mels,
    )
    return mels if mels.ndim else float(mels)


def mel_to_hz(mel, htk: bool = False):
    mel = np.asarray(mel, np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = mel >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (mel - min_log_mel)),
        freqs,
    )
    return freqs if freqs.ndim else float(freqs)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False):
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return mel_to_hz(mels, htk)


def fft_frequencies(sr: int, n_fft: int):
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2)


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 50.0, f_max=None,
                         htk: bool = False, norm="slaney",
                         dtype="float32"):
    """Triangular mel filterbank [n_mels, 1 + n_fft//2]."""
    f_max = f_max if f_max is not None else sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        weights /= np.maximum(
            np.linalg.norm(weights, ord=norm, axis=1, keepdims=True), 1e-10
        )
    return weights.astype(dtype)


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db=80.0):
    """10·log10(S/ref) with a floor at ``amin`` and, with ``top_db``, the
    dynamic range clipped to ``top_db`` below the largest entry of the
    whole tensor; on the tensor's device."""
    s = torch.as_tensor(spect)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def create_dct(n_mfcc: int, n_mels: int, norm="ortho", dtype="float32"):
    """DCT-II basis [n_mels, n_mfcc] (paddle layout: applied as
    mel.T @ dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm == "ortho":
        basis[:, 0] *= 1.0 / math.sqrt(n_mels)
        basis[:, 1:] *= math.sqrt(2.0 / n_mels)
    else:
        basis *= 2.0
    return basis.astype(dtype)
