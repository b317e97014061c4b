"""paddle.fft — discrete Fourier transforms (counterpart of
``paddle_tpu/fft.py``).

The fft/ifft/rfft/irfft/hfft/ihfft family in 1-D/2-D/N-D forms and the
helpers, with Paddle's signatures: ``x`` as the array argument, ``n``/``s``
length overrides, ``axis``/``axes`` placement and ``norm`` in
{"backward", "ortho", "forward"} (None is "backward"), each checked as the
JAX functions check them (``InvalidArgumentError``), then computed by the
``torch.fft`` function of the same name, which follows numpy's
conventions as ``jnp.fft`` does.
"""

from __future__ import annotations

import torch

from .core.device import current_device
from .core.dtype import convert_dtype
from .errors import InvalidArgumentError

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("backward", "ortho", "forward")


def _check_norm(norm):
    if norm is None:
        return "backward"
    if norm not in _NORMS:
        raise InvalidArgumentError(
            f"Unexpected norm: {norm!r}. Norm should be 'forward', "
            f"'backward' or 'ortho'")
    return norm


def _check_n(n):
    if n is not None and n <= 0:
        raise InvalidArgumentError(
            f"Invalid FFT argument n({n}), it should be positive.")
    return n


def _check_s(s):
    if s is not None:
        s = tuple(int(v) for v in s)
        if any(v <= 0 for v in s):
            raise InvalidArgumentError(
                f"Invalid FFT argument s({s}), all entries should be "
                "positive.")
    return s


def fft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.fft(x, _check_n(n), axis, _check_norm(norm))


def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ifft(x, _check_n(n), axis, _check_norm(norm))


def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.rfft(x, _check_n(n), axis, _check_norm(norm))


def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.irfft(x, _check_n(n), axis, _check_norm(norm))


def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.hfft(x, _check_n(n), axis, _check_norm(norm))


def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    return torch.fft.ihfft(x, _check_n(n), axis, _check_norm(norm))


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.fft2(x, _check_s(s), axes, _check_norm(norm))


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.ifft2(x, _check_s(s), axes, _check_norm(norm))


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.rfft2(x, _check_s(s), axes, _check_norm(norm))


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return torch.fft.irfft2(x, _check_s(s), axes, _check_norm(norm))


def fftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.fftn(x, _check_s(s), axes, _check_norm(norm))


def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.ifftn(x, _check_s(s), axes, _check_norm(norm))


def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.rfftn(x, _check_s(s), axes, _check_norm(norm))


def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return torch.fft.irfftn(x, _check_s(s), axes, _check_norm(norm))


def _freqs(fn, n, d, dtype, device):
    _check_n(n)
    out = fn(n, d, dtype=torch.float32, device=current_device(device))
    return out if dtype is None else out.to(convert_dtype(dtype))


def fftfreq(n, d=1.0, dtype=None, name=None, device=None):
    """The sample frequencies, float32 unless ``dtype``, on ``device``
    (the current device, the card by default)."""
    return _freqs(torch.fft.fftfreq, n, d, dtype, device)


def rfftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return _freqs(torch.fft.rfftfreq, n, d, dtype, device)


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, axes)


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, axes)
