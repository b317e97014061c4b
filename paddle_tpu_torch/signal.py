"""STFT and ISTFT (counterpart of ``paddle_tpu/signal.py``; parity:
python/paddle/signal.py).

The JAX functions' framing, step for step: the centre pad with
``pad_mode``, the window zero-padded to ``n_fft`` in the middle, ``frame``
(a strided view: ``Tensor.unfold``), the window, then ``rfft``/``fft``,
with the output ``[..., freq, frames]``. ``torch.stft`` is not called:
its defaults (window, padding, layout) are other ones. ``overlap_add`` is
a scatter-add of the frames (``index_add``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

# numpy's pad modes (what ``jnp.pad`` takes) in ``torch.nn.functional.pad``'s
# names
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def frame(x, frame_length, hop_length, axis=-1):
    """Parity: paddle.signal.frame — a window of ``frame_length`` every
    ``hop_length`` samples: ``[..., frame_length, num_frames]`` for
    ``axis=-1``, ``[num_frames, frame_length, ...]`` for ``axis=0``."""
    if axis not in (-1, 0):
        raise ValueError("frame: axis must be 0 or -1")
    if axis == 0:
        out = frame(x.movedim(0, -1), frame_length, hop_length, axis=-1)
        return out.movedim(-1, 0).movedim(-1, 1)
    # [..., num_frames, frame_length]
    frames = x.unfold(-1, frame_length, hop_length)
    return frames.transpose(-1, -2)


def overlap_add(x, hop_length, axis=-1):
    """Parity: paddle.signal.overlap_add — the inverse of ``frame``: ``x``
    is ``[..., frame_length, num_frames]`` for ``axis=-1``."""
    if axis not in (-1, 0):
        raise ValueError("overlap_add: axis must be 0 or -1")
    if axis == 0:
        moved = x.movedim(1, -1).movedim(0, -1)
        return overlap_add(moved, hop_length, axis=-1).movedim(-1, 0)
    frame_length, num_frames = x.shape[-2], x.shape[-1]
    out_len = (num_frames - 1) * hop_length + frame_length
    idx = (torch.arange(num_frames, device=x.device)[:, None] * hop_length
           + torch.arange(frame_length, device=x.device)[None, :])
    frames = x.transpose(-1, -2)                       # [..., nf, fl]
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, num_frames * frame_length)
    out = flat.new_zeros(flat.shape[0], out_len).index_add(
        1, idx.reshape(-1), flat)
    return out.reshape(*batch_shape, out_len)


def _window(window, win_length, n_fft, device):
    """``window`` (ones if None) as a tensor on ``device``, zero-padded to
    ``n_fft`` in the middle."""
    if window is None:
        window = torch.ones(win_length, dtype=torch.float32, device=device)
    window = torch.as_tensor(window, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = tF.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _pad_last(x, pad, mode):
    """``x`` padded by ``pad`` on both sides of its last axis with numpy's
    ``mode`` (torch pads the last axis of a 2-D or 3-D input in these
    modes, and real tensors: a complex one is padded in two halves)."""
    if mode not in _PAD_MODES:
        raise ValueError(f"stft: unsupported pad_mode {mode!r}")
    if x.is_complex():
        return torch.complex(_pad_last(x.real, pad, mode),
                             _pad_last(x.imag, pad, mode))
    flat = x.reshape(-1, 1, x.shape[-1])
    out = tF.pad(flat, (pad, pad), mode=_PAD_MODES[mode])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Parity: paddle.signal.stft. ``x``: real or complex ``[...,
    seq_len]``; returns complex ``[..., n_fft // 2 + 1`` (onesided) ``or
    n_fft, num_frames]``."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if x.is_complex() and onesided:
        raise ValueError(
            "stft: onesided=True is only valid for real input (parity: "
            "paddle.signal.stft asserts the same)")
    window = _window(window, win_length, n_fft, x.device)
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = frame(x, n_fft, hop_length, axis=-1)       # [..., n_fft, nf]
    frames = frames.transpose(-1, -2) * window          # [..., nf, n_fft]
    if onesided:
        spec = torch.fft.rfft(frames, dim=-1)
    else:
        spec = torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / (float(n_fft) ** 0.5)
    return spec.transpose(-1, -2)                       # [..., freq, nf]


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Parity: paddle.signal.istft — the least-squares inverse: windowed
    overlap-add over the overlap-added squared window."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _window(window, win_length, n_fft, x.device)
    spec = x.transpose(-1, -2)                          # [..., nf, freq]
    if normalized:
        spec = spec * (float(n_fft) ** 0.5)
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, dim=-1)
        if not return_complex:
            frames = frames.real
    frames = frames * window
    y = overlap_add(frames.transpose(-1, -2), hop_length, axis=-1)

    num_frames = x.shape[-1]
    env = overlap_add(
        torch.square(window)[:, None].expand(n_fft, num_frames),
        hop_length, axis=-1)
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))

    if center:
        y = y[..., n_fft // 2:]
    if length is not None:
        y = y[..., :length]
    elif center:
        # drop the trailing centre pad as well
        y = y[..., : y.shape[-1] - n_fft // 2]
    return y
