"""Calibration observers (counterpart of
``paddle_tpu/quantization/observer.py``; parity:
python/paddle/quantization/observers/).

Observers watch activations during PTQ calibration and give the scale
used at convert time. Calibration is a few batches, not a hot path: each
observation syncs the host, as the JAX package's ``float(...)`` does. The
percentile reservoir and the MSE search run on host numpy with the JAX
package's ``default_rng(0)``, so the scales equal JAX's for the same
activations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.module import Layer


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class BaseObserver(Layer):
    """Pass-through layer that records statistics of what flows through."""

    def forward(self, x):
        self.observe(x)
        return x

    def observe(self, x):
        raise NotImplementedError

    def scale(self, qmax: int = 127):
        raise NotImplementedError


class AbsmaxObserver(BaseObserver):
    """Running max of |x|."""

    def __init__(self):
        super().__init__()
        self._amax = 0.0

    def observe(self, x):
        self._amax = max(self._amax, float(x.detach().abs().amax()))

    def scale(self, qmax: int = 127):
        return max(self._amax, 1e-8) / qmax


class EMAObserver(BaseObserver):
    """Exponential moving average of each batch's |x| max."""

    def __init__(self, momentum: float = 0.9):
        super().__init__()
        self.momentum = momentum
        self._amax = None

    def observe(self, x):
        amax = float(x.detach().abs().amax())
        self._amax = amax if self._amax is None else (
            self.momentum * self._amax + (1 - self.momentum) * amax)

    def scale(self, qmax: int = 127):
        return max(self._amax or 0.0, 1e-8) / qmax


class PercentileObserver(BaseObserver):
    """The ``percentile``-th percentile of |x| over a fixed-size reservoir
    of samples (outlier-robust range)."""

    def __init__(self, percentile: float = 99.9, max_samples: int = 1 << 18):
        super().__init__()
        self.percentile = percentile
        self.max_samples = max_samples
        self._reservoir = np.empty((0,), np.float32)
        self._seen = 0
        self._rng = np.random.default_rng(0)

    def observe(self, x):
        flat = np.abs(_host(x)).ravel()
        self._seen += flat.size
        room = self.max_samples - self._reservoir.size
        if room > 0:
            self._reservoir = np.concatenate([self._reservoir, flat[:room]])
            flat = flat[room:]
        if flat.size:
            # each new value replaces one w.p. max_samples / seen
            n_rep = min(flat.size,
                        int(self.max_samples * flat.size / self._seen))
            if n_rep:
                idx = self._rng.choice(self.max_samples, n_rep,
                                       replace=False)
                src = self._rng.choice(flat.size, n_rep, replace=False)
                self._reservoir[idx] = flat[src]

    def scale(self, qmax: int = 127):
        if not self._reservoir.size:
            return 1e-8
        return max(float(np.percentile(self._reservoir, self.percentile)),
                   1e-8) / qmax


class MSEObserver(BaseObserver):
    """The clip range, among ``steps`` fractions of the observed |x| max,
    that minimises the quantization MSE."""

    def __init__(self, steps: int = 20):
        super().__init__()
        self.steps = steps
        self._amax = 0.0
        self._samples = []

    def observe(self, x):
        arr = _host(x).ravel()
        if arr.size > (1 << 18):
            arr = arr[:: arr.size // (1 << 18) + 1]
        self._samples.append(arr)
        self._amax = max(self._amax, float(np.max(np.abs(arr))))

    def scale(self, qmax: int = 127):
        if not self._samples or self._amax == 0.0:
            return 1e-8
        v = np.concatenate(self._samples)
        best, best_err = self._amax, np.inf
        for i in range(self.steps):
            amax = self._amax * (1.0 - i / (2.0 * self.steps))
            s = amax / qmax
            q = np.clip(np.round(v / s), -qmax, qmax) * s
            err = float(np.mean((v - q) ** 2))
            if err < best_err:
                best, best_err = amax, err
        return max(best, 1e-8) / qmax
