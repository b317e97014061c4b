"""Speculative-decoding drafters of the serving engine (counterpart of
``paddle_tpu/inference/spec_decode.py``).

A drafter proposes up to K candidate tokens per slot; the engine scores
them all in one ``[slots, K+1]`` verify pass and keeps the longest prefix
that matches the target's own argmax chain, so greedy outputs equal plain
decode's and only the tokens bought per weight stream change.

The built-in drafter is n-gram prompt lookup (self-drafting): it matches
the slot's latest token suffix against the slot's own prompt and
generation and proposes what followed the most recent earlier
occurrence. Host-side numpy, no draft model and no device work.

``Drafter`` is the seam: anything with ``propose(history, k) ->
np.ndarray`` plugs into ``ContinuousBatchingEngine(..., drafter=...)``.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.zeros((0,), np.int64)


class Drafter:
    """Protocol of speculative-decoding drafters.

    ``propose(history, k)`` receives one slot's whole token history
    (prompt and generated tokens, the last being the token the next decode
    step consumes) and returns up to ``k`` proposed next tokens as a 1-D
    int array (empty: no proposal, the slot decodes one token). Runs on
    the host per slot per scheduler tick, so it must be cheap."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup n-gram drafter.

    Tries suffix lengths ``max_ngram`` down to ``min_ngram``: for the first
    length whose suffix occurs earlier in the history, proposes the tokens
    that followed the most recent such occurrence."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram; got "
                f"min={min_ngram} max={max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.ascontiguousarray(np.asarray(history).reshape(-1), np.int64)
        if k <= 0 or h.size < self.min_ngram + 1:
            return _EMPTY
        for n in range(min(self.max_ngram, h.size - 1),
                       self.min_ngram - 1, -1):
            pat = h[h.size - n:]
            windows = np.lib.stride_tricks.sliding_window_view(h, n)
            hits = np.flatnonzero((windows == pat).all(axis=1))
            # a hit needs a continuation (i + n < len), which also leaves
            # out the suffix matching itself
            hits = hits[hits + n < h.size]
            if hits.size:
                start = int(hits[-1]) + n
                return h[start:start + k].copy()
        return _EMPTY
