"""Text-generation utilities (counterpart of ``paddle_tpu/generation.py``;
parity: PaddleNLP ``GenerationMixin``, greedy_search / sampling /
beam_search with top_k, top_p, temperature and repetition_penalty).

Every logits processor maps ``[batch, vocab]`` logits to new ``[batch,
vocab]`` logits without touching its input. Sampling draws from a
``torch.Generator`` the caller passes, so sampled tokens are reproducible
from a seed but differ from the JAX package's ``jax.random`` draws. Beam
search keeps the KV cache batch-major (``[batch * num_beams, ...]``), so a
beam reorder is one ``index_select`` over every cache tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from .core.device import resolve_device

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# logits processors
# ---------------------------------------------------------------------------
def apply_temperature(logits: torch.Tensor, temperature: float):
    if temperature == 1.0:
        return logits
    return logits / max(temperature, 1e-6)


def top_k_filter(logits: torch.Tensor, k: int):
    """Keep the k highest logits per row, and every logit tied with the
    k-th; the rest become -1e30. ``k <= 0`` is a no-op, and ``k`` over the
    vocabulary keeps everything (the reference clamps it)."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def top_p_filter(logits: torch.Tensor, p: float):
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p (the top token always survives).
    Ties sort by the lower index first, as the JAX stable argsort."""
    if p >= 1.0:
        return logits
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # drop tokens where the cumulative mass BEFORE them already >= p
    drop_sorted = (cum - probs) >= p
    drop = torch.zeros_like(drop_sorted).scatter(1, sort_idx, drop_sorted)
    return logits.masked_fill(drop, NEG_INF)


def repetition_penalty_(logits: torch.Tensor, generated_ids: torch.Tensor,
                        penalty: float, mask: Optional[torch.Tensor] = None):
    """CTRL-style penalty on already-generated tokens (paddle semantics:
    positive logits divided by, negative multiplied by ``penalty``).
    ``generated_ids`` [batch, n]; ``mask`` [batch, n] marks valid ids. An
    id listed more than once counts as seen when any of its entries is
    valid (a scatter-max of the mask)."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    valid = torch.ones(generated_ids.shape, dtype=torch.int32,
                       device=logits.device) if mask is None \
        else mask.to(torch.int32)
    seen = torch.zeros((b, v), dtype=torch.int32, device=logits.device) \
        .scatter_reduce(1, generated_ids.long(), valid, "amax") > 0
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def process_logits(logits: torch.Tensor, temperature=1.0, top_k=0,
                   top_p=1.0, generated_ids=None, repetition_penalty=1.0,
                   generated_mask=None, min_length_active=False,
                   eos_token_id=None):
    """Composition in the reference's order: repetition penalty ->
    temperature -> the min-length eos ban -> top-k -> top-p."""
    if generated_ids is not None and repetition_penalty != 1.0:
        logits = repetition_penalty_(logits, generated_ids,
                                     repetition_penalty, generated_mask)
    logits = apply_temperature(logits, temperature)
    if min_length_active and eos_token_id is not None:
        logits = logits.index_fill(
            1, torch.tensor([eos_token_id], device=logits.device), NEG_INF)
    logits = top_k_filter(logits, top_k)
    logits = top_p_filter(logits, top_p)
    return logits


def process_logits_batch(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor
                         ) -> torch.Tensor:
    """Per-row temperature -> top-k -> top-p over ``[batch, vocab]``
    logits, each parameter a ``[batch]`` tensor. ``top_k <= 0`` and
    ``top_p >= 1`` disable their filter for that row. As in the JAX
    function, top-k cuts by sorted rank (ties at the k-th logit keep
    exactly k entries), top-p's nucleus mass is taken over the top-k
    survivors' renormalised distribution, and the top-1 token always
    survives both filters. A row with ``top_p >= 1`` drops nothing: the
    JAX function can drop tail tokens there when the float32 cumulative
    sum rounds up to 1.0 before the last token."""
    logits = logits / torch.clamp(temperature, min=1e-6)[:, None]
    b, v = logits.shape
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                         stable=True)
    rank = torch.arange(v, device=logits.device)[None, :]
    drop_k = (top_k[:, None] > 0) & (rank >= top_k[:, None])
    probs = torch.softmax(sorted_logits.masked_fill(drop_k, NEG_INF),
                          dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drop_p = ((cum - probs) >= top_p[:, None]) & (top_p[:, None] < 1.0)
    drop_sorted = (drop_k | drop_p) & (rank > 0)
    drop = torch.zeros_like(drop_sorted).scatter(1, sort_idx, drop_sorted)
    return logits.masked_fill(drop, NEG_INF)


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature=1.0, top_k=0, top_p=1.0, **kw) -> torch.Tensor:
    """One token per row, drawn from ``generator`` out of the softmax of
    the processed logits (float32); filtered entries have probability 0.
    ``kw`` goes to ``process_logits``."""
    logits = process_logits(logits, temperature, top_k, top_p, **kw)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
class BeamState:
    """Flat [batch * num_beams]-major beam bookkeeping on ``device`` (the
    card unless the caller asks for the CPU): float32 ``scores`` [batch,
    num_beams], int32 ``tokens`` [batch, num_beams, max_len] and
    ``lengths``, bool ``finished``."""

    def __init__(self, batch, num_beams, max_len, dtype=torch.int32,
                 device="cuda"):
        dev = resolve_device(device)
        self.batch = batch
        self.num_beams = num_beams
        # log-prob scores: beam 0 starts at 0, the others at -1e30 (the
        # standard first-step degeneracy fix)
        self.scores = torch.full((batch, num_beams), NEG_INF,
                                 dtype=torch.float32, device=dev)
        self.scores[:, 0] = 0.0
        self.tokens = torch.zeros((batch, num_beams, max_len), dtype=dtype,
                                  device=dev)
        self.lengths = torch.zeros((batch, num_beams), dtype=torch.int32,
                                   device=dev)
        self.finished = torch.zeros((batch, num_beams), dtype=torch.bool,
                                    device=dev)


def beam_step(state: BeamState, logprobs: torch.Tensor, t: int,
              eos_token_id: Optional[int] = None):
    """One beam-search step. ``logprobs``: [batch * num_beams, vocab]
    log-softmaxed model output for the beams' last tokens. Returns
    (new_state, beam_idx [batch * num_beams] int32 reorder indices into
    the flat batch-major beam axis, next_tokens [batch, num_beams]).
    Candidates that tie keep the lower flat index first, as
    ``jax.lax.top_k`` does (a frozen beam's non-eos candidates all tie at
    -1e30)."""
    b, nb = state.batch, state.num_beams
    v = logprobs.shape[-1]
    lp = logprobs.reshape(b, nb, v)
    if eos_token_id is not None:
        # finished beams may only extend with eos at no cost, so they
        # keep competing under their final score
        frozen = torch.full((v,), NEG_INF, dtype=lp.dtype, device=lp.device)
        frozen[eos_token_id] = 0.0
        lp = torch.where(state.finished[..., None], frozen, lp)
    cand = state.scores[..., None] + lp               # [b, nb, v]
    flat = cand.reshape(b, nb * v)
    ranked, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, top_idx = ranked[:, :nb], order[:, :nb]
    src_beam = top_idx // v
    next_tok = (top_idx % v).to(state.tokens.dtype)

    tokens = torch.gather(state.tokens, 1, src_beam[..., None].expand(
        b, nb, state.tokens.shape[2])).clone()
    tokens[:, :, t] = next_tok
    finished = torch.gather(state.finished, 1, src_beam)
    lengths = torch.gather(state.lengths, 1, src_beam)
    lengths = torch.where(finished, lengths, lengths + 1)
    if eos_token_id is not None:
        finished = finished | (next_tok == eos_token_id)

    new = BeamState.__new__(BeamState)
    new.batch, new.num_beams = b, nb
    new.scores = top_scores
    new.tokens = tokens
    new.lengths = lengths
    new.finished = finished
    # flat reorder indices for the KV cache: batch-major
    beam_idx = (torch.arange(b, device=flat.device)[:, None] * nb
                + src_beam).reshape(-1).to(torch.int32)
    return new, beam_idx, next_tok


def beam_finalize(state: BeamState, length_penalty: float = 0.0):
    """Pick each batch row's best beam under the GNMT length penalty
    ((5 + len) / 6) ** alpha (the reference's default scorer); the first
    beam wins a tie. Returns (tokens [batch, max_len], scores [batch])."""
    lens = torch.clamp(state.lengths, min=1).float()
    denom = torch.pow((5.0 + lens) / 6.0, length_penalty)
    final = state.scores / denom
    best = torch.argmax(final, dim=1)                 # [batch]
    tokens = torch.gather(state.tokens, 1, best[:, None, None].expand(
        -1, 1, state.tokens.shape[2]))[:, 0]
    return tokens, torch.gather(final, 1, best[:, None])[:, 0]


def reorder_cache(caches, beam_idx: torch.Tensor):
    """Gather every cache tensor along its batch (leading) axis, the
    reference's beam cache ``index_select``. ``caches`` is the port's
    cache structure: a list of per-layer ``(ck, cv)`` pairs, each side a
    tensor or a ``QuantizedKV`` (any nesting of lists, tuples and named
    tuples of tensors is taken). Returns new tensors."""
    if isinstance(caches, torch.Tensor):
        return caches.index_select(0, beam_idx)
    parts = [reorder_cache(c, beam_idx) for c in caches]
    if hasattr(caches, "_fields"):  # a named tuple: QuantizedKV
        return type(caches)(*parts)
    return type(caches)(parts)
