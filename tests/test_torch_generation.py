"""The port's generation utilities (paddle_tpu_torch/generation.py)
against the JAX package's on the CPU: every scalar logits processor and
``process_logits`` to 1e-6 on the same seeded inputs (top-k ties, k past
the vocabulary and k <= 0, p >= 1, a masked repetition buffer with
duplicated ids, the min-length eos ban); ``sample_token`` reproducible
from a generator seed, argmax at top_k=1, and its empirical frequencies
over 20,000 draws within 0.02 of the processed softmax (its tokens differ
from ``jax.random.categorical``'s by design); beam search over 4 steps
with the same tokens, lengths, finished flags and reorder indices and
scores to 1e-6, with and without eos, candidate ties included; and
``reorder_cache`` over float and int8 cache pairs."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import generation as JG
from paddle_tpu_torch import generation as G
from paddle_tpu_torch.inference.paged import QuantizedKV

V = 40


def _logits(seed, b=4, v=V):
    """Seeded float32 logits; row 0 has five entries tied at its 3rd
    highest value and row 1 (if any) two tied maxima."""
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32)
    x[0, [3, 9, 17, 25, 31]] = np.sort(x[0])[-3]
    if b > 1:
        x[1, [5, 6]] = x[1].max() + 1.0
    return x


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("k", [-1, 0, 1, 3, 7, V, V + 25])
def test_top_k_filter_matches_jax(k):
    x = _logits(0)
    got = G.top_k_filter(torch.tensor(x), k)
    _close(got, JG.top_k_filter(jnp.asarray(x), k))
    if k == 3:  # every logit tied with the 3rd stays in row 0
        kept = int((got[0] > G.NEG_INF).sum())
        assert kept == (x[0] >= np.sort(x[0])[-3]).sum() and kept >= 7


@pytest.mark.parametrize("p", [0.05, 0.3, 0.9, 1.0, 1.5])
def test_top_p_filter_matches_jax(p):
    x = _logits(1) * 2.0
    _close(G.top_p_filter(torch.tensor(x), p),
           JG.top_p_filter(jnp.asarray(x), p))


@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.8, 0.0])
def test_apply_temperature_matches_jax(temperature):
    x = _logits(2)
    _close(G.apply_temperature(torch.tensor(x), temperature),
           JG.apply_temperature(jnp.asarray(x), temperature))


def _history(seed, b=4, n=12):
    """Seeded ids with duplicates, and a mask where a duplicated id has a
    valid and an invalid entry (it counts as seen)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, n)).astype(np.int32)
    ids[:, 1] = ids[:, 0]
    ids[:, 5] = ids[:, 4]
    mask = rng.random((b, n)) < 0.6
    mask[:, 0], mask[:, 1] = True, False
    mask[:, 4], mask[:, 5] = False, True
    return ids, mask


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.8])
@pytest.mark.parametrize("masked", [False, True])
def test_repetition_penalty_matches_jax(penalty, masked):
    x = _logits(3)
    ids, mask = _history(4)
    tm = torch.tensor(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    got = G.repetition_penalty_(torch.tensor(x), torch.tensor(ids), penalty,
                                tm)
    _close(got, JG.repetition_penalty_(jnp.asarray(x), jnp.asarray(ids),
                                       penalty, jm))
    if masked and penalty != 1.0:
        # the duplicated ids with one valid entry were penalised
        rows = np.arange(4)
        assert not np.allclose(got.numpy()[rows, ids[:, 0]],
                               x[rows, ids[:, 0]])


@pytest.mark.parametrize("case", [
    dict(),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8, repetition_penalty=1.2),
    dict(top_k=3, top_p=0.5, repetition_penalty=0.9,
         min_length_active=True, eos_token_id=7),
    dict(temperature=0.5, top_k=V + 3, top_p=1.0, min_length_active=True,
         eos_token_id=2),
])
def test_process_logits_matches_jax(case):
    x = _logits(5)
    ids, mask = _history(6)
    got = G.process_logits(torch.tensor(x), generated_ids=torch.tensor(ids),
                           generated_mask=torch.tensor(mask), **case)
    want = JG.process_logits(jnp.asarray(x), generated_ids=jnp.asarray(ids),
                             generated_mask=jnp.asarray(mask), **case)
    _close(got, want)
    if case.get("min_length_active"):
        assert (got[:, case["eos_token_id"]] == G.NEG_INF).all()
    # the input is left as it was
    assert np.array_equal(x, _logits(5))


def test_sample_token_reproducible_and_top1_is_argmax():
    x = torch.tensor(_logits(7, b=6))

    def draw(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return G.sample_token(x, gen, temperature=1.5, **kw)

    a = draw(3)
    assert torch.equal(a, draw(3)) and a.shape == (6,)
    assert any(not torch.equal(a, draw(s)) for s in (4, 5, 6))
    # top_k=1 keeps the maximum alone, except row 1's two tied maxima
    top1 = draw(3, top_k=1)
    rows = [0, 2, 3, 4, 5]
    assert torch.equal(top1[rows], torch.argmax(x, dim=-1)[rows])
    assert int(top1[1]) in (5, 6)


def test_sample_token_frequencies_follow_the_processed_softmax():
    """20,000 draws of one row: each token's frequency within 0.02 of its
    processed probability (the largest standard error is 0.0036), and the
    tokens the filters dropped are never drawn."""
    n = 20_000
    row = _logits(8, b=1)
    kw = dict(temperature=0.8, top_k=6, top_p=0.9)
    gen = torch.Generator().manual_seed(0)
    toks = G.sample_token(torch.tensor(row).expand(n, V), gen, **kw)
    freq = np.bincount(toks.numpy(), minlength=V) / n
    probs = torch.softmax(G.process_logits(torch.tensor(row), **kw),
                          dim=-1)[0].numpy()
    assert np.abs(freq - probs).max() < 0.02
    assert (freq[probs == 0] == 0).all() and (probs > 0).sum() >= 2


def _beam_logprobs(seed, rows, v, ties):
    x = np.random.default_rng(seed).standard_normal((rows, v)) * 2.0
    if ties:
        x[:, 4] = x[:, 2]  # tied candidates within every beam
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return lp.astype(np.float32)


def _state_equal(t, j):
    assert np.array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    assert np.array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert np.array_equal(t.finished.numpy(), np.asarray(j.finished))
    _close(t.scores, j.scores)


@pytest.mark.parametrize("eos", [None, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_beam_search_matches_jax(eos, ties):
    """4 steps of 2 rows x 3 beams over 11 tokens; with eos, the eos logit
    is raised at step 1 so beams finish and freeze (their candidates tie
    at -1e30 + score), and the state must stay identical."""
    b, nb, v, steps = 2, 3, 11, 4
    ts = G.BeamState(b, nb, steps, device="cpu")
    js = JG.BeamState(b, nb, steps)
    _state_equal(ts, js)
    for t in range(steps):
        lp = _beam_logprobs(10 + t, b * nb, v, ties)
        if eos is not None and t == 1:
            lp[:, eos] = -0.01
        ts, t_idx, t_tok = G.beam_step(ts, torch.tensor(lp), t, eos)
        js, j_idx, j_tok = JG.beam_step(js, jnp.asarray(lp), t, eos)
        _state_equal(ts, js)
        assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
        assert t_idx.dtype == t_tok.dtype == ts.lengths.dtype == torch.int32
    if eos is not None:
        assert ts.finished.any()
    for alpha in (0.0, 1.0):
        t_best, t_score = G.beam_finalize(ts, alpha)
        j_best, j_score = JG.beam_finalize(js, alpha)
        assert np.array_equal(t_best.numpy(), np.asarray(j_best))
        _close(t_score, j_score)


def test_reorder_cache_gathers_every_tensor():
    rng = np.random.default_rng(9)
    f = rng.standard_normal((4, 5, 2, 3)).astype(np.float32)
    q = rng.integers(-127, 128, (4, 5, 2, 3)).astype(np.int8)
    s = rng.random((4, 5, 2)).astype(np.float32)
    caches = [(torch.tensor(f), torch.tensor(f * 2)),
              (QuantizedKV(torch.tensor(q), torch.tensor(s)),
               QuantizedKV(torch.tensor(q), torch.tensor(s * 3)))]
    idx = np.asarray([2, 2, 0, 3], np.int32)
    out = G.reorder_cache(caches, torch.tensor(idx))
    assert isinstance(out, list) and isinstance(out[1][0], QuantizedKV)
    want = JG.reorder_cache([(f, f * 2), (q, s)], jnp.asarray(idx))
    assert np.array_equal(out[0][0].numpy(), np.asarray(want[0][0]))
    assert np.array_equal(out[0][1].numpy(), np.asarray(want[0][1]))
    assert np.array_equal(out[1][0].q.numpy(), np.asarray(want[1][0]))
    assert np.array_equal(out[1][0].scale.numpy(), np.asarray(want[1][1]))
    assert np.array_equal(out[1][1].scale.numpy(), s[idx] * 3)
    # new tensors: the source caches are untouched
    assert np.array_equal(caches[0][0].numpy(), f)
