"""The Paddle Inference predictor API (counterpart of
``paddle_tpu/inference/__init__.py``: ``Config``, ``Predictor``,
``create_predictor``; parity: ``paddle_infer``).

``Predictor.run`` is the one-shot forward (the flash-attention forward
kernel, row 5, once per layer on the card when the model uses flash
attention). ``generate`` prefills a bucket-padded prompt batch into a
fresh zeroed contiguous cache of ``Config.max_seq_len`` rows at
``Config.decode_dtype`` with the shared scalar ``cache_index`` 0, then
decodes one token a step at the shared index, through the Llama's
shared-index branch (plain SDPA over all ``max_seq_len`` rows, as in
JAX; no kernel). Greedy search, sampling (from a ``torch.Generator``
seeded with ``seed``) and beam search follow the JAX ``Predictor`` step
for step; the JAX compile caches are plain methods here.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import generation as G
from ..core.random import make_generator


class Config:
    """Parity: paddle_infer.Config. Device/IR knobs the reference turns
    into fusion passes are accepted and recorded (introspectable via
    ``summary()``), not errors."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.params_file = params_file
        self.max_batch_size = 1
        self.max_seq_len = 2048
        self.decode_dtype = torch.bfloat16
        self.seq_buckets: Sequence[int] = (128, 512, 1024, 2048)
        self._memory_optim = True
        self._ir_optim = True
        self._records: Dict[str, object] = {}

    # ---- parity knobs (recorded) ----
    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def enable_use_gpu(self, *a, **k):
        self._records["enable_use_gpu"] = (a, k)

    def set_cpu_math_library_num_threads(self, n):
        self._records["cpu_threads"] = n

    def summary(self):
        return {
            "model_dir": self.model_dir,
            "max_batch_size": self.max_batch_size,
            "max_seq_len": self.max_seq_len,
            "seq_buckets": list(self.seq_buckets),
            **self._records,
        }


class Predictor:
    """Causal-LM predictor over a model that exposes ``init_kv_caches``
    and takes ``kv_caches`` / ``cache_index`` in its forward, as
    ``models/llama.py`` does. It runs where the model's weights are."""

    def __init__(self, model: nn.Module, config: Optional[Config] = None):
        self.model = model
        self.config = config or Config()
        model.eval()
        self.device = next(iter(model.parameters())).device
        self._ttft_ms: Optional[float] = None

    # ------------------------------------------------------------------
    def _bucket(self, seq_len: int) -> int:
        for b in self.config.seq_buckets:
            if seq_len <= b:
                return b
        return self.config.max_seq_len

    def _prefill(self, padded: np.ndarray):
        """The bucket-padded prompts' forward into a fresh zeroed cache at
        the shared index 0; returns the logits and the caches."""
        ids = torch.as_tensor(padded, device=self.device)
        batch, bucket = ids.shape
        caches = self.model.init_kv_caches(
            batch, self.config.max_seq_len, dtype=self.config.decode_dtype)
        pos = torch.arange(bucket, device=self.device)[None].expand(
            batch, bucket)
        return self.model(ids, position_ids=pos, kv_caches=caches,
                          cache_index=0)

    def _decode(self, tok: torch.Tensor, caches, idx: int):
        """One ``[batch, 1]`` token at the shared index ``idx``; returns the
        last logits row and the caches (written in place)."""
        pos = torch.full(tok.shape, idx, dtype=torch.long,
                         device=self.device)
        logits, caches = self.model(tok, position_ids=pos, kv_caches=caches,
                                    cache_index=idx)
        return logits[:, -1, :], caches

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, input_ids) -> torch.Tensor:
        """One-shot forward (parity: Predictor::Run) -> logits."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        with torch.no_grad():
            return self.model(ids)

    def generate(
        self,
        input_ids,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        decode_strategy: str = "greedy_search",
        top_k: int = 0,
        top_p: float = 1.0,
        temperature: float = 1.0,
        repetition_penalty: float = 1.0,
        num_beams: int = 1,
        length_penalty: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """Parity: PaddleNLP GenerationMixin.generate: greedy_search,
        sampling (top-k, top-p, temperature, repetition penalty) and
        beam_search (the KV cache reordered each step by one gather).
        Returns ``[batch, steps]`` tokens; stops early once every row
        emitted ``eos_token_id``. Records TTFT: the host wall time up to
        the first token, synchronised on the card."""
        if decode_strategy == "beam_search" or num_beams > 1:
            return self._beam_generate(
                input_ids, max_new_tokens, max(num_beams, 2),
                eos_token_id, length_penalty, temperature,
                repetition_penalty)
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        batch, prompt_len = ids.shape
        padded = np.pad(ids, ((0, 0), (0, self._bucket(prompt_len)
                                       - prompt_len)))
        sampling = decode_strategy == "sampling"
        gen = make_generator(seed, self.device) if sampling else None
        dev = self.device

        def pick(logit_row, slot):
            # the next token, appended to the seen-token buffer at slot
            if sampling:
                tok = G.sample_token(
                    logit_row, gen, temperature=temperature, top_k=top_k,
                    top_p=top_p, generated_ids=gen_buf,
                    repetition_penalty=repetition_penalty,
                    generated_mask=gen_mask)
            else:
                tok = torch.argmax(G.process_logits(
                    logit_row, generated_ids=gen_buf,
                    repetition_penalty=repetition_penalty,
                    generated_mask=gen_mask), dim=-1)
            gen_buf[:, slot] = tok
            gen_mask[:, slot] = True
            return tok

        t0 = time.perf_counter()
        logits, caches = self._prefill(padded)
        # the next token comes from the last *real* prompt position
        last = logits[:, prompt_len - 1, :]
        # the repetition penalty's seen-token buffer: the PROMPT counts
        # too (PaddleNLP penalizes all of input_ids), then each generated
        # token is appended
        buf_len = prompt_len + max_new_tokens
        gen_buf = torch.zeros((batch, buf_len), dtype=torch.int32,
                              device=dev)
        gen_buf[:, :prompt_len] = torch.as_tensor(ids, device=dev)
        gen_mask = torch.zeros((batch, buf_len), dtype=torch.bool,
                               device=dev)
        gen_mask[:, :prompt_len] = True
        nxt = pick(last, prompt_len)
        self._sync()
        self._ttft_ms = (time.perf_counter() - t0) * 1e3

        out: List[torch.Tensor] = [nxt]
        for i in range(max_new_tokens - 1):
            logit_row, caches = self._decode(nxt[:, None], caches,
                                             prompt_len + i)
            nxt = pick(logit_row, prompt_len + i + 1)
            out.append(nxt)
            if eos_token_id is not None \
                    and bool((nxt == eos_token_id).all()):
                break
        return torch.stack(out, dim=1).cpu().numpy()

    def _beam_logprobs(self, logits, state, t, prompt_flat, temperature,
                       repetition_penalty):
        """The beam logits processor and log-softmax: the reference's beam
        path applies the repetition penalty over prompt + beam tokens and
        the temperature; top-k/top-p are sampling-only."""
        if repetition_penalty != 1.0 or temperature != 1.0:
            rows, max_new = prompt_flat.shape[0], state.tokens.shape[2]
            toks_flat = state.tokens.reshape(rows, max_new)
            buf = torch.cat([prompt_flat, toks_flat], dim=1)
            step_seen = torch.arange(max_new, device=self.device) < t
            mask = torch.cat([torch.ones(prompt_flat.shape, dtype=torch.bool,
                                         device=self.device),
                              step_seen[None].expand(rows, max_new)], dim=1)
            logits = G.process_logits(
                logits, temperature=temperature, generated_ids=buf,
                repetition_penalty=repetition_penalty, generated_mask=mask)
        return torch.log_softmax(logits.float(), dim=-1)

    def _beam_generate(self, input_ids, max_new_tokens, num_beams,
                       eos_token_id, length_penalty, temperature=1.0,
                       repetition_penalty=1.0):
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        batch, prompt_len = ids.shape
        # expand each row to num_beams contiguous copies (batch-major)
        tiled = np.repeat(ids, num_beams, axis=0)
        padded = np.pad(tiled, ((0, 0), (0, self._bucket(prompt_len)
                                         - prompt_len)))
        prompt_flat = torch.as_tensor(tiled, dtype=torch.int32,
                                      device=self.device)

        def step(logits, state, t):
            lp = self._beam_logprobs(logits, state, t, prompt_flat,
                                     temperature, repetition_penalty)
            return G.beam_step(state, lp, t, eos_token_id)

        t0 = time.perf_counter()
        logits, caches = self._prefill(padded)
        state = G.BeamState(batch, num_beams, max_new_tokens,
                            device=self.device)
        state, beam_idx, next_tok = step(logits[:, prompt_len - 1, :],
                                         state, 0)
        caches = G.reorder_cache(caches, beam_idx)
        self._sync()
        self._ttft_ms = (time.perf_counter() - t0) * 1e3

        for i in range(max_new_tokens - 1):
            logit_row, caches = self._decode(next_tok.reshape(-1, 1).long(),
                                             caches, prompt_len + i)
            state, beam_idx, next_tok = step(logit_row, state, i + 1)
            caches = G.reorder_cache(caches, beam_idx)
            if eos_token_id is not None and bool(state.finished.all()):
                break
        tokens, scores = G.beam_finalize(state, length_penalty)
        self._last_beam_scores = scores.cpu().numpy()
        return tokens.cpu().numpy()

    @property
    def last_ttft_ms(self):
        return self._ttft_ms


def create_predictor(model_or_config, config: Optional[Config] = None):
    """Parity: paddle_infer.create_predictor. Accepts a model (an
    ``nn.Module``) directly; loading a saved program from a Config's
    ``model_dir`` is not supported, as in the JAX package."""
    if isinstance(model_or_config, nn.Module):
        return Predictor(model_or_config, config)
    raise TypeError(
        "pass a Layer (an nn.Module); program-file loading arrives with "
        "the serialization format")
