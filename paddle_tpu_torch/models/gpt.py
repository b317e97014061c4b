"""GPT-family causal LM (counterpart of ``paddle_tpu/models/gpt.py``):
pre-LN blocks, learned positions, a tanh-GELU MLP.

Parameter names and shapes match the JAX model one to one (linear
weights ``[in_features, out_features]``), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``. Parameters are trainable and
``train()``/``eval()`` are the caller's.

The no-cache forward attends through ``kernels/flash_attention.py:
flash_attention`` (causal): rows 5-9 on the card. With attention dropout
while training, or ``use_flash_attention`` off, it takes the plain SDPA,
as JAX does. The Predictor's cache protocol takes a scalar
``cache_index`` shared by every row: a prefill at index 0 attends over
the prompt alone, and any other call over the whole masked cache, both
through the plain SDPA (no kernel), with the caches written in place. On
one card ``shard_activation`` is the identity and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import default_generator, make_generator
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..kernels import flash_attention as fa
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerList
from ..nn.layer.norm import LayerNorm


@dataclasses.dataclass
class GPTConfig:
    """The defaults are GPT-2 small's published widths (vocab padded to
    50304)."""

    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    # > 0: the train loss through the chunked head + cross-entropy with
    # this many positions a chunk (incubate fused_linear_cross_entropy)
    fused_head_loss_chunk: int = 0

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


def shared_index_attention(q, k, v, kv_cache, cache_index):
    """The scalar-index cache step (JAX ``GPTAttention`` with a
    ``kv_cache``): the ``s`` new rows land at ``cache_index..+s-1`` of
    every batch row of ``(ck, cv)``, written in place in the cache's
    dtype, the start clamped to ``[0, max_len - s]`` as
    ``lax.dynamic_update_slice_in_dim`` clamps it. A prefill at the Python
    int 0 attends causally over the prompt alone; any other call attends
    over all ``max_len`` rows, query ``i`` seeing rows ``<= cache_index +
    i``. Plain SDPA either way."""
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        raise ValueError(
            "GPT decode cache supports scalar cache_index only (the "
            "continuous-batching engine's per-slot vector form is "
            "implemented for Llama)")
    if cache_index is None:
        cache_index = 0
    ck, cv = kv_cache
    s, max_len = q.shape[1], ck.shape[1]
    if s > max_len:
        raise ValueError(f"a block of {s} rows exceeds max_len {max_len}")
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    ar = torch.arange(s, device=q.device)
    q_pos = ar + cache_index
    rows = ar + q_pos[:1].clamp(0, max_len - s)
    ck.index_copy_(1, rows, k)
    cv.index_copy_(1, rows, v)
    if s > 1 and isinstance(cache_index, int) and cache_index == 0:
        # prefill: s x s causal attention over the prompt only
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=False)
    live = torch.arange(max_len, device=q.device)[None, :] <= q_pos[:, None]
    return F.scaled_dot_product_attention(q, ck, cv,
                                          attn_mask=live[None, None],
                                          training=False)


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(std=config.initializer_range, device=device,
                  generator=generator)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, **kw)
        self.out_proj = RowParallelLinear(h, h, **kw)

    def forward(self, x, kv_cache=None, cache_index=None):
        cfg = self.config
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_attention_heads,
                                       cfg.head_dim)
        # strided views: the kernel path copies each to contiguous
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if kv_cache is not None:
            out = shared_index_attention(q, k, v, kv_cache, cache_index)
            return (self.out_proj(out.reshape(b, s, cfg.hidden_size)),
                    kv_cache)
        p = cfg.attention_probs_dropout_prob
        if cfg.use_flash_attention and not (self.training and p > 0):
            out = fa.flash_attention(q, k, v, causal=True,
                                     training=self.training)
        else:
            gen = default_generator(x.device) if self.training and p > 0 \
                else None
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=p,
                training=self.training, generator=gen)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, device, generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        kw = dict(std=config.initializer_range, device=device,
                  generator=generator)
        self.ln_1 = LayerNorm(h, eps, device=device)
        self.attn = GPTAttention(config, device, generator)
        self.ln_2 = LayerNorm(h, eps, device=device)
        self.fc_in = ColumnParallelLinear(h, config.intermediate_size, **kw)
        self.fc_out = RowParallelLinear(config.intermediate_size, h, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def mlp(self, x):
        return self.fc_out(F.gelu(self.fc_in(self.ln_2(x)),
                                  approximate=True))

    def forward(self, x, kv_cache=None, cache_index=None):
        if kv_cache is not None:
            a, kv_cache = self.attn(self.ln_1(x), kv_cache, cache_index)
            x = x + a
            return x + self.mlp(x), kv_cache
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(x))


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device, generator):
        super().__init__()
        self.config = config
        init = I.Normal(0.0, config.initializer_range)
        self.embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            std=config.initializer_range, device=device,
            generator=generator)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init, device=device, generator=generator)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.h = LayerList([GPTBlock(config, device, generator)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=device)

    def forward(self, input_ids, position_ids=None, kv_caches=None,
                cache_index=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embeddings(input_ids) + self.position_embeddings(
            position_ids)
        if kv_caches is not None:
            for block, cache in zip(self.h, kv_caches):
                x, _ = block(x, cache, cache_index)
            return self.ln_f(x), kv_caches
        x = self.drop(x)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    """The GPT causal LM on ``device`` (default the current device: the
    card unless ``set_device("cpu")`` chose the host; without a card it
    raises). Weights are drawn from Normal(0, ``initializer_range``) with
    a ``torch.Generator`` seeded from ``seed`` on that device."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.gpt = GPTModel(config, dev, gen)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size,
            std=config.initializer_range, has_bias=False, device=dev,
            generator=gen)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def loss_count(self, input_ids=None, labels=None, **_):
        """The tokens the loss of ``forward(input_ids, labels)`` averages
        over (labels[:, 1:] not -100), by which ``TrainStep`` over a mesh
        weights each rank's mean."""
        return (labels[:, 1:] != -100).sum()

    def forward(self, input_ids, labels=None, position_ids=None,
                kv_caches=None, cache_index=None):
        """Logits ``[b, s, vocab]``; with ``labels`` the mean next-token
        cross-entropy (ids of -100 ignored), through the chunked head +
        loss when ``fused_head_loss_chunk`` is set. With ``kv_caches`` (a
        list of per-layer ``(ck, cv)`` pairs, written in place, under
        ``torch.no_grad()``) returns ``(logits, kv_caches)``."""
        if kv_caches is not None:
            with torch.no_grad():
                hidden, kv_caches = self.gpt(input_ids, position_ids,
                                             kv_caches, cache_index)
                return self.lm_head(hidden), kv_caches
        hidden = self.gpt(input_ids, position_ids)
        if labels is not None and self.config.fused_head_loss_chunk:
            return fused_linear_cross_entropy(
                hidden[:, :-1, :], self.lm_head.weight, labels[:, 1:],
                ignore_index=-100,
                seq_chunk=self.config.fused_head_loss_chunk)
        logits = self.lm_head(hidden)
        if labels is None:
            return logits
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:],
                               ignore_index=-100)

    def init_kv_caches(self, batch_size: int, max_len: int,
                       dtype=torch.bfloat16) -> List[Tuple]:
        """Zeroed caches, one ``(ck, cv)`` pair per layer, each [batch,
        max_len, heads, head_dim], on the model's device."""
        cfg = self.config
        shape = (batch_size, max_len, cfg.num_attention_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.num_hidden_layers)]
