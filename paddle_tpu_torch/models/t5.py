"""T5 encoder-decoder family (counterpart of ``paddle_tpu/models/t5.py``):
relative-position-bias self-attention, RMS ``T5LayerNorm`` (no bias), no
attention scaling, tied input embeddings, and the v1.1 gated-gelu MLP
behind ``feed_forward_proj``.

Parameter names and shapes match the JAX model one to one (linear
weights ``[in_features, out_features]``), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``.

Self-attention carries the relative bias and takes the plain SDPA, as in
JAX. Cross-attention without a mask and without dropout in training
takes ``kernels/flash_attention.py: flash_attention`` (non-causal, scale
1.0): rows 5-9 on the card. The bucket table is computed on the CPU in
float32 (as JAX computes it) and then moved to the model's device, so
every device sees the same table. ``generate`` decodes greedily under
``torch.no_grad()``: cached (per-layer self-attention caches written in
place and the cross-attention K/V projected once) or uncached (the whole
decoder re-run a token, the oracle); a Python loop stands for JAX's
``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.parameter import Parameter
from ..core.random import default_generator, make_generator
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..kernels import flash_attention as fa
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerList

NEG_INF = -1e30


@dataclass
class T5Config:
    """The defaults are t5-small's published widths."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0
    feed_forward_proj: str = "relu"   # or "gated-gelu" (t5 v1.1)
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    use_flash_attention: bool = True

    def __post_init__(self):
        if self.num_decoder_layers is None:
            self.num_decoder_layers = self.num_layers

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 512)
        kw.setdefault("d_model", 64)
        kw.setdefault("d_kv", 16)
        kw.setdefault("d_ff", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("dropout_rate", 0.0)
        return cls(**kw)


class T5LayerNorm(Layer):
    """RMS norm, no bias, no mean subtraction (the T5 original)."""

    def __init__(self, hidden_size, eps=1e-6, device=None):
        super().__init__()
        self.weight = Parameter(torch.ones(
            (hidden_size,), device=current_device(device)))
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.eps)


def _relative_position_bucket(relative_position, bidirectional, num_buckets,
                              max_distance):
    """The bucket of each relative position (key minus query), as JAX
    computes it: the log ratio in float32 (the divisor's log too),
    truncated to an integer."""
    rp = relative_position
    ret = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(rp > 0, num_buckets, 0)
        rp = rp.abs()
    else:
        rp = -rp.clamp(max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    log_ratio = (torch.log(rp.clamp(min=1).float() / max_exact)
                 / torch.log(torch.tensor(max_distance / max_exact,
                                          dtype=torch.float32)))
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(rp.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, rp, large)


class T5RelativeBias(Layer):
    """The per-stack shared ``relative_attention_bias`` embedding."""

    def __init__(self, config: T5Config, bidirectional: bool, device,
                 generator):
        super().__init__()
        self.embedding = Embedding(
            config.relative_attention_num_buckets, config.num_heads,
            weight_attr=I.Normal(
                0.0, config.initializer_factor * config.d_model ** -0.5),
            device=device, generator=generator)
        self.bidirectional = bidirectional
        self.config = config

    def _buckets(self, relative_position):
        cfg = self.config
        return _relative_position_bucket(
            relative_position, self.bidirectional,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance).to(
                self.embedding.weight.device)

    def forward(self, q_len, k_len):
        """[1, heads, q_len, k_len]."""
        rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
        bias = self.embedding(self._buckets(rel))      # [q, k, heads]
        return bias.permute(2, 0, 1)[None]

    def row(self, q_pos, k_len):
        """The single-query row for cached decode: [1, heads, 1, k_len]."""
        bias = self.embedding(self._buckets(torch.arange(k_len) - q_pos))
        return bias.T[None, :, None, :]


def _pad_bias(attention_mask, bias):
    """``bias`` plus -1e30 (float32) on the keys the [b, sk] mask pads."""
    pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    return pad if bias is None else bias + pad


class T5Attention(Layer):
    def __init__(self, config: T5Config, device, generator,
                 is_cross: bool = False):
        super().__init__()
        cfg = config
        self.config = config
        self.is_cross = is_cross
        inner = cfg.num_heads * cfg.d_kv
        std = cfg.initializer_factor * (cfg.d_model * cfg.d_kv) ** -0.5
        kw = dict(has_bias=False, device=device, generator=generator)
        self.q = ColumnParallelLinear(cfg.d_model, inner, std=std, **kw)
        self.k = ColumnParallelLinear(cfg.d_model, inner, std=std, **kw)
        self.v = ColumnParallelLinear(cfg.d_model, inner, std=std, **kw)
        self.o = RowParallelLinear(
            inner, cfg.d_model, std=cfg.initializer_factor * inner ** -0.5,
            **kw)

    def _heads(self, x):
        cfg = self.config
        return x.reshape(x.shape[0], x.shape[1], cfg.num_heads, cfg.d_kv)

    def project_kv(self, kv):
        """K/V projected once (cross-attention: the encoder output never
        changes during decode)."""
        return self._heads(self.k(kv)), self._heads(self.v(kv))

    def decode_step(self, x, cache_index, kv_cache=None,
                    precomputed_kv=None, position_bias=None,
                    attention_mask=None):
        """Single-token attention against a cache: ``kv_cache`` (k, v)
        [b, max_len, heads, d_kv] for self-attention, its row
        ``cache_index`` (clamped to the cache) written in place;
        ``precomputed_kv`` for cross-attention. Returns (out,
        kv_cache)."""
        b = x.shape[0]
        q = self._heads(self.q(x))
        if precomputed_kv is not None:
            k, v = precomputed_kv
            bias = position_bias
            if attention_mask is not None:
                bias = _pad_bias(attention_mask, bias)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=1.0, training=False)
            return self.o(out.reshape(b, 1, -1)), None
        ck, cv = kv_cache
        max_len = ck.shape[1]
        row = min(max(int(cache_index), 0), max_len - 1)
        ck[:, row] = self._heads(self.k(x))[:, 0].to(ck.dtype)
        cv[:, row] = self._heads(self.v(x))[:, 0].to(cv.dtype)
        # causal validity: only positions <= cache_index are live
        live = torch.arange(max_len, device=x.device) <= cache_index
        bias = torch.where(live, 0.0, NEG_INF)[None, None, None, :]
        if position_bias is not None:
            bias = bias + position_bias
        out = F.scaled_dot_product_attention(q, ck, cv, attn_mask=bias,
                                             scale=1.0, training=False)
        return self.o(out.reshape(b, 1, -1)), kv_cache

    def forward(self, x, kv=None, position_bias=None, causal=False,
                attention_mask=None):
        cfg = self.config
        b, sq, _ = x.shape
        kv = x if kv is None else kv
        q = self._heads(self.q(x))
        k, v = self.project_kv(kv)
        drop = cfg.dropout_rate if self.training else 0.0
        if position_bias is None and cfg.use_flash_attention \
                and attention_mask is None and drop == 0.0:
            # cross-attention: no bias, so the flash path, with T5's
            # unscaled logits as the kernels' scale
            out = fa.flash_attention(q, k, v, causal=causal, scale=1.0,
                                     training=self.training)
        else:
            bias = position_bias
            if attention_mask is not None:
                bias = _pad_bias(attention_mask, bias)
            gen = default_generator(x.device) if drop > 0 else None
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, is_causal=causal, scale=1.0,
                dropout_p=drop, training=self.training, generator=gen)
        return self.o(out.reshape(b, sq, -1))


class T5FF(Layer):
    def __init__(self, config: T5Config, device, generator):
        super().__init__()
        cfg = config
        kw = dict(has_bias=False, device=device, generator=generator)
        std_i = cfg.initializer_factor * cfg.d_model ** -0.5
        self.gated = cfg.feed_forward_proj.startswith("gated")
        self.wi = ColumnParallelLinear(cfg.d_model, cfg.d_ff, std=std_i,
                                       **kw)
        if self.gated:
            self.wi_1 = ColumnParallelLinear(cfg.d_model, cfg.d_ff,
                                             std=std_i, **kw)
        self.wo = RowParallelLinear(
            cfg.d_ff, cfg.d_model,
            std=cfg.initializer_factor * cfg.d_ff ** -0.5, **kw)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi(x), approximate=True) * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(self.dropout(h))


class T5Block(Layer):
    def __init__(self, config: T5Config, is_decoder: bool, device,
                 generator):
        super().__init__()
        d, eps = config.d_model, config.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.ln1 = T5LayerNorm(d, eps, device)
        self.self_attn = T5Attention(config, device, generator)
        if is_decoder:
            self.ln_cross = T5LayerNorm(d, eps, device)
            self.cross_attn = T5Attention(config, device, generator,
                                          is_cross=True)
        self.ln2 = T5LayerNorm(d, eps, device)
        self.ff = T5FF(config, device, generator)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, x, enc=None, position_bias=None,
                attention_mask=None, enc_mask=None):
        # attention_mask is THIS stack's padding mask (the encoder's for
        # the encoder stack, the decoder's for the decoder stack)
        x = x + self.dropout(self.self_attn(
            self.ln1(x), position_bias=position_bias,
            causal=self.is_decoder, attention_mask=attention_mask))
        if self.is_decoder and enc is not None:
            x = x + self.dropout(self.cross_attn(
                self.ln_cross(x), kv=enc, attention_mask=enc_mask))
        return x + self.dropout(self.ff(self.ln2(x)))

    def decode_step(self, x, cache_index, self_cache, cross_kv,
                    position_bias=None, enc_mask=None):
        """One cached decoder token. Returns (x, self_cache)."""
        h, self_cache = self.self_attn.decode_step(
            self.ln1(x), cache_index, kv_cache=self_cache,
            position_bias=position_bias)
        x = x + h
        h, _ = self.cross_attn.decode_step(
            self.ln_cross(x), cache_index, precomputed_kv=cross_kv,
            attention_mask=enc_mask)
        x = x + h
        return x + self.ff(self.ln2(x)), self_cache


class T5Stack(Layer):
    def __init__(self, config: T5Config, is_decoder: bool, device,
                 generator):
        super().__init__()
        n = config.num_decoder_layers if is_decoder else config.num_layers
        self.config = config
        self.is_decoder = is_decoder
        self.relative_bias = T5RelativeBias(
            config, not is_decoder, device, generator)
        self.blocks = LayerList([T5Block(config, is_decoder, device,
                                         generator) for _ in range(n)])
        self.final_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon, device)
        self.dropout = Dropout(config.dropout_rate)

    def forward(self, x, enc=None, attention_mask=None, enc_mask=None):
        s = x.shape[1]
        bias = self.relative_bias(s, s)   # shared by every block
        x = self.dropout(x)
        for blk in self.blocks:
            x = blk(x, enc=enc, position_bias=bias,
                    attention_mask=attention_mask, enc_mask=enc_mask)
        return self.dropout(self.final_norm(x))

    def init_decode(self, batch, max_len, enc, dtype=torch.float32):
        """Decoder only: zeroed self-attention caches and the
        cross-attention K/V projected once from the encoder output."""
        cfg = self.config
        shape = (batch, max_len, cfg.num_heads, cfg.d_kv)
        caches = [(torch.zeros(shape, dtype=dtype, device=enc.device),
                   torch.zeros(shape, dtype=dtype, device=enc.device))
                  for _ in self.blocks]
        cross = [blk.cross_attn.project_kv(enc) for blk in self.blocks]
        return caches, cross

    def decode_step(self, x, cache_index, caches, cross_kvs,
                    enc_mask=None):
        """x: [b, 1, d_model], one token's embedding. Returns (hidden [b,
        1, d_model], caches)."""
        max_len = caches[0][0].shape[1]
        bias = self.relative_bias.row(cache_index, max_len)
        for blk, cache, cross in zip(self.blocks, caches, cross_kvs):
            x, _ = blk.decode_step(x, cache_index, cache, cross,
                                   position_bias=bias, enc_mask=enc_mask)
        return self.final_norm(x), caches


class T5Model(Layer):
    """The encoder-decoder on ``device`` (default the current device: the
    card unless ``set_device("cpu")`` chose the host; without a card it
    raises); weights drawn with a generator seeded from ``seed``."""

    def __init__(self, config: T5Config, device=None, seed: int = 0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = current_device(device)
        gen = generator if generator is not None else make_generator(seed,
                                                                     dev)
        self.config = config
        self.shared = VocabParallelEmbedding(
            config.vocab_size, config.d_model,
            std=config.initializer_factor, device=dev, generator=gen)
        self.encoder = T5Stack(config, False, dev, gen)
        self.decoder = T5Stack(config, True, dev, gen)

    def encode(self, input_ids, attention_mask=None):
        return self.encoder(self.shared(input_ids),
                            attention_mask=attention_mask)

    def decode(self, decoder_input_ids, enc, enc_mask=None,
               decoder_attention_mask=None):
        return self.decoder(self.shared(decoder_input_ids), enc=enc,
                            attention_mask=decoder_attention_mask,
                            enc_mask=enc_mask)

    def forward(self, input_ids, decoder_input_ids, attention_mask=None,
                decoder_attention_mask=None):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, enc_mask=attention_mask,
                           decoder_attention_mask=decoder_attention_mask)


class T5ForConditionalGeneration(Layer):
    """The seq2seq LM head; the loss with ``labels`` (shifted right to
    build the decoder inputs when those are not given; ids equal to
    ``pad_token_id`` ignored). ``device`` and ``seed`` as for
    ``T5Model``."""

    def __init__(self, config: T5Config, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.t5 = T5Model(config, dev, generator=gen)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.d_model, config.vocab_size, has_bias=False,
                std=config.initializer_factor, device=dev, generator=gen)

    def _shift_right(self, labels):
        start = torch.full((labels.shape[0], 1),
                           self.config.decoder_start_token_id,
                           dtype=labels.dtype, device=labels.device)
        return torch.cat([start, labels[:, :-1]], dim=1)

    def _logits(self, hidden):
        cfg = self.config
        if cfg.tie_word_embeddings:
            # the reference rescales by d_model ** -0.5 before the tied
            # projection
            hidden = hidden * (cfg.d_model ** -0.5)
            return torch.matmul(hidden, self.t5.shared.weight.T)
        return self.lm_head(hidden)

    def forward(self, input_ids, decoder_input_ids=None, labels=None,
                attention_mask=None, decoder_attention_mask=None):
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("need decoder_input_ids or labels")
            decoder_input_ids = self._shift_right(labels)
        hidden = self.t5(input_ids, decoder_input_ids,
                         attention_mask=attention_mask,
                         decoder_attention_mask=decoder_attention_mask)
        logits = self._logits(hidden)
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1),
                               ignore_index=self.config.pad_token_id)

    def _start_buffer(self, input_ids, max_length):
        cfg = self.config
        buf = torch.full((input_ids.shape[0], max_length), cfg.pad_token_id,
                         dtype=torch.long, device=input_ids.device)
        buf[:, 0] = cfg.decoder_start_token_id
        return buf

    @torch.no_grad()
    def generate(self, input_ids, max_length=20, attention_mask=None,
                 use_cache=True):
        """Greedy decode [b, max_length] (column 0 the start token), the
        encoder run once. ``use_cache`` decodes incrementally over
        per-layer self-attention caches and the cross-attention K/V
        projected once; without it the whole decoder re-runs for every
        token (the oracle)."""
        enc = self.t5.encode(input_ids, attention_mask)
        buf = self._start_buffer(input_ids, max_length)
        if use_cache:
            caches, cross = self.t5.decoder.init_decode(
                buf.shape[0], max_length, enc, dtype=enc.dtype)
        for t in range(max_length - 1):
            if use_cache:
                x = self.t5.shared(buf[:, t:t + 1])
                hidden, caches = self.t5.decoder.decode_step(
                    x, t, caches, cross, enc_mask=attention_mask)
                logits = self._logits(hidden)[:, 0]
            else:
                # the causal mask keeps the pad suffix from reaching t
                hidden = self.t5.decode(buf, enc, enc_mask=attention_mask)
                logits = self._logits(hidden)[:, t]
            buf[:, t + 1] = torch.argmax(logits, dim=-1)
        return buf
