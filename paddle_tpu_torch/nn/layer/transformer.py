"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``;
parity: ``paddle.nn.layer.transformer``).

Layout: [batch, seq, hidden]; attention works on [batch, seq, heads,
head_dim]. Attention is the plain SDPA of ``nn.functional`` (masks,
dropout), as in JAX: no kernel. Layers that hold parameters take
``device`` (None: the current device, the card unless
``set_device("cpu")`` chose the host; without a card that raises) and
``generator`` (None: the port's generator for that device).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.device import current_device
from ...core.module import Layer
from ...core.random import default_generator
from .. import functional as F
from .common import Dropout, LayerList, Linear
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def compute_kv(self, key, value):
        """Projected K/V [b, s, heads, head_dim]: paddle's StaticCache for
        cross-attention, the encoder memory projected once."""
        b = key.shape[0]
        k = self.k_proj(key).reshape(b, key.shape[1], self.num_heads,
                                     self.head_dim)
        v = self.v_proj(value).reshape(b, value.shape[1], self.num_heads,
                                       self.head_dim)
        return k, v

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, static_cache=None):
        """``cache``: (k_prev, v_prev) [b, s, heads, head_dim] (paddle's
        Cache for incremental decoding); this call's K/V are appended and
        ``(out, (k, v))`` returned. ``static_cache``: K/V from
        ``compute_kv`` (paddle's StaticCache), the key/value projections
        skipped."""
        key = query if key is None else key
        value = query if value is None else value
        b, sq, _ = query.shape
        q = self.q_proj(query).reshape(b, sq, self.num_heads, self.head_dim)
        if static_cache is not None:
            k, v = static_cache
        else:
            k, v = self.compute_kv(key, value)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        drop = self.dropout if self.training else 0.0
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=drop,
            training=self.training,
            generator=default_generator(q.device) if drop > 0 else None)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out


class _FFN(Layer):
    """The sublayers a block shares: linear1 -> activation -> act
    dropout -> linear2."""

    def __init__(self, d_model, dim_feedforward, dropout, activation,
                 act_dropout, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def ffn(self, x):
        return self.linear2(self.act_dropout(self.activation(
            self.linear1(x))))


class TransformerEncoderLayer(_FFN):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, dim_feedforward, dropout, activation,
                         act_dropout, device, generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            device=device, generator=generator)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, src, src_mask=None):
        pre = self.normalize_before
        h = self.self_attn(self.norm1(src) if pre else src,
                           attn_mask=src_mask)
        src = src + self.dropout1(h)
        if not pre:
            src = self.norm1(src)
        h = self.ffn(self.norm2(src) if pre else src)
        src = src + self.dropout2(h)
        return src if pre else self.norm2(src)


def _stack(layer_fn, num_layers, kind):
    if not callable(layer_fn) or isinstance(layer_fn, Layer):
        raise TypeError(f"pass a factory callable: Transformer{kind}("
                        f"lambda: Transformer{kind}Layer(...), num_layers)")
    return LayerList([layer_fn() for _ in range(num_layers)])


class TransformerEncoder(Layer):
    """``num_layers`` layers from the factory ``encoder_layer_fn``, then
    ``norm`` when given."""

    def __init__(self, encoder_layer_fn, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(encoder_layer_fn, num_layers, "Encoder")
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(_FFN):
    """Parity: paddle.nn.TransformerDecoderLayer: masked self-attention,
    encoder-decoder cross-attention and the FFN, each pre- or post-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, dim_feedforward, dropout, activation,
                         act_dropout, device, generator)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def gen_static_cache(self, memory):
        """The cross-attention K/V of ``memory`` (paddle's StaticCache):
        once a sequence, passed to every step."""
        return self.cross_attn.compute_kv(memory, memory)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, static_cache=None):
        pre = self.normalize_before
        h = self.norm1(tgt) if pre else tgt
        if cache is not None:
            h, new_cache = self.self_attn(h, attn_mask=tgt_mask,
                                          cache=cache)
        else:
            h = self.self_attn(h, attn_mask=tgt_mask)
        tgt = tgt + self.dropout1(h)
        if not pre:
            tgt = self.norm1(tgt)
        h = self.cross_attn(self.norm2(tgt) if pre else tgt, memory, memory,
                            attn_mask=memory_mask, static_cache=static_cache)
        tgt = tgt + self.dropout2(h)
        if not pre:
            tgt = self.norm2(tgt)
        h = self.ffn(self.norm3(tgt) if pre else tgt)
        tgt = tgt + self.dropout3(h)
        if not pre:
            tgt = self.norm3(tgt)
        return (tgt, new_cache) if cache is not None else tgt


class TransformerDecoder(Layer):
    """``num_layers`` layers from the factory ``decoder_layer_fn``, then
    ``norm`` when given."""

    def __init__(self, decoder_layer_fn, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(decoder_layer_fn, num_layers, "Decoder")
        self.num_layers = num_layers
        self.norm = norm

    def gen_static_cache(self, memory):
        """Per-layer cross-attention K/V (StaticCache)."""
        return [layer.gen_static_cache(memory) for layer in self.layers]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, static_cache=None):
        """``cache``: a list of per-layer (k, v) self-attention caches;
        returns ``(out, new_caches)`` when given. ``static_cache``: the
        per-layer cross-attention K/V from ``gen_static_cache``."""
        out = tgt
        new_caches = [] if cache is not None else None
        for i, layer in enumerate(self.layers):
            sc = static_cache[i] if static_cache is not None else None
            if cache is not None:
                out, c = layer(out, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask, cache=cache[i],
                               static_cache=sc)
                new_caches.append(c)
            else:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask, static_cache=sc)
        if self.norm is not None:
            out = self.norm(out)
        return (out, new_caches) if cache is not None else out


class Transformer(Layer):
    """Parity: paddle.nn.Transformer, the encoder-decoder stack with the
    final encoder and decoder LayerNorms (built in pre- and post-LN
    configurations alike, as paddle does)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
        kw = dict(device=device, generator=generator)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(*args, **kw),
            num_encoder_layers, norm=LayerNorm(d_model, device=device))
        self.decoder = TransformerDecoder(
            lambda: TransformerDecoderLayer(*args, **kw),
            num_decoder_layers, norm=LayerNorm(d_model, device=device))

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive float32 [length, length] causal mask (0 attends,
        -inf is masked), paddle's convention, on ``device`` (the current
        device by default)."""
        allow = torch.ones((length, length), dtype=torch.bool,
                           device=current_device(device)).tril()
        return torch.where(allow, 0.0, float("-inf"))
