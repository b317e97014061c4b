"""BERT / ERNIE dense encoder family (counterpart of
``paddle_tpu/models/bert.py``): token, position and segment embeddings,
post-LN blocks, a pooler, and the sequence-classification and masked-LM
heads; the ``Ernie*`` names are the same classes.

Parameter names and shapes match the JAX model one to one (linear
weights ``[in_features, out_features]``, the MLM decoder tied to the word
embeddings with its own ``decoder_bias``), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``.

Attention is bidirectional. Without attention dropout in training it
goes to ``kernels/flash_attention.py: flash_attention`` (non-causal,
rows 5-9 on the card), the padding mask passed as segment ids (a real
token 0, padding 1), so a padded query attends the padded keys and a
real query only the real ones. With attention dropout while training it
takes the plain SDPA with the mask on the keys alone, as JAX does: the
two paths agree at real tokens and differ at padded ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
from ..kernels import flash_attention as fa
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerList, Linear
from ..nn.layer.norm import LayerNorm


@dataclass
class BertConfig:
    """The defaults are bert-base's published widths."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    num_labels: int = 2

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
        kw.setdefault("hidden_dropout_prob", 0.0)
        kw.setdefault("attention_probs_dropout_prob", 0.0)
        return cls(**kw)


def _linear_kw(config, device, generator):
    return dict(std=config.initializer_range, device=device,
                generator=generator)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        init = I.Normal(0.0, config.initializer_range)
        h = config.hidden_size
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, h, std=config.initializer_range,
            device=device, generator=generator)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, h, weight_attr=init,
            device=device, generator=generator)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, h, weight_attr=init, device=device,
            generator=generator)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev)[None].expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.long,
                                         device=dev)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertSelfAttention(Layer):
    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = _linear_kw(config, device, generator)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, **kw)
        self.out_proj = RowParallelLinear(h, h, **kw)

    def forward(self, x, attention_mask=None):
        cfg = self.config
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_attention_heads,
                                       cfg.head_dim)
        # strided views: the kernel path copies each to contiguous
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        drop = cfg.attention_probs_dropout_prob if self.training else 0.0
        if cfg.use_flash_attention and drop == 0.0:
            segment_ids = None
            if attention_mask is not None:
                # [b, s] padding mask (1 = real token) -> segment ids:
                # padding is a segment of its own
                segment_ids = (attention_mask <= 0).to(torch.int32)
            out = fa.flash_attention(q, k, v, causal=False,
                                     segment_ids=segment_ids,
                                     training=self.training)
        else:
            mask = None
            if attention_mask is not None:
                mask = attention_mask[:, None, None, :] > 0
            gen = default_generator(x.device) if drop > 0 else None
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=drop,
                training=self.training, generator=gen)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


class BertLayer(Layer):
    """Post-LN encoder block (the BERT/ERNIE original)."""

    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = _linear_kw(config, device, generator)
        self.attention = BertSelfAttention(config, device, generator)
        self.attn_norm = LayerNorm(h, eps, device=device)
        self.fc_in = ColumnParallelLinear(h, config.intermediate_size, **kw)
        self.fc_out = RowParallelLinear(config.intermediate_size, h, **kw)
        self.ffn_norm = LayerNorm(h, eps, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, attention_mask=None):
        x = self.attn_norm(
            x + self.dropout(self.attention(x, attention_mask)))
        h = self.fc_out(F.gelu(self.fc_in(x)))
        return self.ffn_norm(x + self.dropout(h))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            **_linear_kw(config, device, generator))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    """The encoder on ``device`` (default the current device: the card
    unless ``set_device("cpu")`` chose the host; without a card it
    raises); weights drawn with a generator seeded from ``seed``. Returns
    ``(hidden [b, s, h], pooled [b, h])``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = current_device(device)
        gen = generator if generator is not None else make_generator(seed,
                                                                     dev)
        self.config = config
        self.embeddings = BertEmbeddings(config, dev, gen)
        self.encoder = LayerList([BertLayer(config, dev, gen)
                                  for _ in range(config.num_hidden_layers)])
        self.pooler = BertPooler(config, dev, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            h = layer(h, attention_mask)
        return h, self.pooler(h)


class BertForSequenceClassification(Layer):
    """Pooled [CLS] -> dropout -> linear; the cross-entropy with
    ``labels``. ``device`` and ``seed`` as for ``BertModel``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.bert = BertModel(config, dev, generator=gen)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, config.num_labels,
                                 **_linear_kw(config, dev, gen))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels)


class BertForMaskedLM(Layer):
    """Transform + the decoder tied to the word-embedding matrix; the
    loss ignores labels of -100. ``device`` and ``seed`` as for
    ``BertModel``."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.bert = BertModel(config, dev, generator=gen)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                **_linear_kw(config, dev, gen))
        self.transform_norm = LayerNorm(config.hidden_size,
                                        config.layer_norm_eps, device=dev)
        self.decoder_bias = self.create_parameter(
            (config.vocab_size,), is_bias=True, device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        h, _ = self.bert(input_ids, token_type_ids,
                         attention_mask=attention_mask)
        h = self.transform_norm(F.gelu(self.transform(h)))
        w = self.bert.embeddings.word_embeddings.weight
        logits = torch.matmul(h, w.T) + self.decoder_bias
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1), ignore_index=-100)


# ERNIE is architecturally this encoder: the paddle-named surface
ErnieConfig = BertConfig
ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification
ErnieForMaskedLM = BertForMaskedLM
