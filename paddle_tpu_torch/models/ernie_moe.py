"""ERNIE-style MoE causal LM (counterpart of
``paddle_tpu/models/ernie_moe.py``): the GPT backbone whose FFN is a
mixture of experts every ``moe_every`` layers (``distributed/moe.py``:
the capacity gates, or dropless routing with ``moe_dropless``), trained
on the LM loss plus the summed aux load-balance loss.

Parameter names and shapes match the JAX model one to one, so a JAX
``state_dict`` loads through ``convert.load_numpy_state_dict``. Attention
is GPT's: ``flash_attention`` (causal, rows 5-9 on the card) unless
attention dropout is on while training.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import make_generator
from ..distributed.moe import DroplessMoELayer, MoELayer
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerList
from ..nn.layer.norm import LayerNorm
from .gpt import GPTAttention, GPTConfig


@dataclasses.dataclass
class ErnieMoEConfig(GPTConfig):
    num_experts: int = 8
    moe_every: int = 2  # every Nth block uses the MoE FFN
    top_k: int = 2
    capacity_factor: float = 1.25
    gate: str = "gshard"
    aux_loss_weight: float = 1e-2
    # dropless (no-token-drop) routing through per-expert products
    moe_dropless: bool = False

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("num_experts", 4)
        kw.setdefault("moe_every", 1)
        return cls(**kw)


class ErnieMoEBlock(Layer):
    def __init__(self, config: ErnieMoEConfig, use_moe: bool, device,
                 generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, eps, device=device)
        self.attn = GPTAttention(config, device, generator)
        self.ln_2 = LayerNorm(h, eps, device=device)
        self.use_moe = use_moe
        if use_moe:
            if config.moe_dropless:
                # no capacity knob; the gate choice sets the routing width
                # (switch is top-1)
                moe_cls = DroplessMoELayer
                kw = {"top_k": 1 if config.gate == "switch"
                      else config.top_k}
            else:
                moe_cls = MoELayer
                kw = {"gate": config.gate, "top_k": config.top_k,
                      "capacity_factor": config.capacity_factor}
            self.moe = moe_cls(h, config.num_experts,
                               d_hidden=config.intermediate_size,
                               aux_loss_weight=config.aux_loss_weight,
                               device=device, generator=generator, **kw)
        else:
            kw = dict(std=config.initializer_range, device=device,
                      generator=generator)
            self.fc_in = ColumnParallelLinear(h, config.intermediate_size,
                                              **kw)
            self.fc_out = RowParallelLinear(config.intermediate_size, h,
                                            **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln_1(x)))
        h = self.ln_2(x)
        if self.use_moe:
            y, aux = self.moe(h)
            return x + self.dropout(y), aux
        y = self.fc_out(F.gelu(self.fc_in(h), approximate=True))
        return x + self.dropout(y), 0.0


class ErnieMoEForCausalLM(Layer):
    """The MoE LM on ``device`` (default the current device: the card
    unless ``set_device("cpu")`` chose the host; without a card it
    raises); weights drawn with a generator seeded from ``seed``. With
    ``labels`` returns the next-token cross-entropy plus the summed aux
    losses."""

    def __init__(self, config: ErnieMoEConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        std = config.initializer_range
        self.embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, std=std, device=dev,
            generator=gen)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=I.Normal(0.0, std), device=dev, generator=gen)
        self.blocks = LayerList([
            ErnieMoEBlock(config, (i + 1) % config.moe_every == 0, dev, gen)
            for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=dev)
        self.lm_head = ColumnParallelLinear(
            config.hidden_size, config.vocab_size, std=std, has_bias=False,
            device=dev, generator=gen)

    def forward(self, input_ids, labels=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embeddings(input_ids) + self.position_embeddings(pos)
        total_aux = 0.0
        for block in self.blocks:
            x, aux = block(x)
            total_aux = total_aux + aux
        logits = self.lm_head(self.ln_f(x))
        if labels is None:
            return logits
        lm_loss = F.cross_entropy(logits[:, :-1, :], labels[:, 1:],
                                  ignore_index=-100)
        return lm_loss + total_aux
