"""Vision Transformer (counterpart of ``paddle_tpu/models/vit.py``; the
ViT-L / PaddleClas configuration of ``BASELINE.json``).

A conv patch embedding, a cls token and learned positions, pre-LN blocks
on the tensor-parallel linears (one card: plain linears) with the plain
``scaled_dot_product_attention`` (as in JAX, not the flash kernels) and
an exact-GELU MLP, a final LayerNorm and a head on the cls token. The
model takes NCHW pixels; under the channels-last policy (``ViTConfig.
channels_last``, else ``PT_FLAGS_conv_layout``: NHWC on the card) the
patch convolution runs NHWC and the patches flatten into tokens by a
reshape, as the JAX model does. Parameter names and shapes match the JAX
model, so a JAX ``state_dict`` loads through
``convert.load_numpy_state_dict``. On one card ``shard_activation`` is
the identity and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import make_generator
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from ..nn import functional as F
from ..nn import layout
from ..nn.layer.common import Dropout, LayerList, Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer.norm import LayerNorm


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-6
    # None = follow PT_FLAGS_conv_layout (auto: NHWC on the card)
    channels_last: Optional[bool] = None

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def vit_l(cls, **kw):
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


class ViTBlock(Layer):
    def __init__(self, config: ViTConfig, device, generator):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, generator=generator)
        self.norm1 = LayerNorm(h, config.layer_norm_epsilon, device=device)
        self.qkv = ColumnParallelLinear(h, 3 * h, **kw)
        self.proj = RowParallelLinear(h, h, **kw)
        self.norm2 = LayerNorm(h, config.layer_norm_epsilon, device=device)
        self.fc1 = ColumnParallelLinear(h, config.intermediate_size, **kw)
        self.fc2 = RowParallelLinear(config.intermediate_size, h, **kw)
        self.drop = Dropout(config.dropout)
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, s, 3, self.num_heads,
                                              self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], training=self.training)
        x = x + self.drop(self.proj(out.reshape(b, s, h)))
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.drop(y)


class ViT(Layer):
    """The ViT on ``device`` (default the current device: the card unless
    ``set_device("cpu")`` chose the host; without a card it raises),
    drawn with a ``torch.Generator`` seeded from ``seed`` on that device.
    ``forward(pixel_values, labels=None)``: the logits, or with labels
    the mean ``cross_entropy``."""

    def __init__(self, config: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        kw = dict(device=dev, generator=gen)
        self.config = config
        h = config.hidden_size
        self.patch_embed = Conv2D(config.num_channels, h, config.patch_size,
                                  stride=config.patch_size, **kw)
        init = I.TruncatedNormal(std=0.02)
        self.cls_token = self.create_parameter(
            (1, 1, h), default_initializer=init, **kw)
        self.pos_embed = self.create_parameter(
            (1, config.num_patches + 1, h), default_initializer=init, **kw)
        self.blocks = LayerList([ViTBlock(config, dev, gen)
                                 for _ in range(config.num_hidden_layers)])
        self.norm = LayerNorm(h, config.layer_norm_epsilon, device=dev)
        self.head = Linear(h, config.num_classes, **kw)

    def forward(self, pixel_values, labels=None):
        cl = layout.decide(self.config.channels_last, pixel_values.device)
        if cl:
            with layout.channels_last_scope(True):
                x = self.patch_embed(layout.nchw_to_nhwc(pixel_values))
            b, c = x.shape[0], x.shape[-1]
            x = x.reshape(b, -1, c)  # [b, patches, h]
        else:
            x = self.patch_embed(pixel_values)  # [b, h, gh, gw]
            b, c = x.shape[0], x.shape[1]
            x = x.reshape(b, c, -1).transpose(1, 2)
        cls = self.cls_token.expand(b, 1, c).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        logits = self.head(self.norm(x)[:, 0])
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels)
