"""Diffusion UNet (counterpart of ``paddle_tpu/models/unet.py``): the
SD-1.x ``UNet2DConditionModel`` structure, ResNet blocks with
GroupNorm+SiLU, self and cross attention at the two lowest resolutions,
a timestep embedding, down and up sampling with skip connections.

Parameter names and shapes match the JAX model one to one (linear
weights ``[in, out]``, conv weights OIHW), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``. Parameters are trainable.

Layout (``nn.layout``): NCHW at the API. With ``channels_last`` on (the
"auto" default: on for a model on the card, off on the CPU) the forward
transposes once at its entry, runs the whole conv/GroupNorm/attention
body in NHWC, and transposes back at its exit; the GroupNorms then run
the fused kernels (rows 12/13, ``kernels/group_norm.py``), with the
norm -> SiLU chains inside them. Attention goes through the plain
``nn.functional.scaled_dot_product_attention``, as the JAX model uses
its plain XLA version (no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..core.device import current_device
from ..core.module import Layer
from ..core.random import make_generator
from ..nn import functional as F
from ..nn import layout
from ..nn.layer.common import LayerList, Linear, Upsample
from ..nn.layer.conv import Conv2D
from ..nn.layer.norm import GroupNorm, LayerNorm


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    sample_size: int = 64
    # None = follow PT_FLAGS_conv_layout (auto: NHWC on the card); the
    # API stays NCHW either way
    channels_last: Optional[bool] = None

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("in_channels", 4)
        kw.setdefault("out_channels", 4)
        kw.setdefault("block_out_channels", (32, 64))
        kw.setdefault("layers_per_block", 1)
        kw.setdefault("cross_attention_dim", 32)
        kw.setdefault("attention_head_dim", 4)
        kw.setdefault("norm_num_groups", 8)
        kw.setdefault("sample_size", 16)
        return cls(**kw)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """The sinusoidal table [b, dim] in float32: cos then sin of t *
    exp(-ln(max_period) i / half)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(Layer):
    def __init__(self, in_c, out_c, temb_c, groups, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        # SiLU fused into the norm (rows 12/13 under NHWC)
        self.norm1 = GroupNorm(groups, in_c, activation="silu", device=device)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.time_emb_proj = Linear(temb_c, out_c, **kw)
        self.norm2 = GroupNorm(groups, out_c, activation="silu",
                               device=device)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.shortcut = (Conv2D(in_c, out_c, 1, **kw) if in_c != out_c
                         else None)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb))
        h = h + (t[:, None, None, :] if layout.active()
                 else t[:, :, None, None])
        h = self.conv2(self.norm2(h))
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + h


class CrossAttnBlock(Layer):
    """Self-attention, cross-attention and a GEGLU feed-forward over the
    flattened spatial tokens. As in JAX, the heads are ``channels // 64``
    and ``head_dim`` is not read (ROADMAP.md Queue C)."""

    def __init__(self, channels, ctx_dim, head_dim, groups, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        nb = dict(has_bias=False, **kw)
        self.norm = GroupNorm(groups, channels, device=device)
        self.proj_in = Linear(channels, channels, **kw)
        self.n_heads = max(1, channels // 64)
        self.head_dim = channels // self.n_heads
        self.norm1 = LayerNorm(channels, device=device)
        self.to_q1 = Linear(channels, channels, **nb)
        self.to_k1 = Linear(channels, channels, **nb)
        self.to_v1 = Linear(channels, channels, **nb)
        self.to_out1 = Linear(channels, channels, **kw)
        self.norm2 = LayerNorm(channels, device=device)
        self.to_q2 = Linear(channels, channels, **nb)
        self.to_k2 = Linear(ctx_dim, channels, **nb)
        self.to_v2 = Linear(ctx_dim, channels, **nb)
        self.to_out2 = Linear(channels, channels, **kw)
        self.norm3 = LayerNorm(channels, device=device)
        self.ff1 = Linear(channels, channels * 8, **kw)
        self.ff2 = Linear(channels * 4, channels, **kw)
        self.proj_out = Linear(channels, channels, **kw)

    def _attn(self, q, k, v):
        b, sq, c = q.shape
        sk = k.shape[1]
        qh = q.reshape(b, sq, self.n_heads, self.head_dim)
        kh = k.reshape(b, sk, self.n_heads, self.head_dim)
        vh = v.reshape(b, sk, self.n_heads, self.head_dim)
        out = F.scaled_dot_product_attention(qh, kh, vh,
                                             training=self.training)
        return out.reshape(b, sq, c)

    def forward(self, x, context):
        cl = layout.active()
        if cl:
            b, hh, ww, c = x.shape
            # channels-last: the spatial -> token flatten is a reshape
            h = self.norm(x).reshape(b, hh * ww, c)
        else:
            b, c, hh, ww = x.shape
            h = self.norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        residual_spatial = x
        h = self.proj_in(h)
        hn = self.norm1(h)
        h = h + self.to_out1(
            self._attn(self.to_q1(hn), self.to_k1(hn), self.to_v1(hn)))
        hn = self.norm2(h)
        h = h + self.to_out2(
            self._attn(self.to_q2(hn), self.to_k2(context),
                       self.to_v2(context)))
        # GEGLU feed-forward
        hn = self.norm3(h)
        a, gate = self.ff1(hn).chunk(2, dim=-1)
        h = h + self.ff2(a * F.gelu(gate))
        h = self.proj_out(h)
        h = (h.reshape(b, hh, ww, c) if cl
             else h.transpose(1, 2).reshape(b, c, hh, ww))
        return residual_spatial + h


class Downsample(Layer):
    def __init__(self, channels, device, generator):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1,
                           device=device, generator=generator)

    def forward(self, x):
        return self.conv(x)


class UpsampleBlock(Layer):
    def __init__(self, channels, device, generator):
        super().__init__()
        self.up = Upsample(scale_factor=2, mode="nearest")
        self.conv = Conv2D(channels, channels, 3, padding=1, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(self.up(x))


class UNet2DConditionModel(Layer):
    """The UNet on ``device`` (default the current device: the card
    unless ``set_device("cpu")`` chose the host; without a card it
    raises), float32 weights
    drawn with a ``torch.Generator`` seeded from ``seed`` on that device
    as the JAX initializers draw them (linears XavierNormal, convs
    KaimingUniform, biases zeros, norms ones and zeros)."""

    def __init__(self, config: UNetConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        kw = dict(device=dev, generator=gen)
        self.config = config
        ch = config.block_out_channels
        groups = config.norm_num_groups
        temb_c = ch[0] * 4
        self.time_proj_dim = ch[0]
        self.time_embedding1 = Linear(ch[0], temb_c, **kw)
        self.time_embedding2 = Linear(temb_c, temb_c, **kw)
        self.conv_in = Conv2D(config.in_channels, ch[0], 3, padding=1, **kw)

        def attn(c):
            return CrossAttnBlock(c, config.cross_attention_dim,
                                  config.attention_head_dim, groups, dev,
                                  gen)

        self.down_resnets = LayerList()
        self.down_attns = LayerList()
        self.downsamplers = LayerList()
        skip_channels = [ch[0]]
        cur = ch[0]
        for level, out_c in enumerate(ch):
            for _ in range(config.layers_per_block):
                self.down_resnets.append(
                    ResnetBlock(cur, out_c, temb_c, groups, dev, gen))
                use_attn = level >= len(ch) - 2
                self.down_attns.append(attn(out_c) if use_attn else None)
                cur = out_c
                skip_channels.append(cur)
            if level < len(ch) - 1:
                self.downsamplers.append(Downsample(cur, dev, gen))
                skip_channels.append(cur)

        self.mid_res1 = ResnetBlock(cur, cur, temb_c, groups, dev, gen)
        self.mid_attn = attn(cur)
        self.mid_res2 = ResnetBlock(cur, cur, temb_c, groups, dev, gen)

        self.up_resnets = LayerList()
        self.up_attns = LayerList()
        self.upsamplers = LayerList()
        for level, out_c in enumerate(reversed(ch)):
            for _ in range(config.layers_per_block + 1):
                skip = skip_channels.pop()
                self.up_resnets.append(
                    ResnetBlock(cur + skip, out_c, temb_c, groups, dev, gen))
                use_attn = level < 2
                self.up_attns.append(attn(out_c) if use_attn else None)
                cur = out_c
            if level < len(ch) - 1:
                self.upsamplers.append(UpsampleBlock(cur, dev, gen))

        self.conv_norm_out = GroupNorm(groups, cur, activation="silu",
                                       device=dev)
        self.conv_out = Conv2D(cur, config.out_channels, 3, padding=1, **kw)

    def forward(self, sample, timestep, encoder_hidden_states):
        """sample [b, c, h, w]; timestep [b]; context [b, s, ctx_dim];
        returns [b, out_channels, h, w]."""
        # the table is float32; cast to the weights' dtype before it meets
        # activations, or one add would promote every later conv
        temb = timestep_embedding(timestep, self.time_proj_dim)
        temb = temb.to(self.time_embedding1.weight.dtype)
        temb = self.time_embedding2(F.silu(self.time_embedding1(temb)))

        cl = layout.decide(self.config.channels_last, sample.device)
        if cl:
            # the only layout transposes of the forward: NCHW -> NHWC here,
            # and back at the return
            sample = layout.nchw_to_nhwc(sample)
        cat_axis = -1 if cl else 1
        cfg = self.config
        with layout.channels_last_scope(cl):
            h = self.conv_in(sample)
            skips = [h]
            ri, di = 0, 0
            for level in range(len(cfg.block_out_channels)):
                for _ in range(cfg.layers_per_block):
                    h = self.down_resnets[ri](h, temb)
                    attn = self.down_attns[ri]
                    if attn is not None:
                        h = attn(h, encoder_hidden_states)
                    ri += 1
                    skips.append(h)
                if level < len(cfg.block_out_channels) - 1:
                    h = self.downsamplers[di](h)
                    di += 1
                    skips.append(h)

            h = self.mid_res1(h, temb)
            h = self.mid_attn(h, encoder_hidden_states)
            h = self.mid_res2(h, temb)

            ri, ui = 0, 0
            for level in range(len(cfg.block_out_channels)):
                for _ in range(cfg.layers_per_block + 1):
                    h = torch.cat([h, skips.pop()], dim=cat_axis)
                    h = self.up_resnets[ri](h, temb)
                    attn = self.up_attns[ri]
                    if attn is not None:
                        h = attn(h, encoder_hidden_states)
                    ri += 1
                if level < len(cfg.block_out_channels) - 1:
                    h = self.upsamplers[ui](h)
                    ui += 1

            out = self.conv_out(self.conv_norm_out(h))
        return layout.nhwc_to_nchw(out) if cl else out
