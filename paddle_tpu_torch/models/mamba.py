"""Mamba selective state-space LM (counterpart of
``paddle_tpu/models/mamba.py``).

Parameter names and shapes match the JAX model one to one (linear
weights ``[in_features, out_features]``), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``. Parameters are trainable.

The scan: on the card every mixer runs ``kernels/selective_scan.py:
chunked_selective_scan`` (rows 10-11), whatever ``use_chunked_scan`` is
and whether or not ``scan_chunk`` divides the sequence: the kernels
mask a ragged last chunk, and ``scan_chunk`` only sets where states are
saved for the backward. The alternative on the card would be the
associative scan's ``[b, s, d, n]`` operands in plain torch. On the CPU
the port takes the JAX branch: the chunked scan's plain versions when
``use_chunked_scan and s % scan_chunk == 0``, else
``associative_selective_scan`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.parameter import Parameter
from ..core.random import make_generator
from ..distributed.parallel_layers import VocabParallelEmbedding
from ..kernels.selective_scan import (
    associative_selective_scan,
    chunked_selective_scan,
)
from ..nn import functional as F
from ..nn.layer.common import LayerList, Linear
from ..nn.layer.norm import RMSNorm


@dataclasses.dataclass
class MambaConfig:
    """The defaults are the published ``state-spaces/mamba-130m`` widths."""

    vocab_size: int = 50277
    hidden_size: int = 768
    state_size: int = 16
    num_hidden_layers: int = 24
    expand: int = 2
    dt_rank: int = 48  # ceil(hidden / 16)
    conv_kernel: int = 4
    rms_norm_eps: float = 1e-5
    # the chunked scan (rows 10-11); on the CPU it also needs the sequence
    # to be a multiple of scan_chunk, as in JAX
    use_chunked_scan: bool = False
    scan_chunk: int = 128

    @property
    def d_inner(self):
        return self.expand * self.hidden_size

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("state_size", 8)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("dt_rank", 4)
        return cls(**kw)


class MambaMixer(Layer):
    def __init__(self, config: MambaConfig, device, generator):
        super().__init__()
        cfg = config
        d_in = cfg.d_inner
        kw = dict(std=0.02, has_bias=False, device=device,
                  generator=generator)
        self.in_proj = Linear(cfg.hidden_size, 2 * d_in, **kw)
        # depthwise causal conv over the sequence
        self.conv_weight = self.create_parameter(
            (d_in, cfg.conv_kernel), torch.float32, I.Uniform(-0.5, 0.5),
            device=device, generator=generator)
        self.conv_bias = self.create_parameter(
            (d_in,), torch.float32, is_bias=True, device=device)
        self.x_proj = Linear(d_in, cfg.dt_rank + 2 * cfg.state_size, **kw)
        self.dt_proj = Linear(cfg.dt_rank, d_in, std=0.02, device=device,
                              generator=generator)
        self.A_log = Parameter(torch.log(
            torch.arange(1, cfg.state_size + 1, dtype=torch.float32,
                         device=device).expand(d_in, cfg.state_size)
            .contiguous()))
        self.D = Parameter(torch.ones((d_in,), device=device))
        self.out_proj = Linear(d_in, cfg.hidden_size, **kw)
        self.config = config

    def forward(self, x):
        cfg = self.config
        s = x.shape[1]
        xs, z = self.in_proj(x).chunk(2, dim=-1)  # [b, s, d_in] each
        # causal depthwise conv along the sequence, in JAX's order
        k = cfg.conv_kernel
        pad = torch.nn.functional.pad(xs, (0, 0, k - 1, 0))
        w = self.conv_weight  # [d_in, k]
        xs = sum(pad[:, i:i + s, :] * w[:, i] for i in range(k)) \
            + self.conv_bias
        xs = F.silu(xs)
        dt, B, C = torch.split(
            self.x_proj(xs), [cfg.dt_rank, cfg.state_size, cfg.state_size],
            dim=-1)
        delta = F.softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log.float())
        if x.device.type != "cpu" or (cfg.use_chunked_scan
                                      and s % cfg.scan_chunk == 0):
            y = chunked_selective_scan(xs, delta, A, B, C, self.D,
                                       chunk=cfg.scan_chunk).to(x.dtype)
        else:
            f32 = torch.float32
            y = associative_selective_scan(
                xs.to(f32), delta.to(f32), A, B.to(f32), C.to(f32),
                self.D.to(f32)).to(x.dtype)
        return self.out_proj(y * F.silu(z))


class MambaBlock(Layer):
    def __init__(self, config: MambaConfig, device, generator):
        super().__init__()
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device)
        self.mixer = MambaMixer(config, device, generator)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class MambaForCausalLM(Layer):
    """The Mamba LM on ``device`` (default the current device: the card
    unless ``set_device("cpu")`` chose the host; without a card it
    raises), float32 weights drawn with a ``torch.Generator`` seeded from
    ``seed`` on that device, as the JAX initializers draw them
    (projections Normal(0, 0.02), the conv weight Uniform(-0.5, 0.5),
    ``A_log = log(1..n)``, D ones). The head is tied to the embedding."""

    def __init__(self, config: MambaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device=dev,
            generator=gen)
        self.layers = LayerList(
            [MambaBlock(config, dev, gen)
             for _ in range(config.num_hidden_layers)])
        self.norm_f = RMSNorm(config.hidden_size, config.rms_norm_eps,
                              device=dev)

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]``; with ``labels`` the mean next-token
        cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``
        (float32). ``shard_activation`` of the JAX model is a no-op on one
        card."""
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x)
        x = self.norm_f(x)
        logits = x @ self.embeddings.weight.T  # tied
        if labels is None:
            return logits
        return F.cross_entropy(logits[:, :-1], labels[:, 1:])

