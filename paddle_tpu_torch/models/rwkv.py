"""RWKV (v4) language model (counterpart of ``paddle_tpu/models/rwkv.py``).

Parameter names and shapes match the JAX model one to one (linear
weights ``[in_features, out_features]``), so a JAX ``state_dict`` loads
through ``convert.load_numpy_state_dict``.

The WKV recurrence is associative once the carry holds the segment
length, as the JAX module sets out; its elements are (m, a, b, n): the
running max exponent, the sums ``a = sum e^(k_i - m) v_i`` and ``b = sum
e^(k_i - m)``, and the length, and two segments combine as

    M = max(m1 - w n2, m2)
    a = a1 e^(m1 - w n2 - M) + a2 e^(m2 - M),  b likewise,  n = n1 + n2.

torch has no ``associative_scan``, so ``wkv_associative`` carries out the
one JAX's ``jax.lax.associative_scan`` runs, the odd-even recursion (pairs
combined, the half-length scan, then the even positions), so that its
float32 roundings follow JAX's: log depth, no loop over the sequence. It
is plain torch on the card too (a hand-written WKV kernel is later work).
The bonus u of the current token is applied outside the scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import initializer as I
from ..core.device import current_device
from ..core.module import Layer
from ..core.random import make_generator
from ..nn import functional as F
from ..nn.layer.common import Embedding, LayerList, Linear
from ..nn.layer.norm import LayerNorm


@dataclasses.dataclass
class RWKVConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    intermediate_size: int = 0  # 0: 4 * hidden
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_hidden_layers", 2)
        return cls(**kw)

    @classmethod
    def rwkv4_169m(cls, **kw):
        """The published RWKV-4-Pile-169M widths (BlinkDL): 12 layers of
        768, FFN 3072, the GPT-NeoX vocabulary of 50277."""
        kw.setdefault("vocab_size", 50277)
        kw.setdefault("hidden_size", 768)
        kw.setdefault("num_hidden_layers", 12)
        kw.setdefault("intermediate_size", 3072)
        return cls(**kw)


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along dim 1; ``even`` has as many elements
    as ``odd`` or one more."""
    b, n_odd = odd.shape[0], odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).reshape(
        b, 2 * n_odd, *odd.shape[2:])
    if even.shape[1] > n_odd:
        pairs = torch.cat([pairs, even[:, n_odd:]], dim=1)
    return pairs


def associative_scan(combine, elems):
    """The inclusive scan of the tuple of tensors ``elems`` along dim 1
    under the associative ``combine(left, right)``, by the odd-even
    recursion of ``jax.lax.associative_scan``."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    # combine adjacent pairs, then scan the half-length sequence
    odd = associative_scan(combine, combine(
        [e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd],
                       [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    # the first element of the scan is the first element of elems
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def wkv_associative(k, v, w, u):
    """Stabilised WKV over ``[batch, seq, dim]``: ``k``, ``v`` ``[b, s,
    d]``, ``w`` ``[d]`` positive decay, ``u`` ``[d]`` current-token bonus.
    Returns ``[b, s, d]`` in ``v``'s dtype, for each t

        (sum_{i<t} e^(-(t-1-i) w + k_i) v_i + e^(u + k_t) v_t) /
        (sum_{i<t} e^(-(t-1-i) w + k_i)     + e^(u + k_t)),

    computed in float32, the denominator clamped at 1e-30."""
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    wf = w.to(f32)[None, None]
    uf = u.to(f32)[None, None]
    ones = torch.ones_like(kf)

    def combine(left, right):
        m1, a1, b1, n1 = left
        m2, a2, b2, n2 = right
        m1d = m1 - wf * n2
        M = torch.maximum(m1d, m2)
        e1 = torch.exp(m1d - M)
        e2 = torch.exp(m2 - M)
        return M, a1 * e1 + a2 * e2, b1 * e1 + b2 * e2, n1 + n2

    m, a, b, _ = associative_scan(combine, (kf, vf, ones, ones))
    # the inclusive scan at t - 1 is the past of token t (its last token
    # one decay step old): shift it by one, -1e30 / 0 before the first
    m_prev = torch.cat([torch.full_like(m[:, :1], -1e30), m[:, :-1]], dim=1)
    a_prev = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)
    b_prev = torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)

    cur = uf + kf
    M = torch.maximum(m_prev, cur)
    e_prev = torch.exp(m_prev - M)
    e_cur = torch.exp(cur - M)
    num = a_prev * e_prev + vf * e_cur
    den = b_prev * e_prev + e_cur
    return (num / torch.clamp(den, min=1e-30)).to(v.dtype)


def wkv_reference(k, v, w, u):
    """The per-step recurrence (the reference CUDA kernel's math) in numpy
    float64: the oracle of ``wkv_associative``."""
    k, v, w, u = (np.asarray(x, np.float64) for x in (k, v, w, u))
    bsz, s, d = k.shape
    out = np.zeros_like(v)
    decay = np.exp(-w)
    for bi in range(bsz):
        num = np.zeros(d)
        den = np.zeros(d)
        for t in range(s):
            cur = np.exp(u + k[bi, t])
            out[bi, t] = (num + cur * v[bi, t]) / (den + cur + 1e-30)
            # a_t = e^-w a_{t-1} + e^k_t v_t: the new token enters
            # undecayed, the decay applies from the next step
            num = decay * num + np.exp(k[bi, t]) * v[bi, t]
            den = decay * den + np.exp(k[bi, t])
    return out


def _shifted(x):
    """The token shift: x one step later along the sequence, a zero
    first row."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


class RWKVTimeMix(Layer):
    """Time mixing (the attention analog): token-shift interpolation and
    the WKV recurrence (RWKV v4 TimeMix)."""

    def __init__(self, config: RWKVConfig, layer_id: int, device=None,
                 generator=None):
        super().__init__()
        device = current_device(device)
        h = config.hidden_size
        kw = dict(device=device, generator=generator)
        init = I.Normal(0.0, config.initializer_range)
        ratio = layer_id / max(config.num_hidden_layers - 1, 1)
        self.time_decay = self.create_parameter(
            (h,), default_initializer=I.Constant(-1.0 - ratio), **kw)
        self.time_first = self.create_parameter(
            (h,), default_initializer=I.Constant(0.3), **kw)
        for name in ("time_mix_k", "time_mix_v", "time_mix_r"):
            setattr(self, name, self.create_parameter(
                (h,), default_initializer=I.Constant(0.5), **kw))
        self.key = self.create_parameter((h, h), default_initializer=init,
                                         **kw)
        self.value = self.create_parameter((h, h), default_initializer=init,
                                           **kw)
        self.receptance = self.create_parameter(
            (h, h), default_initializer=init, **kw)
        self.output = self.create_parameter((h, h), default_initializer=init,
                                            **kw)

    def forward(self, x):
        prev = _shifted(x)

        def mix(p):
            return x * p + prev * (1 - p)

        k = mix(self.time_mix_k) @ self.key
        v = mix(self.time_mix_v) @ self.value
        r = torch.sigmoid(mix(self.time_mix_r) @ self.receptance)
        # softplus keeps the decay positive (JAX's logaddexp form)
        w = F.softplus(self.time_decay)
        wkv = wkv_associative(k, v, w, self.time_first)
        return (r * wkv) @ self.output


class RWKVChannelMix(Layer):
    """Channel mixing (the FFN analog): squared ReLU (RWKV v4
    ChannelMix)."""

    def __init__(self, config: RWKVConfig, device=None, generator=None):
        super().__init__()
        device = current_device(device)
        h, inter = config.hidden_size, config.intermediate_size
        kw = dict(device=device, generator=generator)
        init = I.Normal(0.0, config.initializer_range)
        self.time_mix_k = self.create_parameter(
            (h,), default_initializer=I.Constant(0.5), **kw)
        self.time_mix_r = self.create_parameter(
            (h,), default_initializer=I.Constant(0.5), **kw)
        self.key = self.create_parameter((h, inter), default_initializer=init,
                                         **kw)
        self.value = self.create_parameter((inter, h),
                                           default_initializer=init, **kw)
        self.receptance = self.create_parameter(
            (h, h), default_initializer=init, **kw)

    def forward(self, x):
        prev = _shifted(x)
        xk = x * self.time_mix_k + prev * (1 - self.time_mix_k)
        xr = x * self.time_mix_r + prev * (1 - self.time_mix_r)
        k = torch.square(torch.relu(xk @ self.key))
        r = torch.sigmoid(xr @ self.receptance)
        return r * (k @ self.value)


class RWKVBlock(Layer):
    def __init__(self, config: RWKVConfig, layer_id: int, device=None,
                 generator=None):
        super().__init__()
        device = current_device(device)
        self.ln1 = LayerNorm(config.hidden_size, config.layer_norm_eps,
                             device=device)
        self.ln2 = LayerNorm(config.hidden_size, config.layer_norm_eps,
                             device=device)
        self.att = RWKVTimeMix(config, layer_id, device, generator)
        self.ffn = RWKVChannelMix(config, device, generator)

    def forward(self, x):
        x = x + self.att(self.ln1(x))
        x = x + self.ffn(self.ln2(x))
        return x


class RWKVForCausalLM(Layer):
    """The RWKV LM on ``device`` (default the current device: the card
    unless ``set_device("cpu")`` chose the host; without a card it
    raises), float32 weights drawn with a ``torch.Generator`` seeded from
    ``seed`` on that device, as the JAX initializers draw them (matrices
    Normal(0, ``initializer_range``), ``time_decay`` ``-1 - layer /
    (layers - 1)``, ``time_first`` 0.3, the mixes 0.5). ``ln_pre``
    normalises the embeddings; the head is untied."""

    def __init__(self, config: RWKVConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        kw = dict(device=dev, generator=gen)
        self.config = config
        init = I.Normal(0.0, config.initializer_range)
        self.embeddings = Embedding(config.vocab_size, config.hidden_size,
                                    weight_attr=init, **kw)
        self.ln_pre = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                device=dev)
        self.blocks = LayerList([
            RWKVBlock(config, i, dev, gen)
            for i in range(config.num_hidden_layers)])
        self.ln_out = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                device=dev)
        self.head = Linear(config.hidden_size, config.vocab_size,
                           weight_attr=init, bias_attr=False, **kw)

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]``; with ``labels`` the mean next-token
        cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``
        (float32)."""
        h = self.ln_pre(self.embeddings(input_ids))
        for blk in self.blocks:
            h = blk(h)
        logits = self.head(self.ln_out(h))
        if labels is None:
            return logits
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, self.config.vocab_size),
            labels[:, 1:].reshape(-1))
