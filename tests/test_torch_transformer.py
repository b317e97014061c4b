"""The port's ``nn.layer.transformer`` against the JAX package on the CPU,
weights carried across: ``MultiHeadAttention`` with an incremental
``cache`` and a ``static_cache`` from ``compute_kv`` (and a boolean mask),
the encoder and decoder layers post- and pre-LN (outputs and every
gradient), ``TransformerDecoder``'s per-layer caches, and the whole
``Transformer`` with ``generate_square_subsequent_mask``. Last, every new
entry point of this slice (the GPT, BERT, T5 and ERNIE-MoE models, the
MoE layers, the transformer layers) defaults to the card and raises
without one. Tolerances as ``tests/torch_parity.py`` states them."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from torch_parity import (carry, check_grads, close, jax_call,
                          jax_value_and_grads)

D, H, FF = 32, 4, 48


def _pair(name, *args, **kw):
    pt.seed(2)
    jlayer = getattr(jnn, name)(*args, **kw)
    return jlayer, carry(jlayer, getattr(tnn, name)(*args, device="cpu",
                                                    **kw))


def _x(seed, s, b=2, d=D):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_multi_head_attention_caches_match_jax():
    jmha, tmha = _pair("MultiHeadAttention", D, H)
    x, mem = _x(1, 5), _x(2, 9)
    mask = np.tril(np.ones((5, 9), bool))[None, None]
    close(tmha(torch.as_tensor(x), torch.as_tensor(mem),
               torch.as_tensor(mem), attn_mask=torch.as_tensor(mask)),
          jax_call(jmha, jnp.asarray(x), jnp.asarray(mem),
                   jnp.asarray(mem), attn_mask=jnp.asarray(mask)))
    # incremental self-attention: three steps of one token each
    jc = tc = None
    for t in range(3):
        step = _x(10 + t, 1)
        jprev = (jnp.zeros((2, 0, H, D // H)),) * 2 if jc is None else jc
        tprev = (torch.zeros((2, 0, H, D // H)),) * 2 if tc is None else tc
        want, jc = jmha(jnp.asarray(step), cache=jprev)
        got, tc = tmha(torch.as_tensor(step), cache=tprev)
        close(got, want)
    for g, w in zip(tc, jc):
        assert g.shape == (2, 3, H, D // H)
        close(g, w)
    # static cache: the memory projected once
    jsc = jmha.compute_kv(jnp.asarray(mem), jnp.asarray(mem))
    tsc = tmha.compute_kv(torch.as_tensor(mem), torch.as_tensor(mem))
    close(tmha(torch.as_tensor(x), static_cache=tsc),
          jmha(jnp.asarray(x), static_cache=jsc))


class _Loss(jnn.Layer):
    """A JAX layer's output reduced to a scalar, so its gradients are
    taken as the port's are."""

    def __init__(self, inner, fn):
        super().__init__()
        self.inner = inner
        self.fn = fn

    def forward(self, *args, **kw):
        return self.fn(self.inner(*args, **kw))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("kind", ["Encoder", "Decoder"])
def test_layers_and_every_gradient_match_jax(kind, pre):
    jlayer, tlayer = _pair(f"Transformer{kind}Layer", D, H, FF, dropout=0.0,
                           activation="gelu", normalize_before=pre)
    x, mem = _x(3, 6), _x(4, 7)
    mask = np.where(np.tril(np.ones((6, 6), bool)), 0.0,
                    -1e30).astype(np.float32)
    args = (x, mem) if kind == "Decoder" else (x,)
    key = "tgt_mask" if kind == "Decoder" else "src_mask"
    w = _x(5, 6)

    def loss_of(out):
        return (out * w).sum()

    want_loss, want = jax_value_and_grads(
        _Loss(jlayer, loss_of), *map(jnp.asarray, args),
        **{key: jnp.asarray(mask)})
    out = tlayer(*map(torch.as_tensor, args), **{key: torch.as_tensor(mask)})
    loss = (out * torch.as_tensor(w)).sum()
    loss.backward()
    close(loss, want_loss)
    check_grads(tlayer, {k.removeprefix("inner."): v
                         for k, v in want.items()})


def test_decoder_caches_and_transformer_match_jax():
    jt, tt = _pair("Transformer", D, H, 2, 2, FF, dropout=0.0)
    src, tgt = _x(6, 8), _x(7, 5)
    tmask = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    jmask = jnn.Transformer.generate_square_subsequent_mask(5)
    close(tmask, jmask)
    close(tt(torch.as_tensor(src), torch.as_tensor(tgt), tgt_mask=tmask),
          jax_call(jt, jnp.asarray(src), jnp.asarray(tgt), tgt_mask=jmask))
    # the decoder a token at a time over per-layer caches and the static
    # cross-attention K/V
    jmem = jt.encoder(jnp.asarray(src))
    tmem = tt.encoder(torch.as_tensor(src))
    close(tmem, jmem)
    jsc = jt.decoder.gen_static_cache(jmem)
    tsc = tt.decoder.gen_static_cache(tmem)
    jc = [(jnp.zeros((2, 0, H, D // H)),) * 2] * 2
    tc = [(torch.zeros((2, 0, H, D // H)),) * 2] * 2
    for t in range(3):
        step = tgt[:, t:t + 1]
        want, jc = jt.decoder(jnp.asarray(step), jmem, cache=jc,
                              static_cache=jsc)
        got, tc = tt.decoder(torch.as_tensor(step), tmem, cache=tc,
                             static_cache=tsc)
        close(got, want)


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from paddle_tpu_torch.distributed import DroplessMoELayer, MoELayer
    from paddle_tpu_torch.models import (
        BertConfig,
        BertForMaskedLM,
        BertForSequenceClassification,
        BertModel,
        ErnieMoEConfig,
        ErnieMoEForCausalLM,
        GPTConfig,
        GPTForCausalLM,
        T5Config,
        T5ForConditionalGeneration,
        T5Model,
    )

    makers = [
        lambda **kw: GPTForCausalLM(GPTConfig.tiny(), **kw),
        lambda **kw: BertModel(BertConfig.tiny(), **kw),
        lambda **kw: BertForSequenceClassification(BertConfig.tiny(), **kw),
        lambda **kw: BertForMaskedLM(BertConfig.tiny(), **kw),
        lambda **kw: T5Model(T5Config.tiny(), **kw),
        lambda **kw: T5ForConditionalGeneration(T5Config.tiny(), **kw),
        lambda **kw: ErnieMoEForCausalLM(ErnieMoEConfig.tiny(), **kw),
        lambda **kw: MoELayer(8, 2, **kw),
        lambda **kw: DroplessMoELayer(8, 2, **kw),
        lambda **kw: tnn.MultiHeadAttention(8, 2, **kw),
        lambda **kw: tnn.TransformerEncoderLayer(8, 2, 16, **kw),
        lambda **kw: tnn.TransformerDecoderLayer(8, 2, 16, **kw),
        lambda **kw: tnn.Transformer(8, 2, 1, 1, 16, **kw),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        layer = make(device="cpu")
        assert all(p.device.type == "cpu" and p.requires_grad
                   for p in layer.parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.Transformer.generate_square_subsequent_mask(4)
