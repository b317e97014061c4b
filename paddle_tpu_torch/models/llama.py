"""Llama-family causal LM (counterpart of ``paddle_tpu/models/llama.py``).

Parameter names and shapes match the JAX model one to one, with weights
in the JAX layout ``[in_features, out_features]``, so a JAX
``state_dict`` loads through ``convert.load_numpy_state_dict``.

Training: parameters are trainable and ``train()``/``eval()`` are the
caller's. The no-cache forward attends through
``kernels/flash_attention.py: flash_attention`` (causal) when
``use_flash_attention`` is on, the Hopper flash-attention kernels on the
card, and through plain SDPA when it is off; with ``labels`` it returns
the shifted next-token cross-entropy, through the chunked head + loss
when ``fused_head_loss_chunk`` is set. ``use_recompute`` recomputes each
decoder layer in the backward (``torch.utils.checkpoint``, non-reentrant)
while training, keeping the matmul outputs under the JAX policy
``"dots_with_no_batch_dims_saveable"``.

Serving: the cache branches the continuous batching engine drives run
under ``torch.no_grad()``, over contiguous per-slot caches or the paged
pool: chunked prefill (``s > 1``) and decode (``s == 1``, fused or
unfused). A scalar ``cache_index`` shared by every row (the Predictor,
the engine's legacy bucketed prefill) takes a float contiguous cache
through plain SDPA. Caches are float or int8: int8 contiguous caches are
``QuantizedKV`` pairs and int8 pools carry scale arrays; rows are
quantized on append and attention reads them dequantized. KV caches are
updated in place, where the JAX model returns new arrays that its engine
donates.

Sequence parallelism (``sequence_parallel = True``: ``TrainStep`` cuts
the batch's sequence over the mesh's sep axis): under a mesh whose sep
axis is above 1 (``sharding.current_mesh()``) each rank holds a chunk of
the sequence; its RoPE positions start at ``rank * s_local``, attention
is the ring (``config.sep_attention == "ring"``) or Ulysses, and the loss
takes ``shifted_labels``, the global labels shifted by one before the
cut (the last position -100), so a chunk's last token predicts the next
chunk's first. ``llama_pipeline_module`` builds the model as a
``distributed.pipeline.PipelineModule`` for ``PipelineTrainStep``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from ..core.device import current_device
from ..core.module import Layer
from ..core.random import make_generator
from ..distributed.parallel_layers.mp_layers import axis_group
from ..distributed.sharding import current_mesh
from ..distributed.parallel_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    copy_to_tp,
    gather_from_tp,
)
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..inference.paged import (
    PagedLayerCache,
    QuantizedKV,
    append_kv,
    append_kv_chunk,
    dequantize_kv,
    gather_kv,
    paged_attention,
    quantize_kv_rows,
)
from ..kernels import decode_attention as da
from ..kernels import flash_attention as fa
from ..kernels import paged_attention as pa
from ..kernels.ring_attention import ring_attention
from ..kernels.rope import apply_rope, rope_frequencies
from ..kernels.ulysses import ulysses_attention
from ..nn import functional as F
from ..nn.layer.common import LayerList
from ..nn.layer.norm import RMSNorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_TODO = "see ROADMAP.md Queue A"


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # the no-cache branch: flash attention (the Hopper kernels on the
    # card) or plain SDPA
    use_flash_attention: bool = True
    # the attention of a sequence cut over the mesh's sep axis: "ulysses"
    # (all-to-all over heads) or "ring" (the KV blocks round the ring)
    sep_attention: str = "ulysses"
    use_recompute: bool = False
    recompute_policy: str = "dots_with_no_batch_dims_saveable"
    # > 0: the train loss through the chunked head + cross-entropy with
    # this many positions a chunk (incubate fused_linear_cross_entropy)
    fused_head_loss_chunk: int = 0
    dtype: str = "float32"
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"LlamaConfig.dtype must be one of "
                             f"{sorted(_DTYPES)}; got {self.dtype!r}")
        return _DTYPES[self.dtype]

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Test config, as in the JAX package."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


def _chunk_history_mask(cache_index, s, ctx_len):
    """Chunked-prefill causal mask: slot b's chunk occupies rows
    ``cache_index[b] .. +s-1``, and query row r attends every cache row
    ``<= r``. Returns ``(rows [b, s], kv_mask [b, 1, s, ctx_len])``."""
    rows = cache_index[:, None] + torch.arange(
        s, dtype=cache_index.dtype, device=cache_index.device)[None, :]
    kv_idx = torch.arange(ctx_len, device=cache_index.device)
    kv_mask = kv_idx[None, None, None, :] <= rows[:, None, :, None]
    return rows, kv_mask


class LlamaAttention(Layer):
    # at tp > 1 (``sharding.place_params_on_mesh``) this rank's heads:
    # num_attention_heads // tp and num_key_value_heads // tp
    tensor_parallel = True
    tp = None

    def __init__(self, config: LlamaConfig, device, generator):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        kw = dict(std=config.initializer_range, has_bias=False,
                  dtype=config.torch_dtype, device=device,
                  generator=generator)
        self.q_proj = ColumnParallelLinear(
            h, config.num_attention_heads * d, **kw)
        self.k_proj = ColumnParallelLinear(
            h, config.num_key_value_heads * d, **kw)
        self.v_proj = ColumnParallelLinear(
            h, config.num_key_value_heads * d, **kw)
        self.o_proj = RowParallelLinear(
            config.num_attention_heads * d, h, **kw)

    def check_tensor_parallel(self, tp: int):
        cfg = self.config
        if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp:
            raise ValueError(
                f"tp = {tp} must divide num_attention_heads "
                f"({cfg.num_attention_heads}) and num_key_value_heads "
                f"({cfg.num_key_value_heads})")

    def forward(self, x, cos, sin, position_ids=None, kv_cache=None,
                cache_index=None):
        cfg = self.config
        b, s, _ = x.shape
        tp = self.tp.size if self.tp is not None else 1
        nh, kvh, hd = (cfg.num_attention_heads // tp,
                       cfg.num_key_value_heads // tp, cfg.head_dim)
        if kv_cache is not None and tp > 1:
            raise NotImplementedError(
                f"the cache branches run on one card, not at tp = {tp} "
                f"({_TODO}7)")
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, kvh, hd)
        v = self.v_proj(x).reshape(b, s, kvh, hd)
        if kv_cache is None:
            q, k = apply_rope(q, k, cos, sin, position_ids)
            mesh = current_mesh()
            if axis_group(mesh, "sep") is not None:
                out = self._sequence_parallel(q, k, v, mesh)
            elif cfg.use_flash_attention:
                out = fa.flash_attention(q, k, v, causal=True,
                                         training=self.training)
            else:
                out = F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True)
        else:
            out = self._cached(q, k, v, cos, sin, position_ids, kv_cache,
                               cache_index)
        out = self.o_proj(out.reshape(b, s, nh * hd))
        return (out, kv_cache) if kv_cache is not None else out

    def _sequence_parallel(self, q, k, v, mesh):
        """Attention over a sequence cut over sep: the ring (row 6 a KV
        block, rows 7-9 in the backward) or the Ulysses all-to-all."""
        if self.config.sep_attention == "ring":
            return ring_attention(q, k, v, mesh=mesh, causal=True)
        return ulysses_attention(q, k, v, causal=True,
                                 training=self.training,
                                 use_flash=self.config.use_flash_attention)

    def _cached(self, q, k, v, cos, sin, position_ids, kv_cache,
                cache_index):
        """The contiguous per-slot cache branches. ``kv_cache`` is a
        ``(ck, cv)`` pair of [slots, max_len, kv_heads, d] float tensors
        or of ``QuantizedKV`` (int8), written in place; ``cache_index`` is
        the [slots] vector of per-slot lengths (prefill: each slot's chunk
        start), or one index shared by every row (``_shared_index``)."""
        if not (isinstance(cache_index, torch.Tensor)
                and cache_index.dim() == 1):
            # before the fused-decode test: JAX never fuses a shared-index
            # decode
            return self._shared_index(q, k, v, cos, sin, position_ids,
                                      kv_cache, cache_index)
        if isinstance(kv_cache[0], PagedLayerCache):
            return self._paged(q, k, v, cos, sin, position_ids, kv_cache,
                               cache_index)
        cfg = self.config
        b, s = q.shape[:2]
        ck, cv = kv_cache
        quant = isinstance(ck, QuantizedKV)
        if s == 1 and da.fused_decode_active():
            pos = (position_ids[:, 0] if position_ids is not None
                   else cache_index).to(torch.int32).contiguous()
            qg = q[:, 0].reshape(b, cfg.num_key_value_heads,
                                 cfg.num_attention_heads
                                 // cfg.num_key_value_heads, cfg.head_dim)
            # int8: the kernel quantizes the appended row and writes its
            # scale beside it
            og = da.fused_contiguous_decode_attention(
                qg.contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous(), ck.q if quant else ck,
                cv.q if quant else cv,
                cache_index.to(torch.int32).contiguous(), pos,
                cos.float().contiguous(), sin.float().contiguous(),
                k_scale=ck.scale if quant else None,
                v_scale=cv.scale if quant else None)[0]
            return og.reshape(b, 1, cfg.num_attention_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin, position_ids)
        if quant:
            # quantize-on-append: payload and per-row scales land together
            (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            stores = ((ck.q, kq), (ck.scale, ks), (cv.q, vq), (cv.scale, vs))
        else:
            stores = ((ck, k.to(ck.dtype)), (cv, v.to(cv.dtype)))
        max_len = ck.shape[1]
        if s > 1:
            # chunked prefill: slot b's rows land at cache_index[b]..+s-1.
            # Rows at or past max_len (the engine's "not prefilling this
            # call" sentinel) are dropped, as JAX's mode="drop" drops
            # them; a clamp would overwrite the last row instead. Without
            # a host sync: each slot rewrites the in-range window of s
            # rows ending where its chunk would, and window rows before
            # its start keep their old values.
            if s > max_len:
                raise ValueError(f"chunk of {s} rows exceeds max_len "
                                 f"{max_len}")
            start = cache_index.long()
            _, kv_mask = _chunk_history_mask(start, s, max_len)
            ar = torch.arange(s, device=q.device)
            win = start.clamp(max=max_len - s)[:, None] + ar[None, :]
            src = win - start[:, None]  # chunk row per window row
            take = src >= 0
            bidx = torch.arange(b, device=q.device)[:, None]
            src = src.clamp(min=0)
            for dst, val in stores:
                keep = take.reshape(take.shape + (1,) * (dst.dim() - 2))
                dst[bidx, win] = torch.where(keep, val[bidx, src],
                                             dst[bidx, win])
        else:
            # unfused decode: each slot appends at its own length and
            # attends to its own history
            idx = cache_index.long()
            bi = torch.arange(b, device=q.device)
            for dst, val in stores:
                dst[bi, idx] = val[:, 0]
            kv_idx = torch.arange(max_len, device=q.device)
            kv_mask = (kv_idx[None, :] <= idx[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(
            q, dequantize_kv(ck), dequantize_kv(cv), attn_mask=kv_mask)
        # dequantized rows are float32; the output keeps the model's dtype,
        # as the fused kernels' and dense_paged_attention's do (the JAX
        # model promotes it here: ROADMAP.md Queue C)
        return out.to(q.dtype) if quant else out

    def _shared_index(self, q, k, v, cos, sin, position_ids, kv_cache,
                      cache_index):
        """The single shared index branch (the Predictor's prefill and
        decode, the engine's legacy bucketed prefill): ``cache_index`` is
        a Python int or a 0-dim tensor, and the block of ``s`` rows lands
        at rows ``cache_index..+s-1`` of every batch row of a float
        ``(ck, cv)`` cache. As ``lax.dynamic_update_slice_in_dim``, the
        start is clamped to ``[0, max_len - s]``, so a decode at or past
        ``max_len`` overwrites the last row; the causal mask is taken from
        the unclamped index (query ``i`` sees rows ``<= cache_index +
        i``). Attention is plain SDPA over all ``max_len`` rows, as in
        JAX, and launches no kernel."""
        ck, cv = kv_cache
        if isinstance(ck, (PagedLayerCache, QuantizedKV)):
            # the JAX model never takes these (its engine refuses int8
            # caches without chunked prefill; paged caches go per slot)
            raise NotImplementedError(
                "a shared scalar cache_index takes float contiguous caches "
                f"only; int8 and paged caches need a per-slot vector "
                f"({_TODO})")
        s, max_len = q.shape[1], ck.shape[1]
        if s > max_len:
            raise ValueError(f"a block of {s} rows exceeds max_len "
                             f"{max_len}")
        q, k = apply_rope(q, k, cos, sin, position_ids)
        # on the device without a host copy or sync: query i sits at
        # cache_index + i, and the write starts at the clamped index
        ar = torch.arange(s, device=q.device)
        q_pos = ar + cache_index
        rows = ar + q_pos[:1].clamp(0, max_len - s)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        kv_mask = torch.arange(max_len, device=q.device)[None, :] \
            <= q_pos[:, None]
        return F.scaled_dot_product_attention(q, ck, cv,
                                              attn_mask=kv_mask[None, None])

    def _paged(self, q, k, v, cos, sin, position_ids, kv_cache,
               cache_index):
        """The paged-pool branches. ``kv_cache`` is the layer's
        ``(PagedLayerCache, PagedState)`` pair; the pools (and an int8
        pool's scales) are written in place through
        ``PagedState.block_tables``."""
        cfg = self.config
        b, s = q.shape[:2]
        nh, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        cache, state = kv_cache
        if s == 1 and da.fused_decode_active():
            # fused decode: rope, append through the block table and
            # attention over rows 0..seq_lens[i] in one kernel
            lens = state.seq_lens
            pos = (position_ids[:, 0] if position_ids is not None
                   else lens).to(torch.int32).contiguous()
            og = pa.fused_paged_decode_attention(
                q[:, 0].reshape(b, kvh, nh // kvh, hd).contiguous(),
                k[:, 0].contiguous(), v[:, 0].contiguous(), cache.k_pages,
                cache.v_pages, state.block_tables, lens, pos,
                cos.float().contiguous(), sin.float().contiguous(),
                k_scale=cache.k_scale, v_scale=cache.v_scale)[0]
            return og.reshape(b, 1, nh, hd)
        q, k = apply_rope(q, k, cos, sin, position_ids)
        if s > 1:
            # chunked prefill: scatter the chunk's rows through the block
            # table at each slot's own offset (rows past the table's span,
            # the engine's max_len sentinel, go to the sink page), then
            # attend over the gathered page view with a per-row causal
            # history mask. The dense gather of the whole [slots, max_len]
            # view per layer per chunk is the JAX reference's KNOWN TRADE,
            # kept so the two sides match; a length-pruned paged prefill
            # is later work.
            append_kv_chunk(cache, state, k, v, cache_index)
            kg, vg = gather_kv(cache, state)
            _, kv_mask = _chunk_history_mask(cache_index, s, kg.shape[1])
            out = F.scaled_dot_product_attention(q, kg, vg,
                                                 attn_mask=kv_mask)
            # an int8 pool gathers float32 rows: keep the model's dtype,
            # as in the contiguous branch
            return out.to(q.dtype) if cache.k_scale is not None else out
        # unfused decode: append this token's row at each slot's length,
        # then block-table attention (the row-3 kernel on the card; an int8
        # pool takes the dense dequantizing path, as in the JAX package)
        append_kv(cache, state, k, v)
        return paged_attention(q, cache, state)


class LlamaMLP(Layer):
    tensor_parallel = True
    tp = None

    def __init__(self, config: LlamaConfig, device, generator):
        super().__init__()
        kw = dict(std=config.initializer_range, has_bias=False,
                  dtype=config.torch_dtype, device=device,
                  generator=generator)
        self.gate_proj = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size, **kw)
        self.up_proj = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size, **kw)
        self.down_proj = RowParallelLinear(
            config.intermediate_size, config.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device, generator):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, generator)
        self.mlp = LlamaMLP(config, device, generator)
        kw = dict(dtype=config.torch_dtype, device=device)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)

    def forward(self, x, cos, sin, position_ids=None, kv_cache=None,
                cache_index=None):
        h = self.input_layernorm(x)
        if kv_cache is not None:
            h, kv_cache = self.self_attn(h, cos, sin, position_ids,
                                         kv_cache, cache_index)
        else:
            h = self.self_attn(h, cos, sin, position_ids)
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, kv_cache) if kv_cache is not None else x


# matmul outputs a recomputed layer keeps, by JAX checkpoint policy name;
# any other name recomputes everything, as a policy JAX does not know
# (``getattr(jax.checkpoint_policies, name, None)``) does
_DOTS = ("mm", "addmm", "bmm")
_SAVED_OPS = {"dots_with_no_batch_dims_saveable": _DOTS,
              "dots_saveable": _DOTS, "checkpoint_dots": _DOTS}


def _recompute_context(policy_name: str):
    """The ``context_fn`` of a selective checkpoint that keeps the outputs
    of the policy's ops, or None for full recompute."""
    names = _SAVED_OPS.get(policy_name)
    if names is None:
        return None
    ops = {getattr(torch.ops.aten, n).default for n in names}

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


class LlamaModel(Layer):
    tensor_parallel = True
    tp = None

    def __init__(self, config: LlamaConfig, device, generator):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            std=config.initializer_range, dtype=config.torch_dtype,
            device=device, generator=generator)
        self.layers = LayerList(
            [LlamaDecoderLayer(config, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            dtype=config.torch_dtype, device=device)
        cos, sin = rope_frequencies(
            config.head_dim, config.max_position_embeddings,
            config.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, position_ids=None, kv_caches=None,
                cache_index=None):
        cfg = self.config
        h = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos, self.rope_sin
        sep = axis_group(current_mesh(), "sep") if kv_caches is None \
            else None
        if sep is not None and position_ids is None:
            # this rank's chunk of the sequence cut over sep
            s = input_ids.shape[1]
            position_ids = (torch.arange(s, device=input_ids.device)
                            + sep.rank * s)[None].expand(
                                input_ids.shape[0], s)
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                h, _ = layer(h, cos, sin, position_ids, kv_caches[i],
                             cache_index)
            elif cfg.use_recompute and self.training:
                ctx = _recompute_context(cfg.recompute_policy)
                kw = {} if ctx is None else {"context_fn": ctx}
                h = ckpt.checkpoint(layer, h, cos, sin, position_ids,
                                    use_reentrant=False, **kw)
            else:
                h = layer(h, cos, sin, position_ids)
        h = self.norm(h)
        return (h, kv_caches) if kv_caches is not None else h


class LlamaForCausalLM(Layer):
    """The Llama causal LM on ``device`` (default the current device: the
    card unless ``set_device("cpu")`` chose the host; without a card it
    raises).
    Weights are drawn from Normal(0, ``initializer_range``) with a
    ``torch.Generator`` seeded from ``seed`` on that device; parameters
    are trainable.

    At tp > 1 (``sharding.place_params_on_mesh``) the head's
    vocab-sharded logits are gathered over tp before the loss (the fused
    chunked loss gathers the head's weight instead), so the loss is JAX's
    cross-entropy over the full vocabulary."""

    tensor_parallel = True
    sequence_parallel = True
    tp = None

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = current_device(device)
        gen = make_generator(seed, dev)
        self.config = config
        self.model = LlamaModel(config, dev, gen)
        self.lm_head = None if config.tie_word_embeddings else \
            ColumnParallelLinear(
                config.hidden_size, config.vocab_size,
                std=config.initializer_range, has_bias=False,
                dtype=config.torch_dtype, device=dev, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def logits(self, hidden):
        """``[..., vocab]`` logits (gathered over tp at tp > 1)."""
        if self.lm_head is not None:
            out = self.lm_head(hidden)
        else:
            out = F.linear(copy_to_tp(hidden, self.tp),
                           self.model.embed_tokens.weight.T)
        return gather_from_tp(out, self.tp)

    def loss_count(self, input_ids=None, labels=None, shifted_labels=None,
                   **_):
        """The tokens the loss of ``forward(input_ids, labels)`` averages
        over (labels[:, 1:] not -100; with ``shifted_labels``, those not
        -100): ``TrainStep`` over a mesh weights each rank's mean by it,
        so the step's loss is the mean over the global batch."""
        if shifted_labels is not None:
            return (shifted_labels != -100).sum()
        return (labels[:, 1:] != -100).sum()

    def forward(self, input_ids, labels=None, position_ids=None,
                kv_caches=None, cache_index=None, shifted_labels=None):
        """Logits ``[b, s, vocab]``; with ``labels`` [b, s] the mean
        next-token cross-entropy of ``logits[:, :-1]`` against
        ``labels[:, 1:]`` (float32; ids of -100 are ignored). With
        ``kv_caches`` (a list of per-layer contiguous ``(ck, cv)`` pairs
        or paged ``(PagedLayerCache, PagedState)`` pairs, written in
        place, under ``torch.no_grad()``) returns ``(logits,
        kv_caches)``. With labels and ``fused_head_loss_chunk`` set, the
        same loss comes from ``incubate.nn.functional.
        fused_linear_cross_entropy`` a sequence chunk at a time, never
        holding the ``[b, s, vocab]`` logits. ``shifted_labels`` [b, s]
        (labels already shifted: position i predicts it) takes the loss
        over every position, as a chunk of a sequence cut over sep
        needs."""
        if kv_caches is not None:
            with torch.no_grad():
                hidden, kv_caches = self.model(input_ids, position_ids,
                                               kv_caches, cache_index)
                return self.logits(hidden), kv_caches
        hidden = self.model(input_ids, position_ids)
        if labels is None and shifted_labels is None:
            return self.logits(hidden)
        if shifted_labels is not None:
            shift_labels, shift_hidden = shifted_labels, hidden
        else:
            shift_labels, shift_hidden = labels[:, 1:], hidden[:, :-1, :]
        chunk = self.config.fused_head_loss_chunk
        if chunk:
            # the chunked head + cross-entropy: the same function as the
            # full-logits path (the softmax is row-wise), peak memory one
            # chunk's logits
            # (at tp > 1 on the head's weight gathered over tp)
            if self.lm_head is not None:
                return fused_linear_cross_entropy(
                    shift_hidden, gather_from_tp(self.lm_head.weight,
                                                 self.tp, 1),
                    shift_labels, ignore_index=-100, seq_chunk=chunk)
            return fused_linear_cross_entropy(
                shift_hidden, gather_from_tp(
                    self.model.embed_tokens.weight, self.tp, 0),
                shift_labels, transpose_weight=True, ignore_index=-100,
                seq_chunk=chunk)
        # next-token LM loss, float32 softmax over the vocabulary
        return F.cross_entropy(self.logits(shift_hidden), shift_labels,
                               ignore_index=-100)

    def init_kv_caches(self, batch_size: int, max_len: int,
                       dtype=torch.bfloat16) -> List[Tuple]:
        """Zeroed contiguous caches, one ``(ck, cv)`` pair per layer, each
        [batch, max_len, kv_heads, head_dim], on the model's device. An
        int8 ``dtype`` gives ``QuantizedKV`` pairs, each with a zeroed
        float32 scale array [batch, max_len, kv_heads]."""
        if dtype != torch.int8 and not dtype.is_floating_point:
            raise ValueError(f"cache dtype must be a float dtype or int8; "
                             f"got {dtype}")
        cfg = self.config
        shape = (batch_size, max_len, cfg.num_key_value_heads, cfg.head_dim)

        def side():
            q = torch.zeros(shape, dtype=dtype, device=self.device)
            if dtype != torch.int8:
                return q
            return QuantizedKV(q, torch.zeros(shape[:3], dtype=torch.float32,
                                              device=self.device))

        return [(side(), side()) for _ in range(cfg.num_hidden_layers)]


class LlamaPipeBlock(Layer):
    """One decoder layer with a single activation, for the pipeline's
    trunk: it builds the RoPE tables of its sequence itself, so only the
    hidden states cross the stages (parity: PaddleNLP's
    LlamaForCausalLMPipe blocks)."""

    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        dev = current_device(device)
        self.config = config
        self.block = LlamaDecoderLayer(
            config, dev, generator if generator is not None
            else make_generator(0, dev))

    def forward(self, x):
        cfg = self.config
        cos, sin = rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                                    device=x.device)
        return self.block(x, cos, sin)


def _tied_head(layer, x):
    """The tied LM head: ``x @ embedding.T``, gathered over tp."""
    return gather_from_tp(F.linear(copy_to_tp(x, layer.tp), layer.weight.T),
                          layer.tp)


def llama_pipeline_module(config: LlamaConfig, num_stages: int, device=None,
                          seed: int = 0):
    """The Llama as a ``distributed.pipeline.PipelineModule`` (parity:
    PaddleNLP LlamaForCausalLMPipe): the embedding (tied or not), the
    decoder layers (the trunk, ``LlamaPipeBlock``), the final norm and
    the head, whose logits are gathered over tp. Weights drawn on
    ``device`` with a generator seeded from ``seed``. Train it with
    ``distributed.PipelineTrainStep``; the loss runs on the last stage."""
    from ..distributed.pipeline import (
        LayerDesc,
        PipelineModule,
        SharedLayerDesc,
    )

    dev = current_device(device)
    kw = dict(std=config.initializer_range, dtype=config.torch_dtype,
              device=dev, generator=make_generator(seed, dev))
    h, vocab = config.hidden_size, config.vocab_size
    if config.tie_word_embeddings:
        embed = SharedLayerDesc("embed", VocabParallelEmbedding, vocab, h,
                                **kw)
        head = SharedLayerDesc("embed", VocabParallelEmbedding, vocab, h,
                               forward_func=_tied_head, **kw)
    else:
        embed = LayerDesc(VocabParallelEmbedding, vocab, h, **kw)
        head = LayerDesc(ColumnParallelLinear, h, vocab, has_bias=False,
                         gather_output=True, **kw)
    descs = ([embed]
             + [LayerDesc(LlamaPipeBlock, config, device=dev,
                          generator=kw["generator"])
                for _ in range(config.num_hidden_layers)]
             + [LayerDesc(RMSNorm, h, config.rms_norm_eps,
                          dtype=config.torch_dtype, device=dev), head])
    return PipelineModule(descs, num_stages=num_stages)
