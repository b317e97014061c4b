"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: prints the card's name and power limit (``nvidia-smi``) and
   requires compute capability 9.0;
2. build: compiles the port's CUDA kernels with ``nvcc`` for ``sm_90a``
   and prints the build time and the compiler's register/spill summary,
   then the registers, spills and shared memory of each of the 352
   instantiations of rows 1-3's split kernel (256 fused, 96 block-table)
   and of each redesigned flash
   instantiation and each body of row 4, how many clusters of row 4's
   decode body the card holds at once, and the registers and spills of the
   GroupNorm kernels (rows 12-13); the card's launch plan of rows 1-3
   (ranks a stream, CTAs, clusters held at once) at every timed shape;
3. kernel vs plain version: the fused decode-attention kernel (row 1)
   against its plain PyTorch version on the card, at the Llama-2-7B decode
   shape, a GQA shape (kvh 8, group 8) and with a float32 cache, with
   ragged lengths, then where the plan splits streams over cluster ranks:
   one slot at 4095 rows, 8 slots at 3968-4095 rows of 4096, GQA at those
   lengths, an empty slot beside a full one; each run twice identically.
   Timed at the serving run's shape (plain version too) and at the long
   points, beside the bandwidth bound and one
   ``scaled_dot_product_attention`` call over the cache cut to
   max(seq_lens) + 1 rows and over the whole cache (yardsticks the port
   never calls);
4. paged kernels vs plain versions: the fused paged decode kernel (row 2)
   and the block-table decode kernel (row 3), each against its plain
   PyTorch version on the card at the same shapes over a pool of 64-row
   pages with a permuted block table, each run twice identically, at the
   serving shape, a GQA shape, a float32 pool and where the plan splits
   streams over cluster ranks (the long points, an empty slot beside a
   full one); timed the same way at the paged serving run's shape and at
   the long points, with SDPA over a pre-gathered dense view (cut and
   whole) as the yardstick of the attention part;
5. reference: a tiny float32 Llama served through the engine and the
   kernel on the card; every served token must be the greedy choice of
   a no-cache forward over the same sequence;
6. paged reference: the same through the paged engine, with an
   oversubscribed pool so that admission waits on pages;
7. weight-only matmul vs plain version: the row-4 kernel against its
   plain PyTorch version on the card, int8 and int4 weights with bf16 and
   float32 activations at the four Llama-2-7B linear shapes, at decode
   (m = 8) and prefill (m = 2048), one ragged shape (m = 3, one
   whole-column group) and the edges of the tensor-core tilings (m no
   multiple of the tile, g of 32, 64 and 96, uneven k splits at m 1 and
   16, bf16 and fp16) and the verify pass's m = 40 (8 slots x 5 rows) at
   the 7B q/k/v/o shape, int8 and int4 (timed too), each run twice
   identically; times every 7B shape at decode and prefill beside the byte or operation bound (and one 7B
   forward's 225 calls from them), and one decode and one prefill shape
   beside the plain version and one ``torch.matmul`` over the
   pre-dequantized bf16 weight (a yardstick);
8. int8 decode kernels vs plain versions: the int8 branches of the fused
   contiguous and fused paged kernels on int8 caches and pools (payloads
   equal or at most 1 apart, scales within rtol 1e-5, outputs at bf16
   tolerance) at the 7B decode shape, a GQA shape and one slot at 4095
   rows, each run twice identically; timed at the 7B decode shape and the
   long points;
9. quantized reference: a tiny float32 Llama with int8 weights and an int8
   KV cache served on the card (kernels) and on the CPU (plain versions),
   contiguous and paged: the greedy tokens are identical;
10. engine: Llama-2-7B width (random bf16 weights from a seed), 8 requests
   of 120 tokens, 32 new tokens each, through
   ``ContinuousBatchingEngine.run``; requires one kernel launch per layer
   per decode forward, then serves the same prompts with
   ``PT_FLAGS_fused_decode=off`` and requires the same first tokens;
11. paged engine: the same model and prompts through
   ``EngineConfig(paged=True, page_size=64)`` with a bf16 pool; requires
   one fused paged launch per layer per decode forward, and with
   ``PT_FLAGS_fused_decode=off`` as many block-table launches, and the
   same first tokens both ways;
12. quantized engines, the same model and prompts: int8 weights over the
   paged bf16 pool (``bench_serve7b``'s configuration), int4 weights over
   it, int8 weights over an int8 paged pool, and an int8 contiguous cache
   with bf16 weights,
   each with fused decode on and off. Requires 7 x 32 + 1 = 225 row-4
   launches per forward (prefill chunks and decode forwards), the fused
   kernel of the cache once per layer per decode forward and no other
   decode kernel (no block-table launch for an int8 pool), every page
   back (free, or held by the prefix store alone and none shared: the
   prefix cache is on, as by default, in every engine phase), and the
   same first tokens both ways; reports the first index where the tokens
   leave the bf16 engine's (measured, not asserted);
13. prefix cache and speculative decoding, the same model: contiguous and
   paged, the prefix cache on and off, one request publishes a seeded
   512-token prompt and 8 requests of it plus 64 tokens of their own
   take 32 new tokens (TTFT p50, ``prefix_snapshot()``, 8 hits of 512
   tokens with the cache on, the first tokens equal both ways, the pool
   identity); then 8 prompts of a seeded 16-token pattern repeated to
   128 tokens take 64 new tokens, contiguous, with
   ``PT_FLAGS_spec_decode=ngram`` and ``off`` (``spec_snapshot()``, decode
   tok/s, verify passes taken, the first tokens equal). Each run must
   launch the cache's decode kernel (row 1 or 2) once per layer per
   decode forward and nothing else;
14. predictor, the same model: ``create_predictor(model, Config())`` with
   the defaults (2048 bf16 cache rows, buckets 128..2048), greedy over the
   8 prompts with 32 new tokens (TTFT, decode tok/s, the first tokens
   beside the contiguous engine's: reported, not asserted), sampling
   twice from one seed (the same tokens), beam search 2 x 4 beams;
   ``generate`` (the shared-index cache branch, plain SDPA) must launch
   no kernel, and ``run`` on one prompt the flash forward (row 5) once per
   layer and nothing else;
15. legacy engines, the same model and prompts with
   ``PT_FLAGS_prefill_chunk=0`` (each request prefilled alone as a [1,
   128] bucket): contiguous (row 1), paged (row 2) and paged with fused
   decode off (row 3), each launching its row once per layer per decode
   forward and nothing else, 8 bucketed prefills, every page back; TTFT
   p50, decode tok/s, the first tokens beside the chunked engines';
16. legacy reference: a tiny float32 Llama on the card and the CPU from
   the same weights: the Predictor's greedy and beam tokens identical
   (beam scores within 1e-4); on the card the legacy engines' greedy
   tokens equal the chunked engines', contiguous and paged;
17. profiles: device time by operation (``torch.profiler``) of the
   prefill wave, and of the wave with 8 decode forwards, for the bf16
   and the quantized engines, with the decode kernels' device time by
   row (and for the paged bf16 engine with fused decode off, row 3's time
   per decode forward); each engine's JSON line carries a digest of its
   greedy tokens;
18. flash attention vs plain versions (rows 5-9, after phase 8): the
   forward without and with LSE, the dq, dk/dv and fused backward
   kernels against their plain PyTorch versions at the Llama-2-7B train
   shape (b 4, s 2048, 32 heads, d 128, causal, bf16), a GQA shape (32
   query heads over 8 kv heads), d 64 and 96, a sliding window of 512,
   packed segments as one array and as a pair, non-causal and float32,
   each backward with a nonzero LSE cotangent; the fused and the
   two-pass backward must agree. Timed at the train shape beside the
   bounds, the plain versions and ``scaled_dot_product_attention``
   forward and backward (a yardstick the port never calls); the dq and
   dk/dv passes also at b 1, s 8192, where the default k block takes the
   two-pass backward, beside SDPA's backward;
19. train reference (after phase 9): a tiny float32 Llama trains 5 steps
   on the card (kernels) and on the CPU (plain versions) from the same
   weights, with the same losses; ``use_recompute`` leaves the card's
   gradients unchanged; ``gradient_merge_k_steps=2`` equals one step
   over the whole batch;
20. train at 7B width (last): Llama-2-7B width cut to 4 layers, bf16,
   ``TrainStep`` with AdamW, float32 masters, global-norm clipping and
   ``master_residency="master_only"`` on batch 4 x 2048: 2 warm-up and 5
   timed steps (step ms, tokens/s, MFU, peak memory; the loss falls)
   with exactly 4 launches of the forward with LSE and of the fused
   backward per step; one step with ``use_recompute`` (8 forward
   launches); one from the same weights with
   ``flash_attention_block_k=256`` (the dq and dk/dv kernels, 4 each,
   and the same loss and grad norm), then that two-pass step timed (2
   warm-ups, the median of 3) beside the fused one; one ``no_grad`` eval
   forward (4 launches of the forward without LSE); a profile of one step;
21. selective scan vs plain versions (after phase 18): row 10 without and
   with states and row 11 against their plain PyTorch versions, row by row
   within 1e-5 (float32), at the Mamba-130m train shape (b 4, s 1024, d
   1536, n 16, chunk 128), a ragged s of 1000, d 200 and n 8; timed at the
   train shape beside the bounds and the plain versions (no PyTorch call
   computes the scan: no library time);
22. GroupNorm vs plain versions: rows 12 and 13 against their plain
   versions at every distinct GroupNorm site of the SD UNet at
   sample_size 32, batch 4, one shape over the JAX kernel's VMEM budget
   (the re-read path), a ragged hw of 1000 split across a cluster, one
   pixel (a cluster of one CTA; with two channels a group dx is held
   against float64, as it is the cancellation of much larger terms),
   slabs of more groups than a CTA has threads, and inputs whose storage
   offset breaks 16-byte alignment, bf16 and float32, with and without
   the SiLU, each backward run twice identically; prints each kernel's
   launch plan at the largest site; timed at the largest site beside the
   bounds, the plain versions and ``torch.nn.functional.group_norm`` +
   ``silu`` forward and backward (a yardstick the port never calls), and
   summed over one UNet step's 56 calls (their shapes, SiLU or not,
   bf16) beside the summed yardsticks and bounds;
23. Mamba reference (after phase 19): a tiny float32 Mamba trains 5 steps
   on the card (rows 10-11) and on the CPU (plain versions) from the same
   weights, with the same losses;
24. UNet reference: the same for a tiny float32 UNet, channels-last on
   both sides (rows 12-13; cuDNN convolutions without TF32);
25. Mamba-130m train (after phase 20): ``bench_mamba``'s step at the
   published widths, float32, batch 4 x 1024, ``TrainStep`` with
   ``AdamW(1e-4, multi_precision=True)``: 2 warm-up and 5 timed steps
   (step ms, tokens/s, peak memory; the loss falls) with exactly 24
   launches of row 10 with states and of row 11 per step, a ``no_grad``
   eval forward (24 of row 10 without states), a profile of one step;
26. SD-UNet train (last): ``bench_unet``'s step, ``UNetConfig(
   sample_size=32)``, bf16 weights with float32 masters, batch 4, the
   denoising MSE: 2 warm-up and 5 timed steps (step ms, samples/s, peak
   memory; the loss falls) with exactly 56 launches of row 12 and of row
   13 per step, a profile of one step;
27. train 7b fused head loss (after phase 20): phase 20's configuration,
   seed-0 weights, AdamW and batch with ``fused_head_loss_chunk=256``: 2
   warm-up and 5 timed steps (step ms, tokens/s, peak memory beside the
   unfused step's, which must be higher), the first loss within 1e-2
   relative of the unfused step's, the losses finite and falling, exactly
   4 launches of rows 6 and 8 per step;
28. train 7b lamb: the same model and batch, 3 steps of ``Lamb`` (decay
   off for the norms): step ms; the losses finite and falling; rows 6
   and 8 per step as above;
29. optimizers reference: a tiny float32 Llama (seq 128) trained 5
   ``TrainStep`` steps on the card and on the CPU from the same weights
   by each of the 12 optimizers beside Adam/AdamW, each with one of the
   17 schedulers in turn (every other run with
   ``fused_head_loss_chunk=32``), losses within 1e-4 relative and
   falling; ``LBFGS`` with and without the strong-Wolfe line search, and
   ``LookAhead(AdamW)``, ``ModelAverage`` and ``EMA`` over 6 updates, card
   against CPU;
30. dropout and nan checks: ``flash_attention(dropout_p=0.1)`` on bf16
   tensors on the card takes the plain SDPA (no flash launch) and equals
   it from the same generator state; ``PT_FLAGS_benchmark`` prints its
   step line;
   a step with an inf planted in a weight raises ``FloatingPointError``
   under ``PT_FLAGS_check_nan_inf`` (the phase fails unless it does);
31. weight-only matmul at the Mamba shapes (after phase 7): row 4 with
   float32 x and int4 weights at m 4096 and the (k, n) of the
   QAT-converted Mamba-130m's four linears ((768, 3072), (1536, 80), (48,
   1536) in one group of 48, (1536, 768)), each against its plain version
   (rel 1e-5) and run twice identically, timed beside its bound (float32
   operations at 67 TFLOP/s against its bytes), its plain version and one
   ``torch.matmul`` over the dequantized float32 weight (TF32 off);
32. QAT reference (after phase 23): a tiny float32 Mamba made QAT by
   ``QAT(QuantConfig()).quantize`` trains 5 AdamW steps on the card (rows
   10-11 under ``FakeQuant``) and on the CPU from the same weights: the
   same losses and ``amax`` buffers (rel 1e-4); ``QAT.convert`` int4 of
   the card's trained state on both sides: the eval logits through rows 4
   and 10 against the plain versions (rtol and atol 1e-5); PTQ with
   ``AbsmaxObserver``, 2 calibration batches, int8: the same
   ``act_scale`` on both sides (rel 1e-5);
33. QAT Mamba-130m (after phase 25): phase 25's configuration made QAT (96
   ``QuantedLinear``, 192 ``FakeQuant``): 2 warm-up and 5 timed steps
   with exactly 24 launches of rows 10 (with states) and 11 a step, the
   losses finite and falling (step ms, tokens/s and peak memory beside
   phase 25's median step), a profile of one step with a range around
   each quanter (FakeQuant's device time), every ``amax``
   finite and moved from 1.0 in ``eval()``; ``QAT.convert`` int4 and a
   ``no_grad`` forward of the same batch with exactly 96 launches of row 4
   and 24 of row 10 without states, finite logits, and the share of
   next-token argmaxes equal to the fake-quant forward's (reported, not
   asserted); PTQ of a fresh model over 2 calibration batches, int8 per
   channel (a plain product: no row-4 launch), finite logits;
34. slo reference (after phase 16): a tiny float32 Llama on the card (rows
   1-2) and on the CPU (plain versions) from the same weights, contiguous
   and paged, under ``SLOFairScheduler`` (3 batch requests, then 2
   interactive ones that preempt them, and one ``preempt`` forced
   mid-decode), driven by ``step_adaptive``: identical tokens, finish
   reasons, admission order and preemption counts;
35. front door 7b: ``start_api_server`` on 127.0.0.1 over the 32-layer
   paged engine, FIFO and then ``SLOFairScheduler(tenants={"bulk":
   TenantQuota(max_slots=4), "acme": TenantQuota(weight=2.0)})``: 16
   ``batch`` streams from ``bulk``, then 8 ``interactive`` ones from
   ``acme`` (one with ``deadline_ms`` 20), over SSE from client threads.
   Every stream ends with ``[DONE]``, its first chunk before its finish;
   each first token equals a FIFO library run's; slo_fair preempts; the
   deadline request times out; every page comes back; row 2 launches.
   Prints interactive TTFT p50 (client clock) under both and the goodput;
36. bench_infer shape (after the serving profiles): ``bench_infer``'s
   Llama (hidden 1024, 16 layers, bf16), 8 slots, ``max_len`` 512, 24
   prompts of 120 tokens with 64 new tokens arriving every 300, 150 and
   75 ms, chunked, blocking (``_admit``) and adaptive
   (``step_adaptive(8, probe_chunk=2)``): TTFT p50/p99, served tok/s, the
   chunk lengths taken, row 1 once per layer per decode forward;
37. train mamba 130m tf32 (after phase 25): phase 25's step, 2 warm-up
   and 5 timed, under ``default_matmul_precision=tensorfloat32``
   (``flags.apply_matmul_precision``), beside the exact float32 median;
   exact float32 is restored after.

Each phase prints its wall time. Every kernel's launch count is set to 0
just before the run that reports it and read just after.

The last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result, when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20   # larger than the 50 MB L2
HOLD_CYCLES = 5_000_000      # about 2.5 ms at the H100's 1.98 GHz boost


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters=100, warmup=10, hold=HOLD_CYCLES) -> float:
    """Median device time of ``fn`` over ``iters`` launches, from CUDA
    events around each, after an L2 flush (the serving path meets a cold
    cache: a layer's KV was last touched a whole step earlier).

    A spin kernel holds the stream busy while the host enqueues the flush,
    the events and ``fn``, so that the events bracket the device's work
    and not the host's launch overhead; raises when the spin ended before
    the host had finished enqueueing in a quarter of the launches. With
    ``hold=0`` there is no spin, and the events bracket the host's
    enqueueing too: for a call of thousands of small launches, more than
    the card's launch queue holds behind a spin."""
    for _ in range(warmup):
        fn()
    times = []
    late = 0
    for _ in range(iters):
        if hold:
            torch.cuda._sleep(hold)
        held = torch.cuda.Event()
        held.record()
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        late += bool(hold) and held.query()
        b.synchronize()
        times.append(a.elapsed_time(b))
    if late > iters // 4:
        raise RuntimeError(f"the host outran the spin in {late} of {iters} "
                           "launches: the times would include host overhead")
    return float(np.median(times))


def decode_inputs(slots, kvh, group, d, max_len, lens, act_dtype,
                  cache_dtype, seed):
    from paddle_tpu_torch.kernels.rope import rope_frequencies

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    cos, sin = rope_frequencies(d, max(2048, max_len), device="cuda")
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return dict(q=randn(slots, kvh, group, d, dtype=act_dtype),
                k_new=randn(slots, kvh, d, dtype=act_dtype),
                v_new=randn(slots, kvh, d, dtype=act_dtype),
                ck=randn(slots, max_len, kvh, d, dtype=cache_dtype),
                cv=randn(slots, max_len, kvh, d, dtype=cache_dtype),
                seq_lens=lens_t, positions=lens_t.clone(), cos=cos,
                sin=sin)


def row_bytes(inp, payload, d):
    """Bytes of one cached row of one kv head: d payload elements, plus a
    float32 scale for an int8 cache."""
    extra = 4 if inp.get("k_scale") is not None else 0
    return d * inp[payload].element_size() + extra


def bound(inp):
    """Least time for the fused decode call at these inputs: the bytes it
    must move (cache rows 0..len-1 read, the appended row written, q,
    k_new, v_new, cos/sin rows read, out written; an int8 row with its
    scale) over the HBM rate, and its float32 operations over the float32
    rate; the larger of the two."""
    slots, kvh, group, d = inp["q"].shape
    lens = inp["seq_lens"].cpu().numpy().astype(np.int64)
    rb = row_bytes(inp, "ck", d)
    ae = inp["q"].element_size()
    nbytes = (int(lens.sum()) * kvh * 2 * rb          # cache rows read
              + slots * kvh * 2 * rb                  # appended rows
              + 2 * slots * kvh * group * d * ae      # q in, out
              + 2 * slots * kvh * d * ae              # k_new, v_new
              + 2 * slots * (d // 2) * 4)             # cos/sin rows
    flops = int((lens + 1).sum()) * kvh * group * (4 * d + 5)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_call(inp, cut=False):
    """One ``scaled_dot_product_attention`` over the masked cache: the
    attention part of the fused function (no RoPE, no append). ``cut``:
    over the cache cut to max(seq_lens) + 1 rows, the mask kept, so that
    it reads no more rows than the longest slot attends."""
    q, ck, cv = inp["q"], inp["ck"], inp["cv"]
    slots, kvh, group, d = q.shape
    rows = int(inp["seq_lens"].max()) + 1 if cut else ck.shape[1]
    qh = q.reshape(slots, kvh * group, 1, d).to(ck.dtype)
    kh = ck[:, :rows].permute(0, 2, 1, 3)
    vh = cv[:, :rows].permute(0, 2, 1, 3)
    mask = (torch.arange(rows, device="cuda")[None, :]
            <= inp["seq_lens"][:, None].long())[:, None, None, :]
    kw = {"enable_gqa": True} if group > 1 else {}
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, **kw)


def check_case(name, slots, kvh, group, d, max_len, lens, act_dtype,
               cache_dtype, tol, seed):
    """Kernel vs plain version on one input set: outputs within ``tol``,
    appended rows within one bf16 ulp, every other row bit-identical, and
    a second run on the same inputs ``torch.equal`` to the first."""
    from paddle_tpu_torch.kernels import decode_attention as da

    inp = decode_inputs(slots, kvh, group, d, max_len, lens, act_dtype,
                        cache_dtype, seed)
    ref_inp = {k: v.clone() for k, v in inp.items()}
    again = {k: v.clone() for k, v in inp.items()}
    out, ck, cv = da.fused_contiguous_decode_attention(**inp)
    ref, ckr, cvr = da.fused_contiguous_decode_plain(**ref_inp)
    second = da.fused_contiguous_decode_attention(**again)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, ck, cv), second)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    del again, second
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel output differs from the "
                             f"plain version, max abs err {err}")
    rows = torch.arange(slots, device="cuda")
    lens_l = inp["seq_lens"].long()
    for a, b, which in ((ck, ckr, "K"), (cv, cvr, "V")):
        new_a, new_b = a[rows, lens_l].float(), b[rows, lens_l].float()
        if not torch.allclose(new_a, new_b, rtol=2.0 ** -7, atol=1e-6):
            raise AssertionError(f"{name}: appended {which} rows differ by "
                                 "more than one bf16 ulp")
        keep = torch.ones(a.shape[:2], dtype=torch.bool, device="cuda")
        keep[rows, lens_l] = False
        if not torch.equal(a[keep], b[keep]):
            raise AssertionError(f"{name}: the kernel changed {which} rows "
                                 "other than the appended ones")
    print(f"kernel check {name}: slots={slots} kvh={kvh} group={group} "
          f"d={d} max_len={max_len} cache={cache_dtype} lens={lens} "
          f"max_abs_err={err:.3e} (tol {tol}) ok", flush=True)
    return err


SERVE_LENS = [120 + 4 * i for i in range(8)]
LONG_LENS = [3968 + 127 * i // 7 for i in range(8)]  # 3968 .. 4095
# the timed shapes of rows 1-2 (d 128, bf16 activations): (slots, kvh,
# group, max_len, lens); the serving run's (Llama-2-7B, 8 slots of about
# 150 rows), and at Llama-2-7B's published 4096 positions one slot, 8
# slots and GQA (8 kv heads of 8 query heads)
DECODE_POINTS = {
    "serve": (8, 32, 1, 1024, SERVE_LENS),
    "one_slot_4095": (1, 32, 1, 4096, [4095]),
    "slots8_4k": (8, 32, 1, 4096, LONG_LENS),
    "gqa8_4k": (8, 8, 8, 4096, LONG_LENS),
}
# the split's checks at the long points and at an empty slot beside a
# full one: (name, slots, kvh, group, max_len, lens)
SPLIT_CHECKS = [
    ("one_slot_4095", 1, 32, 1, 4096, [4095]),
    ("slots8_4k", 8, 32, 1, 4096, LONG_LENS),
    ("gqa8_4k", 8, 8, 8, 4096, LONG_LENS),
    ("empty_and_full", 2, 4, 1, 1024, [0, 1023]),
]


def point_inputs(layout, quant, point, seed):
    """Inputs of rows 1 (``layout`` "contig"), 2 ("paged") or 3 ("table")
    at one ``DECODE_POINTS`` shape, bf16 activations, a bf16 or int8
    cache (rows 1-2)."""
    slots, kvh, group, max_len, lens = DECODE_POINTS[point]
    if quant:
        make = int8_contig_inputs if layout == "contig" \
            else int8_paged_inputs
        return make(lens, torch.bfloat16, seed, kvh, group, slots, max_len)
    make = decode_inputs if layout == "contig" else paged_inputs
    return make(slots, kvh, group, 128, max_len, lens, torch.bfloat16,
                torch.bfloat16, seed)


def dequantized(layout, inp):
    """``inp`` with its int8 cache or pool replaced by a bf16 copy of the
    dequantized values: what SDPA, the yardstick, reads."""
    keys = (("ck", "cv"), ("k_scale", "v_scale")) if layout == "contig" \
        else (("k_pages", "v_pages"), ("k_scale", "v_scale"))
    out = dict(inp)
    for c, sc in zip(*keys):
        scale = inp[sc][..., None] if layout == "contig" else inp[sc]
        out[c] = (inp[c].float() * scale).to(torch.bfloat16)
    return out


def point_timings(layout, quant, flush, seed):
    """Rows 1 (``layout`` "contig"), 2 ("paged") or 3 ("table"), bf16 or
    int8 cache (rows 1-2), at every ``DECODE_POINTS`` shape: the kernel's
    time beside its bound and one SDPA over the cache cut to max(seq_lens)
    + 1 rows and over the whole cache (int8: over a pre-dequantized bf16
    copy)."""
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import paged_attention as pa

    kernel = {"contig": da.fused_contiguous_decode_attention,
              "paged": pa.fused_paged_decode_attention,
              "table": pa.paged_decode_attention}[layout]
    call = library_call if layout == "contig" else paged_library_call
    out = {}
    for point in DECODE_POINTS:
        inp = point_inputs(layout, quant, point, seed)
        lib = dequantized(layout, inp) if quant else inp
        bound_ms, bound_by = bound(inp) if layout == "contig" \
            else paged_bound(inp, layout == "paged")
        args = {k: inp[k] for k in BLOCK_KEYS} if layout == "table" else inp
        res = dict(ms=time_ms(lambda: kernel(**args), flush),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=time_ms(call(lib, cut=True), flush),
                   library_full_ms=time_ms(call(lib), flush))
        out[point] = res
        print(f"decode timing {layout} {'int8' if quant else 'bf16'} "
              f"{point}: kernel {res['ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {res['ms'] / bound_ms:.2f}x)"
              f", sdpa cut {res['library_ms']:.4f} ms, full "
              f"{res['library_full_ms']:.4f} ms", flush=True)
        del inp, lib, args
    return out


def decode_plan_report():
    """The card's launch plans of rows 1-3 at every timed shape: ranks a
    stream, CTAs, and how many clusters the card holds at once."""
    from paddle_tpu_torch.kernels import decode_attention as da

    dev = torch.device("cuda", torch.cuda.current_device())
    for point, (slots, kvh, group, max_len, _) in DECODE_POINTS.items():
        for layout in ("contig", "paged", "table"):
            caches = (torch.bfloat16,) if layout == "table" \
                else (torch.bfloat16, torch.int8)
            for cache in caches:
                plan = da._card_plan(dev, layout, cache, slots, kvh, group,
                                     128, max_len)
                print(f"decode plan {layout} {cache} {point}: ranks "
                      f"{plan.ranks}, {plan.clusters} clusters = "
                      f"{plan.clusters * plan.ranks} CTAs of "
                      f"{32 * plan.warps} threads, {plan.smem} B "
                      f"dynamic shared memory, the card holds "
                      f"{plan.held} clusters at once", flush=True)


SPLIT_TYPES = {"f": ("f32", 4), "6__half": ("f16", 2),
               "13__nv_bfloat16": ("bf16", 2), "a": ("i8", 1)}
# the split kernel's row policies: rows 1, 2 and 3
SPLIT_ROWS = {"ContigRows": "contig", "PagedRows": "paged",
              "TableRows": "table"}


def decode_build_report(log):
    """The ptxas registers, spills and shared memory of every
    instantiation of rows 1-3's split kernel (the fused rows 1-2: 2
    layouts x 4 cache types, and the block-table row 3: 3 float pool
    types; each x 8 head dims x 4 head blocks): one line per layout and
    cache type, an entry ``d/heads: registers r, spill stores, static +
    dynamic shared memory`` per instantiation."""
    from paddle_tpu_torch.kernels import decode_attention as da

    pat = re.compile(r"Compiling entry function '\S*?split_decode_kernelI"
                     r"(f|6__half|13__nv_bfloat16|a)Li(\d+)ELi(\d+)E\S*?"
                     r"(ContigRows|PagedRows|TableRows)\S*' for 'sm_90a'\n"
                     r".*\n\s*(.*)\n(.*)\n")
    found = {}
    for m in pat.finditer(log):
        tc, epl, hpb, rows, frame, used = m.groups()
        layout = SPLIT_ROWS[rows]
        tag, itemsize = SPLIT_TYPES[tc]
        regs = int(re.search(r"Used (\d+) registers", used).group(1))
        static = int(re.search(r"(\d+) bytes smem", used).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", frame).group(1))
        d = 32 * int(epl)
        dyn = da._smem_bytes(d, itemsize, tag == "i8", int(hpb))
        found[(layout, tag, d, int(hpb))] = (regs, spill, static, dyn)
    for layout in SPLIT_ROWS.values():
        for tag, _ in SPLIT_TYPES.values():
            if layout == "table" and tag == "i8":
                continue
            entries = sorted((d, h, v) for (lay, t, d, h), v in found.items()
                             if lay == layout and t == tag)
            print(f"ptxas split_decode_kernel {layout} {tag}: "
                  + ", ".join(f"{d}/{h}: {r}r {sp}B spill {st}+{dy}B smem"
                              for d, h, (r, sp, st, dy) in entries),
                  flush=True)
    if len(found) != (2 * 4 + 3) * 8 * 4:
        raise AssertionError(f"expected the ptxas lines of 256 + 96 split "
                             f"instantiations, found {len(found)}")
    return found


def kernel_phase():
    from paddle_tpu_torch.kernels import decode_attention as da

    # bf16 outputs: one bf16 ulp of an O(1) value is 2^-7 ~ 8e-3, and the
    # plain version rounds the rotated q to bf16 where the kernel keeps it
    # in float32, so 2e-2 covers a few ulps. float32: the two sum the
    # softmax in different orders (online per warp vs one pass), ~1e-6
    # relative; 1e-4 leaves room at these lengths.
    ragged = [0, 63, 64, 1022, 150, 1, 300, 700]
    errs = [
        check_case("7b_bf16", 8, 32, 1, 128, 1024, ragged,
                   torch.bfloat16, torch.bfloat16, 2e-2, seed=1),
        check_case("gqa8_bf16", 8, 8, 8, 128, 1024, ragged,
                   torch.bfloat16, torch.bfloat16, 2e-2, seed=2),
        check_case("7b_f32_cache", 8, 32, 1, 128, 1024, ragged,
                   torch.float32, torch.float32, 1e-4, seed=3),
    ]
    errs += [check_case(name, slots, kvh, group, 128, max_len, lens,
                        torch.bfloat16, torch.bfloat16, 2e-2, seed=4)
             for name, slots, kvh, group, max_len, lens in SPLIT_CHECKS]
    # timing at the serving run's shape (Llama-2-7B decode, 8 slots with
    # about 150 cached rows each: 120-token prompts, 32 new tokens) and at
    # the long-context points
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    inp = decode_inputs(8, 32, 1, 128, 1024, SERVE_LENS, torch.bfloat16,
                        torch.bfloat16, seed=7)
    plain_ms = time_ms(lambda: da.fused_contiguous_decode_plain(**inp),
                       flush)
    del inp
    points = point_timings("contig", False, flush, seed=7)
    serve = points["serve"]
    print(f"kernel timing 7b decode lens={SERVE_LENS}: kernel "
          f"{serve['ms']:.4f} ms, plain {plain_ms:.4f} ms, sdpa cut "
          f"{serve['library_ms']:.4f} ms, full {serve['library_full_ms']:.4f}"
          f" ms, bound {serve['bound_ms']:.4f} ms ({serve['bound_by']})",
          flush=True)
    return dict(name="fused_contiguous_decode_attention", route="cuda",
                source="paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                replaces="paddle_tpu/kernels/decode_attention.py:118",
                shape="slots=8 kvh=32 group=1 d=128 max_len=1024 bf16 "
                      f"lens={SERVE_LENS}",
                max_abs_err=max(errs), ms=serve["ms"], kernel_ms=serve["ms"],
                plain_ms=plain_ms, bound_ms=serve["bound_ms"],
                bound_by=serve["bound_by"], library_ms=serve["library_ms"],
                library_full_ms=serve["library_full_ms"], points=points)


PAGE = 64  # the paged serving run's page size (bench_serve7b)


def paged_inputs(slots, kvh, group, d, max_len, lens, act_dtype,
                 pool_dtype, seed):
    """Random inputs for the paged kernels: a pool of ``slots * max_len /
    PAGE`` pages plus the sink page 0, and a permuted block table over
    pages 1.., so that no slot's pages are contiguous."""
    from paddle_tpu_torch.kernels.rope import rope_frequencies

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    max_pages = max_len // PAGE
    n_pages = slots * max_pages + 1
    perm = np.random.default_rng(seed).permutation(n_pages - 1) + 1
    bt = torch.tensor(perm.reshape(slots, max_pages).astype(np.int32),
                      device="cuda")
    cos, sin = rope_frequencies(d, max(2048, max_len), device="cuda")
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return dict(q=randn(slots, kvh, group, d, dtype=act_dtype),
                k_new=randn(slots, kvh, d, dtype=act_dtype),
                v_new=randn(slots, kvh, d, dtype=act_dtype),
                k_pages=randn(kvh, n_pages, PAGE, d, dtype=pool_dtype),
                v_pages=randn(kvh, n_pages, PAGE, d, dtype=pool_dtype),
                block_tables=bt, seq_lens=lens_t, positions=lens_t.clone(),
                cos=cos, sin=sin)


BLOCK_KEYS = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")


def paged_bound(inp, fused):
    """Least time for one paged decode call at these inputs: the bytes it
    must move (pool rows 0..len-1 read and the appended row written when
    fused, rows 0..len read otherwise; q and out; k_new, v_new and the
    rope rows when fused; the block-table entries of the pages read and
    the per-slot lengths and positions; an int8 row with its scale) over
    the HBM rate, and its float32 operations over the float32 rate; the
    larger of the two."""
    slots, kvh, group, d = inp["q"].shape
    lens = inp["seq_lens"].cpu().numpy().astype(np.int64)
    rb = row_bytes(inp, "k_pages", d)
    ae = inp["q"].element_size()
    rows_read = int(lens.sum()) if fused else int((lens + 1).sum())
    nbytes = (rows_read * kvh * 2 * rb
              + 2 * slots * kvh * group * d * ae
              + int((lens // PAGE + 1).sum()) * 4
              + slots * 4)
    if fused:
        nbytes += (slots * kvh * 2 * rb              # appended rows
                   + 2 * slots * kvh * d * ae        # k_new, v_new
                   + 2 * slots * (d // 2) * 4        # cos/sin rows
                   + slots * 4)                      # positions
    flops = int((lens + 1).sum()) * kvh * group * (4 * d + 5)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def paged_library_call(inp, cut=False):
    """One ``scaled_dot_product_attention`` over a dense view of each
    slot's rows, gathered from the pool before the timing: the attention
    part only (no page gather, no RoPE, no append), as no single PyTorch
    call walks a block table. ``cut``: over rows 0..max(seq_lens) of the
    view only, the mask kept."""
    q, bt = inp["q"], inp["block_tables"].long()
    slots, kvh, group, d = q.shape
    ctx = bt.shape[1] * PAGE
    # [kvh, slots, pages, PAGE, d] -> [slots, kvh, ctx, d]
    kh = inp["k_pages"][:, bt].reshape(kvh, slots, ctx, d).transpose(0, 1)
    vh = inp["v_pages"][:, bt].reshape(kvh, slots, ctx, d).transpose(0, 1)
    if cut:
        ctx = int(inp["seq_lens"].max()) + 1
        kh, vh = kh[:, :, :ctx], vh[:, :, :ctx]
    kh, vh = kh.contiguous(), vh.contiguous()
    qh = q.reshape(slots, kvh * group, 1, d).to(kh.dtype)
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= inp["seq_lens"][:, None].long())[:, None, None, :]
    kw = {"enable_gqa": True} if group > 1 else {}
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, **kw)


def check_paged_case(name, slots, kvh, group, d, max_len, lens, act_dtype,
                     pool_dtype, tol, seed):
    """Both paged kernels vs their plain versions on one input set:
    outputs within ``tol``; for the fused kernel the appended rows within
    one bf16 ulp; every other pool row bit-identical (page 0, the sink,
    excepted); a second run on the same inputs ``torch.equal`` to the
    first. Returns the two max abs errors (fused, block table)."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    errs = []
    for fused in (True, False):
        inp = paged_inputs(slots, kvh, group, d, max_len, lens, act_dtype,
                           pool_dtype, seed)
        ref_inp = {k: v.clone() for k, v in inp.items()}
        again = {k: v.clone() for k, v in inp.items()}
        if fused:
            out, kp, vp = pa.fused_paged_decode_attention(**inp)
            ref, kpr, vpr = pa.fused_paged_decode_plain(**ref_inp)
            second = pa.fused_paged_decode_attention(**again)
        else:
            out = pa.paged_decode_attention(**{k: inp[k]
                                               for k in BLOCK_KEYS})
            ref = pa.paged_decode_plain(**{k: ref_inp[k]
                                           for k in BLOCK_KEYS})
            kp, vp, kpr, vpr = (inp["k_pages"], inp["v_pages"],
                                ref_inp["k_pages"], ref_inp["v_pages"])
            second = (pa.paged_decode_attention(**{k: again[k]
                                                   for k in BLOCK_KEYS}),
                      again["k_pages"], again["v_pages"])
        torch.cuda.synchronize()
        kind = "fused" if fused else "block-table"
        if not all(torch.equal(a, b) for a, b in zip((out, kp, vp), second)):
            raise AssertionError(f"{name} {kind}: two runs on the same "
                                 "inputs differ")
        del again, second
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{name} {kind}: kernel output differs "
                                 f"from the plain version, max abs err "
                                 f"{err}")
        rows = torch.arange(slots, device="cuda")
        lens_l = inp["seq_lens"].long()
        page = inp["block_tables"].long()[rows, lens_l // PAGE]
        off = lens_l % PAGE
        for a, b, which in ((kp, kpr, "K"), (vp, vpr, "V")):
            keep = torch.ones(a.shape[1:3], dtype=torch.bool, device="cuda")
            keep[0] = False
            if fused:
                if not torch.allclose(a[:, page, off].float(),
                                      b[:, page, off].float(),
                                      rtol=2.0 ** -7, atol=1e-6):
                    raise AssertionError(f"{name}: appended {which} rows "
                                         "differ by more than one bf16 ulp")
                keep[page, off] = False
            if not torch.equal(a[:, keep], b[:, keep]):
                raise AssertionError(f"{name} {kind}: the kernel changed "
                                     f"{which} pool rows other than the "
                                     "appended ones")
        print(f"paged kernel check {name} {kind}: slots={slots} kvh={kvh} "
              f"group={group} d={d} page={PAGE} pool={pool_dtype} "
              f"lens={lens} max_abs_err={err:.3e} (tol {tol}) ok",
              flush=True)
        errs.append(err)
    return errs


def paged_kernel_phase():
    from paddle_tpu_torch.kernels import paged_attention as pa

    # tolerances as in kernel_phase: bf16 outputs 2e-2 (a few ulps of an
    # O(1) value), float32 1e-4 (two summation orders)
    ragged = [0, 63, 64, 1022, 150, 1, 300, 700]
    errs = [
        check_paged_case("7b_bf16", 8, 32, 1, 128, 1024, ragged,
                         torch.bfloat16, torch.bfloat16, 2e-2, seed=11),
        check_paged_case("gqa8_bf16", 8, 8, 8, 128, 1024, ragged,
                         torch.bfloat16, torch.bfloat16, 2e-2, seed=12),
        check_paged_case("7b_f32_pool", 8, 32, 1, 128, 1024, ragged,
                         torch.float32, torch.float32, 1e-4, seed=13),
    ]
    errs += [check_paged_case(name, slots, kvh, group, 128, max_len, lens,
                              torch.bfloat16, torch.bfloat16, 2e-2, seed=14)
             for name, slots, kvh, group, max_len, lens in SPLIT_CHECKS]
    # timing at the paged serving run's shape (Llama-2-7B decode, 8 slots
    # with about 150 cached rows each, 64-row pages) and at the
    # long-context points
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    inp = paged_inputs(8, 32, 1, 128, 1024, SERVE_LENS, torch.bfloat16,
                       torch.bfloat16, seed=17)
    block = {k: inp[k] for k in BLOCK_KEYS}
    library = {cut: time_ms(paged_library_call(inp, cut=cut), flush)
               for cut in (True, False)}
    rows = []
    for fused, (kernel, plain, body) in (
            (True, (pa.fused_paged_decode_attention,
                    pa.fused_paged_decode_plain, 210)),
            (False, (pa.paged_decode_attention, pa.paged_decode_plain,
                     49))):
        args = inp if fused else block
        kernel_ms = time_ms(lambda: kernel(**args), flush)
        # the plain versions enqueue a few dozen ops: hold the stream
        # eight times longer while the host does
        plain_ms = time_ms(lambda: plain(**args), flush,
                           hold=8 * HOLD_CYCLES)
        bound_ms, bound_by = paged_bound(inp, fused)
        name = kernel.__name__
        print(f"paged kernel timing {name} 7b decode lens={SERVE_LENS}: "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"over a pre-gathered view cut {library[True]:.4f} ms, full "
              f"{library[False]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        rows.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            replaces=f"paddle_tpu/kernels/paged_attention.py:{body}",
            shape=f"slots=8 kvh=32 group=1 d=128 page={PAGE} pages/slot=16 "
                  f"bf16 lens={SERVE_LENS}",
            max_abs_err=max(e[0 if fused else 1] for e in errs),
            ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library[True],
            library_full_ms=library[False]))
    del inp, block
    rows[0]["points"] = point_timings("paged", False, flush, seed=17)
    rows[1]["points"] = point_timings("table", False, flush, seed=17)
    return rows


# ------------------------------------------------ row 4: weight-only matmul
H100_BF16_FLOPS = 989e12     # dense bf16/fp16 tensor-core rate
# the Llama-2-7B linears as (k, n) and their calls per layer: q, k, v, o;
# gate, up; down; and lm_head once per forward
SHAPES_7B = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1,
             (4096, 32000): 0}
GROUP = 128                  # EngineConfig.weight_group_size
VERIFY_M = 8 * (4 + 1)       # 8 slots x (EngineConfig.spec_k + 1) rows


def qmm_inputs(m, k, n, g, wdt, act, seed):
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    x = torch.randn((m, k), generator=gen, device="cuda").to(act)
    quant = (qmm.quantize_weight_int4_grouped if wdt == "int4"
             else qmm.quantize_weight_int8_grouped)
    qw, sc = quant(w, g)
    return dict(x=x, qweight=qw, scale=sc, group_size=g, weight_dtype=wdt)


def qmm_bound(inp):
    """Least time for one weight-only matmul at these inputs: the bytes it
    must move (W, its scales, x and y) over the HBM rate, and its
    2 m k n operations over the tensor-core rate for 16-bit x (float32
    rate for float32 x); the larger of the two."""
    x, qw, sc = inp["x"], inp["qweight"], inp["scale"]
    m, k = x.shape
    n = qw.shape[1]
    nbytes = qw.numel() + sc.numel() * 4 + (m * k + m * n) * x.element_size()
    rate = H100_F32_FLOPS if x.dtype == torch.float32 else H100_BF16_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def qmm_check(m, k, n, g, wdt, act, seed):
    """Kernel vs plain version on one input set: the max abs error and the
    max error relative to the output's largest magnitude, which must stay
    within 1e-5 for float32 x (two summation orders) and 2e-2 for bf16 x
    (a few ulps of the rounded output; cuBLAS may reduce in bf16)."""
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    inp = qmm_inputs(m, k, n, g, wdt, act, seed)
    y = qmm.weight_only_matmul(**inp)
    ref = qmm.weight_only_matmul_plain(**inp)
    again = qmm.weight_only_matmul(**inp)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    tol = 1e-5 if act == torch.float32 else 2e-2
    if not (y.shape == ref.shape and torch.isfinite(y).all() and rel <= tol):
        raise AssertionError(f"weight-only matmul m={m} k={k} n={n} g={g} "
                             f"{wdt} {act}: relative error {rel} > {tol}")
    if not torch.equal(y, again):  # no float atomics: run-to-run identical
        raise AssertionError(f"weight-only matmul m={m} k={k} n={n} g={g} "
                             f"{wdt} {act}: two runs differ")
    return err, rel


# the edges of the tensor-core tilings (m, k, n, g, weight dtype, x dtype):
# prefill m no multiple of the 128-row tile at both weight and both 16-bit
# x types, g smaller than the 64-deep k tile (32, 64) and g = 96, n a
# multiple of 8 but not of 128; decode over 8 k splits whose stored rows
# do not divide by 8 (1100 int8 rows, 550 int4 rows), at m 1 and m 16
QMM_EDGE_CASES = [
    (200, 512, 384, 128, "int8", torch.bfloat16),
    (77, 1024, 256, 128, "int4", torch.float16),
    (129, 512, 136, 128, "int4", torch.bfloat16),
    (260, 768, 384, 128, "int8", torch.float16),
    (256, 512, 256, 32, "int8", torch.bfloat16),
    (130, 768, 384, 64, "int4", torch.bfloat16),
    (160, 576, 264, 96, "int8", torch.float16),
    (96, 576, 256, 96, "int4", torch.bfloat16),
    (1, 1100, 512, 100, "int8", torch.bfloat16),
    (16, 1100, 384, 110, "int4", torch.float16),
    (16, 1100, 256, 100, "int8", torch.float32),
    (1, 2200, 200, 110, "int4", torch.bfloat16),
]
# the bodies of row 4 by their mangled names: T, NSUB and GAL (prefill and
# decode on the tensor cores) or VEC (decode_kernel)
QMM_BODIES = ("prefill_kernel", "decode_tc_kernel", "decode_kernel")


def qmm_build_report(log):
    """The ptxas registers and spills of row 4's bodies, the dynamic shared
    memory each is launched with, and how many decode clusters of 8 CTAs
    the card holds at once."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.library()
    smem = lib.pt_weight_only_matmul_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    clusters = lib.pt_weight_only_matmul_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int], ctypes.c_int
    pat = re.compile(r"Compiling entry function '\S*?\d+(prefill_kernel|"
                     r"decode_tc_kernel|decode_kernel)I(6__half|13__nv_bfloat16"
                     r"|f)Li(\d)EL(b|i)(\d)E\S*' for 'sm_90a'\n.*\n\s*(.*)"
                     r"\n(.*)\n")
    rows = []
    for m in pat.finditer(log):
        body, tname, nsub, kind, last = m.groups()[:5]
        tag = {"6__half": "f16", "13__nv_bfloat16": "bf16", "f": "f32"}[tname]
        wdt = "int4" if nsub == "2" else "int8"
        if body == "decode_kernel":
            nbytes = smem(2 if last == "8" else 3, 0)
            var = f"VEC {last}"
        else:
            nbytes = smem(QMM_BODIES.index(body), int(nsub == "2"))
            var = "g % 16 == 0" if last == "1" else "any g"
        regs = re.search(r"Used (\d+) registers", m.group(7))
        line = (f"ptxas {body} {tag} {wdt} {var}: {regs.group(1)} registers, "
                f"{m.group(6).strip()}, {nbytes} bytes of dynamic shared "
                f"memory")
        print(line, flush=True)
        rows.append(line)
    if len(rows) != 28:
        raise AssertionError(f"expected the ptxas lines of 28 row-4 "
                             f"instantiations, found {len(rows)}")
    for i4 in (0, 1):
        print(f"weight-only matmul: {clusters(i4)} decode_tc_kernel clusters "
              f"of 8 CTAs resident at once ({'int4' if i4 else 'int8'}, "
              f"bf16)", flush=True)
    return rows


def quant_kernel_phase():
    """Row 4 against its plain version at the 7B shapes and the edges of
    its tilings, then timed."""
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    errs, rels = [], []
    seed = 40
    for wdt in ("int8", "int4"):
        for act in (torch.bfloat16, torch.float32):
            for (k, n) in SHAPES_7B:
                for m in (8, 2048):
                    seed += 1
                    e, r = qmm_check(m, k, n, GROUP, wdt, act, seed)
                    errs.append(e)
                    rels.append(r)
            e, r = qmm_check(3, 11008, 4096, 11008, wdt, act, seed + 100)
            errs.append(e)
            rels.append(r)
            print(f"weight-only matmul check {wdt} x={act}: 7B shapes at "
                  f"m=8 and m=2048, m=3 with g=k: max abs err "
                  f"{max(errs[-9:]):.3e}, max rel err {max(rels[-9:]):.3e} "
                  f"ok", flush=True)
    for i, (m, k, n, g, wdt, act) in enumerate(QMM_EDGE_CASES):
        e, r = qmm_check(m, k, n, g, wdt, act, 200 + i)
        errs.append(e)
        rels.append(r)
    bodies = sorted({qmm.kernel_body(m, n, k, a)
                     for m, k, n, _, _, a in QMM_EDGE_CASES})
    print(f"weight-only matmul check: {len(QMM_EDGE_CASES)} edge cases of "
          f"the tilings ({', '.join(bodies)}): max rel err "
          f"{max(rels[-len(QMM_EDGE_CASES):]):.3e}, each run twice "
          f"identically ok", flush=True)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    # the verify pass of speculative decoding: 8 slots x (spec_k + 1) rows
    m, (k, n) = VERIFY_M, (4096, 4096)
    verify = {}
    for wdt in ("int8", "int4"):
        e, r = qmm_check(m, k, n, GROUP, wdt, torch.bfloat16, 300)
        errs.append(e)
        rels.append(r)
        inp = qmm_inputs(m, k, n, GROUP, wdt, torch.bfloat16, 301)
        t = time_ms(lambda: qmm.weight_only_matmul(**inp), flush)
        b, by = qmm_bound(inp)
        verify[wdt] = t
        print(f"weight-only matmul check m={m} k={k} n={n} {wdt} bf16 "
              f"({qmm.kernel_body(m, n, k, torch.bfloat16)}, the verify "
              f"pass's m): max abs err {e:.3e}, max rel err {r:.3e}, run "
              f"twice identically ok; kernel {t:.4f} ms, bound {b:.4f} ms "
              f"({by})", flush=True)
    times = {}
    for m in (8, 2048):
        for (k, n) in SHAPES_7B:
            for wdt in ("int8", "int4"):
                inp = qmm_inputs(m, k, n, GROUP, wdt, torch.bfloat16, 7)
                t = time_ms(lambda: qmm.weight_only_matmul(**inp), flush,
                            iters=100 if m == 8 else 30)
                b, by = qmm_bound(inp)
                times[(m, k, n, wdt)] = (t, b)
                print(f"weight-only matmul timing m={m} k={k} n={n} {wdt} "
                      f"bf16 ({qmm.kernel_body(m, n, k, torch.bfloat16)}): "
                      f"kernel {t:.4f} ms ({2 * m * k * n / t / 1e9:.1f} "
                      f"TFLOP/s), bound {b:.4f} ms ({by})", flush=True)
    # the yardsticks at the row's headline shape (down_proj, m = 8) and at
    # one prefill shape (gate/up, m = 2048 = 8 slots x 256-token chunk)
    rows = {}
    for label, (m, k, n) in (("decode", (8, 11008, 4096)),
                             ("prefill", (2048, 4096, 11008))):
        inp = qmm_inputs(m, k, n, GROUP, "int8", torch.bfloat16, 9)
        w_bf16 = (inp["qweight"].float().reshape(k // GROUP, GROUP, n)
                  * inp["scale"][:, None, :]).reshape(k, n).to(torch.bfloat16)
        x = inp["x"]
        kernel_ms = time_ms(lambda: qmm.weight_only_matmul(**inp), flush)
        plain_ms = time_ms(lambda: qmm.weight_only_matmul_plain(**inp),
                           flush, hold=8 * HOLD_CYCLES)
        library_ms = time_ms(lambda: torch.matmul(x, w_bf16), flush)
        bound_ms, bound_by = qmm_bound(inp)
        print(f"weight-only matmul timing {label} m={m} k={k} n={n} int8 "
              f"bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul over the dequantized bf16 W {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        rows[label] = (kernel_ms, plain_ms, library_ms, bound_ms, bound_by)
    # one 7B forward: 32 layers of q, k, v, o, gate, up, down and the
    # head, from the per-shape times above, at decode (8 slots) and over
    # one prefill chunk (8 slots x 256 tokens)
    fwd = {}
    for m, label in ((8, "decode"), (2048, "prefill chunk")):
        for wdt in ("int8", "int4"):
            fwd[(m, wdt)] = [sum((32 * c if c else 1)
                                 * times[(m, k, n, wdt)][i]
                                 for (k, n), c in SHAPES_7B.items())
                             for i in (0, 1)]
            print(f"weight-only matmul per 7B {label} forward (225 calls, "
                  f"m={m}, {wdt}): kernels {fwd[(m, wdt)][0]:.4f} ms, bound "
                  f"{fwd[(m, wdt)][1]:.4f} ms", flush=True)
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = rows["decode"]
    pre = rows["prefill"]
    return dict(name="weight_only_matmul", route="cuda",
                source="paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
                replaces="paddle_tpu/kernels/quant_matmul.py:110",
                shape="m=8 k=11008 n=4096 int8 g=128 bf16",
                max_abs_err=max(errs), max_rel_err=max(rels), ms=kernel_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                prefill_ms=pre[0], prefill_plain_ms=pre[1],
                prefill_library_ms=pre[2], prefill_bound_ms=pre[3],
                prefill_int4_ms=times[(2048, 4096, 11008, "int4")][0],
                verify_m40_int8_ms=verify["int8"],
                verify_m40_int4_ms=verify["int4"],
                int4_ms=times[(8, 11008, 4096, "int4")][0],
                int4_bound_ms=times[(8, 11008, 4096, "int4")][1],
                forward_int8_ms=fwd[(8, "int8")][0],
                forward_int8_bound_ms=fwd[(8, "int8")][1],
                forward_int4_ms=fwd[(8, "int4")][0],
                forward_int4_bound_ms=fwd[(8, "int4")][1],
                prefill_forward_int8_ms=fwd[(2048, "int8")][0],
                prefill_forward_int4_ms=fwd[(2048, "int4")][0],
                prefill_forward_bound_ms=fwd[(2048, "int8")][1])


# the converted Mamba-130m's linears (k, n, group): in_proj, x_proj (dt
# rank 48 + 2 x 16 states), dt_proj (k 48: one whole-column group) and
# out_proj, at batch 4 x 1024 tokens
MAMBA_QMM = ((768, 3072, 128), (1536, 80, 128), (48, 1536, 48),
             (1536, 768, 128))
MAMBA_M = 4 * 1024


def qmm_mamba_phase():
    """Row 4 with float32 x at the shapes of the QAT-converted Mamba-130m
    (int4 weights, m 4096): each against its plain version (rel 1e-5),
    run twice identically, then timed beside its bound (float32 operations
    at 67 TFLOP/s against its bytes), its plain version and one
    ``torch.matmul`` over the dequantized float32 weight (TF32 off)."""
    from paddle_tpu_torch.kernels import quant_matmul as qmm

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for i, (k, n, g) in enumerate(MAMBA_QMM):
        err, rel = qmm_check(MAMBA_M, k, n, g, "int4", torch.float32,
                             500 + i)
        inp = qmm_inputs(MAMBA_M, k, n, g, "int4", torch.float32, 510 + i)
        x = inp["x"]
        w = (qmm._unpack_int4(inp["qweight"]).float().reshape(k // g, g, n)
             * inp["scale"][:, None, :]).reshape(k, n)
        kernel_ms = time_ms(lambda: qmm.weight_only_matmul(**inp), flush,
                            iters=30)
        plain_ms = time_ms(lambda: qmm.weight_only_matmul_plain(**inp),
                           flush, iters=30)
        library_ms = time_ms(lambda: torch.matmul(x, w), flush, iters=30)
        bound_ms, bound_by = qmm_bound(inp)
        body = qmm.kernel_body(MAMBA_M, n, k, torch.float32)
        row = dict(m=MAMBA_M, k=k, n=n, group=g, body=body,
                   max_abs_err=err, max_rel_err=rel, ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=2 * MAMBA_M * k * n / kernel_ms / 1e9)
        rows.append(row)
        print(f"weight-only matmul mamba m={MAMBA_M} k={k} n={n} g={g} int4 "
              f"float32 x ({body}): max rel err {rel:.3e} (tol 1e-5), run "
              f"twice identically; kernel {kernel_ms:.4f} ms "
              f"({row['tflops']:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"torch.matmul over the dequantized float32 W "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
    fwd = {key: sum(r[key] for r in rows) * 24
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"weight-only matmul per converted Mamba-130m forward (96 calls "
          f"at m {MAMBA_M}, float32 x): kernels {fwd['ms']:.3f} ms, "
          f"torch.matmul {fwd['library_ms']:.3f} ms, bound "
          f"{fwd['bound_ms']:.3f} ms", flush=True)
    return dict(shapes=rows, forward=fwd)


# ------------------------------------------ int8 branches of rows 1 and 2
def int8_side(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.019 + 1e-3
    return q, s


def compare_int8_rows(name, got_q, want_q, got_s, want_s):
    """Appended int8 rows: payloads equal or at most 1 apart (the share
    that differs is printed), scales within rtol 1e-5."""
    diff = (got_q.int() - want_q.int()).abs()
    share = (diff > 0).float().mean().item()
    if diff.max().item() > 1:
        raise AssertionError(f"{name}: appended int8 payloads differ by "
                             f"{diff.max().item()}")
    if not torch.allclose(got_s, want_s, rtol=1e-5, atol=0):
        raise AssertionError(f"{name}: appended scales differ beyond rtol "
                             "1e-5")
    return share


def int8_contig_inputs(lens, act, seed, kvh=32, group=1, slots=8,
                       max_len=1024):
    inp = decode_inputs(slots, kvh, group, 128, max_len, lens, act,
                        torch.float32, seed)
    shape = (slots, max_len, kvh, 128)
    inp["ck"], inp["k_scale"] = int8_side(shape, seed + 1)
    inp["cv"], inp["v_scale"] = int8_side(shape, seed + 2)
    return inp


def int8_paged_inputs(lens, act, seed, kvh=32, group=1, slots=8,
                      max_len=1024):
    inp = paged_inputs(slots, kvh, group, 128, max_len, lens, act,
                       torch.float32, seed)
    shape = tuple(inp["k_pages"].shape)
    inp["k_pages"], ks = int8_side(shape, seed + 1)
    inp["v_pages"], vs = int8_side(shape, seed + 2)
    inp["k_scale"], inp["v_scale"] = ks[..., None], vs[..., None]
    return inp


def int8_decode_phase():
    """The int8 branches of rows 1 and 2 against their plain versions at
    the 7B decode shape (bf16 activations), a GQA shape (float32
    activations) and one slot at 4095 rows beside one at 3000 (bf16), each
    run twice identically; then timed at the serving run's lengths and the
    long-context points."""
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import paged_attention as pa

    ragged = [0, 63, 64, 1022, 150, 1, 300, 700]
    errs = {"contig": [], "paged": []}
    for label, act, kvh, group, tol, seed, lens, slots, max_len in (
            ("7b_bf16", torch.bfloat16, 32, 1, 2e-2, 51, ragged, 8, 1024),
            ("gqa8_f32", torch.float32, 8, 8, 1e-4, 52, ragged, 8, 1024),
            ("long_bf16", torch.bfloat16, 32, 1, 2e-2, 53, [4095, 3000], 2,
             4096)):
        for kind in ("contig", "paged"):
            make = int8_contig_inputs if kind == "contig" \
                else int8_paged_inputs
            inp = make(lens, act, seed, kvh, group, slots, max_len)
            ref_inp = {k: v.clone() for k, v in inp.items()}
            again = {k: v.clone() for k, v in inp.items()}
            kernel = da.fused_contiguous_decode_attention \
                if kind == "contig" else pa.fused_paged_decode_attention
            got = kernel(**inp)
            second = kernel(**again)
            if kind == "contig":
                ref = da.fused_contiguous_decode_plain(**ref_inp)
                rows = torch.arange(slots, device="cuda")
                at = (rows, inp["seq_lens"].long())
            else:
                ref = pa.fused_paged_decode_plain(**ref_inp)
                lens_l = inp["seq_lens"].long()
                page = inp["block_tables"].long()[torch.arange(
                    slots, device="cuda"), lens_l // PAGE]
                at = (slice(None), page, lens_l % PAGE)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, second)):
                raise AssertionError(f"int8 {kind} {label}: two runs on the "
                                     "same inputs differ")
            out, kq, vq, ks, vs = got
            ref, kqr, vqr, ksr, vsr = ref
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.allclose(out.float(), ref.float(), rtol=tol,
                                  atol=tol):
                raise AssertionError(f"int8 {kind} {label}: output max abs "
                                     f"err {err} > {tol}")
            shares = [compare_int8_rows(f"int8 {kind} {label}", a[at],
                                        b[at], sa[at], sb[at])
                      for a, b, sa, sb in ((kq, kqr, ks, ksr),
                                           (vq, vqr, vs, vsr))]
            errs[kind].append(err)
            print(f"int8 kernel check {kind} {label}: kvh={kvh} "
                  f"group={group} d=128 lens={lens} max_abs_err="
                  f"{err:.3e} (tol {tol}), appended payloads differing "
                  f"K {shares[0]:.4f} V {shares[1]:.4f} ok", flush=True)
            del inp, ref_inp, again, got, second
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out_rows = []
    for kind in ("contig", "paged"):
        inp = (int8_contig_inputs if kind == "contig"
               else int8_paged_inputs)(SERVE_LENS, torch.bfloat16, 57)
        if kind == "contig":
            plain = da.fused_contiguous_decode_plain
            name, body = "fused_contiguous_decode_attention", \
                "paddle_tpu/kernels/decode_attention.py:118"
            src = "paddle_tpu_torch/kernels/csrc/decode_attention.cu"
        else:
            plain = pa.fused_paged_decode_plain
            name, body = "fused_paged_decode_attention", \
                "paddle_tpu/kernels/paged_attention.py:210"
            src = "paddle_tpu_torch/kernels/csrc/paged_attention.cu"
        plain_ms = time_ms(lambda: plain(**inp), flush, hold=8 * HOLD_CYCLES)
        del inp
        points = point_timings(kind, True, flush, seed=57)
        serve = points["serve"]
        print(f"int8 kernel timing {name} 7b decode lens={SERVE_LENS}: "
              f"kernel {serve['ms']:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"over a pre-dequantized bf16 view cut "
              f"{serve['library_ms']:.4f} ms, full "
              f"{serve['library_full_ms']:.4f} ms, bound "
              f"{serve['bound_ms']:.4f} ms ({serve['bound_by']})", flush=True)
        out_rows.append(dict(
            name=f"{name}[int8]", route="cuda", source=src, replaces=body,
            shape=f"slots=8 kvh=32 group=1 d=128 int8 cache, bf16 x, "
                  f"lens={SERVE_LENS}",
            max_abs_err=max(errs[kind]), ms=serve["ms"],
            kernel_ms=serve["ms"], plain_ms=plain_ms,
            bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
            library_ms=serve["library_ms"],
            library_full_ms=serve["library_full_ms"], points=points))
    return out_rows


def reference_phase(paged=False):
    """Small-input reference: a tiny float32 Llama (head_dim 64, group 2)
    on the card serves 5 queued prompts over 2 slots in 16-token prefill
    chunks through the fused kernel, with the prefix cache on (the
    default). One no-cache forward over each
    prompt and its output (the model's plain causal path: no KV cache, no
    kernel) must rank every served token first: its logit within 1e-4 of
    the row's maximum, so a float32 near-tie cannot fail the check.

    ``paged``: the paged engine with 16-token pages and a pool of 4 usable
    pages (plus the sink): the 40-token request needs 4 pages and cannot
    join the first, so admission waits on the pool (and evicts the prefix
    store's pages to fit); at the end every page is free or held by the
    store alone."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256)
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (3, 40, 17, 9, 33)]
    extra = dict(paged=True, page_size=16, n_pages=5) if paged else {}
    saved = flags.flag("prefill_chunk")
    flags.set_flags({"fused_decode": "auto", "prefill_chunk": 16})
    blocked = False
    try:
        eng = ContinuousBatchingEngine(
            model, EngineConfig(max_slots=2, max_len=128,
                                cache_dtype=torch.float32, **extra),
            device="cuda")
        rids = [eng.add_request(p, 12) for p in prompts]
        while eng.step_chunk(4) or eng._queue or eng.active.any():
            blocked = blocked or eng._pool_blocked
        reqs = [eng._finished[r] for r in rids]
    finally:
        flags.set_flags({"prefill_chunk": saved})
    if paged:
        check_pool("paged reference", eng)
        if not blocked:
            raise AssertionError("paged reference: admission never waited "
                                 "on the pool")
    worst = 0.0
    for p, r in zip(prompts, reqs):
        if len(r.output) != 12:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
        ids = torch.as_tensor(np.concatenate([p, r.output[:-1]]),
                              device="cuda")[None]
        rows = model(ids)[0, len(p) - 1:].float()
        if not torch.isfinite(rows).all():
            raise AssertionError("the no-cache forward gave non-finite "
                                 "logits")
        served = torch.as_tensor(r.output, device="cuda")
        gap = (rows.max(dim=-1).values
               - rows.gather(1, served[:, None])[:, 0]).max().item()
        worst = max(worst, gap)
        if gap > 1e-4:
            raise AssertionError(
                f"request {r.rid}: served tokens {r.output} are not the "
                f"no-cache forward's greedy choice (logit gap {gap})")
    print(f"{'paged ' if paged else ''}reference check: tiny float32 Llama "
          f"on the card, {len(reqs)} requests x 12 tokens, "
          f"{eng.stats['decode_forwards']} decode forwards through the "
          f"kernel, served tokens are the no-cache forward's greedy choice "
          f"(max logit gap {worst:.2e})"
          + (f", admission waited on the pool, pages at the end "
             f"{pool_identity(eng)}" if paged else ""), flush=True)


def quant_reference_phase():
    """A tiny float32 Llama (head_dim 64, group 2) with int8 weights and an
    int8 KV cache, served on the card (row 4 and the int8 branches of the
    fused kernels) and on the CPU (their plain versions) from the same
    weights, contiguous and paged: the greedy tokens must be identical."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256)
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    host = LlamaForCausalLM(cfg, device="cpu", seed=1)
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (3, 40, 17, 9, 33)]
    saved = flags.flag("prefill_chunk")
    flags.set_flags({"fused_decode": "auto", "prefill_chunk": 16})
    try:
        for paged in (False, True):
            extra = dict(paged=True, page_size=16) if paged else {}
            outs = {}
            for dev, m in (("cuda", model), ("cpu", host)):
                reset_launches()
                eng = ContinuousBatchingEngine(
                    m, EngineConfig(max_slots=2, max_len=128,
                                    weight_dtype="int8", cache_dtype="int8",
                                    **extra), device=dev)
                outs[dev] = [r.output for r in eng.run(
                    prompts, max_new_tokens=12, max_chunk=4)]
                counts = read_launches()
                fused = "fused_paged_decode_attention" if paged \
                    else "fused_contiguous_decode_attention"
                ran = counts["weight_only_matmul"] > 0 and counts[fused] > 0
                if ran != (dev == "cuda") or (dev == "cpu"
                                              and any(counts.values())):
                    raise AssertionError(f"{dev} engine launches {counts}")
            if outs["cuda"] != outs["cpu"]:
                raise AssertionError(
                    f"quantized reference ({'paged' if paged else 'contig'}"
                    f"): card tokens {outs['cuda']} differ from the plain "
                    f"versions' {outs['cpu']} (first divergence "
                    f"{first_divergence(outs['cuda'], outs['cpu'])})")
            print(f"quantized reference {'paged' if paged else 'contig'}: "
                  f"tiny float32 Llama, int8 weights x int8 KV, "
                  f"{len(prompts)} requests x 12 tokens: greedy tokens on "
                  f"the card equal the plain versions' on the CPU",
                  flush=True)
    finally:
        flags.set_flags({"prefill_chunk": saved})


# ------------------------------------------------ rows 5-9: flash attention
FA_FILE = "paddle_tpu/kernels/pallas_attention.py"
FA_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
# rows 5-9 by launch-count name
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_fused",
                 "flash_attention_bwd_dkv")
# the train shape of Llama-2-7B width: batch 4 x seq 2048, 32 heads of 128
TRAIN_SHAPE = dict(b=4, s=2048, hq=32, hk=32, d=128)


def fa_inputs(b, s, hq, hk, d, dtype, seed, sk=None):
    """q, k, v, do and an LSE cotangent; k and v have ``sk`` rows (``s``
    when None)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sk = s if sk is None else sk

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    return (randn(b, s, hq, d), randn(b, sk, hk, d), randn(b, sk, hk, d),
            randn(b, s, hq, d),
            torch.randn((b, hq, s), generator=gen, device="cuda"))


def fa_segments(kind, b, s):
    """Four packed sequences per row, as one [b, s] array or a pair."""
    if kind is None:
        return None
    ids = (torch.arange(s, device="cuda") * 4 // s).to(torch.int32)
    ids = ids.expand(b, s).contiguous()
    return ids if kind == "one" else (ids, ids.clone())


def fa_err(got, want):
    """Max abs error, and the same over the reference's largest magnitude
    (at least 1)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


# Kernel against plain version, row by row: the norm of each [d] row's
# difference over the norm of the plain version's row (taken as at least
# 1e-3 of the tensor's root-mean-square row norm, so that a row the
# plain version cancels to near zero is held to the tensor's scale).
# bf16: p and ds are rounded to bf16 (2^-8 relative) against other
# running maxima and summed in other orders, and the outputs are rounded
# once more: a few tenths of a percent of a row, so 2e-2 holds them with
# room and rejects a kernel that skips a kv tile (fa_planted_fault).
# float32: the kernels' FMA chains against the card's float32 matmuls.
# lse is float32 on both sides, held absolutely.
FA_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
FA_LSE_TOL = 1e-5


def fa_row_err(got, want):
    """The largest relative error of a [d] row (see FA_ROW_TOL) and the
    max abs error."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    den = w.norm(dim=-1)
    floor = (1e-3 * den.square().mean().sqrt()).clamp_min(1e-30)
    rel = (num / torch.maximum(den, floor)).max().item()
    return rel, (g - w).abs().max().item()


def fa_compare(name, got, want, tol):
    """Hold each output against its reference: lse (a [b, h, s] float32
    tensor) within FA_LSE_TOL absolutely, the others row by row within
    ``tol``. Returns {key: (row err, max abs err)} and the keys that
    failed."""
    errs, failed = {}, []
    for key in got:
        g = got[key]
        if key == "lse":
            err = (g.float() - want[key].float()).abs().max().item()
            errs[key] = (err, err)
            bad = not err <= FA_LSE_TOL
        else:
            errs[key] = fa_row_err(g, want[key])
            bad = not errs[key][0] <= tol
        if bad or not torch.isfinite(g).all():
            failed.append(key)
    return errs, failed


def fa_check(name, b, s, hq, hk, d, dtype, causal=True, window=0,
             segments=None, seed=0, sk=None):
    """Rows 5-9 against their plain versions on one input set: the
    forward without and with LSE, then the dq, dk/dv and fused backward
    from the plain statistics with a nonzero LSE cotangent folded into
    delta; the fused and the two-pass backward must agree (dk, dv bit for
    bit: the same sums in the same order). ``sk`` (``s`` when None) is
    the kv length. Returns the max abs errors by kernel."""
    from paddle_tpu_torch.kernels import mha as fa

    q, k, v, do, dlse = fa_inputs(b, s, hq, hk, d, dtype, seed, sk)
    sk = k.shape[1]
    qseg, kseg = fa.split_segments(fa_segments(segments, b, s), q, k)
    kw = dict(causal=causal, sm_scale=d ** -0.5, qseg=qseg, kseg=kseg,
              window=window)
    tol = FA_ROW_TOL[dtype]
    o5, _ = fa.flash_forward(q, k, v, **kw)
    o6, lse = fa.flash_forward(q, k, v, with_lse=True, **kw)
    ref_o, ref_lse = fa.mha_forward_plain(q, k, v, **kw)
    delta = fa.attention_delta(ref_o, do, dlse)
    args = (q, k, v, do, ref_lse, delta)
    span = fa.fit_block(1024, sk)
    got = {"fwd": o5, "fwd_lse": o6, "lse": lse,
           "bwd_dq": fa.flash_bwd_dq(*args, **kw)}
    got["bwd_dk"], got["bwd_dv"] = fa.flash_bwd_dkv(*args, **kw)
    got["fused_dq"], got["fused_dk"], got["fused_dv"] = \
        fa.flash_bwd_fused(*args, span=span, **kw)
    torch.cuda.synchronize()
    want = {"fwd": ref_o, "fwd_lse": ref_o, "lse": ref_lse,
            "bwd_dq": fa.mha_bwd_dq_plain(*args, **kw)}
    want["bwd_dk"], want["bwd_dv"] = fa.mha_bwd_dkv_plain(*args, **kw)
    want["fused_dq"], want["fused_dk"], want["fused_dv"] = \
        fa.mha_bwd_fused_plain(*args, span=span, **kw)
    errs, failed = fa_compare(name, got, want, tol)
    if failed:
        raise AssertionError(f"flash check {name}: {failed} differ from "
                             f"the plain versions: " + ", ".join(
                                 f"{k} row err {errs[k][0]:.3e} max abs "
                                 f"{errs[k][1]:.3e}" for k in failed)
                             + f" (tol {tol} of a row, lse {FA_LSE_TOL})")
    if not torch.equal(o5, o6):
        raise AssertionError(f"flash check {name}: the forward with and "
                             "without LSE differ")
    if not (torch.equal(got["fused_dk"], got["bwd_dk"])
            and torch.equal(got["fused_dv"], got["bwd_dv"])):
        raise AssertionError(f"flash check {name}: fused and two-pass "
                             "dk/dv differ")
    pass_rel, _ = fa_row_err(got["fused_dq"], got["bwd_dq"])
    if not pass_rel <= tol:
        raise AssertionError(f"flash check {name}: fused and two-pass dq "
                             f"differ by {pass_rel} of a row")
    # the same through mha_with_lse under autograd (the forward with LSE,
    # then the backward its k_block picks), cotangents (do, dlse)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o, lse = fa.mha_with_lse(*leaves, causal=causal,
                             segment_ids=fa_segments(segments, b, s),
                             window=window)
    torch.autograd.backward((o, lse), (do, dlse))
    for key, leaf in zip(("fused_dq", "fused_dk", "fused_dv"), leaves):
        rel, e = fa_row_err(leaf.grad, want[key])
        if not rel <= tol:
            raise AssertionError(f"flash check {name}: mha_with_lse "
                                 f"gradient {key[-2:]} differs by {rel} "
                                 "of a row")
        errs[f"autograd_{key[-2:]}"] = (rel, e)
    print(f"flash check {name}: b={b} s={s} sk={sk} hq={hq} hk={hk} d={d} "
          f"{dtype} "
          f"causal={causal} window={window} segments={segments}: row err / "
          f"max abs err " + ", ".join(f"{k} {r:.2e}/{e:.2e}"
                                      for k, (r, e) in errs.items())
          + f"; fused vs two-pass dq row err {pass_rel:.2e} (tol {tol} of "
          f"a row, lse {FA_LSE_TOL}) ok", flush=True)
    ab = {k: e for k, (_, e) in errs.items()}
    return {"flash_attention_fwd": ab["fwd"],
            "flash_attention_fwd_lse": max(ab["fwd_lse"], ab["lse"]),
            "flash_attention_bwd_dq": ab["bwd_dq"],
            "flash_attention_bwd_fused": max(ab["fused_dq"], ab["fused_dk"],
                                             ab["fused_dv"]),
            "flash_attention_bwd_dkv": max(ab["bwd_dk"], ab["bwd_dv"])}


def fa_dense(q, k, v, do, dlse, vis, scale):
    """Dense float32 attention under ``vis`` ([s, s], True = attend; kv
    heads equal to query heads), and its gradients by autograd for the
    cotangents (do, dlse): an independent reference, with no rounding of
    p or ds."""
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    sc = sc.masked_fill(~vis, -1e30)
    lse = torch.logsumexp(sc, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(sc - lse[..., None]), vf)
    dq, dk, dv = torch.autograd.grad((o, lse), (qf, kf, vf),
                                     (do.float(), dlse))
    return {"o": o.detach(), "lse": lse.detach(), "dq": dq, "dk": dk,
            "dv": dv}


def fa_planted_fault():
    """The check has teeth: at the train shape, the kernels' forward and
    fused backward are held, through ``fa_compare``, against a dense
    float32 reference (``fa_dense``). With the true causal mask every
    output must pass; with a planted fault (each query in the second half
    of the sequence skips its last visible 64-key tile, the diagonal one,
    as a kernel whose causal bound stopped a tile early would) every
    output must fail. The backward kernel takes its ``delta`` from the
    reference's float32 output: the kernels take delta as an input, and
    one from the bf16 output would shift each row of ds by p times that
    rounding, which in a row whose dq is small by chance is several
    percent of the row (the caller's rounding, not the kernels')."""
    from paddle_tpu_torch.kernels import mha as fa

    t = TRAIN_SHAPE
    b, s, hq, hk, d = (t[x] for x in ("b", "s", "hq", "hk", "d"))
    q, k, v, do, dlse = fa_inputs(b, s, hq, hk, d, torch.bfloat16, seed=80)
    i = torch.arange(s, device="cuda")[:, None]
    j = torch.arange(s, device="cuda")[None, :]
    true_vis = j <= i
    fault_vis = true_vis & ~((i >= s // 2) & (j >= i // 64 * 64))
    want_true = fa_dense(q, k, v, do, dlse, true_vis, d ** -0.5)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    o, lse = fa.flash_forward(q, k, v, with_lse=True, **kw)
    delta = fa.attention_delta(want_true["o"], do, dlse)
    dq, dk, dv = fa.flash_bwd_fused(q, k, v, do, lse, delta,
                                    span=fa.fit_block(1024, s), **kw)
    got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    tol = FA_ROW_TOL[torch.bfloat16]
    out = {}
    for label, vis, must_pass in (("true mask", true_vis, True),
                                  ("planted fault", fault_vis, False)):
        want = (want_true if must_pass
                else fa_dense(q, k, v, do, dlse, vis, d ** -0.5))
        errs, failed = fa_compare(label, got, want, tol)
        del want
        want_true = None
        ok = not failed if must_pass else set(failed) == set(got)
        print(f"flash planted fault: kernels vs dense float32 with the "
              f"{label}: row err / max abs err " + ", ".join(
                  f"{k} {r:.2e}/{e:.2e}" for k, (r, e) in errs.items())
              + f"; failed {failed} (tol {tol} of a row, lse "
              f"{FA_LSE_TOL}): {'as required' if ok else 'WRONG'}",
              flush=True)
        if not ok:
            raise AssertionError(
                f"flash planted fault: with the {label} the check "
                f"{'failed' if must_pass else 'passed'} "
                f"{failed if must_pass else set(got) - set(failed)}")
        out[label] = {k: r for k, (r, _) in errs.items()}
    return out


def fa_pairs(sq, sk, causal, window):
    """Visible (query, key) pairs of one head: the data-dependent work."""
    i = np.arange(sq)[:, None] + (sk - sq)
    j = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= (i - j) < window
    return int(vis.sum())


def fa_bound(name, b, s, hq, hk, d, itemsize, pairs):
    """Least time for the function on these inputs: its products over
    the visible pairs (forward 2, dq pass 3, dk/dv pass 4, fused 5 of
    2 * d operations each) at the tensor-core rate, against each input
    read once and each output written once (lse and delta float32);
    the larger of the two."""
    qb = b * s * hq * d * itemsize      # q, o, do or dq
    kvb = b * s * hk * d * itemsize     # k, v, dk or dv
    rows = b * hq * s * 4               # lse or delta
    products, nbytes = {
        "flash_attention_fwd": (2, 2 * qb + 2 * kvb),
        "flash_attention_fwd_lse": (2, 2 * qb + 2 * kvb + rows),
        "flash_attention_bwd_dq": (3, 3 * qb + 2 * kvb + 2 * rows),
        "flash_attention_bwd_dkv": (4, 2 * qb + 4 * kvb + 2 * rows),
        "flash_attention_bwd_fused": (5, 3 * qb + 4 * kvb + 2 * rows),
    }[name]
    ops = products * 2 * d * pairs * b * hq
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops


def flash_build_report(log):
    """The ptxas registers and spills of the redesigned flash kernels
    (``fwd_kernel``, ``dq_kernel`` and ``dkv_kernel`` at 16-bit DP 64 and
    128) and the dynamic shared memory each is launched with."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.library()
    pat = re.compile(r"Compiling entry function '\S*?\d+(fwd_kernel|dq_kernel|"
                     r"dkv_kernel)I(6__half|13__nv_bfloat16)Li(\d+)E(Lb([01])E)?"
                     r"\S*' for 'sm_90a'\n.*\n\s*(.*)\n(.*)\n")
    passes = {("fwd_kernel", None): 0, ("dq_kernel", None): 1,
              ("dkv_kernel", "0"): 2, ("dkv_kernel", "1"): 3}
    rows = []
    for m in pat.finditer(log):
        kernel, tname, dp, fused = m.group(1), m.group(2), int(m.group(3)), \
            m.group(5)
        tag = "bf16" if "bfloat16" in tname else "f16"
        fn = getattr(lib, f"pt_flash_smem_{tag}")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        smem = fn(passes[(kernel, fused)], dp)
        label = kernel + ("" if fused is None else
                          ("<FUSED>" if fused == "1" else "<two-pass>"))
        regs = re.search(r"Used (\d+) registers", m.group(7))
        line = (f"ptxas {label} {tag} DP {dp}: {regs.group(1)} registers, "
                f"{m.group(6).strip()}, {smem} bytes of dynamic shared "
                f"memory")
        print(line, flush=True)
        rows.append(line)
    if len(rows) != 16:
        raise AssertionError(f"expected the ptxas lines of 16 redesigned "
                             f"flash instantiations, found {len(rows)}")
    return rows


def flash_kernel_phase():
    """Rows 5-9 against their plain versions at the shapes of the train
    path and its variants, then timed at the Llama-2-7B train shape beside
    their bounds, their plain versions and ``scaled_dot_product_attention``
    (forward, and its backward for the backward kernels: a yardstick the
    port never calls)."""
    from paddle_tpu_torch.kernels import mha as fa

    t = TRAIN_SHAPE
    cases = [
        ("train_7b", t["b"], t["s"], t["hq"], t["hk"], t["d"],
         torch.bfloat16, {}),
        ("gqa_32_over_8", 2, 2048, 32, 8, 128, torch.bfloat16, {}),
        ("d64", 2, 1024, 8, 8, 64, torch.bfloat16, {}),
        ("d96", 2, 1024, 8, 4, 96, torch.bfloat16, {}),
        ("window512", 2, 2048, 8, 8, 128, torch.bfloat16,
         dict(window=512)),
        ("segments_one", 2, 2048, 8, 8, 128, torch.bfloat16,
         dict(segments="one")),
        ("segments_pair", 2, 2048, 8, 2, 128, torch.bfloat16,
         dict(segments="pair", causal=False)),
        ("noncausal", 2, 1024, 8, 8, 128, torch.bfloat16,
         dict(causal=False)),
        ("float32", 1, 512, 4, 2, 128, torch.float32, {}),
        # ragged: no multiple of the kernels' tiles or of 128, nine
        # 128-row spans in the fused pass
        ("ragged_1100", 1, 1100, 8, 2, 128, torch.bfloat16, {}),
        # the edges of the redesigned tiling: s no multiple of the forward's
        # 64-row q tile or the backward's 128-key kv tile; sq != sk, so a
        # causal tile straddles the bottom-right diagonal; a window edge
        # inside a tile; GQA with the fused pass over 3 spans of 1024
        ("ragged_1000", 2, 1000, 8, 8, 128, torch.bfloat16, {}),
        ("causal_sq_1000_sk_2048", 2, 1000, 8, 2, 128, torch.bfloat16,
         dict(sk=2048)),
        ("window_300", 2, 2048, 8, 8, 128, torch.bfloat16,
         dict(window=300)),
        ("gqa_3_spans", 1, 3072, 16, 4, 128, torch.bfloat16, {}),
    ]
    errs = {}
    for i, (name, b, s, hq, hk, d, dtype, kw) in enumerate(cases):
        for key, e in fa_check(name, b, s, hq, hk, d, dtype, seed=60 + i,
                               **kw).items():
            errs[key] = max(errs.get(key, 0.0), e)
    fa_planted_fault()
    # timing at the train shape, causal bf16
    b, s, hq, hk, d = (t[x] for x in ("b", "s", "hq", "hk", "d"))
    q, k, v, do, _ = fa_inputs(b, s, hq, hk, d, torch.bfloat16, seed=70)
    kw = dict(causal=True)
    o, lse = fa.flash_forward(q, k, v, with_lse=True, **kw)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    span = fa.fit_block(1024, s)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    plain_hold = dict(iters=10, warmup=2, hold=8 * HOLD_CYCLES)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qh, kh, vh))
    out = sdpa(qg, kg, vg, is_causal=True)
    lib_fwd = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True), flush,
                      iters=30)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), doh, retain_graph=True), flush, iters=30)
    calls = {
        "flash_attention_fwd": (lambda: fa.flash_forward(q, k, v, **kw),
                                lambda: fa.mha_forward_plain(q, k, v, **kw),
                                lib_fwd, 250),
        "flash_attention_fwd_lse": (
            lambda: fa.flash_forward(q, k, v, with_lse=True, **kw),
            lambda: fa.mha_forward_plain(q, k, v, **kw), lib_fwd, 263),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_bwd_dq(*args, **kw),
            lambda: fa.mha_bwd_dq_plain(*args, **kw), lib_bwd, 550),
        "flash_attention_bwd_fused": (
            lambda: fa.flash_bwd_fused(*args, span=span, **kw),
            lambda: fa.mha_bwd_fused_plain(*args, span=span, **kw),
            lib_bwd, 595),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(*args, **kw),
            lambda: fa.mha_bwd_dkv_plain(*args, **kw), lib_bwd, 628),
    }
    pairs = fa_pairs(s, s, True, 0)
    rows = {}
    for name, (kernel, plain, library_ms, line) in calls.items():
        kernel_ms = time_ms(kernel, flush, iters=30)
        plain_ms = time_ms(plain, flush, **plain_hold)
        bound_ms, bound_by, ops = fa_bound(name, b, s, hq, hk, d, 2, pairs)
        print(f"flash timing {name} b={b} s={s} h={hq} d={d} causal bf16: "
              f"kernel {kernel_ms:.4f} ms ({ops / kernel_ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
              f"{'forward' if 'fwd' in name else 'backward'} "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        rows[name] = dict(
            name=name, route="cuda", source=FA_SOURCE,
            replaces=f"{FA_FILE}:{line}",
            shape=f"b={b} s={s} hq={hq} hk={hk} d={d} causal bf16"
                  + (f" span={span}" if "fused" in name else ""),
            max_abs_err=errs[name], ms=kernel_ms, kernel_ms=kernel_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms)
    long_context_timing(rows, flush)
    return rows


# a long-context train shape: b 1, s 8192, 32 heads of 128, causal, bf16
LONG_SHAPE = dict(b=1, s=8192, hq=32, hk=32, d=128)


def long_context_timing(rows, flush):
    """Rows 7 and 9, the two-pass backward, timed where the default
    dispatch takes them: at ``LONG_SHAPE`` the default k block of 1024
    gives 8 kv blocks, more than the fused pass takes (``mha_backward``'s
    rule), so every long-context train step runs them in every layer.
    Beside them ``scaled_dot_product_attention``'s backward (a yardstick
    the port never calls); the plain versions are not timed here (their
    score tensors alone would be 8.6 GB)."""
    from paddle_tpu_torch.kernels import mha as fa

    t = LONG_SHAPE
    b, s, hq, hk, d = (t[x] for x in ("b", "s", "hq", "hk", "d"))
    k_blocks = -(-s // fa.fit_block(fa.DEFAULT_K_BLOCK, s))
    if k_blocks <= fa.FUSED_BWD_MAX_KB:
        raise AssertionError(f"s={s}: {k_blocks} kv blocks of the default "
                             "k block take the fused pass, not rows 7 and 9")
    q, k, v, do, _ = fa_inputs(b, s, hq, hk, d, torch.bfloat16, seed=71)
    o, lse = fa.flash_forward(q, k, v, with_lse=True, causal=True)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qh, kh, vh))
    out = sdpa(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), doh, retain_graph=True), flush, iters=20)
    pairs = fa_pairs(s, s, True, 0)
    two = 0.0
    for name, fn in (
            ("flash_attention_bwd_dq",
             lambda: fa.flash_bwd_dq(*args, causal=True)),
            ("flash_attention_bwd_dkv",
             lambda: fa.flash_bwd_dkv(*args, causal=True))):
        ms = time_ms(fn, flush, iters=20)
        bound_ms, bound_by, ops = fa_bound(name, b, s, hq, hk, d, 2, pairs)
        two += ms
        print(f"flash timing {name} b={b} s={s} h={hq} d={d} causal bf16 "
              f"({k_blocks} kv blocks of {fa.DEFAULT_K_BLOCK}: the default "
              f"dispatch's two-pass backward): kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s), sdpa backward {lib_bwd:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        rows[name].update(long_shape=f"b={b} s={s} hq={hq} hk={hk} d={d} "
                                     "causal bf16",
                          long_ms=ms, long_bound_ms=bound_ms,
                          long_library_ms=lib_bwd)
    print(f"flash timing two-pass backward (rows 7 + 9) b={b} s={s}: "
          f"{two:.4f} ms against sdpa backward {lib_bwd:.4f} ms", flush=True)


FLASH_TRAIN_ROWS = ("flash_attention_fwd_lse", "flash_attention_bwd_fused",
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")


def train_launches_want(n_steps, layers):
    """Launches of rows 5-9 in ``n_steps`` train steps of ``layers``
    layers at a sequence the fused backward takes (up to 4 k blocks):
    rows 6 and 8 once per layer a step, the rest never."""
    return {n: (n_steps * layers if n in FLASH_TRAIN_ROWS[:2] else 0)
            for n in FLASH_TRAIN_ROWS}


def card_and_cpu(make, seed):
    """A model built on the CPU by ``make(device, seed)`` and the same
    weights on the card."""
    from paddle_tpu_torch.convert import load_numpy_state_dict

    cpu = make("cpu", seed)
    card = make("cuda", 0)
    load_numpy_state_dict(card, {k: v.detach().numpy()
                                 for k, v in cpu.state_dict().items()})
    return cpu, card


def same_losses(label, card_losses, cpu_losses, tol=1e-4):
    """float32 both ways, the kernels' sums against the CPU's: five AdamW
    steps keep the losses within ``tol`` relative, and they fall."""
    gap = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    if not gap <= tol or not card_losses[-1] < card_losses[0]:
        raise AssertionError(f"{label}: card losses {card_losses}, CPU "
                             f"{cpu_losses} (rel gap {gap})")
    return gap


def tiny_train_pair(**cfg):
    """A tiny float32 Llama on the CPU and the same weights on the card."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    return card_and_cpu(lambda dev, seed: LlamaForCausalLM(
        LlamaConfig.tiny(**cfg), device=dev, seed=seed), 4)


def train_reference_phase():
    """A tiny float32 Llama (seq 128, so the kernel path is taken) trained
    5 steps on the card (kernels) and on the CPU (plain versions) from the
    same weights; the card's gradients with ``use_recompute`` against
    those without; a ``gradient_merge_k_steps=2`` step against one step
    over the whole batch."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.trainer import TrainStep

    ids = np.random.default_rng(6).integers(0, 256, (4, 128))
    batch = {"input_ids": ids, "labels": ids}

    def step(model, merge_k=1, epsilon=1e-8):
        strategy = DistributedStrategy(gradient_merge=merge_k > 1,
                                       gradient_merge_k_steps=merge_k)
        return TrainStep(model, topt.AdamW(
            learning_rate=1e-3, weight_decay=0.01, epsilon=epsilon,
            grad_clip=topt.ClipGradByGlobalNorm(1.0)), strategy=strategy)

    cpu, card = tiny_train_pair()
    layers = card.config.num_hidden_layers
    ts_card, ts_cpu = step(card), step(cpu)
    reset_launches()
    card_losses = [float(ts_card.run(batch)) for _ in range(5)]
    counts = read_launches()
    cpu_losses = [float(ts_cpu.run(batch)) for _ in range(5)]
    want = train_launches_want(5, layers)
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"train reference launches {counts}, want "
                             f"{want}")
    gap = same_losses("train reference", card_losses, cpu_losses)
    print(f"train reference: tiny float32 Llama, batch 4 x 128, 5 AdamW "
          f"steps: card {card_losses}, CPU {cpu_losses}, max rel gap "
          f"{gap:.3e} (tol 1e-4); launches {want}", flush=True)

    grads = {}
    for recompute in (False, True):
        _, model = tiny_train_pair(use_recompute=recompute)
        reset_launches()
        model(torch.as_tensor(ids, device="cuda"),
              torch.as_tensor(ids, device="cuda")).backward()
        fwd = read_launches()["flash_attention_fwd_lse"]
        if fwd != (2 if recompute else 1) * layers:
            raise AssertionError(f"recompute={recompute}: {fwd} forward "
                                 "launches")
        grads[recompute] = {n: p.grad for n, p in model.named_parameters()}
    worst = max(fa_err(grads[True][n], grads[False][n])[1]
                for n in grads[False])
    if not worst <= 1e-6:
        raise AssertionError(f"use_recompute changed the gradients by "
                             f"{worst}")
    print(f"train reference: use_recompute gradients equal those without "
          f"(max rel err {worst:.3e}, tol 1e-6); forward launches "
          f"{2 * layers} with it, {layers} without", flush=True)

    # epsilon 1e-2: Adam's normalised update would otherwise turn the two
    # sums' float32 rounding in a near-zero gradient into a step of its own
    _, whole = tiny_train_pair()
    _, merged = tiny_train_pair()
    lw = float(step(whole, epsilon=1e-2).run(batch))
    lm = float(step(merged, merge_k=2, epsilon=1e-2).run(batch))
    worst = max(fa_err(a, b)[0] for a, b in zip(merged.parameters(),
                                                whole.parameters()))
    if not (abs(lm - lw) <= 1e-5 * abs(lw) and worst <= 1e-5):
        raise AssertionError(f"gradient merge: loss {lm} vs {lw}, params "
                             f"differ by {worst}")
    print(f"train reference: gradient_merge_k_steps=2 equals one step over "
          f"the whole batch: loss {lm:.6f} vs {lw:.6f}, params within "
          f"{worst:.3e} (tol 1e-5)", flush=True)


def train_flops(cfg, b, s):
    """Model FLOPs of one train step: 6 * N * T for the N matmul weights
    (the layers' projections and the head; the embedding is a lookup) over
    T = b * s tokens, plus the attention products 3 * 4 * b * h * d * P
    per layer (forward once, backward twice) over the P = s(s+1)/2 causal
    pairs; recomputation not counted."""
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hk = cfg.num_attention_heads, cfg.num_key_value_heads
    per_layer = h * hq * d * 2 + h * hk * d * 2 + 3 * h * f
    n = cfg.num_hidden_layers * per_layer + h * cfg.vocab_size
    attn = 12 * b * hq * d * (s * (s + 1) // 2) * cfg.num_hidden_layers
    return 6 * n * b * s + attn, n


def train_steps(ts, batch, warmup=2, timed=5):
    """``warmup`` and ``timed`` steps of ``ts`` on one batch; the timed
    ones between reset_launches and read_launches, each timed by CUDA
    events. Returns the losses, the grad norms, the step ms, the launch
    counts and the peak GB of the timed steps."""
    losses, norms = [], []
    for _ in range(warmup):
        losses.append(float(ts.run(batch)))
        norms.append(float(ts.last_grad_norm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = ts.run(batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        norms.append(float(ts.last_grad_norm))
    counts = read_launches()
    return (losses, norms, step_ms, counts,
            torch.cuda.max_memory_allocated() / 1e9)



def profile_step(label, ts, batch, kernel_names, ranges=()):
    """Device time by operation of one train step (``torch.profiler``):
    the wall, the card's kernel time, the time of the kernels whose names
    contain one of ``kernel_names`` (in all and by name), the device time
    under each ``record_function`` range named in ``ranges``, and the
    heaviest operators and kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.run(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # a range also shows on the device's timeline, as the span from its
    # first kernel's start to its last one's end: not a kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    ours_ms = sum(dev_us(e) for e in kernels
                  if any(k in e.key for k in kernel_names)) / 1e3
    by_name = {k: round(sum(dev_us(e) for e in kernels if k in e.key) / 1e3,
                        3) for k in kernel_names}
    ops = sorted((e for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=dev_us, reverse=True)
    top = [(e.key[:60], round(dev_us(e) / 1e3, 3), e.count)
           for e in ops[:8]]
    top_kernels = [(e.key[:60], round(dev_us(e) / 1e3, 3), e.count)
                   for e in sorted(kernels, key=dev_us, reverse=True)[:8]]

    def total_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    by_range = {}
    for r in ranges:
        mine = [e for e in events if e.key == r]
        by_range[r] = dict(
            calls=sum(e.count for e in mine
                      if e.device_type != torch.autograd.DeviceType.CUDA),
            kernels_ms=sum(total_us(e) for e in mine if e.device_type
                           != torch.autograd.DeviceType.CUDA) / 1e3,
            span_ms=sum(dev_us(e) for e in mine if e.device_type
                        == torch.autograd.DeviceType.CUDA) / 1e3)
    print(f"profile {label} step: wall {wall_ms:.2f} ms, kernel time "
          f"{total_ms:.2f} ms, the port's kernels {kernel_names} "
          f"{ours_ms:.2f} ms {by_name}; ranges (calls, device time of the "
          f"kernels launched inside, device span) {by_range}; heaviest "
          f"operators (name, device ms, calls): "
          f"{top}; heaviest kernels: {top_kernels}", flush=True)
    return dict(wall_ms=wall_ms, device_ms=total_ms, kernels_ms=ours_ms,
                by_name_ms=by_name, ranges=by_range, top=top,
                top_kernels=top_kernels)


def train_7b_phase():
    """Llama-2-7B width cut to 4 layers, bf16 random weights from seed 0,
    trained as ``bench.py`` trains: AdamW (lr 3e-4, weight decay 0.01,
    float32 masters, global-norm clip 1.0), ``master_residency=
    "master_only"``, batch 4 x 2048 of one seeded batch with labels equal
    to the inputs. 2 warm-up and 5 timed steps with exact launch counts,
    one step with ``use_recompute``, one from the same weights with
    ``flash_attention_block_k=256`` (the two-pass backward), one
    ``no_grad`` eval forward, and a profile of one step. Returns the
    launch counts of rows 5-9, each from its own run, and the timed
    steps' first loss, median ms and peak GB."""
    from paddle_tpu_torch import flags

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    cfg = train_7b_config()
    print(f"train 7b: Llama-2-7B width (hidden 4096, intermediate 11008, "
          f"32 heads, 32 kv heads, d 128, vocab 32000) with depth cut from "
          f"32 to {cfg.num_hidden_layers} layers: the masters, moments and "
          f"gradients of all 32 under master_only (about 94 GB) exceed the "
          f"80 GB card", flush=True)
    t0 = time.perf_counter()
    model, ts, batch = train_7b_step(cfg)
    ids = batch["input_ids"]
    # master_only has released the bf16 copies: count the masters
    n_params = sum(m.numel() for m in ts.opt_state["master"].values())
    torch.cuda.synchronize()
    print(f"train 7b: {n_params} parameters, bf16 weights with float32 "
          f"masters and moments, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    layers = cfg.num_hidden_layers
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
    want = train_launches_want(5, layers)
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"train 7b launches {counts}, want {want}")
    if not (all(math.isfinite(x) for x in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train 7b: losses {losses}, grad norms "
                             f"{norms}")
    flops, n_matmul = train_flops(cfg, b, s)
    med_ms = float(np.median(step_ms))
    tokens_per_s = b * s / (med_ms / 1e3)
    mfu = flops / (med_ms / 1e3) / H100_BF16_FLOPS
    print(f"train 7b: 5 timed steps {[round(x, 3) for x in step_ms]} ms "
          f"(median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{tokens_per_s:.1f} tokens/s, MFU {mfu:.4f} = (6 * {n_matmul} "
          f"matmul weights * {b * s} tokens + 12 * b * h * d * s(s+1)/2 "
          f"attention per layer = {flops / 1e12:.2f} TFLOP) / step time / "
          f"989 TFLOP/s; peak {peak_gb:.2f} GB; losses {losses}; grad norms "
          f"{norms}; launches per 5 steps {want}", flush=True)

    # one step with use_recompute, and one from the same weights with the
    # two-pass backward
    masters = {n: m.clone() for n, m in ts.opt_state["master"].items()}
    model.config.use_recompute = True
    reset_launches()
    loss_a, norm_a = float(ts.run(batch)), float(ts.last_grad_norm)
    rec = read_launches()
    model.config.use_recompute = False
    if (rec["flash_attention_fwd_lse"], rec["flash_attention_bwd_fused"]) \
            != (2 * layers, layers):
        raise AssertionError(f"use_recompute step launches {rec}")
    for n, m in ts.opt_state["master"].items():
        m.copy_(masters[n])
    del masters
    flags.set_flags({"flash_attention_block_k": 256})
    try:
        reset_launches()
        loss_b, norm_b = float(ts.run(batch)), float(ts.last_grad_norm)
        two = read_launches()
        # the two-pass step timed as the fused one was: 2 warm-ups, then
        # the median of 3 (rows 7 and 9 once per layer a step)
        _, _, two_ms, two_timed, _ = train_steps(ts, batch, timed=3)
    finally:
        flags.set_flags({"flash_attention_block_k": 1024})
    want_two = {"flash_attention_fwd_lse": layers,
                "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers,
                "flash_attention_bwd_fused": 0, "flash_attention_fwd": 0}
    if {n: two[n] for n in want_two} != want_two:
        raise AssertionError(f"block_k=256 step launches {two}, want "
                             f"{want_two}")
    if {n: two_timed[n] for n in want_two} \
            != {n: 3 * c for n, c in want_two.items()}:
        raise AssertionError(f"block_k=256 timed steps launches "
                             f"{two_timed}, want 3 x {want_two}")
    two_med = float(np.median(two_ms))
    # the same weights and forward; the two backward passes differ only in
    # how dq sums (float32 span partials or one pass)
    if not (abs(loss_a - loss_b) <= 1e-3 * abs(loss_a)
            and abs(norm_a - norm_b) <= 1e-2 * abs(norm_a)):
        raise AssertionError(f"fused vs two-pass step: loss {loss_a} vs "
                             f"{loss_b}, grad norm {norm_a} vs {norm_b}")
    print(f"train 7b: use_recompute step launches {rec}; the two-pass step "
          f"(flash_attention_block_k=256) from the same weights: loss "
          f"{loss_b:.6f} vs {loss_a:.6f}, grad norm {norm_b:.6f} vs "
          f"{norm_a:.6f} (tol 1e-3 and 1e-2 relative); launches {want_two}",
          flush=True)
    print(f"train 7b: two-pass step (block_k=256, rows 7 and 9) "
          f"{[round(x, 3) for x in two_ms]} ms, median {two_med:.3f} ms, "
          f"against the fused step's median {med_ms:.3f} ms (CUDA events "
          f"around TrainStep.run, 2 warm-ups each)", flush=True)

    ts.sync_to_model()
    reset_launches()
    with torch.no_grad():
        logits = model(ids)
    evals = read_launches()
    if evals["flash_attention_fwd"] != layers \
            or evals["flash_attention_fwd_lse"] != 0 \
            or tuple(logits.shape) != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"eval forward: launches {evals}, logits "
                             f"{tuple(logits.shape)}")
    del logits
    print(f"train 7b: no_grad eval forward: {layers} launches of the "
          "forward without LSE, finite logits", flush=True)
    prof = profile_step("train 7b", ts, batch,
                        ("fwd_kernel", "dq_kernel", "dkv_kernel"))
    print(json.dumps({"train_7b": {
        "model": "llama2_7b width, 4 layers, random bf16 weights (seed 0)",
        "batch": b, "seq": s, "parameters": n_params,
        "step_ms": step_ms, "step_ms_median": med_ms,
        "tokens_per_s": tokens_per_s, "mfu": mfu,
        "model_tflop_per_step": flops / 1e12, "peak_memory_gb": peak_gb,
        "losses": losses, "grad_norms": norms,
        "two_pass_loss": loss_b, "two_pass_grad_norm": norm_b,
        "two_pass_step_ms": two_ms, "two_pass_step_ms_median": two_med,
        "profile": prof}}), flush=True)
    return ({"flash_attention_fwd": evals["flash_attention_fwd"],
             "flash_attention_fwd_lse": counts["flash_attention_fwd_lse"],
             "flash_attention_bwd_fused":
                 counts["flash_attention_bwd_fused"],
             "flash_attention_bwd_dq": two["flash_attention_bwd_dq"],
             "flash_attention_bwd_dkv": two["flash_attention_bwd_dkv"]},
            dict(first_loss=losses[0], step_ms_median=med_ms,
                 peak_gb=peak_gb))


def train_7b_config(**kw):
    """``train_7b_phase``'s configuration: Llama-2-7B width, 4 layers,
    bf16, sequences of ``TRAIN_SHAPE["s"]``."""
    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(
        LlamaConfig.llama2_7b(max_position_embeddings=TRAIN_SHAPE["s"],
                              dtype="bfloat16"),
        num_hidden_layers=4, **kw)


def train_7b_step(cfg, optimizer=None):
    """The seed-0 model of ``cfg`` on the card, its ``TrainStep`` under
    ``master_only`` (``optimizer``, by default ``bench.py``'s AdamW: lr
    3e-4, weight decay 0.01, float32 masters, global-norm clip 1.0) and
    one seeded batch of 4 x 2048 with labels equal to the inputs."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    if optimizer is None:
        optimizer = topt.AdamW(
            learning_rate=3e-4, weight_decay=0.01, multi_precision=True,
            grad_clip=topt.ClipGradByGlobalNorm(1.0))
    ts = TrainStep(model, optimizer, master_residency="master_only")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_SHAPE["b"], TRAIN_SHAPE["s"])),
        device="cuda")
    return model, ts, {"input_ids": ids, "labels": ids}


# ---------------------------------------------------------------------------
# the train step's optimizer surface: the chunked head loss, Lamb, every
# optimizer and scheduler, LBFGS, the incubate wrappers, attention dropout
# and the debug flags
# ---------------------------------------------------------------------------
def train_7b_fused_head_phase(unfused):
    """``train_7b_phase``'s configuration, weights, optimizer and batch
    with ``fused_head_loss_chunk=256``: the vocabulary head and the loss a
    256-position chunk at a time, never the [4, 2048, 32000] logits. 2
    warm-up and 5 timed steps: the first loss within 1e-2 relative of the
    unfused step's, losses finite and falling, exactly 5 x layers launches
    of rows 6 and 8, and a peak below the unfused step's (which holds the
    bf16 logits and their float32 log-softmax, about 1.5 GB, and their
    gradients). Returns the launch counts."""
    cfg = train_7b_config(fused_head_loss_chunk=256)
    _, ts, batch = train_7b_step(cfg)
    layers = cfg.num_hidden_layers
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
    want = train_launches_want(5, layers)
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"fused head loss launches {counts}, want "
                             f"{want}")
    gap = abs(losses[0] - unfused["first_loss"]) / abs(unfused["first_loss"])
    if not (gap <= 1e-2 and all(math.isfinite(x) for x in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"fused head loss: losses {losses} (unfused "
                             f"first {unfused['first_loss']}, rel gap "
                             f"{gap}), grad norms {norms}")
    if not peak_gb < unfused["peak_gb"]:
        raise AssertionError(f"fused head loss peak {peak_gb:.2f} GB, not "
                             f"below the unfused {unfused['peak_gb']:.2f}")
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    med_ms = float(np.median(step_ms))
    print(f"train 7b fused head loss (chunk 256): 5 timed steps "
          f"{[round(x, 3) for x in step_ms]} ms, median {med_ms:.3f} ms "
          f"(unfused {unfused['step_ms_median']:.3f}), "
          f"{b * s / (med_ms / 1e3):.1f} tokens/s; peak {peak_gb:.2f} GB "
          f"against the unfused step's {unfused['peak_gb']:.2f} GB; first "
          f"loss {losses[0]:.6f} against {unfused['first_loss']:.6f} (rel "
          f"gap {gap:.3e}, tol 1e-2); losses {losses}; launches per 5 steps "
          f"{want}; {nvidia_smi_line()}", flush=True)
    print(json.dumps({"train_7b_fused_head_loss": {
        "chunk": 256, "step_ms": step_ms, "step_ms_median": med_ms,
        "unfused_step_ms_median": unfused["step_ms_median"],
        "tokens_per_s": b * s / (med_ms / 1e3), "peak_memory_gb": peak_gb,
        "unfused_peak_memory_gb": unfused["peak_gb"], "losses": losses,
        "grad_norms": norms, "launches": want}}), flush=True)
    return {n: counts[n] for n in want}


def train_7b_lamb_phase():
    """``train_7b_phase``'s configuration, weights and batch trained 3
    steps with ``Lamb`` (lr 1e-2, decay 0.01 except the norms', float32
    masters, global-norm clip 1.0): per-parameter trust ratios, two norms
    over every weight a step. 1 warm-up and 2 timed steps; the losses are
    finite and fall."""
    from paddle_tpu_torch import optimizer as topt

    cfg = train_7b_config()
    lamb = topt.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                     multi_precision=True,
                     grad_clip=topt.ClipGradByGlobalNorm(1.0),
                     exclude_from_weight_decay_fn=lambda n: "norm" in n)
    _, ts, batch = train_7b_step(cfg, lamb)
    layers = cfg.num_hidden_layers
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch,
                                                          warmup=1, timed=2)
    want = train_launches_want(2, layers)
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"lamb launches {counts}, want {want}")
    if not (all(math.isfinite(x) for x in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"lamb: losses {losses}, grad norms {norms}")
    med_ms = float(np.median(step_ms))
    print(f"train 7b lamb: 2 timed steps {[round(x, 3) for x in step_ms]} "
          f"ms (median {med_ms:.3f} ms, after 1 warm-up), peak "
          f"{peak_gb:.2f} GB; losses {losses}; grad norms {norms}; "
          f"{nvidia_smi_line()}", flush=True)
    print(json.dumps({"train_7b_lamb": {
        "step_ms": step_ms, "step_ms_median": med_ms,
        "peak_memory_gb": peak_gb, "losses": losses,
        "grad_norms": norms}}), flush=True)


# each optimizer of the slice with one of the 17 schedulers, in turn:
# (optimizer, its arguments, the scheduler over the optimizer module)
OPTIMIZER_RUNS = [
    ("SGD", {}, lambda m: m.NoamDecay(d_model=64, warmup_steps=4,
                                      learning_rate=1.0)),
    ("Momentum", dict(momentum=0.9),
     lambda m: m.ExponentialDecay(0.02, gamma=0.9)),
    ("Adagrad", dict(initial_accumulator_value=0.1),
     lambda m: m.StepDecay(0.02, step_size=2, gamma=0.5)),
    ("Lamb", dict(exclude_from_weight_decay_fn=lambda n: "norm" in n),
     lambda m: m.PiecewiseDecay([2, 4], [0.01, 0.005, 0.002])),
    ("Lars", dict(lars_coeff=0.02, exclude_from_weight_decay=["norm"]),
     lambda m: m.MultiStepDecay(1.0, milestones=[2, 4], gamma=0.5)),
    ("RMSProp", dict(centered=True, momentum=0.5),
     lambda m: m.NaturalExpDecay(1e-3, gamma=0.1)),
    ("Adamax", {}, lambda m: m.InverseTimeDecay(5e-3, gamma=0.5)),
    ("Adadelta", {}, lambda m: m.LambdaDecay(1.0, lambda e: 0.9 ** e)),
    ("NAdam", {}, lambda m: m.MultiplicativeDecay(3e-3, lambda e: 0.9)),
    ("RAdam", {}, lambda m: m.OneCycleLR(max_learning_rate=1e-2,
                                         total_steps=10)),
    ("ASGD", dict(batch_num=3),
     lambda m: m.CyclicLR(0.01, 0.05, step_size_up=2)),
    ("Rprop", {}, lambda m: m.CosineAnnealingWarmRestarts(1e-3, T_0=2,
                                                          T_mult=2)),
    ("SGD", {}, lambda m: m.ConstantLR(0.05)),
    ("Momentum", dict(momentum=0.9, use_nesterov=True),
     lambda m: m.LinearWarmup(m.CosineAnnealingDecay(0.02, T_max=10),
                              warmup_steps=2, start_lr=0.0, end_lr=0.02)),
    ("Adagrad", {}, lambda m: m.CosineAnnealingDecay(0.02, T_max=8)),
    ("RMSProp", dict(momentum=0.9),
     lambda m: m.PolynomialDecay(1e-3, decay_steps=8, end_lr=1e-4)),
    ("Lamb", {}, lambda m: m.ReduceOnPlateau(0.01, patience=1)),
]


def optimizer_runs(device_models, batch):
    """Five ``TrainStep`` steps of every entry of ``OPTIMIZER_RUNS`` (the
    odd ones with ``fused_head_loss_chunk=32``) for each (label, make)
    of ``device_models``, ``make(fused)`` giving the model; returns the
    losses by run and label."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.trainer import TrainStep

    out = []
    for i, (kind, kw, sched) in enumerate(OPTIMIZER_RUNS):
        losses = {}
        for label, make in device_models:
            opt = getattr(topt, kind)(
                learning_rate=sched(topt),
                grad_clip=topt.ClipGradByGlobalNorm(1.0), **kw)
            ts = TrainStep(make(32 if i % 2 else 0), opt)
            losses[label] = [float(ts.run(batch)) for _ in range(5)]
        out.append(losses)
    return out


def lbfgs_losses(device, line_search):
    """Three ``LBFGS`` steps (4 inner iterations, history 5) on a 32-wide
    quartic-perturbed quadratic from seeded numpy; the closure calls
    ``backward()``. Returns the loss at the start and after each step, and
    the final point."""
    from paddle_tpu_torch import optimizer as topt

    rng = np.random.default_rng(21)
    a = rng.standard_normal((32, 32)).astype(np.float32)
    a = torch.tensor(a @ a.T / 32 + np.eye(32, dtype=np.float32),
                     device=device)
    b = torch.tensor(rng.standard_normal(32).astype(np.float32),
                     device=device)
    w = torch.nn.Parameter(torch.tensor(
        rng.standard_normal(32).astype(np.float32), device=device))
    opt = topt.LBFGS(learning_rate=1.0, max_iter=4, history_size=5,
                     line_search_fn=line_search, parameters=[w])

    def closure():
        opt.clear_grad()
        loss = 0.5 * w @ a @ w - b @ w + 0.05 * torch.sum(w ** 4)
        loss.backward()
        return loss

    losses = [float(closure().detach())]
    losses += [float(opt.step(closure)) for _ in range(3)]
    return losses, w.detach().cpu()


def wrapper_states(device):
    """``LookAhead(AdamW)`` (k 3), ``ModelAverage(SGD)`` (window 4) and
    ``EMA`` (warm-up decay) over 6 updates of seeded gradients on
    ``device``; returns every tensor of their states and parameters."""
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch import optimizer as topt

    rng = np.random.default_rng(22)
    start = {n: rng.standard_normal(shape).astype(np.float32)
             for n, shape in (("w", (64, 48)), ("b", (48,)))}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32)
              for n, v in start.items()} for _ in range(6)]
    out = {}
    wrappers = {
        "lookahead": incubate.LookAhead(topt.AdamW(
            learning_rate=1e-2, multi_precision=False), alpha=0.5, k=3),
        "model_average": incubate.ModelAverage(
            inner_optimizer=topt.SGD(learning_rate=0.05,
                                     multi_precision=False),
            max_average_window=4)}
    for label, wrapper in wrappers.items():
        p = {n: torch.tensor(v, device=device) for n, v in start.items()}
        st = wrapper.init(p)
        for g in grads:
            wrapper.update({n: torch.tensor(v, device=device)
                            for n, v in g.items()}, st, p)
        out[label] = {**{f"param {n}": v for n, v in p.items()},
                      **{f"slow {n}": v for n, v in st.get("slow",
                                                            {}).items()},
                      **{f"avg {n}": v for n, v in st.get("avg",
                                                           {}).items()}}
    ema = incubate.EMA(decay=0.99, thres_steps=True)
    p = {n: torch.tensor(v, device=device) for n, v in start.items()}
    st = ema.init(p)
    for g in grads:
        p = {n: v - 0.1 * torch.tensor(g[n], device=device)
             for n, v in p.items()}
        ema.update(st, p)
    out["ema"] = ema.apply(st, p)
    return out


def optimizers_reference_phase():
    """The slice's optimizer surface on the card against the CPU, float32:
    a tiny Llama (seq 128, so rows 6 and 8 are taken) trained 5 steps by
    each of the 12 optimizers beside Adam/AdamW, each run with one of the
    17 schedulers in turn and every other run with
    ``fused_head_loss_chunk=32``, from the same weights, within 1e-4
    relative and falling; ``LBFGS`` with and without the strong-Wolfe line
    search; ``LookAhead``, ``ModelAverage`` and ``EMA`` over 6 updates."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    ids = np.random.default_rng(23).integers(0, 256, (4, 128))
    batch = {"input_ids": ids, "labels": ids}
    cpu0 = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=4)
    weights = {k: v.detach().numpy() for k, v in cpu0.state_dict().items()}

    def maker(device):
        def make(chunk):
            model = LlamaForCausalLM(
                LlamaConfig.tiny(fused_head_loss_chunk=chunk),
                device=device, seed=0)
            return load_numpy_state_dict(model, weights)
        return make

    reset_launches()
    runs = optimizer_runs([("card", maker("cuda")), ("cpu", maker("cpu"))],
                          batch)
    counts = read_launches()
    layers = cpu0.config.num_hidden_layers
    want = train_launches_want(5 * len(OPTIMIZER_RUNS), layers)
    if {n: counts[n] for n in want} != want:
        raise AssertionError(f"optimizers reference launches {counts}, "
                             f"want {want}")
    gaps = []
    for (kind, _, sched), losses in zip(OPTIMIZER_RUNS, runs):
        label = f"{kind} + {type(sched(topt)).__name__}"
        gaps.append((label, same_losses(label, losses["card"],
                                        losses["cpu"])))
    print(f"optimizers reference: 17 runs of 5 TrainStep steps, tiny "
          f"float32 Llama, batch 4 x 128 (every other run with "
          f"fused_head_loss_chunk=32), card vs CPU max rel gap "
          f"{max(g for _, g in gaps):.3e} (tol 1e-4): "
          f"{[(n, f'{g:.1e}') for n, g in gaps]}; launches {want}",
          flush=True)

    for line_search in (None, "strong_wolfe"):
        (lc, wc), (lp, wp) = (lbfgs_losses(d, line_search)
                              for d in ("cuda", "cpu"))
        gap = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        werr = float((wc - wp).abs().max() / wp.abs().max())
        if not (gap <= 1e-4 and werr <= 1e-4 and lc[-1] < lc[0]):
            raise AssertionError(f"LBFGS {line_search}: card {lc}, CPU {lp}"
                                 f", point rel err {werr}")
        print(f"optimizers reference: LBFGS line_search={line_search}: "
              f"card losses {lc}, CPU {lp}, max rel gap {gap:.3e}, final "
              f"point rel err {werr:.3e} (tol 1e-4)", flush=True)

    card, cpu = wrapper_states("cuda"), wrapper_states("cpu")
    worst = 0.0
    for label in card:
        for n, t in card[label].items():
            ref = cpu[label][n]
            err = float((t.cpu() - ref).abs().max() / ref.abs().max())
            worst = max(worst, err)
            if not err <= 1e-5:
                raise AssertionError(f"{label} {n}: card vs CPU rel err "
                                     f"{err}")
    print(f"optimizers reference: LookAhead(AdamW) k 3, ModelAverage "
          f"window 4 and EMA over 6 updates, card vs CPU max rel err "
          f"{worst:.3e} (tol 1e-5)", flush=True)


def dropout_and_nan_phase():
    """Attention dropout on the card: ``flash_attention(dropout_p=0.1)``
    at a bf16 train-like shape with a causal window takes the plain SDPA
    (no flash kernel launched) and equals it given the same generator
    state, within bf16 tolerance; the same call without dropout launches
    row 5. Then the debug flags on a tiny Llama ``TrainStep``:
    ``PT_FLAGS_benchmark`` prints its step line, and a step after an inf
    is planted in one weight raises ``FloatingPointError`` under
    ``PT_FLAGS_check_nan_inf`` (the phase fails unless it does)."""
    import contextlib
    import io

    from paddle_tpu_torch import flags
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    from paddle_tpu_torch.trainer import TrainStep

    b, s, h, d, window = 2, 1024, 16, 64, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.float32).bfloat16() for _ in range(3))
    reset_launches()
    got = fa.flash_attention(q, k, v, causal=True, dropout_p=0.1,
                             window_size=window,
                             generator=torch.Generator(
                                 device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    launched = {n: c for n, c in read_launches().items()
                if n in FLASH_TRAIN_ROWS and c}
    i = torch.arange(s, device="cuda")
    band = ((i[:, None] - i[None, :]) < window)[None, None]
    want = scaled_dot_product_attention(
        q, k, v, attn_mask=band, dropout_p=0.1, is_causal=True,
        generator=torch.Generator(device="cuda").manual_seed(5))
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    reset_launches()
    plain = fa.flash_attention(q, k, v, causal=True, window_size=window,
                               dropout_p=0.1, training=False)
    rows = read_launches()
    changed = float((got != plain).float().mean())
    if launched or not err <= 1e-2 or rows["flash_attention_fwd"] != 1 \
            or got.shape != plain.shape or not changed > 0.5:
        raise AssertionError(f"dropout attention: launches {launched}, rel "
                             f"err {err} (tol 1e-2), eval launches {rows}, "
                             f"share changed by dropout {changed}")
    print(f"dropout: flash_attention(dropout_p=0.1) b={b} s={s} h={h} d={d} "
          f"causal window {window} bf16 on the card: plain SDPA, no flash "
          f"launch, max rel err {err:.3e} against SDPA from the same "
          f"generator state (tol 1e-2), {changed:.3f} of the outputs moved "
          f"by the dropout; without dropout one row-5 launch", flush=True)

    _, model = tiny_train_pair()
    ids = np.random.default_rng(24).integers(0, 256, (4, 128))
    batch = {"input_ids": ids, "labels": ids}
    ts = TrainStep(model, topt.AdamW(learning_rate=1e-3))
    out = io.StringIO()
    flags.set_flags({"benchmark": True})
    try:
        with contextlib.redirect_stdout(out):
            loss = float(ts.run(batch))
    finally:
        flags.set_flags({"benchmark": False})
    line = out.getvalue().strip()
    if not re.fullmatch(r"\[pt-benchmark\] step 1: \d+\.\d\d ms  "
                        r"loss=\S+  grad_norm=\S+", line) \
            or not math.isfinite(loss):
        raise AssertionError(f"benchmark line {line!r}, loss {loss}")
    with torch.no_grad():
        model.model.norm.weight[7] = float("inf")
    flags.set_flags({"check_nan_inf": True})
    try:
        ts.run(batch)
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("check_nan_inf did not raise on a step with "
                             "an inf weight")
    finally:
        flags.set_flags({"check_nan_inf": False})
    if "at step 2" not in message:
        raise AssertionError(f"check_nan_inf message {message!r}")
    print(f"debug flags on the card: {line!r}; the step after an inf weight "
          f"raised FloatingPointError({message!r})", flush=True)


# ---------------------------------------------------------------------------
# rows 10-11: the selective scan, and the Mamba train path
# ---------------------------------------------------------------------------
SCAN_FILE = "paddle_tpu/kernels/selective_scan.py"
SCAN_SOURCE = "paddle_tpu_torch/kernels/csrc/selective_scan.cu"
SCAN_KERNELS = ("selective_scan_fwd", "selective_scan_fwd_states",
                "selective_scan_bwd")
# the Mamba-130m train shape: batch 4 x seq 1024, d_inner 1536, 16 states
SCAN_SHAPE = dict(b=4, s=1024, d=1536, n=16, chunk=128)
SCAN_ROW_TOL = 1e-5  # float32 both ways: FMA contraction and expf only


def scan_inputs(b, s, d, n, seed):
    """Inputs of the scan as the Mamba mixer makes them: delta through a
    softplus, A = -exp(.) (negative), float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u, B, C = randn(b, s, d), randn(b, s, n), randn(b, s, n)
    delta = torch.nn.functional.softplus(randn(b, s, d) - 1.0)
    at = (-torch.exp(randn(d, n) * 0.5)).t().contiguous()
    return u, delta, B, C, at, randn(b, s, d)


def scan_check(name, b, s, d, n, chunk, seed):
    """Rows 10 (without and with states) and 11 against their plain
    versions, row by row (fa_row_err) within SCAN_ROW_TOL, through
    ``split_scan_*`` (over 16 states, one launch per block); the forward
    without states equal to the one with; returns the max abs errors."""
    from paddle_tpu_torch.kernels import selective_scan as ss

    u, delta, B, C, at, g = scan_inputs(b, s, d, n, seed)
    y0 = ss.split_scan_fwd(u, delta, B, C, at, chunk, False)
    y, h0s = ss.split_scan_fwd(u, delta, B, C, at, chunk, True)
    y_ref, h0s_ref = ss.selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                                 True)
    bwd = ss.split_scan_bwd(u, delta, B, C, at, h0s_ref, g, chunk)
    bwd_ref = ss.selective_scan_bwd_plain(u, delta, B, C, at, h0s_ref, g,
                                          chunk)
    torch.cuda.synchronize()
    pairs = {"y": (y, y_ref), "h0s": (h0s, h0s_ref)}
    pairs.update({k: (a, w) for k, a, w in zip(
        ("du", "ddelta", "dB", "dC", "dat"), bwd, bwd_ref)})
    errs = {k: fa_row_err(a, w) for k, (a, w) in pairs.items()}
    bad = [k for k, (rel, _) in errs.items()
           if not rel <= SCAN_ROW_TOL or not torch.isfinite(pairs[k][0]).all()]
    if bad or not torch.equal(y0, y):
        raise AssertionError(f"scan check {name}: {bad} differ from the "
                             f"plain versions ({errs}), or the forward "
                             "with and without states differ")
    print(f"scan check {name}: b={b} s={s} d={d} n={n} chunk={chunk}: row "
          f"err / max abs err " + ", ".join(
              f"{k} {r:.2e}/{e:.2e}" for k, (r, e) in errs.items())
          + f" (tol {SCAN_ROW_TOL} of a row) ok", flush=True)
    fwd = max(errs["y"][1], errs["h0s"][1])
    return {"selective_scan_fwd": errs["y"][1],
            "selective_scan_fwd_states": fwd,
            "selective_scan_bwd": max(errs[k][1] for k in (
                "du", "ddelta", "dB", "dC", "dat"))}


def scan_bound(name, b, s, d, n, chunk):
    """Least time for the function on these inputs: each input read once
    and each output written once (float32) over the HBM rate, against its
    float32 operations over the float32 rate (7 per (token, channel,
    state) forward and 1 per (token, channel); the backward recomputes the
    forward from h0s and does 15 more per (token, channel, state)); the
    larger of the two."""
    nc = -(-s // chunk)
    bsd, bsn, nd, states = b * s * d, b * s * n, n * d, b * nc * n * d
    nbytes, ops = {
        "selective_scan_fwd": (3 * bsd + 2 * bsn + nd, bsd * (7 * n + 1)),
        "selective_scan_fwd_states": (3 * bsd + 2 * bsn + nd + states,
                                      bsd * (7 * n + 1)),
        "selective_scan_bwd": (5 * bsd + 4 * bsn + 2 * nd + states,
                               bsd * (20 * n + 3)),
    }[name]
    t_bytes = 4 * nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


SCAN_BODIES = ("scan_fwd_kernel", "scan_bwd_kernel")
# b 1 x seq 8192 at the 130m widths: 48 channel tiles, time split over a
# cluster
SCAN_LONG = dict(b=1, s=8192, d=1536, n=16, chunk=128)
SCAN_WARPS = (4, 8, 16)  # one instantiation of each kernel per warp count


def scan_build_report(log):
    """The ptxas registers, stack frame and spills of rows 10-11's
    kernels, one instantiation per warp count, beside each one's dynamic
    shared memory."""
    from paddle_tpu_torch.kernels import selective_scan as ss

    pat = re.compile(r"Compiling entry function '\S*?(scan_fwd_kernel|"
                     r"scan_bwd_kernel)ILi(\d+)E\S*' for 'sm_90a'\n.*\n"
                     r"\s*(.*)\n(.*)\n")
    found = {}
    for m in pat.finditer(log):
        body, warps, frame, used = m.groups()
        regs = int(re.search(r"Used (\d+) registers", used).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", frame).group(1))
        found[(body, int(warps))] = (regs, spill)
        smem = ss._smem_bytes(int(warps), body == "scan_bwd_kernel")
        print(f"ptxas {body} W {warps}: {regs} registers, {frame.strip()}; "
              f"dynamic shared memory {smem} bytes", flush=True)
    want = {(k, w) for k in SCAN_BODIES for w in SCAN_WARPS}
    if set(found) != want:
        raise AssertionError(f"expected the ptxas lines of {sorted(want)}, "
                             f"found {sorted(found)}")
    return found


def sass_instructions(sass):
    """(address, text) of each instruction of one function's SASS
    (cuobjdump)."""
    return [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]


def sass_branch(text):
    """The target of a branch instruction, or None."""
    m = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?0x([0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def sass_loops(ins):
    """The loops of one function: for each backward branch, its span
    (lo, hi), the fewest instructions an iteration issues (the shortest
    path from lo to the branch, inner loops not taken, predicated
    instructions counted), and the MUFU.EX2 and SHFL in the span."""
    out = []
    for addr, text in ins:
        target = sass_branch(text)
        if target is None or target >= addr:
            continue
        body = [(a, t) for a, t in ins if target <= a <= addr]
        index = {a: i for i, (a, _) in enumerate(body)}
        dist = [math.inf] * len(body)
        dist[0] = 1
        for i, (a, t) in enumerate(body[:-1]):
            to = sass_branch(t)
            if not (t.startswith("BRA") or t.startswith("EXIT")):
                dist[i + 1] = min(dist[i + 1], dist[i] + 1)
            if to is not None and to > a and to in index:
                dist[index[to]] = min(dist[index[to]], dist[i] + 1)
        out.append(dict(span=(target, addr), issued=dist[-1],
                        ex2=sum("MUFU.EX2" in t for _, t in body),
                        shfl=sum("SHFL" in t for _, t in body)))
    return out


def scan_sass_report(obj, shapes):
    """The instruction-issue and MUFU floors of rows 10-11 from their
    SASS (cuobjdump of the scan unit's object ``obj``), at each shape's
    card plan: per kernel instantiation
    its state loops (one warp's 8 steps of one state, or of two for the
    pairs loops of the forward sweeps), each with the fewest instructions
    an iteration issues; the sweeps a launch runs (forward: its output
    sweep, and the range sweep on all ranks but the last; backward: the
    tile-state sweep, the main sweep, and the gh range sweep on all ranks
    but the first) times their iterations, over an SM issuing 4 warp
    instructions and 16 EX2 lanes a clock on every SM at the card's top
    clock. Returns the floors by (kernel, shape), or None where
    ``cuobjdump`` is missing."""
    from paddle_tpu_torch.kernels import _card
    from paddle_tpu_torch.kernels import selective_scan as ss

    tool = "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()[0])
    except (OSError, subprocess.SubprocessError) as err:
        print(f"sass scan: not measured ({err})", flush=True)
        return None
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    loops = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        m = re.search(r"(scan_fwd_kernel|scan_bwd_kernel)ILi(\d+)E", name)
        if m is None:
            continue
        found = [x for x in sass_loops(sass_instructions(body))
                 if x["ex2"] >= ss.SCAN_STEPS]
        # a state loop holds no other: keep the innermost of nested spans
        found = [x for x in found if not any(
            y is not x and x["span"][0] <= y["span"][0]
            and y["span"][1] <= x["span"][1] for y in found)]
        loops[(m.group(1), int(m.group(2)))] = found
        print(f"sass {m.group(1)} W {m.group(2)}: state loops (fewest "
              f"issued, MUFU.EX2, SHFL): "
              f"{[(x['issued'], x['ex2'], x['shfl']) for x in found]}",
              flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = _card.sm_count(dev)
    rate = sms * mhz * 1e6
    floors = {}
    for label, t in shapes.items():
        b, s, d, n, chunk = (t[x] for x in ("b", "s", "d", "n", "chunk"))
        for kernel in SCAN_BODIES:
            backward = kernel == "scan_bwd_kernel"
            plan = ss._card_plan(dev, b, s, d, n, chunk, backward)
            ctas = b * -(-d // 32) * plan.ranks
            steps = ctas * plan.warps * plan.tiles  # warp-tiles a sweep
            pairs = [x for x in loops[(kernel, plan.warps)]
                     if x["ex2"] == 2 * ss.SCAN_STEPS]
            singles = [x for x in loops[(kernel, plan.warps)]
                       if x["ex2"] == ss.SCAN_STEPS]
            share = (plan.ranks - 1) / plan.ranks  # ranks with a range scan
            if backward:  # phase F (pairs); main (shuffles); gh range scan
                sweeps = [(pairs[0], -(-n // 2), 1.0)] + [
                    (x, n, 1.0 if x["shfl"] else share) for x in singles]
            else:  # the output sweep is the larger pairs loop
                out, *rest = sorted(pairs, key=lambda x: -x["issued"])
                sweeps = [(out, -(-n // 2), 1.0)] + [
                    (x, -(-n // 2), share) for x in rest]
            issued = sum(x["issued"] * k * w for x, k, w in sweeps) * steps
            ex2 = sum(x["ex2"] * k * w for x, k, w in sweeps) * steps * 32
            issue_ms = issued / (4 * rate) * 1e3
            mufu_ms = ex2 / (16 * rate) * 1e3
            floors[(kernel, label)] = (issue_ms, mufu_ms)
            print(f"sass floor {kernel} {label} ({plan.warps} warps, "
                  f"{plan.ranks} ranks): issue {issue_ms:.4f} ms, MUFU "
                  f"{mufu_ms:.4f} ms at {mhz:.0f} MHz", flush=True)
    return floors


def scan_plan_report():
    """The card's launch plans for rows 10-11 at the train shape and at b
    1, s 8192: warps a CTA, ranks a cluster, the clusters the card holds
    at once, the grid's CTAs and the warps an SM holds on average."""
    from paddle_tpu_torch.kernels import _card
    from paddle_tpu_torch.kernels import selective_scan as ss

    dev = torch.device("cuda", torch.cuda.current_device())
    sms = _card.sm_count(dev)
    for label, t in (("train", SCAN_SHAPE), ("b1_s8192", SCAN_LONG)):
        b, s, d, n, chunk = (t[x] for x in ("b", "s", "d", "n", "chunk"))
        fit = ss._card_clusters(b, s, d, n, chunk)
        for backward in (False, True):
            plan = ss._card_plan(dev, b, s, d, n, chunk, backward)
            held = fit(plan, backward)
            grid = b * -(-d // ss.SCAN_LANES) * plan.ranks
            print(f"scan plan {label} {'bwd' if backward else 'fwd'}: "
                  f"{plan}; the card holds {held} clusters ({held * plan.ranks}"
                  f" CTAs) at once, the grid is {grid} CTAs: "
                  f"{ss.resident_warps(plan, b, d, held, sms):.2f} warps "
                  f"an SM ({sms} SMs)",
                  flush=True)


def scan_kernel_phase():
    """Rows 10-11 against their plain versions at the Mamba-130m train
    shape, a ragged s over several time tiles, d no multiple of the
    32-channel tile and d 33, n 8 and n 32 (two blocks of 16 states), a
    chunk of 100 and b 1, s 8192 (the time split over a cluster); then
    timed at the train shape beside their bounds and plain versions, and
    at b 1, s 8192 beside their bounds. No single PyTorch call computes
    the scan, so library_ms is None for these rows."""
    from paddle_tpu_torch.kernels import selective_scan as ss

    t = SCAN_SHAPE
    long = SCAN_LONG
    cases = [("mamba130m_train", t["b"], t["s"], t["d"], t["n"], t["chunk"]),
             ("ragged_s1000", 2, 1000, 1536, 16, 128),
             ("d200", 2, 512, 200, 16, 128),
             ("n8", 2, 512, 512, 8, 128),
             # a state size over the kernels' 16: two blocks of 16
             ("n32", 2, 512, 512, 32, 128),
             ("ragged_s1063", 2, 1063, 1536, 16, 128),
             ("chunk100", 2, 512, 256, 16, 100),
             ("d33", 2, 256, 33, 16, 64),
             ("b1_s8192", *(long[x] for x in ("b", "s", "d", "n", "chunk")))]
    errs = {}
    for i, case in enumerate(cases):
        for k, e in scan_check(*case, seed=80 + i).items():
            errs[k] = max(errs.get(k, 0.0), e)
    scan_plan_report()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = {}
    for label, shape in (("train", t), ("b1_s8192", long)):
        b, s, d, n, chunk = (shape[x] for x in ("b", "s", "d", "n", "chunk"))
        u, delta, B, C, at, g = scan_inputs(b, s, d, n, seed=90)
        _, h0s = ss.selective_scan_fwd(u, delta, B, C, at, chunk, True)
        calls = {
            "selective_scan_fwd": (
                lambda: ss.selective_scan_fwd(u, delta, B, C, at, chunk,
                                              False),
                lambda: ss.selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                                    False), 122),
            "selective_scan_fwd_states": (
                lambda: ss.selective_scan_fwd(u, delta, B, C, at, chunk,
                                              True),
                lambda: ss.selective_scan_fwd_plain(u, delta, B, C, at, chunk,
                                                    True), 129),
            "selective_scan_bwd": (
                lambda: ss.selective_scan_bwd(u, delta, B, C, at, h0s, g,
                                              chunk),
                lambda: ss.selective_scan_bwd_plain(u, delta, B, C, at, h0s, g,
                                                    chunk), 258),
        }
        for name, (kernel, plain, line) in calls.items():
            kernel_ms = time_ms(kernel, flush, iters=30)
            bound_ms, bound_by = scan_bound(name, b, s, d, n, chunk)
            if label != "train":
                print(f"scan timing {name} b={b} s={s} d={d} n={n} "
                      f"chunk={chunk}: kernel {kernel_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by})", flush=True)
                rows[name][f"{label}_ms"] = kernel_ms
                rows[name][f"{label}_bound_ms"] = bound_ms
                continue
            # the plain versions launch about 12,000 (forward) and 40,000
            # (backward) small kernels a call, more than the launch queue
            # holds behind a spin: timed without one, host enqueueing
            # included
            plain_ms = time_ms(plain, flush, iters=3, warmup=1, hold=0)
            print(f"scan timing {name} b={b} s={s} d={d} n={n} "
                  f"chunk={chunk}: kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (events around the call, no spin), "
                  f"bound {bound_ms:.4f} ms ({bound_by}); no library call "
                  "computes the scan", flush=True)
            rows[name] = dict(
                name=name, route="cuda", source=SCAN_SOURCE,
                replaces=f"{SCAN_FILE}:{line}",
                shape=f"b={b} s={s} d={d} n={n} chunk={chunk} float32",
                max_abs_err=errs[name], ms=kernel_ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)
        del u, delta, B, C, at, g, h0s
    return rows


def check_counts(label, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label} launches {got}, want {want}")


def mamba_reference_phase():
    """A tiny float32 Mamba (chunked scan, chunk 32, batch 4 x 128) trains
    5 AdamW steps on the card (rows 10-11) and on the CPU (their plain
    versions) from the same weights: the same losses."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    cfg = MambaConfig.tiny(use_chunked_scan=True, scan_chunk=32)
    cpu, card = card_and_cpu(
        lambda dev, seed: MambaForCausalLM(cfg, device=dev, seed=seed), 4)
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 128))
    batch = {"input_ids": ids, "labels": ids}

    def step(model):
        return TrainStep(model, topt.AdamW(learning_rate=1e-3,
                                           weight_decay=0.01))

    ts_card, ts_cpu = step(card), step(cpu)
    reset_launches()
    card_losses = [float(ts_card.run(batch)) for _ in range(5)]
    counts = read_launches()
    cpu_losses = [float(ts_cpu.run(batch)) for _ in range(5)]
    layers = cfg.num_hidden_layers
    want = {"selective_scan_fwd_states": 5 * layers,
            "selective_scan_bwd": 5 * layers, "selective_scan_fwd": 0}
    check_counts("mamba reference", counts, want)
    gap = same_losses("mamba reference", card_losses, cpu_losses)
    print(f"mamba reference: tiny float32 Mamba, chunk 32, batch 4 x 128, 5 "
          f"AdamW steps: card {card_losses}, CPU {cpu_losses}, max rel gap "
          f"{gap:.3e} (tol 1e-4); launches {want}", flush=True)


class UNetLoss(torch.nn.Module):
    """``benchmarks/suite.py: bench_unet``'s adapter: the denoising MSE of
    the UNet's prediction against ``target``, in float32."""

    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, sample, timestep, context, target):
        pred = self.unet(sample, timestep, context)
        return (pred.float() - target.float()).square().mean()


def unet_reference_phase():
    """A tiny float32 UNet with ``channels_last=True`` on both sides trains
    5 AdamW steps on the card (rows 12-13, cuDNN convolutions without
    TF32) and on the CPU (their plain versions) from the same weights: the
    same losses."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                         unet_gn_sites)
    from paddle_tpu_torch.trainer import TrainStep

    cfg = UNetConfig.tiny(channels_last=True)
    cpu, card = card_and_cpu(lambda dev, seed: UNetLoss(
        UNet2DConditionModel(cfg, device=dev, seed=seed)), 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    batch = {"sample": x, "timestep": rng.integers(0, 1000, (2,)),
             "context": rng.standard_normal(
                 (2, 7, cfg.cross_attention_dim)).astype(np.float32),
             "target": x}

    def step(model):
        return TrainStep(model, topt.AdamW(learning_rate=1e-3,
                                           weight_decay=0.01))

    ts_card, ts_cpu = step(card), step(cpu)
    reset_launches()
    card_losses = [float(ts_card.run(batch)) for _ in range(5)]
    counts = read_launches()
    cpu_losses = [float(ts_cpu.run(batch)) for _ in range(5)]
    per_step = len(unet_gn_sites(cfg, 16))
    want = {"group_norm_fwd": 5 * per_step, "group_norm_bwd": 5 * per_step}
    check_counts("unet reference", counts, want)
    gap = same_losses("unet reference", card_losses, cpu_losses)
    print(f"unet reference: tiny float32 UNet, channels_last, batch 2 x 4 x "
          f"16 x 16, 5 AdamW steps: card {card_losses}, CPU {cpu_losses}, "
          f"max rel gap {gap:.3e} (tol 1e-4); launches {want}", flush=True)


def mamba_train_phase():
    """``bench_mamba``'s train step at the published Mamba-130m widths
    (``MambaConfig(use_chunked_scan=True)`` defaults: 24 layers, hidden
    768, d_inner 1536, 16 states, vocab 50277), float32 random weights
    from seed 0, batch 4 x 1024 seeded tokens with labels equal to the
    inputs, ``TrainStep(model, AdamW(1e-4, multi_precision=True))``: 2
    warm-up and 5 timed steps (24 launches of row 10 with states and 24
    of row 11 each), one ``no_grad`` eval forward (24 of row 10 without
    states), a profile of one step. Returns the launch counts and the
    median step ms."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    b, s = SCAN_SHAPE["b"], SCAN_SHAPE["s"]
    cfg = MambaConfig(use_chunked_scan=True)
    t0 = time.perf_counter()
    model = MambaForCausalLM(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True))
    torch.cuda.synchronize()
    print(f"mamba 130m: {n_params} parameters, float32, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    losses, _, step_ms, counts, peak_gb = train_steps(ts, batch)
    layers = cfg.num_hidden_layers
    check_counts("mamba 130m", counts, {
        "selective_scan_fwd_states": 5 * layers,
        "selective_scan_bwd": 5 * layers, "selective_scan_fwd": 0})
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"mamba 130m: losses {losses}")
    med_ms = float(np.median(step_ms))
    tokens_per_s = b * s / (med_ms / 1e3)
    print(f"mamba 130m: 5 timed steps {[round(x, 3) for x in step_ms]} ms "
          f"(median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{tokens_per_s:.1f} tokens/s, peak {peak_gb:.2f} GB; losses "
          f"{losses}; launches per 5 steps: {5 * layers} of row 10 with "
          f"states and of row 11", flush=True)
    reset_launches()
    with torch.no_grad():
        logits = model(ids)
    evals = read_launches()
    check_counts("mamba 130m eval forward", evals, {
        "selective_scan_fwd": layers, "selective_scan_fwd_states": 0,
        "selective_scan_bwd": 0})
    if tuple(logits.shape) != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"mamba 130m eval logits {tuple(logits.shape)}")
    del logits
    print(f"mamba 130m: no_grad eval forward: {layers} launches of row 10 "
          "without states, finite logits", flush=True)
    # rows 10 (with states) and 11 summed over the step, by kernel
    prof = profile_step("mamba 130m", ts, batch, SCAN_BODIES)
    print(json.dumps({"train_mamba130m": {
        "model": "mamba-130m widths, 24 layers, random float32 weights "
                 "(seed 0)", "batch": b, "seq": s, "parameters": n_params,
        "step_ms": step_ms, "step_ms_median": med_ms,
        "tokens_per_s": tokens_per_s, "peak_memory_gb": peak_gb,
        "losses": losses, "profile": prof}}), flush=True)
    return ({"selective_scan_fwd": evals["selective_scan_fwd"],
             "selective_scan_fwd_states": counts["selective_scan_fwd_states"],
             "selective_scan_bwd": counts["selective_scan_bwd"]}, med_ms)


# ---------------------------------------------------------------------------
# QAT and PTQ: Mamba through FakeQuant (rows 10-11), converted (rows 4, 10)
# ---------------------------------------------------------------------------
def amax_values(model):
    return {k: float(v) for k, v in model.state_dict().items()
            if k.endswith("amax")}


def qat_reference_phase():
    """A tiny float32 QAT Mamba (``MambaConfig.tiny(use_chunked_scan=True)``,
    chunk 128, batch 4 x 128) with the same weights on the card (rows
    10-11) and on the CPU (their plain versions): 5 AdamW ``TrainStep``
    steps with the same losses and ``amax`` buffers (rel 1e-4); then both
    converted from the card's trained state by ``QAT.convert`` int4: the
    eval logits through rows 4 and 10 against the plain versions (rtol and
    atol 1e-5, as ``tests/test_torch_quant.py``); PTQ with AbsmaxObserver
    on fresh models, 2 calibration batches, converted int8: the
    ``act_scale`` of every layer equal on both sides (rel 1e-5)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.convert import load_numpy_state_dict
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    cfg = MambaConfig.tiny(use_chunked_scan=True)
    layers = cfg.num_hidden_layers
    cpu, card = card_and_cpu(lambda dev, seed: Q.QAT(Q.QuantConfig())
                             .quantize(MambaForCausalLM(cfg, device=dev,
                                                        seed=seed)), 4)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, (4, 128))
    batch = {"input_ids": ids, "labels": ids}

    def step(model):
        return TrainStep(model, topt.AdamW(learning_rate=1e-3,
                                           weight_decay=0.01))

    ts_card, ts_cpu = step(card), step(cpu)
    reset_launches()
    card_losses = [float(ts_card.run(batch)) for _ in range(5)]
    counts = read_launches()
    cpu_losses = [float(ts_cpu.run(batch)) for _ in range(5)]
    check_counts("qat reference", counts, {
        "selective_scan_fwd_states": 5 * layers,
        "selective_scan_bwd": 5 * layers, "selective_scan_fwd": 0,
        "weight_only_matmul": 0})
    gap = same_losses("qat reference", card_losses, cpu_losses)
    amax_card, amax_cpu = amax_values(card), amax_values(cpu)
    amax_gap = max(abs(amax_card[k] - v) / abs(v)
                   for k, v in amax_cpu.items())
    if len(amax_card) != 8 * layers or not amax_gap <= 1e-4 \
            or any(v == 1.0 for v in amax_card.values()):
        raise AssertionError(f"qat reference amax: card {amax_card}, CPU "
                             f"{amax_cpu} (rel gap {amax_gap})")
    print(f"qat reference: tiny float32 QAT Mamba ({8 * layers} FakeQuant), "
          f"batch 4 x 128, 5 AdamW steps: card {card_losses}, CPU "
          f"{cpu_losses}, max rel gap {gap:.3e} (tol 1e-4); amax max rel "
          f"gap {amax_gap:.3e} (tol 1e-4); launches "
          f"{counts['selective_scan_fwd_states']} of row 10 with states and "
          f"of row 11", flush=True)

    # convert the same trained state on both sides
    load_numpy_state_dict(cpu, {k: v.detach().cpu().numpy()
                                for k, v in card.state_dict().items()})
    qat = Q.QAT(Q.QuantConfig())
    card = qat.convert(card.eval(), weight_dtype="int4")
    cpu = qat.convert(cpu.eval(), weight_dtype="int4")
    reset_launches()
    with torch.no_grad():
        got = card(torch.as_tensor(ids, device="cuda"))
    counts = read_launches()
    with torch.no_grad():
        want = cpu(torch.as_tensor(ids))
    check_counts("qat reference converted", counts, {
        "weight_only_matmul": 4 * layers, "selective_scan_fwd": layers,
        "selective_scan_fwd_states": 0, "selective_scan_bwd": 0})
    err = (got.cpu() - want).abs()
    worst = float((err - 1e-5 * want.abs()).max())
    if not (torch.isfinite(got).all() and worst <= 1e-5):
        raise AssertionError(f"qat reference converted int4 logits: max abs "
                             f"err {float(err.max())}")
    print(f"qat reference: QAT.convert int4 eval logits, card (rows 4 and "
          f"10: {counts['weight_only_matmul']} and "
          f"{counts['selective_scan_fwd']} launches) vs CPU plain: max abs "
          f"err {float(err.max()):.3e} (rtol and atol 1e-5)", flush=True)

    cpu, card = card_and_cpu(lambda dev, seed: Q.PTQ().quantize(
        MambaForCausalLM(cfg, device=dev, seed=seed)), 5)
    calib = [rng.integers(0, cfg.vocab_size, (4, 128)) for _ in range(2)]
    with torch.no_grad():
        for c in calib:
            card(torch.as_tensor(c, device="cuda"))
            cpu(torch.as_tensor(c))
    scales = []
    for model in (card, cpu):
        Q.PTQ().convert(model)
        scales.append([float(m.act_scale) for m in model.sublayers()
                       if isinstance(m, Q.WeightOnlyLinear)])
    scale_gap = max(abs(a - b) / b for a, b in zip(*scales))
    reset_launches()
    with torch.no_grad():
        out = card(torch.as_tensor(ids, device="cuda"))
    ptq_counts = read_launches()
    if len(scales[0]) != 4 * layers or not scale_gap <= 1e-5 \
            or min(scales[0]) <= 0 or not torch.isfinite(out).all() \
            or ptq_counts["weight_only_matmul"] != 0:
        raise AssertionError(f"ptq reference: act_scale card {scales[0]}, "
                             f"CPU {scales[1]} (rel gap {scale_gap}); "
                             f"launches {ptq_counts}")
    print(f"qat reference: PTQ AbsmaxObserver, 2 calibration batches, int8 "
          f"per channel (a plain product, no row-4 launch): "
          f"{len(scales[0])} act_scale, card vs CPU max rel gap "
          f"{scale_gap:.3e} (tol 1e-5)", flush=True)


def qat_mamba_phase(plain_ms):
    """``mamba_train_phase``'s configuration (Mamba-130m widths, float32,
    seed 0, batch 4 x 1024, ``AdamW(1e-4, multi_precision=True)``) made QAT
    by ``QAT(QuantConfig()).quantize``: 96 QuantedLinear, 192 FakeQuant; 2
    warm-up and 5 timed steps (24 launches of row 10 with states and 24 of
    row 11 each; losses finite and falling; step ms beside the plain
    step's ``plain_ms`` from this run), a profile of one step with a range
    around each quanter (FakeQuant's device time), ``eval()`` with every
    ``amax`` finite and moved from 1.0; ``QAT.convert`` int4 and a
    ``no_grad`` forward of the same batch (24 launches of row 10 without
    states, 96 of row 4, finite logits), and the share of next-token
    argmaxes equal to the fake-quant eval forward's (reported); PTQ of a
    fresh model over 2 calibration batches, int8. Returns row 4's launches
    in the converted forward."""
    from torch.profiler import record_function

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    b, s = SCAN_SHAPE["b"], SCAN_SHAPE["s"]
    cfg = MambaConfig(use_chunked_scan=True)
    layers = cfg.num_hidden_layers
    model = Q.QAT(Q.QuantConfig()).quantize(
        MambaForCausalLM(cfg, device="cuda", seed=0))
    n_quanted = sum(isinstance(m, Q.QuantedLinear) for m in model.sublayers())
    quanters = [m for m in model.sublayers() if isinstance(m, Q.FakeQuant)]
    if (n_quanted, len(quanters)) != (4 * layers, 8 * layers):
        raise AssertionError(f"qat mamba 130m: {n_quanted} QuantedLinear, "
                             f"{len(quanters)} FakeQuant")
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True))
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                          device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    losses, _, step_ms, counts, peak_gb = train_steps(ts, batch)
    check_counts("qat mamba 130m", counts, {
        "selective_scan_fwd_states": 5 * layers,
        "selective_scan_bwd": 5 * layers, "selective_scan_fwd": 0,
        "weight_only_matmul": 0})
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"qat mamba 130m: losses {losses}")
    med_ms = float(np.median(step_ms))
    tokens_per_s = b * s / (med_ms / 1e3)
    print(f"qat mamba 130m: {n_quanted} QuantedLinear, {len(quanters)} "
          f"FakeQuant; 5 timed steps {[round(x, 3) for x in step_ms]} ms "
          f"(median {med_ms:.3f} ms against the plain step's {plain_ms:.3f} "
          f"ms in this run, {med_ms - plain_ms:+.3f} ms), {tokens_per_s:.1f} "
          f"tokens/s, peak {peak_gb:.2f} GB; losses {losses}; launches per "
          f"5 steps: {5 * layers} of row 10 with states and of row 11",
          flush=True)

    ranges = {}

    def enter(layer, args):
        ranges[id(layer)] = record_function("fake_quant")
        ranges[id(layer)].__enter__()

    def leave(layer, args, out):
        ranges.pop(id(layer)).__exit__(None, None, None)

    handles = [h for q in quanters
               for h in (q.register_forward_pre_hook(enter),
                         q.register_forward_post_hook(leave))]
    try:
        prof = profile_step("qat mamba 130m", ts, batch, SCAN_BODIES,
                            ranges=("fake_quant",))
    finally:
        for h in handles:
            h.remove()
    del ts
    torch.cuda.empty_cache()

    model.eval()
    amax = amax_values(model)
    if len(amax) != 8 * layers or not all(
            math.isfinite(v) and v != 1.0 for v in amax.values()):
        raise AssertionError(f"qat mamba 130m amax after training: {amax}")
    with torch.no_grad():
        fq_next = model(ids).argmax(-1)
    Q.QAT(Q.QuantConfig()).convert(model, weight_dtype="int4")
    reset_launches()
    with torch.no_grad():
        logits = model(ids)
    evals = read_launches()
    check_counts("qat mamba 130m converted forward", evals, {
        "weight_only_matmul": 4 * layers, "selective_scan_fwd": layers,
        "selective_scan_fwd_states": 0, "selective_scan_bwd": 0})
    if tuple(logits.shape) != (b, s, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"qat mamba 130m converted logits "
                             f"{tuple(logits.shape)}")
    agree = float((logits.argmax(-1) == fq_next).float().mean())
    del logits, fq_next, model
    torch.cuda.empty_cache()
    print(f"qat mamba 130m: eval amax {min(amax.values()):.4f}.."
          f"{max(amax.values()):.4f} (none left at 1.0); QAT.convert int4: "
          f"{evals['weight_only_matmul']} launches of row 4 (float32 x) and "
          f"{evals['selective_scan_fwd']} of row 10 without states, finite "
          f"logits; next-token argmax equal to the fake-quant eval forward's "
          f"at {agree:.4f} of {b * s} positions (reported, not gated)",
          flush=True)

    fresh = Q.PTQ().quantize(MambaForCausalLM(cfg, device="cuda", seed=0))
    with torch.no_grad():
        for _ in range(2):
            fresh(torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                  device="cuda"))
    Q.PTQ().convert(fresh)
    scales = [float(m.act_scale) for m in fresh.sublayers()
              if isinstance(m, Q.WeightOnlyLinear)]
    reset_launches()
    with torch.no_grad():
        ptq_ok = bool(torch.isfinite(fresh(ids)).all())
    ptq_counts = read_launches()
    if len(scales) != 4 * layers or min(scales) <= 0 or not ptq_ok \
            or ptq_counts["weight_only_matmul"] != 0:
        raise AssertionError(f"ptq mamba 130m: act_scale {scales}, finite "
                             f"{ptq_ok}, launches {ptq_counts}")
    del fresh
    torch.cuda.empty_cache()
    print(f"qat mamba 130m: PTQ over 2 calibration batches, int8 per "
          f"channel: {len(scales)} act_scale {min(scales):.4e}.."
          f"{max(scales):.4e}, finite logits, no row-4 launch", flush=True)
    print(json.dumps({"qat_mamba130m": {
        "model": "mamba-130m widths, 24 layers, random float32 weights "
                 "(seed 0), QAT(QuantConfig())", "batch": b, "seq": s,
        "quanted_linears": n_quanted, "fake_quants": len(quanters),
        "step_ms": step_ms, "step_ms_median": med_ms,
        "plain_step_ms_median": plain_ms, "tokens_per_s": tokens_per_s,
        "peak_memory_gb": peak_gb, "losses": losses, "profile": prof,
        "amax_min": min(amax.values()), "amax_max": max(amax.values()),
        "converted_launches": {k: evals[k] for k in (
            "weight_only_matmul", "selective_scan_fwd")},
        "argmax_agreement": agree,
        "ptq_act_scale_min": min(scales),
        "ptq_act_scale_max": max(scales)}}), flush=True)
    return evals["weight_only_matmul"]


# ---------------------------------------------------------------------------
# rows 12-13: the fused GroupNorm, and the SD-UNet train path
# ---------------------------------------------------------------------------
GN_FILE = "paddle_tpu/kernels/group_norm.py"
GN_SOURCE = "paddle_tpu_torch/kernels/csrc/group_norm.cu"
GN_KERNELS = ("group_norm_fwd", "group_norm_bwd")
# the serving runs launch none of the train kernels (rows 5-13)
NO_TRAIN_KERNELS = dict.fromkeys(FLASH_KERNELS + SCAN_KERNELS + GN_KERNELS,
                                 0)
UNET_BATCH, UNET_SIZE = 4, 32  # bench_unet: UNetConfig(sample_size=32)
# the outputs in x's dtype within one rounding of the same float32 value
# (bf16 2^-7 relative: one ulp; float32: the sums' order), over a floor
# of 1e-5 of the largest value; mean/rstd and the dgamma/dbeta partials
# within 1e-5 of the largest value
GN_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def gn_err(got, want, rtol):
    """(worst |got - want| over rtol |want| + 1e-5 max|want|, max abs err):
    the first at most 1 passes."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    allowed = rtol * w.abs() + 1e-5 * w.abs().max()
    return (diff / allowed.clamp_min(1e-30)).max().item(), diff.max().item()


def gn_inputs(n, hw, c, dtype, seed, offset=0):
    """x, dy [n, hw, c] in dtype (contiguous views ``offset`` elements into
    their storage), gamma and beta [c] float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def view(t):
        if not offset:
            return t.to(dtype)
        buf = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(t.shape)

    x = view(torch.randn((n, hw, c), generator=gen, device="cuda") * 2 + 0.5)
    dy = view(torch.randn((n, hw, c), generator=gen, device="cuda"))
    gamma = 1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x, dy, gamma, beta


def gn_dx_f64(x, dy, gamma, beta, mean, rstd, g, act):
    """dx = rstd (dxhat - m1 - xhat m2) in float64 from the same inputs and
    saved statistics, and the size of the terms it is the difference of,
    rstd (|dxhat| + |m1| + |xhat m2|)."""
    n, hw, c = x.shape
    cg, f = c // g, torch.float64

    def per_channel(v):
        return v.repeat_interleave(cg, dim=1)[:, None, :]

    def group_mean(v):
        return v.sum(dim=1).reshape(n, g, cg).sum(dim=-1) / (hw * cg)

    rs = per_channel(rstd.to(f))
    xh = (x.to(f) - per_channel(mean.to(f))) * rs
    ga, be, dz = gamma.to(f), beta.to(f), dy.to(f)
    if act == "silu":
        z = xh * ga + be
        sg = torch.sigmoid(z)
        dz = dz * (sg * (1 + z * (1 - sg)))
    dxh = dz * ga
    m1 = per_channel(group_mean(dxh))
    xm2 = xh * per_channel(group_mean(dxh * xh))
    return rs * (dxh - m1 - xm2), rs * (dxh.abs() + m1.abs() + xm2.abs())


def gn_check(n, hw, c, g, dtype, act, seed, offset=0, cancel=False):
    """Rows 12 and 13 against their plain versions on one input set, the
    backward twice with identical results; returns the max abs errors
    (outputs, statistics and partials) and the worst error over its
    allowance. With ``cancel`` (groups of two elements on one pixel, where
    xhat is +-(1 - O(eps)) and dx the near-total cancellation of terms of
    the size of dxhat) dx is held, the kernel's and the plain version's
    alike, against float64 within the tolerance of the terms' size
    (``gn_dx_f64``) instead of the plain version's value."""
    from paddle_tpu_torch.kernels import group_norm as gn

    x, dy, gamma, beta = gn_inputs(n, hw, c, dtype, seed, offset)
    y, mean, rstd = gn.group_norm_fwd(x, gamma, beta, g, 1e-5, act)
    y_r, mean_r, rstd_r = gn.group_norm_fwd_plain(x, gamma, beta, g, 1e-5,
                                                  act)
    bwd = gn.group_norm_bwd(x, dy, gamma, beta, mean_r, rstd_r, g, act)
    bwd_r = gn.group_norm_bwd_plain(x, dy, gamma, beta, mean_r, rstd_r, g,
                                    act)
    again = gn.group_norm_bwd(x, dy, gamma, beta, mean_r, rstd_r, g, act)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(bwd, again)):
        raise AssertionError(f"group norm backward n={n} hw={hw} c={c} "
                             f"{dtype} {act}: two runs differ")
    rt = GN_RTOL[dtype]
    errs = {"y": gn_err(y, y_r, rt), "mean": gn_err(mean, mean_r, 0.0),
            "rstd": gn_err(rstd, rstd_r, 0.0),
            "dx": gn_err(bwd[0], bwd_r[0], rt),
            "dgamma": gn_err(bwd[1], bwd_r[1], 0.0),
            "dbeta": gn_err(bwd[2], bwd_r[2], 0.0)}
    if cancel:
        ref, terms = gn_dx_f64(x, dy, gamma, beta, mean_r, rstd_r, g, act)
        allowed = (rt * terms).clamp_min(1e-30)
        kern, plain = ((d.double() - ref).abs()
                       for d in (bwd[0], bwd_r[0]))
        r_kern = (kern / allowed).max().item()
        r_plain = (plain / allowed).max().item()
        print(f"group norm cancellation witness n={n} hw={hw} c={c} g={g} "
              f"{dtype} {act}: max |dx| {ref.abs().max().item():.4g} of "
              f"terms up to {terms.max().item():.4g}; from float64 the "
              f"kernel {kern.max().item():.4g} ({r_kern:.4f} of {rt:g} of "
              f"the terms), the plain version {plain.max().item():.4g} "
              f"({r_plain:.4f}); kernel against plain {errs['dx'][0]:.3f} "
              f"of the plain-referenced allowance", flush=True)
        errs["dx"] = (max(r_kern, r_plain), errs["dx"][1])
    bad = [k for k, (r, _) in errs.items() if not r <= 1.0]
    if bad or y.dtype != dtype or bwd[0].dtype != dtype:
        raise AssertionError(f"group norm check n={n} hw={hw} c={c} g={g} "
                             f"{dtype} {act}: {bad} differ from the plain "
                             f"versions ({errs})")
    return ({"group_norm_fwd": max(errs[k][1] for k in ("y", "mean",
                                                         "rstd")),
             "group_norm_bwd": max(errs[k][1] for k in ("dx", "dgamma",
                                                         "dbeta"))},
            max(r for r, _ in errs.values()))


def gn_bound(name, n, hw, c, g, itemsize, silu):
    """Least time for the function on these inputs: x (and dy) read, y
    (dx) written in their dtype, gamma/beta and the [n, g] statistics and
    [n, c] partials in float32, over the HBM rate; against its float32
    operations (forward 8 per element, 12 with the SiLU; backward 20, 32
    with it) over the float32 rate; the larger."""
    e = n * hw * c
    if name == "group_norm_fwd":
        nbytes = 2 * e * itemsize + 2 * c * 4 + 2 * n * g * 4
        ops = e * (12 if silu else 8)
    else:
        nbytes = 3 * e * itemsize + 2 * c * 4 + 2 * n * g * 4 + 2 * n * c * 4
        ops = e * (32 if silu else 20)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# the GroupNorm kernels' instantiations by their mangled names: direction,
# vector width V, resident tile, element type (csrc/group_norm.cu)
GN_BODIES = ("gn_fwd_tile_kernel", "gn_bwd_tile_kernel")
GN_TYPES = {"6__half": "f16", "13__nv_bfloat16": "bf16", "f": "f32"}


def gn_build_report(log):
    """The ptxas registers and spills of rows 12-13: one line per kernel and
    type at its widest vector (resident and re-read), and the worst over
    all 44 instantiations."""
    pat = re.compile(r"Compiling entry function '\S*?(gn_fwd_tile_kernel|"
                     r"gn_bwd_tile_kernel)ILi(\d)ELb([01])EEEvPK(6__half|"
                     r"13__nv_bfloat16|f)\S*' for 'sm_90a'\n.*\n\s*(.*)\n"
                     r"(.*)\n")
    found = []
    for m in pat.finditer(log):
        body, vec, res, tname, frame, used = m.groups()
        tag = GN_TYPES[tname]
        regs = int(re.search(r"Used (\d+) registers", used).group(1))
        spill = int(re.search(r"(\d+) bytes spill stores", frame).group(1))
        found.append((body, tag, int(vec), res == "1", regs, spill))
        if int(vec) == (4 if tag == "f32" else 8):
            print(f"ptxas {body} {tag} V {vec} "
                  f"{'resident' if res == '1' else 're-read'}: {regs} "
                  f"registers, {frame.strip()}", flush=True)
    if len(found) != 44:
        raise AssertionError(f"expected the ptxas lines of 44 GroupNorm "
                             f"instantiations, found {len(found)}")
    for body in GN_BODIES:
        mine = [f for f in found if f[0] == body]
        print(f"ptxas {body}: {len(mine)} instantiations, registers max "
              f"{max(f[4] for f in mine)}, spill stores max "
              f"{max(f[5] for f in mine)} bytes", flush=True)
    return found


def gn_step_timing(cfg, flush):
    """Rows 12 and 13 summed over one UNet step's GroupNorm calls (its
    sites in call order, SiLU or not, bf16, batch 4), each chain timed as
    one call after one L2 flush, beside ``F.group_norm`` (+ ``silu``) on
    the NCHW views, forward and backward, and the summed bounds."""
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.models import unet_gn_sites

    fn = torch.nn.functional
    n, g = UNET_BATCH, cfg.norm_num_groups
    sites = unet_gn_sites(cfg, UNET_SIZE)
    calls = []
    for k, (hw, c, act) in enumerate(sites):
        x, dy, gamma, beta = gn_inputs(n, hw, c, torch.bfloat16, 300 + k)
        _, mean, rstd = gn.group_norm_fwd(x, gamma, beta, g, 1e-5, act)
        side = math.isqrt(hw)
        x4 = x.view(n, side, side, c).permute(0, 3, 1, 2)
        dy4 = dy.view(n, side, side, c).permute(0, 3, 1, 2)
        wb = [t.to(torch.bfloat16).requires_grad_() for t in (gamma, beta)]
        xg = x4.detach().requires_grad_()
        out = fn.group_norm(xg, g, wb[0], wb[1], 1e-5)
        if act == "silu":
            out = fn.silu(out)
        calls.append((x, dy, gamma, beta, mean, rstd, act, x4, dy4, wb, xg,
                      out))

    def kernel_fwd():
        for x, _, gamma, beta, _, _, act, *_ in calls:
            gn.group_norm_fwd(x, gamma, beta, g, 1e-5, act)

    def kernel_bwd():
        for x, dy, gamma, beta, mean, rstd, act, *_ in calls:
            gn.group_norm_bwd(x, dy, gamma, beta, mean, rstd, g, act)

    def lib_fwd():
        for *_, act, x4, _, wb, _, _ in calls:
            out = fn.group_norm(x4, g, wb[0], wb[1], 1e-5)
            if act == "silu":
                fn.silu(out)

    def lib_bwd():
        for *_, dy4, wb, xg, out in calls:
            torch.autograd.grad(out, [xg, *wb], dy4, retain_graph=True)

    # the host enqueues 56 calls (and autograd's graphs) behind the spin
    hold = 40 * HOLD_CYCLES
    times = {"group_norm_fwd": (time_ms(kernel_fwd, flush, 20, 3, hold),
                                time_ms(lib_fwd, flush, 20, 3, hold)),
             "group_norm_bwd": (time_ms(kernel_bwd, flush, 20, 3, hold),
                                time_ms(lib_bwd, flush, 20, 3, hold))}
    n_silu = sum(act == "silu" for _, _, act in sites)
    out = {}
    for name, (kernel_ms, library_ms) in times.items():
        bound_ms = sum(gn_bound(name, n, hw, c, g, 2, act == "silu")[0]
                       for hw, c, act in sites)
        kind = "forward" if "fwd" in name else "backward"
        print(f"group norm step timing {name}: one UNet step's {len(sites)} "
              f"calls ({n_silu} with the SiLU), bf16, batch {n}: kernels "
              f"{kernel_ms:.4f} ms, F.group_norm (+ silu) {kind} "
              f"{library_ms:.4f} ms, summed bounds {bound_ms:.4f} ms",
              flush=True)
        out[name] = dict(step_calls=len(sites), step_ms=kernel_ms,
                         step_library_ms=library_ms, step_bound_ms=bound_ms)
    return out


def gn_site_timing(cfg, flush):
    """Rows 12-13 at the UNet's largest GroupNorm site (batch 4, bf16, the
    SiLU) beside their bounds, their plain versions and
    ``torch.nn.functional.group_norm`` + ``silu`` forward and backward on
    the NCHW view (a yardstick the port never calls); returns the rows
    of the ``kernels`` line without their errors and launches."""
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.models import unet_gn_sites

    n, g = UNET_BATCH, cfg.norm_num_groups
    hw, c = max(((hw, c) for hw, c, _ in unet_gn_sites(cfg, UNET_SIZE)),
                key=lambda s: s[0] * s[1])
    x, dy, gamma, beta = gn_inputs(n, hw, c, torch.bfloat16, seed=200)
    _, mean, rstd = gn.group_norm_fwd(x, gamma, beta, g, 1e-5, "silu")
    side = int(math.isqrt(hw))
    x4 = x.view(n, side, side, c).permute(0, 3, 1, 2)
    dy4 = dy.view(n, side, side, c).permute(0, 3, 1, 2)
    wb = [t.to(torch.bfloat16).requires_grad_() for t in (gamma, beta)]
    xg = x4.detach().requires_grad_()
    fn = torch.nn.functional

    def lib_fwd():
        return fn.silu(fn.group_norm(x4, g, wb[0], wb[1], 1e-5))

    out = fn.silu(fn.group_norm(xg, g, wb[0], wb[1], 1e-5))
    library = {"group_norm_fwd": time_ms(lib_fwd, flush, iters=30),
               "group_norm_bwd": time_ms(lambda: torch.autograd.grad(
                   out, [xg, *wb], dy4, retain_graph=True), flush,
                   iters=30)}
    calls = {
        "group_norm_fwd": (
            lambda: gn.group_norm_fwd(x, gamma, beta, g, 1e-5, "silu"),
            lambda: gn.group_norm_fwd_plain(x, gamma, beta, g, 1e-5, "silu"),
            160),
        "group_norm_bwd": (
            lambda: gn.group_norm_bwd(x, dy, gamma, beta, mean, rstd, g,
                                      "silu"),
            lambda: gn.group_norm_bwd_plain(x, dy, gamma, beta, mean, rstd,
                                            g, "silu"), 194),
    }
    rows = {}
    for name, (kernel, plain, line) in calls.items():
        kernel_ms = time_ms(kernel, flush, iters=30)
        plain_ms = time_ms(plain, flush, iters=30)
        bound_ms, bound_by = gn_bound(name, n, hw, c, g, 2, True)
        kind = "forward" if "fwd" in name else "backward"
        print(f"group norm timing {name} n={n} hw={hw} c={c} g={g} bf16 "
              f"silu: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.group_norm + silu {kind} {library[name]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        rows[name] = dict(
            name=name, route="cuda", source=GN_SOURCE,
            replaces=f"{GN_FILE}:{line}",
            shape=f"n={n} hw={hw} c={c} g={g} bf16 silu", ms=kernel_ms,
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library[name])
    return rows


def gn_kernel_phase():
    """Rows 12-13 against their plain versions at every distinct
    GroupNorm site of the SD UNet at sample_size 32, batch 4 (bf16 and
    float32, activation None and silu), at a shape over the JAX kernel's
    VMEM budget (n 1, 128 x 128, c 1024, g 32: the re-read path), a ragged
    hw of 1000 split across a cluster, one pixel (16 channels a group; 2
    a group held against float64, ``gn_check``'s ``cancel``), slabs of
    more groups than a CTA has threads (one pixel, c 48 in 48 groups; c
    296 in 296 groups), and inputs 1 and 4 elements into their storage;
    prints the launch plans at the largest site; then timed there
    (``gn_site_timing``) and summed over one UNet step's calls
    (``gn_step_timing``)."""
    from paddle_tpu_torch.kernels import _card
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.models import UNetConfig, unet_gn_sites

    cfg = UNetConfig(sample_size=UNET_SIZE)
    g = cfg.norm_num_groups
    sites = sorted({(hw, c) for hw, c, _ in unet_gn_sites(cfg, UNET_SIZE)})
    # (n, hw, c, groups, storage offset, dx against float64)
    cases = [(UNET_BATCH, hw, c, g, 0, False) for hw, c in sites] + [
        (1, 128 * 128, 1024, g, 0, False), (2, 1000, 640, g, 0, False),
        (1, 1, 64, 4, 0, False), (1, 1, 64, 32, 0, True),
        (1, 1, 48, 48, 0, False), (1, 16, 296, 296, 0, False),
        (2, 256, 640, g, 1, False), (2, 256, 640, g, 4, False)]
    errs, worst, seed = {}, 0.0, 100
    for n, hw, c, groups, offset, cancel in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for act in (None, "silu"):
                e, r = gn_check(n, hw, c, groups, dtype, act, seed, offset,
                                cancel)
                seed += 1
                worst = max(worst, r)
                for k, v in e.items():
                    errs[k] = max(errs.get(k, 0.0), v)
    print(f"group norm check: {len(cases)} shapes (the UNet's distinct "
          f"(hw, c) sites {sites} at batch {UNET_BATCH}, n=1 hw=16384 "
          f"c=1024, n=2 hw=1000 c=640, n=1 hw=1 c=64 g=4 and g=32 (dx "
          f"against float64), n=1 hw=1 c=48 g=48, n=1 hw=16 c=296 g=296, "
          f"and n=2 hw=256 c=640 1 and 4 elements into their storage) x "
          f"bf16/float32 x "
          f"None/silu: worst error {worst:.3f} of its allowance, max abs "
          f"err {errs}, backward run-to-run identical: ok", flush=True)
    n, (hw, c) = UNET_BATCH, max(sites, key=lambda s: s[0] * s[1])
    held = gn._card_clusters("bf16", n, hw, c, g)
    for backward in (False, True):
        plan = gn._launch_plan(n, hw, c, g, 2, backward=backward,
                               clusters=held, sms=_card.sm_count(0))
        at_once = held(plan, backward)
        print(f"group norm plan {'backward' if backward else 'forward'} "
              f"n={n} hw={hw} c={c} g={g} bf16: {plan._asdict()}, grid "
              f"{(plan.ranks, c // plan.slab, n)}, the card holds "
              f"{at_once} such clusters at once", flush=True)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = gn_site_timing(cfg, flush)
    for name, step in gn_step_timing(cfg, flush).items():
        rows[name].update(step, max_abs_err=errs[name])
    return rows


def unet_train_phase():
    """``bench_unet``'s train step at the SD-1.x UNet widths
    (``UNetConfig(sample_size=32)``: 320/640/1280/1280 channels, 2 layers
    per block, cross-attention 768, 32 groups), bf16 random weights from
    seed 0 with float32 masters (``AdamW(1e-4, multi_precision=True)``),
    channels-last on the card ("auto"), batch 4: a seeded sample [4, 4,
    32, 32], timesteps in [0, 1000), context [4, 77, 768], the denoising
    MSE against the sample. 2 warm-up and 5 timed steps with exactly 56
    launches of row 12 and of row 13 per step, and a profile of one step.
    Returns the launch counts."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                         unet_gn_sites)
    from paddle_tpu_torch.nn import layout
    from paddle_tpu_torch.trainer import TrainStep

    cfg = UNetConfig(sample_size=UNET_SIZE)
    b, size = UNET_BATCH, cfg.sample_size
    t0 = time.perf_counter()
    unet = UNet2DConditionModel(cfg, device="cuda", seed=0).to(
        torch.bfloat16)
    model = UNetLoss(unet)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True))
    torch.cuda.synchronize()
    fmt = "NHWC" if layout.decide(cfg.channels_last, "cuda") else "NCHW"
    print(f"unet: {n_params} parameters in {n_tensors} tensors, bf16 with "
          f"float32 masters, built in {time.perf_counter() - t0:.2f} s; "
          f"layout {fmt}", flush=True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(
        (b, cfg.in_channels, size, size)), device="cuda").to(torch.bfloat16)
    batch = {"sample": x,
             "timestep": torch.as_tensor(np.random.default_rng(1).integers(
                 0, 1000, (b,)), device="cuda"),
             "context": torch.as_tensor(np.random.default_rng(2)
                                        .standard_normal(
                                            (b, 77, cfg.cross_attention_dim)),
                                        device="cuda").to(torch.bfloat16),
             "target": x}
    losses, _, step_ms, counts, peak_gb = train_steps(ts, batch)
    sites = unet_gn_sites(cfg, size)
    per_step = len(sites)
    n_silu = sum(act == "silu" for _, _, act in sites)
    check_counts("unet", counts, {"group_norm_fwd": 5 * per_step,
                                  "group_norm_bwd": 5 * per_step})
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"unet: losses {losses}")
    med_ms = float(np.median(step_ms))
    samples_per_s = b / (med_ms / 1e3)
    print(f"unet: 5 timed steps {[round(v, 3) for v in step_ms]} ms "
          f"(median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{samples_per_s:.2f} samples/s, peak {peak_gb:.2f} GB; losses "
          f"{losses}; launches per step {per_step} of row 12 ({n_silu} "
          f"with the SiLU, {per_step - n_silu} without) and {per_step} of "
          "row 13", flush=True)
    prof = profile_step("unet", ts, batch, GN_BODIES)
    print(json.dumps({"train_unet": {
        "model": "SD-1.x UNet widths, sample_size 32, random bf16 weights "
                 "(seed 0), float32 masters", "batch": b,
        "parameters": n_params, "step_ms": step_ms,
        "step_ms_median": med_ms, "samples_per_s": samples_per_s,
        "peak_memory_gb": peak_gb, "losses": losses, "profile": prof}}),
        flush=True)
    return {k: counts[k] for k in GN_KERNELS}


def reset_launches():
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.kernels import mha
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    from paddle_tpu_torch.kernels import selective_scan as ss

    da.LAUNCHES = 0
    qmm.LAUNCHES = 0
    for counts in (pa.LAUNCHES, mha.LAUNCHES, ss.LAUNCHES, gn.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels import group_norm as gn
    from paddle_tpu_torch.kernels import mha
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    from paddle_tpu_torch.kernels import selective_scan as ss

    return {"fused_contiguous_decode_attention": da.LAUNCHES, **pa.LAUNCHES,
            "weight_only_matmul": qmm.LAUNCHES, **mha.LAUNCHES,
            **ss.LAUNCHES, **gn.LAUNCHES}


def pool_identity(eng):
    """A paged engine's pages: free, held by the prefix store alone,
    shared (refcount > 1), and usable (all but the sink page)."""
    pool = eng.pool
    return {"free": pool.free_pages,
            "store_only": (eng._prefix.evictable_pages(pool)
                           if eng._prefix is not None else 0),
            "shared": pool.shared_pages, "usable": pool.n_pages - 1}


def check_pool(label, eng):
    """After a run every usable page is free or held by the prefix store
    alone (with the cache off: free), and none is shared."""
    ident = pool_identity(eng)
    if ident["free"] + ident["store_only"] != ident["usable"] \
            or ident["shared"]:
        raise AssertionError(f"{label}: pages not returned: {ident}")
    return ident


def serve(model, prompts, fused: str, max_new_tokens=32, max_chunk=8,
          **config):
    """Serve ``prompts`` through a fresh engine (``config``: further
    EngineConfig fields); returns the requests, the wall time and the
    engine's counts, with its init time (quantization included) under
    ``init_s`` and, paged, its pool after the run (checked by
    ``check_pool``) under ``pool``."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    flags.set_flags({"fused_decode": fused})
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, **config),
        device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=max_new_tokens,
                   max_chunk=max_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    pool = check_pool("serve", eng) if eng.pool is not None else None
    return reqs, wall, dict(eng.stats, init_s=t1 - t0, pool=pool)


def build_7b():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(max_position_embeddings=2048,
                                dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"engine: Llama-2-7B width, {cfg.num_hidden_layers} layers, "
          f"{n_params} parameters in bf16, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 120) for _ in range(8)]
    return model, prompts


def engine_phase(model, prompts):
    """The contiguous engine at 7B width; returns its fused row-1 launch
    count and the fused run's outputs."""
    cfg = model.config

    # warm-up on a short request (library handles, allocator), not counted
    serve(model, prompts[:2], "auto", max_new_tokens=4, max_chunk=4)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs, wall, stats = serve(model, prompts, "auto")
    launches = read_launches()["fused_contiguous_decode_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launches()
    reqs_off, wall_off, _ = serve(model, prompts, "off")
    launches_off = read_launches()["fused_contiguous_decode_attention"]
    for r in reqs:
        if len(r.output) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    ttft = [r.ttft_ms for r in reqs]
    ttft_p50 = float(np.median(ttft))
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    decode_wall = wall - max(ttft) / 1e3
    decode_tps = decode_tokens / decode_wall
    decode_forwards = stats["decode_forwards"]
    expected = cfg.num_hidden_layers * decode_forwards
    print(f"engine fused: 8 requests served in {wall:.3f} s, TTFT p50 "
          f"{ttft_p50:.2f} ms, decode {decode_tps:.1f} tok/s "
          f"({decode_tokens} tokens in {decode_wall:.3f} s), peak memory "
          f"{peak_gb:.2f} GB, kernel launches {launches} = "
          f"{cfg.num_hidden_layers} layers x {decode_forwards} decode "
          f"forwards", flush=True)
    if launches <= 0 or launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected} (> 0)")
    if launches_off != 0:
        raise AssertionError(f"fused_decode=off launched the kernel "
                             f"{launches_off} times")
    fused_outs = [r.output for r in reqs]
    off_outs = [r.output for r in reqs_off]
    divergence = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       None) for a, b in zip(fused_outs, off_outs)]
    print(json.dumps({"engine": {
        "model": "llama2_7b width, random bf16 weights (seed 0)",
        "requests": 8, "prompt_tokens": 120, "max_new_tokens": 32,
        "max_chunk": 8, "ttft_ms": ttft, "ttft_p50_ms": ttft_p50,
        "decode_tokens_per_s": decode_tps, "peak_memory_gb": peak_gb,
        "kernel_launches": launches, "decode_forwards": decode_forwards,
        "wall_s": wall, "unfused_wall_s": wall_off,
        "outputs_match": fused_outs == off_outs,
        "first_divergence": divergence,
        "tokens_digest": tokens_digest(fused_outs),
        "unfused_tokens_digest": tokens_digest(off_outs)}}), flush=True)
    if any(a[0] != b[0] for a, b in zip(fused_outs, off_outs)):
        raise AssertionError("the first generated token differs between "
                             "fused and unfused decode")
    return launches, fused_outs


def paged_engine_phase(model, prompts, contiguous_outs):
    """``bench_serve7b``'s shape through the paged engine: 64-token pages,
    a bf16 pool of 8 * 16 + 1 pages. Fused decode must launch the fused
    paged kernel once per layer per decode forward and nothing else;
    with fused decode off, the block-table kernel as many times. Returns
    the two launch counts."""
    cfg = model.config
    paged = dict(paged=True, page_size=PAGE)
    layers = cfg.num_hidden_layers

    serve(model, prompts[:2], "auto", max_new_tokens=4, max_chunk=4,
          **paged)  # warm-up, not counted

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs, wall, stats = serve(model, prompts, "auto", **paged)
    fused_counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launches()
    reqs_off, wall_off, stats_off = serve(model, prompts, "off", **paged)
    off_counts = read_launches()
    for r in reqs + reqs_off:
        if len(r.output) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"paged request {r.rid}: bad output "
                                 f"{r.output}")
    ttft = [r.ttft_ms for r in reqs]
    ttft_p50 = float(np.median(ttft))
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    decode_wall = wall - max(ttft) / 1e3
    decode_tps = decode_tokens / decode_wall
    fused_want = {"fused_contiguous_decode_attention": 0,
                  "fused_paged_decode_attention":
                      layers * stats["decode_forwards"],
                  "paged_decode_attention": 0, "weight_only_matmul": 0,
                  **NO_TRAIN_KERNELS}
    off_want = {"fused_contiguous_decode_attention": 0,
                "fused_paged_decode_attention": 0,
                "paged_decode_attention":
                    layers * stats_off["decode_forwards"],
                "weight_only_matmul": 0, **NO_TRAIN_KERNELS}
    print(f"paged engine fused: 8 requests served in {wall:.3f} s, TTFT "
          f"p50 {ttft_p50:.2f} ms, decode {decode_tps:.1f} tok/s "
          f"({decode_tokens} tokens in {decode_wall:.3f} s), peak memory "
          f"{peak_gb:.2f} GB, free pages {stats['free_pages']}, launches "
          f"{fused_counts} ({layers} layers x {stats['decode_forwards']} "
          f"decode forwards); unfused: launches {off_counts}", flush=True)
    if fused_counts != fused_want \
            or fused_want["fused_paged_decode_attention"] <= 0:
        raise AssertionError(f"fused paged launches {fused_counts}, "
                             f"expected {fused_want}")
    if off_counts != off_want or off_want["paged_decode_attention"] <= 0:
        raise AssertionError(f"unfused paged launches {off_counts}, "
                             f"expected {off_want}")
    n_pages = 8 * (1024 // PAGE) + 1
    fused_outs = [r.output for r in reqs]
    off_outs = [r.output for r in reqs_off]
    same_first_as_contiguous = sum(
        a[0] == b[0] for a, b in zip(fused_outs, contiguous_outs))
    print(json.dumps({"paged_engine": {
        "model": "llama2_7b width, random bf16 weights (seed 0)",
        "requests": 8, "prompt_tokens": 120, "max_new_tokens": 32,
        "max_chunk": 8, "page_size": PAGE, "n_pages": n_pages,
        "ttft_ms": ttft, "ttft_p50_ms": ttft_p50,
        "decode_tokens_per_s": decode_tps, "peak_memory_gb": peak_gb,
        "free_pages": stats["free_pages"], "pool": stats["pool"],
        "launches": fused_counts,
        "unfused_launches": off_counts,
        "decode_forwards": stats["decode_forwards"], "wall_s": wall,
        "unfused_wall_s": wall_off,
        "outputs_match_unfused": fused_outs == off_outs,
        "first_tokens_equal_to_contiguous": same_first_as_contiguous,
        "tokens_digest": tokens_digest(fused_outs),
        "unfused_tokens_digest": tokens_digest(off_outs)}}),
        flush=True)
    if any(a[0] != b[0] for a, b in zip(fused_outs, off_outs)):
        raise AssertionError("the first generated token differs between "
                             "fused and unfused paged decode")
    return (fused_counts["fused_paged_decode_attention"],
            off_counts["paged_decode_attention"], fused_outs)


def tokens_digest(outs):
    """A short digest of an engine's greedy tokens, to compare runs."""
    return hashlib.sha1(json.dumps(outs).encode()).hexdigest()[:16]


def first_divergence(outs, ref_outs):
    """Per request, the first index where ``outs`` leaves ``ref_outs``
    (None where they agree throughout)."""
    return [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(outs, ref_outs)]


def quant_engine_phase(label, model, prompts, ref_outs, **config):
    """One quantized configuration at 7B width, fused decode on and off.
    Requires exact launch counts: 225 row-4 launches per forward (prefill
    chunks and decode forwards) with quantized weights, the fused kernel
    of the cache once per layer per decode forward with fused decode on,
    the block-table kernel as often with it off on a float pool and never
    on an int8 pool; every page back (free, or held by the prefix store
    alone); the same first tokens both ways.
    Reports TTFT, decode rate, peak memory and the first index where the
    tokens leave the bf16 engine's ``ref_outs``. Returns the fused run's
    launch counts."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    paged = bool(config.get("paged"))
    int8_kv = config.get("cache_dtype") == "int8"
    quant_w = config.get("weight_dtype", "bf16") != "bf16"

    serve(model, prompts[:2], "auto", max_new_tokens=4, max_chunk=4,
          **config)  # warm-up, not counted

    runs = {}
    for fused in ("auto", "off"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reqs, wall, stats = serve(model, prompts, fused, **config)
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        decode = layers * stats["decode_forwards"]
        forwards = stats["prefill_chunk"] + stats["decode_forwards"] \
            + stats["verify_forwards"]
        want = {"fused_contiguous_decode_attention":
                    decode if fused == "auto" and not paged else 0,
                "fused_paged_decode_attention":
                    decode if fused == "auto" and paged else 0,
                "paged_decode_attention":
                    decode if fused == "off" and paged and not int8_kv
                    else 0,
                "weight_only_matmul":
                    (7 * layers + 1) * forwards if quant_w else 0,
                **NO_TRAIN_KERNELS}
        if counts != want or (quant_w and want["weight_only_matmul"] <= 0):
            raise AssertionError(f"{label} fused={fused}: launches {counts}, "
                                 f"expected {want}")
        for r in reqs:
            if len(r.output) != 32 or not all(
                    0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"{label}: request {r.rid} bad output "
                                     f"{r.output}")
        runs[fused] = (reqs, wall, stats, counts, peak_gb)
    reqs, wall, stats, counts, peak_gb = runs["auto"]
    outs = [r.output for r in reqs]
    off_outs = [r.output for r in runs["off"][0]]
    ttft = [r.ttft_ms for r in reqs]
    ttft_p50 = float(np.median(ttft))
    decode_tokens = sum(len(o) - 1 for o in outs)
    decode_wall = wall - max(ttft) / 1e3
    decode_tps = decode_tokens / decode_wall
    print(f"{label}: 8 requests served in {wall:.3f} s (engine init "
          f"{stats['init_s']:.2f} s), TTFT p50 {ttft_p50:.2f} ms, decode "
          f"{decode_tps:.1f} tok/s, peak memory {peak_gb:.2f} GB, launches "
          f"{counts} ({stats['prefill_chunk']} prefill chunks, "
          f"{stats['decode_forwards']} decode forwards); unfused: launches "
          f"{runs['off'][3]}", flush=True)
    print(json.dumps({label: {
        "model": "llama2_7b width, random bf16 weights (seed 0)",
        "config": {k: str(v) for k, v in config.items()},
        "requests": 8, "prompt_tokens": 120, "max_new_tokens": 32,
        "max_chunk": 8, "ttft_ms": ttft, "ttft_p50_ms": ttft_p50,
        "decode_tokens_per_s": decode_tps, "peak_memory_gb": peak_gb,
        "engine_init_s": stats["init_s"], "launches": counts,
        "unfused_launches": runs["off"][3],
        "prefill_chunks": stats["prefill_chunk"],
        "decode_forwards": stats["decode_forwards"], "wall_s": wall,
        "unfused_wall_s": runs["off"][1],
        "outputs_match_unfused": outs == off_outs,
        "first_divergence_vs_bf16": first_divergence(outs, ref_outs),
        "tokens_digest": tokens_digest(outs),
        "unfused_tokens_digest": tokens_digest(off_outs)}}),
        flush=True)
    if any(a[0] != b[0] for a, b in zip(outs, off_outs)):
        raise AssertionError(f"{label}: the first generated token differs "
                             "between fused and unfused decode")
    return counts


# the prefix runs: one seeded 512-token shared prompt (8 blocks of 64)
# plus 64 tokens of each request's own; the spec runs: 8 prompts, each a
# seeded 16-token pattern repeated to 128 tokens
PREFIX_SHARED, PREFIX_OWN, SPEC_PATTERN, SPEC_LEN = 512, 64, 16, 128


def engine_run(model, prompts, max_new_tokens, label, publish=None,
               drafter=None, **config):
    """One timed run of ``prompts`` through a fresh 8-slot engine at the
    current flags (``publish``: a request served first, untimed, so that
    its prompt's blocks are in the prefix store; ``drafter``: the
    engine's drafter when speculative decoding is on). The counts are set to 0
    just before the timed run and read just after: the decode kernel of
    the cache (row 1 contiguous, row 2 paged) must have run once per
    layer per decode forward of that run (a verify forward launches
    none) and no other kernel at all.
    Returns the requests, wall time, decode forwards and verify forwards
    of the run, the launches, and the engine."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    cfg = model.config
    paged = bool(config.get("paged"))
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, **config),
        device="cuda", drafter=drafter)
    if publish is not None:
        eng.run([publish], max_new_tokens=1)
    torch.cuda.synchronize()
    forwards0 = eng.stats["decode_forwards"]
    verify0 = eng.stats["verify_forwards"]
    reset_launches()
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=max_new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    forwards = eng.stats["decode_forwards"] - forwards0
    verify = eng.stats["verify_forwards"] - verify0
    decode = cfg.num_hidden_layers * forwards
    want = {"fused_contiguous_decode_attention": 0 if paged else decode,
            "fused_paged_decode_attention": decode if paged else 0,
            "paged_decode_attention": 0, "weight_only_matmul": 0,
            **NO_TRAIN_KERNELS}
    if counts != want or forwards + verify <= 0:
        raise AssertionError(f"{label}: launches {counts}, expected {want} "
                             f"({cfg.num_hidden_layers} layers x {forwards} "
                             "decode forwards)")
    for r in reqs:
        if len(r.output) != max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"{label}: request {r.rid} bad output "
                                 f"{r.output}")
    return dict(reqs=reqs, wall=wall, forwards=forwards, verify=verify,
                launches=counts, engine=eng)


def run_summary(run):
    """TTFT p50 and decode tokens/s of one ``engine_run``."""
    reqs = run["reqs"]
    ttft = [r.ttft_ms for r in reqs]
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    return {"ttft_p50_ms": float(np.median(ttft)), "ttft_ms": ttft,
            "decode_tokens_per_s":
                decode_tokens / (run["wall"] - max(ttft) / 1e3),
            "wall_s": run["wall"], "decode_forwards": run["forwards"],
            "verify_forwards": run["verify"],
            "decode_kernel_launches": sum(run["launches"].values())}


class ReplayDrafter:
    """Proposes, for a known prompt, the next tokens of a recorded greedy
    run of it (the spec-off arm's outputs): the verify pass's best case,
    where only a difference between the verify forward's and the decode
    kernel's bf16 numbers rejects a draft."""

    def __init__(self, prompts, outputs):
        self.n_prompt = len(prompts[0])
        self.runs = {np.asarray(p, np.int64).tobytes(): o
                     for p, o in zip(prompts, outputs)}

    def propose(self, history, k):
        out = self.runs.get(np.asarray(history[:self.n_prompt],
                                       np.int64).tobytes(), [])
        n = len(history) - self.n_prompt
        return np.asarray(out[n:n + k], np.int64)


def prefix_spec_phase(model):
    """Prefix caching and speculative decoding at 7B width, bf16.

    Prefix runs, contiguous and paged (64-token pages), the cache on and
    off: one request publishes the shared 512-token prompt, then 8
    requests of it plus 64 tokens of their own take 32 new tokens each.
    With the cache on every one of the 8 hits all 512 tokens (paged: it
    adopts the 8 cached pages, and row 2 appends past them); the first
    tokens must equal the cache-off run's, and every paged page must be
    free or held by the store alone, none shared, after the run.

    Spec runs, contiguous: the 8 repeated-pattern prompts take 64 new
    tokens with ``PT_FLAGS_spec_decode`` off, ngram, and ngram with a
    ``ReplayDrafter`` of the off run's tokens. A random-weight model does
    not copy its prompt, so the n-gram drafter may find nothing to
    propose (reported, not asserted); the replay run must take verify
    passes. The first tokens of both must equal the off run's. Every run
    launches only the cache's decode kernel, once per layer per decode
    forward (a verify pass launches none)."""
    from paddle_tpu_torch import flags

    cfg = model.config
    rng = np.random.default_rng(12)
    shared = rng.integers(1, cfg.vocab_size, PREFIX_SHARED)
    own = [rng.integers(1, cfg.vocab_size, PREFIX_OWN) for _ in range(9)]
    prompts = [np.concatenate([shared, o]) for o in own]
    out = {}
    saved = {k: flags.flag(k) for k in ("prefix_cache", "spec_decode")}
    try:
        flags.set_flags({"fused_decode": "auto", "spec_decode": "off"})
        for paged in (False, True):
            layout = "paged" if paged else "contig"
            config = dict(paged=True, page_size=PAGE) if paged else {}
            runs = {}
            for on in (True, False):
                flags.set_flags({"prefix_cache": on})
                label = f"prefix {layout} {'on' if on else 'off'}"
                run = engine_run(model, prompts[1:], 32, label,
                                 publish=prompts[0], **config)
                eng = run["engine"]
                summary = run_summary(run)
                summary["prefix"] = eng.prefix_snapshot()
                if paged:
                    summary["pool"] = check_pool(label, eng)
                runs[on] = (run, summary)
                print(f"{label}: TTFT p50 {summary['ttft_p50_ms']:.2f} ms, "
                      f"decode {summary['decode_tokens_per_s']:.1f} tok/s, "
                      f"launches {summary['decode_kernel_launches']} = "
                      f"{cfg.num_hidden_layers} layers x {run['forwards']} "
                      f"decode forwards, prefix {summary['prefix']}"
                      + (f", pool {summary['pool']}" if paged else ""),
                      flush=True)
            snap = runs[True][1]["prefix"]
            if snap["hits"] != 8 or snap["hit_tokens"] != 8 * PREFIX_SHARED:
                raise AssertionError(f"prefix {layout}: {snap}, expected 8 "
                                     f"hits of {PREFIX_SHARED} tokens")
            on_outs = [r.output for r in runs[True][0]["reqs"]]
            off_outs = [r.output for r in runs[False][0]["reqs"]]
            if [o[0] for o in on_outs] != [o[0] for o in off_outs]:
                raise AssertionError(f"prefix {layout}: first tokens differ "
                                     "between the cache on and off")
            out[f"prefix_{layout}"] = {
                "on": runs[True][1], "off": runs[False][1],
                "first_tokens_equal": True,
                "outputs_equal": on_outs == off_outs,
                "first_divergence": first_divergence(on_outs, off_outs)}
        flags.set_flags({"prefix_cache": True})
        spec_prompts = [np.tile(rng.integers(1, cfg.vocab_size, SPEC_PATTERN),
                                SPEC_LEN // SPEC_PATTERN) for _ in range(8)]
        runs = {}
        for arm in ("off", "ngram", "replay"):
            flags.set_flags({"spec_decode": "off" if arm == "off"
                             else "ngram"})
            drafter = None
            if arm == "replay":
                drafter = ReplayDrafter(
                    spec_prompts, [r.output for r in runs["off"][0]["reqs"]])
            label = f"spec contig {arm}"
            engine_run(model, spec_prompts[:2], 8, label + " warm-up",
                       drafter=drafter)
            run = engine_run(model, spec_prompts, 64, label,
                             drafter=drafter)
            summary = run_summary(run)
            summary["spec"] = run["engine"].spec_snapshot()
            outs = [r.output for r in run["reqs"]]
            if arm != "off":
                ref = [r.output for r in runs["off"][0]["reqs"]]
                if [o[0] for o in outs] != [o[0] for o in ref]:
                    raise AssertionError(f"{label}: first tokens differ "
                                         "from spec off")
                summary["outputs_equal_off"] = outs == ref
                summary["first_divergence"] = first_divergence(outs, ref)
            runs[arm] = (run, summary)
            print(f"{label}: TTFT p50 {summary['ttft_p50_ms']:.2f} ms, "
                  f"decode {summary['decode_tokens_per_s']:.1f} tok/s, "
                  f"{run['forwards']} decode forwards and {run['verify']} "
                  f"verify forwards, launches "
                  f"{summary['decode_kernel_launches']}, spec "
                  f"{summary['spec']}", flush=True)
        if runs["replay"][1]["spec"]["verify_calls"] <= 0:
            raise AssertionError("spec replay: no verify pass was taken")
        out["spec_contig"] = {arm: runs[arm][1] for arm in runs}
    finally:
        flags.set_flags(saved)
    print(json.dumps({"prefix_spec": {
        "model": "llama2_7b width, random bf16 weights (seed 0)",
        "prefix_prompt_tokens": PREFIX_SHARED + PREFIX_OWN,
        "shared_tokens": PREFIX_SHARED, "spec_prompt_tokens": SPEC_LEN,
        **out}}), flush=True)
    return out


def predictor_phase(model, prompts, contiguous_outs):
    """The Paddle Inference predictor at 7B width, bf16:
    ``create_predictor(model, Config())`` with the defaults (2048 cache
    rows at bf16, buckets 128..2048). Greedy over the 8 prompts, 32 new
    tokens (TTFT, decode tok/s, first tokens beside the contiguous
    engine's: reported, not asserted, as bf16 near-ties part them);
    sampling (top_k 50, top_p 0.9, temperature 0.8, repetition penalty
    1.2) twice from one seed, with the same tokens; beam search, 2 prompts
    x 4 beams. ``generate`` decodes through the shared-index branch and
    must launch no kernel; ``run`` on one prompt must launch the flash
    forward (row 5) once per layer and nothing else."""
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = model.config
    pred = create_predictor(model, Config())
    ids = np.stack(prompts)
    pred.generate(ids[:2], max_new_tokens=2)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    greedy = pred.generate(ids, max_new_tokens=32)
    wall = time.perf_counter() - t0
    ttft = pred.last_ttft_ms
    counts = read_launches()
    if greedy.shape != (8, 32) or not ((greedy >= 0)
                                       & (greedy < cfg.vocab_size)).all():
        raise AssertionError(f"predictor greedy: bad tokens {greedy}")
    if any(counts.values()):
        raise AssertionError(f"predictor generate launched {counts}")
    decode_tps = (greedy.size - len(ids)) / (wall - ttft / 1e3)
    first_equal = int(sum(int(g) == o[0]
                          for g, o in zip(greedy[:, 0], contiguous_outs)))
    kw = dict(max_new_tokens=16, decode_strategy="sampling", top_k=50,
              top_p=0.9, temperature=0.8, repetition_penalty=1.2, seed=5)
    sampled = pred.generate(ids, **kw)
    if not np.array_equal(sampled, pred.generate(ids, **kw)):
        raise AssertionError("predictor sampling: one seed gave two "
                             "token sequences")
    t0 = time.perf_counter()
    beam = pred.generate(ids[:2], max_new_tokens=16, num_beams=4)
    beam_wall = time.perf_counter() - t0
    beam_ttft = pred.last_ttft_ms
    scores = pred._last_beam_scores
    if beam.shape != (2, 16) or not np.isfinite(scores).all():
        raise AssertionError(f"predictor beam: {beam.shape}, {scores}")
    reset_launches()
    logits = pred.run(ids[:1])
    torch.cuda.synchronize()
    run_counts = read_launches()
    want = dict.fromkeys(run_counts, 0)
    want["flash_attention_fwd"] = cfg.num_hidden_layers
    if run_counts != want:
        raise AssertionError(f"predictor run: launches {run_counts}, "
                             f"expected {want}")
    if tuple(logits.shape) != (1, ids.shape[1], cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("predictor run: bad logits")
    out = {
        "card": nvidia_smi_line(),
        "model": "llama2_7b width, random bf16 weights (seed 0)",
        "config": pred.config.summary(), "batch": len(ids),
        "prompt_tokens": ids.shape[1], "max_new_tokens": 32,
        "ttft_ms": ttft, "decode_tokens_per_s": decode_tps, "wall_s": wall,
        "first_tokens_equal_to_contiguous_engine": first_equal,
        "tokens_digest": tokens_digest(greedy.tolist()),
        "sampling_reproducible": True,
        "beam": {"batch": 2, "num_beams": 4, "max_new_tokens": 16,
                 "ttft_ms": beam_ttft, "wall_s": beam_wall,
                 "scores": scores.tolist()},
        "run_flash_attention_fwd_launches": run_counts[
            "flash_attention_fwd"],
        "run_first_token_equal_to_greedy": int(
            logits[0, -1].float().argmax()) == int(greedy[0, 0])}
    print(f"predictor: greedy 8 x 32 tokens, TTFT {ttft:.2f} ms, decode "
          f"{decode_tps:.1f} tok/s, {first_equal}/8 first tokens equal to "
          f"the contiguous engine's; beam 2 x 4 in {beam_wall:.3f} s; run: "
          f"{cfg.num_hidden_layers} row-5 launches", flush=True)
    print(json.dumps({"predictor": out}), flush=True)
    return out


def legacy_engine_phase(model, prompts, contiguous_outs, paged_outs):
    """The legacy bucketed prefill (``PT_FLAGS_prefill_chunk=0``) at 7B
    width, bf16: the 8 prompts, 32 new tokens, each prefilled alone as a
    ``[1, 128]`` bucket, through the contiguous engine (row 1), the paged
    engine (row 2) and the paged engine with fused decode off (row 3).
    Each run must launch its decode kernel once per layer per decode
    forward and nothing else, take 8 bucketed prefills and no chunk, and
    (paged) return every page. TTFT p50, decode tok/s and the first tokens
    beside the chunked engines' (reported, not asserted)."""
    from paddle_tpu_torch import flags

    layers = model.config.num_hidden_layers
    paged = dict(paged=True, page_size=PAGE)
    saved = flags.flag("prefill_chunk")
    flags.set_flags({"prefill_chunk": 0})
    out = {"card": nvidia_smi_line()}
    try:
        serve(model, prompts[:2], "auto", max_new_tokens=4, max_chunk=4)
        for label, fused, config, row, ref in (
                ("contig", "auto", {}, "fused_contiguous_decode_attention",
                 contiguous_outs),
                ("paged", "auto", paged, "fused_paged_decode_attention",
                 paged_outs),
                ("paged_unfused", "off", paged, "paged_decode_attention",
                 paged_outs)):
            reset_launches()
            reqs, wall, stats = serve(model, prompts, fused, **config)
            counts = read_launches()
            want = dict.fromkeys(counts, 0)
            want[row] = layers * stats["decode_forwards"]
            if counts != want or want[row] <= 0 \
                    or stats["prefill_bucket"] != 8 \
                    or stats["prefill_chunk"] != 0:
                raise AssertionError(f"legacy {label}: launches {counts}, "
                                     f"expected {want}; stats {stats}")
            outs = [r.output for r in reqs]
            for o in outs:
                if len(o) != 32 or not all(0 <= t < model.config.vocab_size
                                           for t in o):
                    raise AssertionError(f"legacy {label}: bad output {o}")
            ttft = [r.ttft_ms for r in reqs]
            decode_tps = sum(len(o) - 1 for o in outs) / (
                wall - max(ttft) / 1e3)
            out[label] = {
                "ttft_p50_ms": float(np.median(ttft)), "ttft_ms": ttft,
                "decode_tokens_per_s": decode_tps, "wall_s": wall,
                "decode_forwards": stats["decode_forwards"],
                "launches": {row: counts[row]}, "pool": stats["pool"],
                "first_tokens_equal_to_chunked": int(sum(
                    a[0] == b[0] for a, b in zip(outs, ref))),
                "first_divergence_from_chunked": first_divergence(outs, ref),
                "tokens_digest": tokens_digest(outs)}
            print(f"legacy {label}: TTFT p50 "
                  f"{out[label]['ttft_p50_ms']:.2f} ms, decode "
                  f"{decode_tps:.1f} tok/s, {row} launches {counts[row]} = "
                  f"{layers} layers x {stats['decode_forwards']} decode "
                  f"forwards, first tokens equal to chunked "
                  f"{out[label]['first_tokens_equal_to_chunked']}/8"
                  + (f", pool {stats['pool']}" if config else ""),
                  flush=True)
    finally:
        flags.set_flags({"prefill_chunk": saved})
    print(json.dumps({"legacy_engines": out}), flush=True)
    return out


def legacy_reference_phase():
    """A tiny float32 Llama (head_dim 64, group 2) on the card and on the
    CPU from the same weights: the Predictor's greedy and beam tokens
    (``max_seq_len`` 64, buckets 16 and 32, float32 caches) are identical
    and the beam scores agree to 1e-4; on the card, the legacy bucketed
    engines' greedy tokens (contiguous and paged) equal the chunked
    engines' for 5 queued prompts over 2 slots."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (Config,
                                            ContinuousBatchingEngine,
                                            EngineConfig, Predictor)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256)
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    host = LlamaForCausalLM(cfg, device="cpu", seed=1)
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (2, 7))
    pcfg = Config()
    pcfg.max_seq_len, pcfg.seq_buckets = 64, (16, 32)
    pcfg.decode_dtype = torch.float32
    got = {}
    for dev, m in (("cuda", model), ("cpu", host)):
        pred = Predictor(m, pcfg)
        got[dev] = (pred.generate(ids, max_new_tokens=12),
                    pred.generate(ids, max_new_tokens=8, num_beams=3,
                                  length_penalty=1.0, temperature=0.7),
                    pred._last_beam_scores)
    (g_card, b_card, s_card), (g_cpu, b_cpu, s_cpu) = got["cuda"], got["cpu"]
    if not np.array_equal(g_card, g_cpu) or not np.array_equal(b_card,
                                                               b_cpu):
        raise AssertionError(f"legacy reference: predictor tokens on the "
                             f"card {g_card} / {b_card} differ from the "
                             f"CPU's {g_cpu} / {b_cpu}")
    score_err = float(np.abs(s_card - s_cpu).max())
    if score_err > 1e-4:
        raise AssertionError(f"legacy reference: beam scores differ by "
                             f"{score_err}")
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (3, 40, 17, 9, 33)]
    saved = flags.flag("prefill_chunk")
    try:
        for paged in (False, True):
            extra = dict(paged=True, page_size=16) if paged else {}
            outs = {}
            for chunk in (0, 16):
                flags.set_flags({"prefill_chunk": chunk,
                                 "fused_decode": "auto"})
                reset_launches()
                eng = ContinuousBatchingEngine(
                    model, EngineConfig(max_slots=2, max_len=128,
                                        seq_buckets=(32,),
                                        cache_dtype=torch.float32, **extra),
                    device="cuda")
                outs[chunk] = [r.output for r in eng.run(
                    prompts, max_new_tokens=12, max_chunk=4)]
                row = "fused_paged_decode_attention" if paged \
                    else "fused_contiguous_decode_attention"
                if read_launches()[row] != cfg.num_hidden_layers \
                        * eng.stats["decode_forwards"]:
                    raise AssertionError(f"legacy reference: {row} "
                                         f"launches {read_launches()}")
                if paged:
                    check_pool("legacy reference", eng)
            if outs[0] != outs[16]:
                raise AssertionError(
                    f"legacy reference ({'paged' if paged else 'contig'}): "
                    f"legacy tokens {outs[0]} differ from chunked "
                    f"{outs[16]}")
    finally:
        flags.set_flags({"prefill_chunk": saved})
    print(f"legacy reference: tiny float32 Llama, Predictor greedy 2 x 12 "
          f"and beam 2 x 3 x 8 tokens equal on the card and the CPU (beam "
          f"scores within {score_err:.2e}); legacy engines' tokens equal "
          f"the chunked engines' on the card, contiguous and paged",
          flush=True)


def wave_profile(model, prompts, label, max_new_tokens=1, fused="auto",
                 **config):
    """Device time by operation of one run of the 8 prompts through a
    fresh engine (``fused``: the ``fused_decode`` flag), from
    ``torch.profiler``: with ``max_new_tokens=1`` the prefill wave alone
    (one 256-token chunk), with 9 the wave and one chunk of 8 decode
    forwards. Prints the run's wall time, the device time summed over
    operations, the heaviest operations, and the decode kernels' device
    time by row (the split kernel's row policy in its name) and per decode
    forward."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    flags.set_flags({"fused_decode": fused})
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, **config),
        device="cuda")
    eng.run(prompts[:2], max_new_tokens=max_new_tokens)  # warm-up
    torch.cuda.synchronize()
    forwards0 = eng.stats["decode_forwards"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(prompts, max_new_tokens=max_new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # each kernel's time shows twice: on its own event and on the operator
    # that launched it; the total sums kernels, the top list operators
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in events
                  if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=dev_us, reverse=True)
    top = [(e.key[:60], round(dev_us(e) / 1e3, 3), e.count)
           for e in ops[:6]]
    # the decode kernels (rows 1-3; launched through ctypes, so under no
    # operator), by kernel name, and by row
    decode = [e for e in kernels if "decode_kernel" in e.key]
    decode_ms = sum(dev_us(e) for e in decode) / 1e3
    decode_launches = sum(e.count for e in decode)
    by_row = {layout: sum(dev_us(e) for e in decode if rows in e.key) / 1e3
              for rows, layout in SPLIT_ROWS.items()}
    forwards = eng.stats["decode_forwards"] - forwards0
    per_forward = decode_ms / forwards if forwards else None
    print(f"profile {label} fused_decode={fused} (max_new_tokens="
          f"{max_new_tokens}): wall {wall_ms:.2f} ms, kernel time "
          f"{total_ms:.2f} ms; heaviest operators (name, device ms, calls):"
          f" {top}; decode kernels {decode_ms:.3f} ms in {decode_launches} "
          f"launches, by row {by_row}, {forwards} decode forwards"
          + (f", {per_forward:.4f} ms a forward" if forwards else ""),
          flush=True)
    return dict(wall_ms=wall_ms, device_ms=total_ms, top=top,
                decode_kernel_ms=decode_ms,
                decode_kernel_launches=decode_launches,
                decode_kernel_ms_by_row=by_row, decode_forwards=forwards,
                decode_kernel_ms_per_forward=per_forward)


# ---------------------------------------------------------------------------
# SLO scheduling, step_adaptive and the serving front door
# ---------------------------------------------------------------------------
# the serving flags at their defaults (earlier phases leave fused decode
# off, the legacy prefill on, speculative decoding on)
SERVING_DEFAULTS = {"fused_decode": "auto", "prefill_chunk": 256,
                    "prefix_cache": True, "spec_decode": "off"}
PROBE_CHUNK = 2                      # step_adaptive's short chunk
BENCH_GAPS = (0.300, 0.150, 0.075)   # bench_infer's arrival gaps, s
BENCH_MODES = ("chunked", "blocking", "adaptive")


def bench_infer_config():
    """``benchmarks/suite.py: bench_infer``'s Llama: vocab 32000, hidden
    1024, intermediate 2816, 16 layers, 8 heads, 8 kv heads, bf16."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=16,
                       num_attention_heads=8, num_key_value_heads=8,
                       max_position_embeddings=2048, dtype="bfloat16")


def run_load(eng, prompts, new_tokens, gap, max_chunk, mode):
    """``bench_infer``'s steady-arrival sweep: a request every ``gap`` s
    while earlier ones decode, driven by ``step_chunk`` (``chunked``),
    with admission blocking the loop first (``blocking``: ``_admit``), or
    by ``step_adaptive`` (``adaptive``). Returns TTFT p50/p99 from
    ``Request.ttft_ms``, served tokens/s and the decode chunk lengths
    taken (a histogram)."""
    eng._finished.clear()
    eng.metrics_window_reset()
    ks = {}
    step_chunk = eng.step_chunk

    def counted(k):
        ks[k] = ks.get(k, 0) + 1
        return step_chunk(k)

    eng.step_chunk = counted
    try:
        t_start = time.perf_counter()
        submitted = 0
        next_arrival = t_start
        while True:
            now = time.perf_counter()
            while submitted < len(prompts) and now >= next_arrival:
                eng.add_request(prompts[submitted], new_tokens)
                submitted += 1
                next_arrival += gap
                now = time.perf_counter()
            if mode == "blocking" and eng._queue:
                eng._admit()
            if mode == "adaptive":
                busy = eng.step_adaptive(max_chunk, probe_chunk=PROBE_CHUNK)
            else:
                busy = eng.step_chunk(max_chunk)
            if submitted >= len(prompts) and not busy \
                    and not eng.active.any():
                break
        t_total = time.perf_counter() - t_start
    finally:
        del eng.step_chunk
    reqs = [eng._finished[r] for r in sorted(eng._finished)]
    if len(reqs) != len(prompts) or any(
            len(r.output) != new_tokens for r in reqs):
        raise AssertionError(f"{mode} at {gap * 1e3:.0f} ms: "
                             f"{[len(r.output) for r in reqs]} tokens")
    ttft = np.array([r.ttft_ms for r in reqs])
    return {"mode": mode, "gap_ms": gap * 1e3,
            "p50_ttft_ms": float(np.percentile(ttft, 50)),
            "p99_ttft_ms": float(np.percentile(ttft, 99)),
            "served_tokens_per_s": sum(len(r.output) for r in reqs)
            / t_total, "wall_s": t_total, "n_requests": len(reqs),
            "chunk_lengths": {str(k): n for k, n in sorted(ks.items())}}


def bench_infer_phase():
    """``bench_infer``'s load on the card: its Llama (random bf16 weights
    from seed 0), ``EngineConfig(max_slots=8, max_len=512,
    seq_buckets=(128,))`` with a bf16 cache and the default flags (prefix
    cache on), 24 seeded prompts of 120 tokens with 64 new tokens each,
    arriving every 300, 150 and 75 ms, in the chunked, blocking and
    adaptive modes, after ``bench_infer``'s warm-up (a 2-token request at
    K 8 and at K 2) and its unloaded point. Row 1 must launch once per
    layer per decode forward of the loads."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM

    flags.set_flags(SERVING_DEFAULTS)
    cfg = bench_infer_config()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=512, seq_buckets=(128,)),
        device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (120,)) for _ in range(24)]
    max_chunk, new_tokens = 8, 64
    eng.run([prompts[0]], max_new_tokens=2, max_chunk=max_chunk)
    eng.run([prompts[0]], max_new_tokens=2, max_chunk=PROBE_CHUNK)
    unloaded = run_load(eng, prompts[:1], new_tokens, 1e-3, max_chunk,
                        "chunked")
    reset_launches()
    forwards0 = eng.stats["decode_forwards"]
    runs = [run_load(eng, prompts, new_tokens, gap, max_chunk, mode)
            for mode in BENCH_MODES for gap in BENCH_GAPS]
    launches = read_launches()["fused_contiguous_decode_attention"]
    forwards = eng.stats["decode_forwards"] - forwards0
    if launches <= 0 or launches != cfg.num_hidden_layers * forwards:
        raise AssertionError(f"bench_infer shape: row 1 launched {launches}"
                             f" times over {forwards} decode forwards")
    for r in runs:
        print(f"bench_infer shape {r['mode']} gap {r['gap_ms']:.0f} ms: "
              f"TTFT p50 {r['p50_ttft_ms']:.2f} p99 {r['p99_ttft_ms']:.2f} "
              f"ms, {r['served_tokens_per_s']:.1f} served tok/s, chunk "
              f"lengths {r['chunk_lengths']}", flush=True)
    print(json.dumps({"bench_infer_shape": {
        "model": "bench_infer Llama (hidden 1024, 16 layers, 8 heads, "
                 "vocab 32000), random bf16 weights (seed 0)",
        "slots": 8, "max_len": 512, "requests": 24, "prompt_tokens": 120,
        "new_tokens": new_tokens, "max_chunk": max_chunk,
        "probe_chunk": PROBE_CHUNK, "unloaded": unloaded, "runs": runs,
        "row1_launches": launches, "decode_forwards": forwards}}),
        flush=True)
    return launches


def sse_request(url, body, out, key):
    """One streamed completion: ``out[key]`` holds the token chunks as
    they come (with the seconds since the request was sent), then the
    finish reason (and its time), whether ``[DONE]`` came, or the
    client's error."""
    import urllib.request

    t0 = time.perf_counter()
    got = out[key] = {"chunks": [], "reason": None, "done": False}
    try:
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            for raw in resp:
                line = raw.strip()
                if line == b"data: [DONE]":
                    got["done"] = True
                    break
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                if "error" in ev:
                    got["error"] = ev["error"]["message"]
                    break
                choice = ev["choices"][0]
                t = time.perf_counter() - t0
                if choice["token_ids"]:
                    got["chunks"].append((t, choice["token_ids"]))
                if choice["finish_reason"] is not None:
                    got["reason"] = (t, choice["finish_reason"])
    except Exception as e:  # reported and failed on by the caller
        got["error"] = repr(e)


def front_door_run(model, bulk, inter, scheduler):
    """The front door over a fresh 7B-width paged engine: 16 ``batch``
    streams of tenant ``bulk`` (64 new tokens), then, once 4 of them have
    their first tokens, 8 ``interactive`` streams of tenant ``acme`` (16
    new tokens; the last with ``deadline_ms`` 20), each from a client
    thread. Returns the streams, the engine's SLO and scheduler counters
    and its pool after the run."""
    import threading

    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.serving_api import start_api_server

    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, paged=True,
                            page_size=PAGE), device="cuda")
    out = {}
    threads = []

    def send(key, body):
        t = threading.Thread(target=sse_request,
                             args=(srv.url, body, out, key))
        t.start()
        threads.append(t)

    srv = start_api_server(eng, scheduler=scheduler, max_chunk=8)
    try:
        for i, p in enumerate(bulk):
            send(("bulk", i), {"prompt": p.tolist(), "max_tokens": 64,
                               "tenant": "bulk", "slo": "batch"})
        end = time.perf_counter() + 120
        while time.perf_counter() < end and sum(
                1 for (tenant, _), got in list(out.items())
                if tenant == "bulk" and got["chunks"]) < 4:
            time.sleep(0.005)
        for i, p in enumerate(inter):
            body = {"prompt": p.tolist(), "max_tokens": 16,
                    "tenant": "acme", "slo": "interactive"}
            if i == len(inter) - 1:
                body["deadline_ms"] = 20.0
            send(("acme", i), body)
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("front door: a client did not finish")
    finally:
        srv.shutdown()
    return out, eng.slo_snapshot(), dict(eng.sched_stats), \
        check_pool("front door", eng)


def front_door_phase(model):
    """``start_api_server`` on 127.0.0.1 over the 32-layer paged engine,
    FIFO and then ``SLOFairScheduler(tenants={"bulk":
    TenantQuota(max_slots=4), "acme": TenantQuota(weight=2.0)},
    ttft_margin_ms=250)`` (an interactive request is at risk from the
    moment it waits, so preemption fires when no slot is free). Every
    stream ends with ``[DONE]``, its first chunk before its finish; each
    request's first token equals a FIFO library run's over the same
    prompts; slo_fair preempts at least once; the deadline request
    finishes ``"timeout"``; every page comes back. Prints interactive
    TTFT p50 (client clock: send to first token chunk) under both, and
    the goodput."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.serving_api import SLOFairScheduler, TenantQuota

    flags.set_flags(SERVING_DEFAULTS)
    cfg = model.config
    rng = np.random.default_rng(16)
    bulk = [rng.integers(1, cfg.vocab_size, 120) for _ in range(16)]
    inter = [rng.integers(1, cfg.vocab_size, 120) for _ in range(8)]
    lib = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, paged=True,
                            page_size=PAGE), device="cuda")
    first = [r.output[0] for r in lib.run(bulk + inter, max_new_tokens=1)]
    del lib
    reset_launches()
    results = {}
    for name, sched in (
            ("fifo", None),
            ("slo_fair", SLOFairScheduler(
                tenants={"bulk": TenantQuota(max_slots=4),
                         "acme": TenantQuota(weight=2.0)},
                ttft_margin_ms=250.0))):
        out, slo, sched_stats, pool = front_door_run(model, bulk, inter,
                                                     sched)
        for (tenant, i), got in sorted(out.items()):
            label = f"front door {name} {tenant} {i}"
            deadline = tenant == "acme" and i == len(inter) - 1
            if "error" in got or not got["done"] \
                    or got["reason"] is None:
                raise AssertionError(f"{label}: {got}")
            want_reason = "timeout" if deadline else "max_new_tokens"
            if got["reason"][1] != want_reason:
                raise AssertionError(f"{label}: finished "
                                     f"{got['reason'][1]}")
            if deadline:
                continue
            if not got["chunks"] or got["chunks"][0][0] >= got["reason"][0]:
                raise AssertionError(f"{label}: no token chunk before the "
                                     "finish")
            want = first[i if tenant == "bulk" else len(bulk) + i]
            if got["chunks"][0][1][0] != want:
                raise AssertionError(
                    f"{label}: first token {got['chunks'][0][1][0]}, the "
                    f"FIFO library run's {want}")
        ttft = [out[("acme", i)]["chunks"][0][0] * 1e3
                for i in range(len(inter) - 1)]
        results[name] = {
            "interactive_ttft_ms": ttft,
            "interactive_ttft_p50_ms": float(np.median(ttft)),
            "bulk_ttft_p50_ms": float(np.median(
                [out[("bulk", i)]["chunks"][0][0] * 1e3
                 for i in range(len(bulk))])),
            "goodput": slo["goodput"], "slo": slo,
            "scheduler": sched_stats, "pool": pool}
        print(f"front door {name}: interactive TTFT p50 "
              f"{results[name]['interactive_ttft_p50_ms']:.2f} ms, bulk "
              f"{results[name]['bulk_ttft_p50_ms']:.2f} ms, goodput "
              f"{slo['goodput']}, preemptions {sched_stats['preemptions']}",
              flush=True)
    counts = read_launches()
    if results["slo_fair"]["scheduler"]["preemptions"] < 1:
        raise AssertionError("front door: slo_fair never preempted")
    if counts["fused_paged_decode_attention"] <= 0:
        raise AssertionError("front door: row 2 was not launched")
    print(json.dumps({"front_door": {
        "model": "llama2_7b width, 32 layers, random bf16 weights (seed 0)",
        "engine": "paged, 8 slots, max_len 1024, 64-token pages",
        "bulk": "16 batch streams, 120 + 64 tokens",
        "acme": "8 interactive streams, 120 + 16 tokens, one deadline_ms 20",
        "runs": results,
        "row2_launches": counts["fused_paged_decode_attention"]}}),
        flush=True)


def slo_reference_run(model, device, paged):
    """A tiny float32 Llama engine under the SLO-fair scheduler: 3 batch
    requests, 2 interactive ones from the third tick (preemption fires:
    every TTFT target is at risk at a margin of 1e9 ms), one ``preempt``
    forced on slot 0 at the sixth tick, driven by ``step_adaptive(4,
    probe_chunk=2)``. Returns the tokens, finish reasons, first-admission
    order and preemption count."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)
    from paddle_tpu_torch.serving_api import SLOFairScheduler, TenantQuota

    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=2, max_len=128, page_size=16,
                            paged=paged, cache_dtype=torch.float32),
        device=device)
    eng.set_scheduler(SLOFairScheduler(
        tenants={"bulk": TenantQuota(max_slots=2)}, ttft_margin_ms=1e9,
        preempt=True))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, model.config.vocab_size, n)
               for n in (9, 33, 17, 40, 12)]
    batch = dict(tenant="bulk", slo="batch", ttft_target_ms=1e12,
                 tpot_target_ms=1e12)
    rids = [eng.add_request(p, 14, **batch) for p in prompts[:3]]
    forced = False
    for tick in range(1, 400):
        if tick == 3:
            rids += [eng.add_request(p, 8, tenant="acme",
                                     slo="interactive") for p in prompts[3:]]
        if tick == 6:
            forced = eng.preempt(0)
        busy = eng.step_adaptive(4, probe_chunk=2)
        if tick > 6 and not (busy or eng._queue or eng.active.any()):
            break
    reqs = [eng._finished[r] for r in rids]
    order = [r.rid for r in sorted(reqs, key=lambda r: r._admit_t)]
    return ([r.output for r in reqs], [r.finish_reason for r in reqs],
            order, eng.sched_stats["preemptions"], forced)


def slo_reference_phase():
    """A tiny float32 Llama (head_dim 64, group 2) on the card (rows 1 and
    2) and the same weights on the CPU (their plain versions): the
    SLO-fair run of ``slo_reference_run``, contiguous and paged, gives
    identical tokens, reasons, admission order and preemptions, with a
    forced preemption mid-decode."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    flags.set_flags(SERVING_DEFAULTS)
    cpu, card = card_and_cpu(lambda dev, seed: LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256), device=dev, seed=seed), 3)
    for paged, row in ((False, "fused_contiguous_decode_attention"),
                       (True, "fused_paged_decode_attention")):
        label = "slo reference " + ("paged" if paged else "contiguous")
        reset_launches()
        got = slo_reference_run(card, "cuda", paged)
        launches = read_launches()[row]
        want = slo_reference_run(cpu, "cpu", paged)
        if got != want:
            raise AssertionError(f"{label}: card {got}, CPU {want}")
        if not got[4] or got[3] < 3:
            raise AssertionError(f"{label}: {got[3]} preemptions (forced "
                                 f"{got[4]})")
        if launches <= 0:
            raise AssertionError(f"{label}: {row} was not launched")
        print(f"{label}: card tokens = CPU tokens for {len(got[0])} "
              f"requests, {got[3]} preemptions (one forced), admission "
              f"order {got[2]}, {row} launched {launches} times", flush=True)


def mamba_tf32_phase(plain_ms):
    """The Mamba-130m train step of ``mamba_train_phase`` (2 warm-up and 5
    timed steps, a profile of one) once more under
    ``PT_FLAGS_default_matmul_precision=tensorfloat32``
    (``flags.apply_matmul_precision``), beside the exact float32 step's
    median ``plain_ms``; exact float32 is restored after."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import MambaConfig, MambaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    b, s = SCAN_SHAPE["b"], SCAN_SHAPE["s"]
    cfg = MambaConfig(use_chunked_scan=True)
    model = MambaForCausalLM(cfg, device="cuda", seed=0)
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    flags.apply_matmul_precision("tensorfloat32")
    try:
        losses, _, step_ms, _, peak_gb = train_steps(ts, batch)
        # the GEMMs' device time under TF32 (aten::mm in the profile)
        prof = profile_step("mamba 130m tf32", ts, batch, SCAN_BODIES)
    finally:
        flags.apply_matmul_precision("float32")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"mamba 130m tf32: losses {losses}")
    med_ms = float(np.median(step_ms))
    print(f"mamba 130m tf32: 5 timed steps {[round(x, 3) for x in step_ms]}"
          f" ms (median {med_ms:.3f} ms against {plain_ms:.3f} exact "
          f"float32), peak {peak_gb:.2f} GB, losses {losses}", flush=True)
    print(json.dumps({"train_mamba130m_tf32": {
        "step_ms": step_ms, "step_ms_median": med_ms,
        "float32_step_ms_median": plain_ms, "peak_memory_gb": peak_gb,
        "losses": losses, "profile": prof}}), flush=True)


T_START = time.perf_counter()


def phase(name, fn, *args, **kw):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.kernels import _build

    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0; got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path = _build.build()
    # this build's compiler output, or the one saved beside a library an
    # earlier process built
    log = str(_build.BUILD_INFO.get("log", "")) or \
        (path.parent / "build.log").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    spilled = re.findall(r"Function properties for (\S+)\n\s+\d+ bytes "
                         r"stack frame, [1-9]\d* bytes spill stores", log)
    print(f"build: {path} in {time.perf_counter() - t0:.1f} s (nvcc "
          f"sm_90a); {len(regs)} kernels, registers max "
          f"{max(regs, default=0)}, spill stores max "
          f"{max(spills, default=0)} bytes in {len(spilled)} kernels "
          f"{spilled}", flush=True)

    decode_build_report(log)
    flash_build_report(log)
    qmm_build_report(log)
    gn_build_report(log)
    scan_build_report(log)
    phase("scan sass", scan_sass_report, path.parent / "selective_scan.o",
          {"train": SCAN_SHAPE, "b1_s8192": SCAN_LONG})
    phase("decode plans", decode_plan_report)
    row = phase("decode kernel", kernel_phase)
    fused_row, block_row = phase("paged kernels", paged_kernel_phase)
    qmm_row = phase("weight-only matmul kernel", quant_kernel_phase)
    qmm_row["mamba_f32"] = phase("weight-only matmul mamba f32",
                                 qmm_mamba_phase)
    row_i8, fused_row_i8 = phase("int8 decode kernels", int8_decode_phase)
    fa_rows = phase("flash kernels", flash_kernel_phase)
    scan_rows = phase("scan kernels", scan_kernel_phase)
    gn_rows = phase("group norm kernels", gn_kernel_phase)
    phase("reference", reference_phase)
    phase("paged reference", reference_phase, True)
    phase("quant reference", quant_reference_phase)
    phase("train reference", train_reference_phase)
    phase("mamba reference", mamba_reference_phase)
    phase("qat reference", qat_reference_phase)
    phase("unet reference", unet_reference_phase)
    model, prompts = phase("build 7b", build_7b)
    row["launches"], contiguous_outs = phase("engine", engine_phase, model,
                                             prompts)
    fused_row["launches"], block_row["launches"], paged_outs = phase(
        "paged engine", paged_engine_phase, model, prompts, contiguous_outs)
    paged = dict(paged=True, page_size=PAGE)
    counts = phase("quant engine int8w paged", quant_engine_phase,
                   "quant_engine_int8w_paged", model, prompts, paged_outs,
                   weight_dtype="int8", **paged)
    qmm_row["launches"] = counts["weight_only_matmul"]
    phase("quant engine int4w paged", quant_engine_phase,
          "quant_engine_int4w_paged", model, prompts, paged_outs,
          weight_dtype="int4", **paged)
    counts = phase("quant engine int8w int8kv paged", quant_engine_phase,
                   "quant_engine_int8w_int8kv_paged", model, prompts,
                   paged_outs, weight_dtype="int8", cache_dtype="int8",
                   **paged)
    fused_row_i8["launches"] = counts["fused_paged_decode_attention"]
    counts = phase("quant engine int8kv contig", quant_engine_phase,
                   "quant_engine_int8kv_contig", model, prompts,
                   contiguous_outs, cache_dtype="int8")
    row_i8["launches"] = counts["fused_contiguous_decode_attention"]
    phase("prefix and spec", prefix_spec_phase, model)
    phase("predictor", predictor_phase, model, prompts, contiguous_outs)
    phase("legacy engines", legacy_engine_phase, model, prompts,
          contiguous_outs, paged_outs)
    phase("legacy reference", legacy_reference_phase)
    phase("slo reference", slo_reference_phase)
    phase("front door 7b", front_door_phase, model)
    # where the time goes: the prefill wave alone, and with one chunk of
    # 8 decode forwards, for the bf16 and the quantized engines
    t0 = time.perf_counter()
    profiles = {}
    for label, config in (("bf16_contig", {}),
                          ("int8kv_contig", dict(cache_dtype="int8")),
                          ("bf16_paged", paged),
                          ("int8w_paged", dict(paged, weight_dtype="int8")),
                          ("int8w_int8kv_paged",
                           dict(paged, weight_dtype="int8",
                                cache_dtype="int8"))):
        for n in (1, 9):
            profiles[f"{label}_new{n}"] = wave_profile(
                model, prompts, label, max_new_tokens=n, **config)
    # the unfused paged engine: row 3 once per layer per decode forward
    unfused = wave_profile(model, prompts, "bf16_paged", max_new_tokens=9,
                           fused="off", **paged)
    table_ms = unfused["decode_kernel_ms_by_row"]["table"]
    if table_ms <= 0 or not math.isclose(table_ms,
                                         unfused["decode_kernel_ms"]):
        raise AssertionError(f"the unfused paged profile shows row 3 at "
                             f"{table_ms} ms of {unfused['decode_kernel_ms']}"
                             " ms of decode kernels")
    profiles["bf16_paged_unfused_new9"] = unfused
    print(json.dumps({"profiles": profiles}), flush=True)
    print(f"phase serving profiles: {time.perf_counter() - t0:.1f} s",
          flush=True)
    del model, prompts
    torch.cuda.empty_cache()
    phase("bench_infer shape", bench_infer_phase)
    torch.cuda.empty_cache()
    counts, unfused = phase("train 7b", train_7b_phase)
    for name, n in counts.items():
        fa_rows[name]["launches"] = n
    torch.cuda.empty_cache()
    phase("train 7b fused head loss", train_7b_fused_head_phase, unfused)
    torch.cuda.empty_cache()
    phase("train 7b lamb", train_7b_lamb_phase)
    torch.cuda.empty_cache()
    phase("optimizers reference", optimizers_reference_phase)
    phase("dropout and nan checks", dropout_and_nan_phase)
    torch.cuda.empty_cache()
    counts, plain_ms = phase("train mamba 130m", mamba_train_phase)
    for name, n in counts.items():
        scan_rows[name]["launches"] = n
    torch.cuda.empty_cache()
    phase("train mamba 130m tf32", mamba_tf32_phase, plain_ms)
    torch.cuda.empty_cache()
    qmm_row["mamba_f32"]["launches"] = phase("qat mamba 130m",
                                             qat_mamba_phase, plain_ms)
    torch.cuda.empty_cache()
    for name, n in phase("train unet", unet_train_phase).items():
        gn_rows[name]["launches"] = n
    kernels = {"kernels": [row, row_i8, fused_row, fused_row_i8, block_row,
                           qmm_row, *fa_rows.values(), *scan_rows.values(),
                           *gn_rows.values()]}
    for r in kernels["kernels"]:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            # no single PyTorch call computes the scan (rows 10-11)
            if r[key] is None and key == "library_ms" \
                    and r["name"] in SCAN_KERNELS:
                continue
            if not math.isfinite(r[key]):
                raise AssertionError(f"{key} is not finite: {r[key]}")
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its "
                                 "path")
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all",
          flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
