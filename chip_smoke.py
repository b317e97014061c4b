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
   exact float32 is restored after;
38. resilience reference (after phase 35): a tiny float32 Llama on the
   card (rows 1-2) and the CPU, contiguous and paged, sanitized, under a
   seeded step/NaN/latency/pool storm: the card's tokens equal the CPU's
   and a clean run's, ``resilience_snapshot()`` is identical on both
   with recoveries and NaN steps; then a decode forward raising
   ``torch.OutOfMemoryError`` under ``serve_recovery=all``: one rebuild,
   the clean tokens, the memory held after the run within 1 MB of the
   clean engine's;
39. router reference: the same model in a sanitized 2-replica paged
   ``EngineRouter`` on the card and the CPU under a seeded replica
   crash/hang storm with one scripted crash: card tokens = CPU tokens = a
   single clean engine's, ``fleet_snapshot()`` identical, failovers >= 1;
40. router 7b: the 32-layer engine's model, one clean paged engine and a
   2-replica router, 16 prompts of 120 + 32 tokens, clean and under the
   storm: lengths, first tokens equal to the clean engine's (the first
   divergence printed), every pool back; wall time, served tok/s, TTFT
   p50, failovers, peak memory, one replay prefill's device time; then a
   drain -> ``admit_ledger`` handoff between the replicas' engines
   mid-generation;
41. obs reference (after phase 40): a tiny float32 Llama, paged, on the
   card and the CPU from the same weights with the observability layer on
   (JAX's defaults plus ``profile_programs`` every 2nd dispatch, the time
   series and alerts): equal tokens, Prometheus sample names and label
   sets, counters and histogram counts, per-request tracer event names,
   ``hbm_snapshot()``, recompile counts, profiler dispatch/sample counts
   and windows; each sampled dispatch's CUDA-event ``device_ms`` is
   positive and no larger than its step's wall;
42. obs 7b: the 32-layer model, paged, 8 slots, the 8 prompts with 32 new
   tokens: a warm-up and five runs each with telemetry off and with JAX's
   defaults (telemetry on, ``trace_sample`` 1.0), interleaved, the same
   tokens every run: TTFT p50, TPOT p50, served tok/s; then ``profile_programs``
   at every dispatch: the schedule / dispatch / device split of the
   prefill chunk, the decode chunk (and per forward) and the decode step;
43. obs front door: ``start_api_server`` over one 32-layer paged engine
   and over a 2-replica ``EngineRouter``, the time series on, 4 SSE
   streams each: ``/metrics`` (parsed), ``/trace`` (``?fleet=1`` on the
   router) and ``/timeline`` answer 200 with the streams in them;
44. train 7b telemetry (after phase 28): phase 20's configuration, 3 steps
   timed with the step's telemetry off, then ``TrainTelemetry(
   sample_every=2)`` with ``log_memory_stats``: the sampled step's loss,
   grad norm, tokens/s, MFU against 989 TFLOP/s (``FlopCounterMode``
   FLOPs, and the analytic count) and peak bytes beside the untelemetered
   step time;
45. flash shapes (after phase 27, the UNet step): rows 5-9 against their
   plain versions (``fa_check``) and timed beside their bounds and
   ``scaled_dot_product_attention`` at GPT-2's (b 8, s 1024, 12 x 64,
   causal bf16), bert-base's (b 16, s 512, padding segments with ragged
   tails), t5-small's cross-attention (sq 128, sk 512, scale 1.0) and
   ERNIE-MoE's (b 4, s 1024, 8 x 128, causal float32) shapes;
46. model references: GPT, BERT (masked LM, padded), T5 and ERNIE-MoE
   (both arms) in float32 at full width and 2 layers, card (kernels) vs
   CPU (plain versions) from the same weights: logits, loss and every
   gradient within ``FAMILY_REF_TOL``, row 5 in the ``no_grad`` forward
   and rows 6 and 8 in the step once a flash layer; a float32 T5 (untied
   head) generating 32 tokens cached = uncached;
47. train gpt2: GPT-2 small (``GPTConfig()``, dropouts 0), bf16 with
   float32 masters, AdamW 3e-4, batch 8 x 1024; then ``create_predictor``
   on 8 prompts of 120 + 32 tokens: TTFT, decode tokens/s;
48. train bert-base: ``BertForSequenceClassification(BertConfig())``,
   dropouts 0, batch 16 x 512 with padded tails, bf16 with masters;
49. train t5-small: ``T5Config()`` with dropout 0, encoder 512 and decoder
   128, batch 16, bf16 with masters; then cached and uncached
   ``generate`` of 32 tokens, first tokens equal;
50. train ernie-moe: ``bench_moe``'s configuration (8 layers, 4 MoE of 8
   experts) in float32, batch 4 x 1024, the capacity (GShard top-2) and
   the dropless arms, each MoE layer's ``last_drop_fraction``. Phases 47-50
   print step ms (median of 5 after 2 warm-ups), tokens/s, MFU from the
   analytic FLOPs, peak GB and the flash kernels' device ms a step, and
   require exactly one launch of rows 6 and 8 a flash layer a step and of
   row 5 a flash layer in an eval forward;
51. vision reference, train vit-l, train resnet50, vision zoo: ViT-L (2
   layers) and ResNet-50 float32 card vs CPU (gradients against float64);
   ViT-L b 32 and ResNet-50 b 64 (BatchNorm and the GroupNorm arm, rows
   12-13) bf16 train steps; one bf16 eval forward of each zoo model;
52. rwkv reference: the RWKV-4 169M widths cut to 2 layers, batch 2 x
   1024, float32, card vs CPU from the same weights: logits, loss and
   every gradient within ``RWKV_REF_TOL``; the card's WKV scan against the
   float64 recurrence on [2, 1024, 64] and at k of +-90;
53. train rwkv-169m: ``RWKVConfig.rwkv4_169m()`` uncut, float32, batch 4 x
   1024, ``AdamW(1e-4, multi_precision=True)``: step ms, tokens/s, MFU
   against 67 TFLOP/s, peak GB, one profiled step's busy share and
   heaviest operators;
54. losses and rnn reference: the 22 losses at moderate sizes (``ctc_loss``
   T 256, B 16, C 32; ``rnnt_loss`` B 4, T 128, U 32, V 128) and
   ``SimpleRNN``/``LSTM``/``GRU`` (2 layers bidirectional, 512, batch 16 x
   256), float32 card vs CPU, values and every gradient, with forward +
   backward ms;
55. speech surface: ``LogMelSpectrogram`` and ``MFCC`` on [8, 64000] card
   vs CPU; ``SpeechCTC`` (log-mel -> GRU -> Linear -> ``ctc_loss``): its
   forward + backward ms and loss, card = CPU. Phases 51-55 launch no
   kernel of rows 1-13;
56. ring attention: ``kernels/ring_attention.py``'s bodies of 4
   virtual ranks run in lockstep on the card (``run_ring_virtual``), b 1,
   s 8192, 32 x 128 heads, bf16, zigzag causal, contiguous causal and
   non-causal, forward and backward: held against one whole-sequence row-6
   call and its backward (bf16 2e-2 row-wise, LSE 4 x 1e-5: a merge of
   up to 4 block LSEs); row 6 a block,
   row 8 a block's backward (rows 7 and 9 in the contiguous layout, run
   at ``flash_attention_block_k=256``), counted exactly; the ring's and
   the whole call's device ms;
57. checkpoint: Llama-2-7B width at 2 layers, bf16 master_only, b 4 x
   2048, through ``TrainStep(mesh=build_mesh())`` over NCCL at world size
   1 (this process joins the group): 3 steps, ``AsyncCheckpointer.save``,
   steps 4-5 while it writes, a fresh step loads it and repeats steps
   4-5 with equal losses; the state's GB, the blocking snapshot's, the
   commit's and the load's seconds, the native writer's GB/s;
58. pipeline: ``llama_pipeline_module`` at 7B width, 4 layers, untied,
   bf16, b 4 x 2048 in 4 micro-batches, ``PipelineTrainStep`` at pp 1
   over NCCL under 1F1B, VPP (vpp 2) and F-then-B, 3 steps each: losses
   within 2e-4 of each other, rows 6 and 8 once a layer a micro-batch;
   ms a step, tokens/s, peak GB. The process then leaves its group;
59. distributed: ``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 1`` runs this script with ``--dist-worker nccl`` in a
   fresh process: every collective over NCCL at world size 1 on CUDA
   tensors (results and ``comm_log()`` checked), then the 7B train
   configuration 3 AdamW steps through ``TrainStep(mesh=build_mesh(),
   strategy)`` at ZeRO stage 3 (degree 1) and 3 through the meshless
   step from the same weights: the losses within 1e-4, rows 6 and 8
   once a layer a step on the mesh path, each arm's step ms, tokens/s
   and peak GB beside the card's name and power limit. At degree 1 the
   mesh arm runs the mesh step's code (the count-weighted loss, the
   slot and clip bookkeeping) but no all-gather, reduce-scatter or tp
   collective: every axis has one rank. Those run over gloo in the
   tests; over NCCL they wait for a 4-card cell. Then
   ``--nproc_per_node 2`` over gloo on the host: the collectives, a tiny
   Llama at dp = 2, a pipeline at pp = 2 (1F1B), sep = 2 with ring and
   with Ulysses attention, a dropless MoE layer at ep = 2 forward and
   backward, and a checkpoint saved at dp = 2 and loaded at fsdp = 2
   (ZeRO-3), each against the meshless result. Both runs' exit codes and
   worker logs are checked and printed;
60. hapi 7b (after phase 44): the paddle namespace's high-level path,
   ``import paddle_tpu_torch as paddle``: phase 20's configuration through
   ``paddle.amp.decorate`` (O2, float32 masters) trains with
   ``paddle.Model(model).prepare(AdamW, loss).fit`` over a
   ``paddle.io.DataLoader`` (shuffled, 2 thread workers) of 7 seeded
   batches: 2 warm-up and 5 timed steps, held to a ``TrainStep`` on the
   same batches and to the model's own first loss; ``evaluate`` and
   ``predict``; rows 5, 6 and 8 counted exactly and against their plain
   versions at this shape; ``summary``/``flops`` on the meta device;
   ``prefetch_to_device`` against synchronous copies; ``Model.save`` and
   ``load`` at 2 layers. Step ms, tokens/s, peak GB and the host's idle
   share beside the TrainStep's and phase 20's steps (``hapi_phase``).
61. kernel ops (after phase 4's kernels): ``torch.library.opcheck`` of
   each of the 14 ``paddle_tpu::*`` ops (rows 1-13) on the card at
   float32, float16 and bfloat16, int8 caches and int8 / int4 weights
   (``kernel_ops_phase``);
62. jit 7b (after phase 60): ``jit.save`` / ``jit.load`` of the phase-20
   model in eval (``InputSpec([None, 2048])``, called at b 1 and 4), an
   int8 weight-only Llama at 2 layers, Mamba-130m at b 4 x 1024 and the
   SD-UNet at sample 32, b 4: the loaded outputs bitwise equal to the
   eager ones, the kernel ops as graph nodes and exactly rows 5, 4, 10
   and 12's launches a call; export, save and load seconds, the file's
   GB, eager and loaded ms (``jit_7b_phase``);
63. abstract 7b: ``TrainStep(abstract=True)`` of Llama-2-7B at 32 layers
   under ``meta_init`` planned without allocating; the 4-layer plan's
   arguments exactly the real step's and its peak against 5 real steps'
   ``max_memory_allocated`` (``abstract_7b_phase``);
64. profiler 7b: ``paddle.profiler`` over 4 steps of that step, one
   record window, its chrome trace parsed, the flash ops' calls equal to
   their launches (``profiler_7b_phase``);
65. vision data and ops: ``FakeData`` through the transforms and a
   4-worker ``DataLoader`` into ResNet-50 bf16 eval (images/s), ``nms``,
   ``roi_align`` (forward and backward) and ``deform_conv2d`` at Faster
   R-CNN R50-FPN sizes against float64 (``vision_data_ops_phase``);
66. linalg, distribution, sparse: seven decompositions at 4096 and a
   batch of 1024 32 x 32 matrices against float64, densities card = CPU
   and the moments of 10^7 draws, an 8192 x 8192 1% sparse product card =
   CPU (``linalg_dist_sparse_phase``).

Every number phases 38-66 print stands beside the card's name and power
limit. Each phase prints its wall time. Every kernel's launch count is set to 0
just before the run that reports it and read just after.

The last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result, when no CUDA device is present.
"""

from __future__ import annotations

import copy
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
# the flash kernels' names in a profile (the float32 *_v1 bodies too)
FLASH_BODIES = ("fwd_kernel", "dq_kernel", "dkv_kernel")
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


def padded_lengths(b, s):
    """Real lengths of a padded batch: ragged tails, the first row
    unpadded."""
    return [s - (i * 37) % (s // 4) for i in range(b)]


def fa_segments(kind, b, s):
    """Four packed sequences per row, as one [b, s] array or a pair; or
    (``"padding"``) BERT's padding mask of ``padded_lengths`` as segment
    ids, 0 on real tokens and 1 on padding."""
    if kind is None:
        return None
    if kind == "padding":
        lens = torch.tensor(padded_lengths(b, s), device="cuda")
        return (torch.arange(s, device="cuda")[None] >= lens[:, None]).to(
            torch.int32)
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
# lse is float32 on both sides, held absolutely at the logits' scale of
# unit inputs under sm_scale = d ** -0.5; its rounding grows with its
# magnitude, so a larger scale (T5's 1.0: logits sqrt(d) times larger)
# takes the tolerance times sm_scale * sqrt(d) (fa_lse_tol).
FA_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
FA_LSE_TOL = 1e-5


def fa_lse_tol(sm_scale, d):
    return FA_LSE_TOL * max(1.0, sm_scale * d ** 0.5)


def fa_row_err(got, want):
    """The largest relative error of a [d] row (see FA_ROW_TOL) and the
    max abs error."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    den = w.norm(dim=-1)
    floor = (1e-3 * den.square().mean().sqrt()).clamp_min(1e-30)
    rel = (num / torch.maximum(den, floor)).max().item()
    return rel, (g - w).abs().max().item()


def fa_compare(name, got, want, tol, lse_tol=FA_LSE_TOL):
    """Hold each output against its reference: lse (a [b, h, s] float32
    tensor) within ``lse_tol`` absolutely, the others row by row within
    ``tol``. Returns {key: (row err, max abs err)} and the keys that
    failed."""
    errs, failed = {}, []
    for key in got:
        g = got[key]
        if key == "lse":
            err = (g.float() - want[key].float()).abs().max().item()
            errs[key] = (err, err)
            bad = not err <= lse_tol
        else:
            errs[key] = fa_row_err(g, want[key])
            bad = not errs[key][0] <= tol
        if bad or not torch.isfinite(g).all():
            failed.append(key)
    return errs, failed


def fa_check(name, b, s, hq, hk, d, dtype, causal=True, window=0,
             segments=None, seed=0, sk=None, scale=None):
    """Rows 5-9 against their plain versions on one input set: the
    forward without and with LSE, then the dq, dk/dv and fused backward
    from the plain statistics with a nonzero LSE cotangent folded into
    delta; the fused and the two-pass backward must agree (dk, dv bit for
    bit: the same sums in the same order). ``sk`` (``s`` when None) is
    the kv length, ``scale`` the logits' (``d ** -0.5`` when None).
    Returns the max abs errors by kernel."""
    from paddle_tpu_torch.kernels import mha as fa

    q, k, v, do, dlse = fa_inputs(b, s, hq, hk, d, dtype, seed, sk)
    sk = k.shape[1]
    qseg, kseg = fa.split_segments(fa_segments(segments, b, s), q, k)
    kw = dict(causal=causal, sm_scale=d ** -0.5 if scale is None else scale,
              qseg=qseg, kseg=kseg, window=window)
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
    lse_tol = fa_lse_tol(kw["sm_scale"], d)
    errs, failed = fa_compare(name, got, want, tol, lse_tol)
    if failed:
        raise AssertionError(f"flash check {name}: {failed} differ from "
                             f"the plain versions: " + ", ".join(
                                 f"{k} row err {errs[k][0]:.3e} max abs "
                                 f"{errs[k][1]:.3e}" for k in failed)
                             + f" (tol {tol} of a row, lse {lse_tol})")
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
    # then the backward its k_block picks), cotangents (do, dlse), held
    # against the plain backward from that forward's own outputs: autograd
    # takes delta from the kernel's rounded o, as the JAX backward does,
    # and where the softmax is peaked (T5's scale 1.0) a row's dq is of
    # that rounding's size
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o, lse = fa.mha_with_lse(*leaves, causal=causal,
                             sm_scale=kw["sm_scale"],
                             segment_ids=fa_segments(segments, b, s),
                             window=window)
    torch.autograd.backward((o, lse), (do, dlse))
    auto_want = fa.mha_bwd_fused_plain(
        q, k, v, do, lse.detach(), fa.attention_delta(o.detach(), do, dlse),
        span=span, **kw)
    for key, leaf, w in zip(("dq", "dk", "dv"), leaves, auto_want):
        rel, e = fa_row_err(leaf.grad, w)
        if not rel <= tol:
            raise AssertionError(f"flash check {name}: mha_with_lse "
                                 f"gradient {key} differs by {rel} of a "
                                 "row")
        errs[f"autograd_{key}"] = (rel, e)
    print(f"flash check {name}: b={b} s={s} sk={sk} hq={hq} hk={hk} d={d} "
          f"{dtype} "
          f"causal={causal} window={window} segments={segments} "
          f"scale={kw['sm_scale']:.4g}: row err / "
          f"max abs err " + ", ".join(f"{k} {r:.2e}/{e:.2e}"
                                      for k, (r, e) in errs.items())
          + f"; fused vs two-pass dq row err {pass_rel:.2e} (tol {tol} of "
          f"a row, lse {lse_tol:.3g}) ok", flush=True)
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


def fa_bound(name, b, s, hq, hk, d, itemsize, pairs, sk=None):
    """Least time for the function on these inputs: its products over
    the visible pairs (``pairs`` a (batch row, head); forward 2, dq pass
    3, dk/dv pass 4, fused 5 of 2 * d operations each) at the rate of the
    operands' type (bf16/fp16 tensor cores, float32 outside them),
    against each input read once and each output written once (lse and
    delta float32; ``sk`` kv rows, ``s`` when None); the larger of the
    two."""
    qb = b * s * hq * d * itemsize      # q, o, do or dq
    kvb = b * (s if sk is None else sk) * hk * d * itemsize  # k, v, dk, dv
    rows = b * hq * s * 4               # lse or delta
    products, nbytes = {
        "flash_attention_fwd": (2, 2 * qb + 2 * kvb),
        "flash_attention_fwd_lse": (2, 2 * qb + 2 * kvb + rows),
        "flash_attention_bwd_dq": (3, 3 * qb + 2 * kvb + 2 * rows),
        "flash_attention_bwd_dkv": (4, 2 * qb + 4 * kvb + 2 * rows),
        "flash_attention_bwd_fused": (5, 3 * qb + 4 * kvb + 2 * rows),
    }[name]
    ops = products * 2 * d * pairs * b * hq
    rate = H100_F32_FLOPS if itemsize == 4 else H100_BF16_FLOPS
    t_ops = ops / rate * 1e3
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
    prof = profile_step("train 7b", ts, batch, FLASH_BODIES)
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
                    "prefix_cache": True, "spec_decode": "off",
                    "fault_inject": "", "serve_recovery": "auto",
                    "degradation": True, "sanitize": False}
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


# ---------------------------------------------------------------------------
# resilience: fault injection, quarantine and replay, hard recovery, the
# router with failover, drain and ledger handoff
# ---------------------------------------------------------------------------
RES_STORM = "step:0.2,nan:0.1,latency:0.05,pool:0.1"
FLEET_STORM = "replica_crash:0.2,replica_hang:0.08"
FLEET_SCRIPTED_CRASH = 4  # replica_crash's 5th consultation: tick 3


def storm_injector(spec, seed, scripted_crash=None):
    """A seeded ``FaultInjector`` over ``spec``; ``scripted_crash``: the
    ``replica_crash`` consultation that fires whatever the stream draws,
    so that a failover surely happens."""
    from paddle_tpu_torch.inference import FaultInjector

    class Storm(FaultInjector):
        def fire(self, site):
            n = self.draws[site]
            hit = super().fire(site)
            if site == "replica_crash" and n == scripted_crash:
                self.draws[site] = n + 1
                if not hit:
                    self.fires[site] += 1
                hit = True
            return hit

    return Storm(spec, seed=seed, latency_ms=1.0)


def resilience_run(model, device, paged, injector=None, fault_call=None,
                   max_retries=20):
    """A tiny float32 Llama engine (3 slots, ``max_len`` 128, 16-token
    pages) serving 6 seeded prompts of 5-40 tokens, 12 new tokens each,
    by ``step_chunk(4)``, under ``injector``. ``fault_call``: the decode
    forward that raises ``torch.OutOfMemoryError`` (once). Returns the
    tokens, ``resilience_snapshot()``, the engine and the device memory
    it holds after the run (the card: ``memory_allocated`` over the
    value before the engine was built)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    if device == "cuda":
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=3, max_len=128, page_size=16,
                            paged=paged, cache_dtype=torch.float32,
                            max_retries=max_retries),
        device=device, fault_injector=injector)
    if fault_call is not None:
        real = eng._decode_forward
        calls = []

        def failing(*a, **k):
            calls.append(1)
            if len(calls) == fault_call:
                raise torch.OutOfMemoryError("a decode forward failed")
            return real(*a, **k)

        eng._decode_forward = failing
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, model.config.vocab_size, n)
               for n in (5, 40, 17, 9, 33, 24)]
    rids = [eng.add_request(p, 12) for p in prompts]
    for _ in range(2000):
        if not (eng.step_chunk(4) or eng._queue or eng.active.any()):
            break
    else:
        raise AssertionError("resilience run: the engine did not drain")
    reqs = [eng._finished[r] for r in rids]
    if any(r.finish_reason != "max_new_tokens" for r in reqs):
        raise AssertionError(f"resilience run: reasons "
                             f"{[r.finish_reason for r in reqs]}")
    held = None
    if device == "cuda":
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - m0
    return [r.output for r in reqs], eng.resilience_snapshot(), eng, held


def resilience_reference_phase():
    """A tiny float32 Llama on the card (rows 1-2) and the same weights on
    the CPU, contiguous and paged, sanitized, under the seeded
    ``RES_STORM`` (step, NaN, latency and pool faults; ``max_retries`` 20,
    so none fails): the card's tokens equal the CPU's and the card's
    clean run, ``resilience_snapshot()`` is identical on both with
    recoveries and NaN steps, rows 1-2 launched. Then a hard fault under
    ``serve_recovery=all``: the third decode forward of a paged engine
    raises ``torch.OutOfMemoryError`` once; one rebuild, the clean
    tokens, and the memory the engine holds after the run within 1 MB of
    the clean engine's."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    smi = nvidia_smi_line()
    flags.set_flags(dict(SERVING_DEFAULTS, sanitize=True))
    cpu, card = card_and_cpu(lambda dev, seed: LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256), device=dev, seed=seed), 5)
    try:
        for paged, row in ((False, "fused_contiguous_decode_attention"),
                           (True, "fused_paged_decode_attention")):
            label = "resilience reference " + ("paged" if paged
                                               else "contiguous")
            clean, _, _, _ = resilience_run(card, "cuda", paged)
            reset_launches()
            got, snap, eng, _ = resilience_run(
                card, "cuda", paged, storm_injector(RES_STORM, 0))
            launches = read_launches()[row]
            want, want_snap, _, _ = resilience_run(
                cpu, "cpu", paged, storm_injector(RES_STORM, 0))
            if got != want or got != clean:
                raise AssertionError(f"{label}: card storm {got}, CPU storm "
                                     f"{want}, card clean {clean}")
            if snap != want_snap:
                raise AssertionError(f"{label}: card {snap}, CPU "
                                     f"{want_snap}")
            if snap["recoveries"] <= 0 or snap["nan_steps"] <= 0:
                raise AssertionError(f"{label}: the storm never fired: "
                                     f"{snap}")
            if eng._san is None or launches <= 0:
                raise AssertionError(f"{label}: sanitizer {eng._san}, "
                                     f"{row} launched {launches} times")
            print(f"{label} ({smi}): card tokens = CPU tokens = clean "
                  f"tokens for 6 requests; {snap['recoveries']} recoveries,"
                  f" {snap['retries']} retries, {snap['nan_steps']} NaN "
                  f"steps, faults {snap['faults']}, degradation level "
                  f"{snap['degradation']['level']} ("
                  f"{len(snap['degradation']['transitions'])} transitions)"
                  f" on both; {row} launched {launches} times", flush=True)
        clean, _, eng, held_clean = resilience_run(card, "cuda", True)
        del eng
        flags.set_flags({"serve_recovery": "all"})
        got, snap, eng, held = resilience_run(card, "cuda", True,
                                              fault_call=3)
        if got != clean or snap["rebuilds"] != 1 \
                or snap["faults"] != {"error": 1}:
            raise AssertionError(f"resilience hard fault: {snap}, tokens "
                                 f"{got} against {clean}")
        if abs(held - held_clean) > 1 << 20:
            raise AssertionError(f"resilience hard fault: the engine holds "
                                 f"{held} bytes after the run, the clean "
                                 f"one {held_clean}")
        print(f"resilience hard fault ({smi}): 1 rebuild, clean tokens, "
              f"{held} bytes held after the run against {held_clean} "
              "clean", flush=True)
        del eng
    finally:
        flags.set_flags(SERVING_DEFAULTS)


def fleet_run(model, device, injector, prompts, new_tokens, **config):
    """A 2-replica ``EngineRouter`` (sanitized) over ``prompts`` by
    ``step(8)``; returns the requests, ``fleet_snapshot()``, the router
    and the wall time."""
    from paddle_tpu_torch.inference import EngineConfig, EngineRouter

    router = EngineRouter(model, EngineConfig(**config), n_replicas=2,
                          device=device, fault_injector=injector,
                          breaker_cooldown=3, seed=0)
    if router._san is None:
        raise AssertionError("fleet run: the fleet sanitizer is off")
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [router.add_request(p, new_tokens) for p in prompts]
    for _ in range(5000):
        if not router.step(8):
            break
    else:
        raise AssertionError("fleet run: the fleet did not drain")
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [router.result(r) for r in rids]
    if any(r is None or len(r.output) != new_tokens for r in reqs):
        raise AssertionError(f"fleet run: lengths "
                             f"{[r and len(r.output) for r in reqs]}")
    return reqs, router.fleet_snapshot(), router, wall


def router_reference_phase():
    """The tiny float32 Llama in a sanitized 2-replica paged router, on the
    card and on the CPU, under the seeded ``FLEET_STORM`` with one
    scripted crash: card tokens = CPU tokens = a single clean engine's,
    ``fleet_snapshot()`` identical on both with at least one failover."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    smi = nvidia_smi_line()
    flags.set_flags(dict(SERVING_DEFAULTS, sanitize=True))
    cpu, card = card_and_cpu(lambda dev, seed: LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256), device=dev, seed=seed), 6)
    try:
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, 256, n)
                   for n in (9, 33, 17, 40, 12, 26, 21, 7)]
        config = dict(max_slots=2, max_len=128, page_size=16, paged=True,
                      cache_dtype=torch.float32, max_retries=50)
        from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                                EngineConfig)

        ref = [r.output for r in ContinuousBatchingEngine(
            card, EngineConfig(**config), device="cuda").run(
                prompts, 10, max_chunk=8)]
        reset_launches()
        got, snap, router, _ = fleet_run(
            card, "cuda", storm_injector(FLEET_STORM, 5,
                                         FLEET_SCRIPTED_CRASH),
            prompts, 10, **config)
        launches = read_launches()["fused_paged_decode_attention"]
        want, want_snap, _, _ = fleet_run(
            cpu, "cpu", storm_injector(FLEET_STORM, 5, FLEET_SCRIPTED_CRASH),
            prompts, 10, **config)
        got = [r.output for r in got]
        if got != [r.output for r in want] or got != ref:
            raise AssertionError(f"router reference: card {got}, CPU "
                                 f"{[r.output for r in want]}, clean {ref}")
        if snap != want_snap or snap["failovers"] < 1:
            raise AssertionError(f"router reference: card {snap}, CPU "
                                 f"{want_snap}")
        for rep in router._replicas:
            check_pool(f"router reference replica {rep.idx}", rep.engine)
        if launches <= 0:
            raise AssertionError("router reference: row 2 was not launched")
        print(f"router reference ({smi}): card tokens = CPU tokens = clean "
              f"tokens for {len(prompts)} requests; {snap['failovers']} "
              f"failovers, {snap['reclaimed']} reclaimed, "
              f"{snap['replayed']} replayed, {snap['breaker_opens']} "
              f"breaker opens on both; fleet sanitizer on; row 2 launched "
              f"{launches} times", flush=True)
    finally:
        flags.set_flags(SERVING_DEFAULTS)


def replay_prefill_ms(eng, req, history):
    """One replay's prefill at 7B width, from ``torch.profiler``: ``req``'s
    ledger with ``history`` (generated tokens) admitted on the idle
    ``eng`` under a fresh rid, its admission (prompt + history in one
    ``[slots, C]`` chunk forward, then the first-token sync) profiled,
    the request cancelled after. Returns (device ms summed over kernels,
    wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import request_ledger

    led = dict(request_ledger(req), rid=10 ** 6,
               output=[int(t) for t in history])
    eng.admit_ledger(led)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not eng.active.any() or not eng.cancel(led["rid"]):
        raise AssertionError("replay prefill: the replay was not admitted")
    device_us = sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    return device_us / 1e3, wall_ms


def router_7b_phase(model):
    """Llama-2-7B width, bf16: one clean paged engine (8 slots, ``max_len``
    1024, 64-token pages), then a 2-replica router at the same config,
    each serving 16 seeded prompts of 120 tokens with 32 new tokens:
    clean, and the fleet under ``FLEET_STORM`` with one scripted crash.
    Every request reaches its length, every first token equals the clean
    engine's (bf16 replays may leave it later: the first divergence is
    printed), every replica's pool comes back. Prints wall time, served
    tok/s and TTFT p50 of the three runs, the failovers, the reclaimed
    and replayed counts, the peak memory, and the device time of one
    replay prefill. Then a handoff mid-generation: replica 0 drains
    (deadline 1 ms), replica 1 admits its ledgers and finishes them."""
    from paddle_tpu_torch import flags

    smi = nvidia_smi_line()
    flags.set_flags(dict(SERVING_DEFAULTS, sanitize=True))
    # max_retries 50: a storm this dense would fail requests at the
    # default bound of 2 replays
    paged = dict(paged=True, page_size=PAGE, max_retries=50)
    config = dict(paged, max_slots=8, max_len=1024)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, model.config.vocab_size, 120)
               for _ in range(16)]
    new = 32
    try:
        # every run sanitized (host checks a tick, no device sync)
        reqs, wall, _ = serve(model, prompts, "auto", max_new_tokens=new,
                              **paged)
        ref = [r.output for r in reqs]
        runs = {"clean_engine": (reqs, wall)}
        reqs, fs_clean, router, wall = fleet_run(model, "cuda", None,
                                                 prompts, new, **config)
        runs["clean_fleet"] = (reqs, wall)
        for rep in router._replicas:
            check_pool(f"router 7b clean fleet replica {rep.idx}",
                       rep.engine)
        handoff_router = router
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reqs, fs, router, wall = fleet_run(
            model, "cuda", storm_injector(FLEET_STORM, 5,
                                          FLEET_SCRIPTED_CRASH),
            prompts, new, **config)
        launches = read_launches()["fused_paged_decode_attention"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runs["stormed_fleet"] = (reqs, wall)
        for rep in router._replicas:
            check_pool(f"router 7b stormed fleet replica {rep.idx}",
                       rep.engine)
        if fs["failovers"] < 1 or launches <= 0:
            raise AssertionError(f"router 7b: {fs['failovers']} failovers, "
                                 f"row 2 launched {launches} times")
        out = {"card": smi, "requests": 16, "prompt_tokens": 120,
               "new_tokens": new, "engine": "paged, 8 slots, max_len 1024,"
               " 64-token pages", "storm": FLEET_STORM + " seed 5, one "
               "scripted crash at tick 3"}
        for name, (rs, wall) in runs.items():
            outs = [r.output for r in rs]
            firsts = [o[0] for o in outs]
            if firsts != [o[0] for o in ref]:
                raise AssertionError(f"router 7b {name}: first tokens "
                                     f"{firsts}, clean {[o[0] for o in ref]}")
            div = first_divergence(outs, ref)
            ttft = float(np.median([r.ttft_ms for r in rs]))
            out[name] = {"wall_s": wall, "served_tok_s": 16 * new / wall,
                         "ttft_p50_ms": ttft, "first_divergence": div}
            print(f"router 7b {name} ({smi}): {wall:.3f} s, "
                  f"{16 * new / wall:.1f} served tok/s, TTFT p50 "
                  f"{ttft:.2f} ms, first divergence {div}", flush=True)
        replay_ms, replay_wall_ms = replay_prefill_ms(
            router._replicas[0].engine, runs["clean_engine"][0][0],
            ref[0][:16])
        out.update(failovers=fs["failovers"], reclaimed=fs["reclaimed"],
                   replayed=fs["replayed"], held=fs["held"],
                   breaker_opens=fs["breaker_opens"],
                   injector_fires=fs["injector"]["fires"],
                   peak_memory_gb=peak_gb, row2_launches=launches,
                   replay_prefill_device_ms=replay_ms,
                   replay_prefill_wall_ms=replay_wall_ms,
                   replay_prefill_tokens=136)
        print(f"router 7b storm ({smi}): {fs['failovers']} failovers, "
              f"{fs['reclaimed']} reclaimed, {fs['replayed']} replayed, "
              f"{fs['held']} held, peak {peak_gb:.2f} GB; one replay "
              f"prefill (136 tokens) {replay_ms:.3f} ms device time, "
              f"{replay_wall_ms:.3f} ms wall", flush=True)
        # drain -> admit_ledger between the clean fleet's two engines
        src, dst = (rep.engine for rep in handoff_router._replicas)
        src._finished.clear()
        dst._finished.clear()
        rids = [src.add_request(p, new) for p in prompts]
        src.step_chunk(8)
        summary = src.drain(deadline_ms=1.0, max_chunk=8)
        ledgers = summary["unfinished"]
        if len(ledgers) != 16 or summary["expired"] != 8:
            raise AssertionError(f"router 7b handoff: {summary['expired']} "
                                 f"expired, {len(ledgers)} ledgers")
        for led in ledgers:
            # a handoff moves a request: the fresh ones the drain left
            # queued on the source leave it
            src.cancel(led["rid"])
            dst.admit_ledger(led)
        src.resume()
        for _ in range(5000):
            if not (dst.step_chunk(8) or dst._queue or dst.active.any()):
                break
        got = [dst._finished[led["rid"]].output for led in ledgers]
        want = [ref[rids.index(led["rid"])] for led in ledgers]
        if any(len(o) != new for o in got) \
                or [o[0] for o in got] != [o[0] for o in want]:
            raise AssertionError(f"router 7b handoff: lengths "
                                 f"{[len(o) for o in got]}, first tokens "
                                 f"{[o[0] for o in got]} against "
                                 f"{[o[0] for o in want]}")
        check_pool("router 7b handoff source", src)
        check_pool("router 7b handoff target", dst)
        div = first_divergence(got, want)
        out["handoff"] = {"expired": summary["expired"],
                          "ledgers": len(ledgers),
                          "replayed_tokens": [len(led["output"])
                                              for led in ledgers],
                          "first_divergence": div}
        print(f"router 7b handoff ({smi}): replica 0 drained mid-"
              f"generation ({summary['expired']} expired, {len(ledgers)} "
              f"ledgers), replica 1 finished all at length {new}, first "
              f"tokens equal, first divergence {div}", flush=True)
        print(json.dumps({"router_7b": out}), flush=True)
    finally:
        flags.set_flags(SERVING_DEFAULTS)


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


# ---------------------------------------------------------------------------
# observability: the registry, the tracer, the profiler on CUDA events, the
# time series, alerts and cost, the front door's /metrics, /trace and
# /timeline, and train telemetry
# ---------------------------------------------------------------------------
# the JAX package's defaults of the observability flags
OBS_DEFAULTS = {"telemetry": True, "trace_sample": 1.0,
                "cost_attribution": True, "recompile_watchdog": True,
                "recompile_warmup_ticks": 64, "profile_programs": False,
                "profile_sample_every": 16, "timeseries": False,
                "timeseries_cadence": 16, "alerts": True,
                "slo_degradation": False, "log_memory_stats": False}
PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
PROM_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def prom_untimed(text, engine_id):
    """What of one engine's Prometheus series is not a time: each
    sample's name and label set (the engine label replaced by ``*``),
    every counter's value and every histogram's ``_count``."""
    kinds = {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
             if ln.startswith("# TYPE ")}
    keys, values = [], {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"unparseable exposition line {line!r}")
        labels = dict(PROM_LABEL.findall(m.group(3) or ""))
        if labels.get("engine") != engine_id:
            continue
        key = (m.group(1), tuple(sorted(dict(labels, engine="*").items())))
        keys.append(key)
        base = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
        if kinds.get(m.group(1)) == "counter" or (
                kinds.get(base) == "histogram"
                and m.group(1).endswith("_count")):
            values[key] = float(m.group(4))
    return sorted(keys), values


def obs_reference_run(model, device):
    """The tiny float32 paged engine with JAX's observability defaults
    plus the profiler (every 2nd dispatch), the time series (cadence 2)
    and alerts: 6 seeded requests, 3 of them sharing a 32-token prefix.
    Returns what the card and the CPU must agree on, and the profiled
    step events."""
    from paddle_tpu_torch import flags, observability
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    flags.set_flags({**SERVING_DEFAULTS, **OBS_DEFAULTS,
                     "profile_programs": True, "profile_sample_every": 2,
                     "timeseries": True, "timeseries_cadence": 2})
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=2, max_len=128, page_size=16,
                            paged=True, cache_dtype=torch.float32),
        device=device)
    rng = np.random.default_rng(18)
    shared = rng.integers(1, 256, 32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, n)])
               for n in (5, 11, 3)] + [rng.integers(1, 256, n)
                                       for n in (9, 27, 14)]
    reqs = eng.run(prompts, 10, max_chunk=4)
    text = observability.global_registry().prometheus_text()
    keys, values = prom_untimed(text, eng._tel.engine_id)
    events = {}
    for ev in eng._tracer.events():
        if ev["kind"] == "request":
            events.setdefault(ev["rid"], []).append(ev["name"])
    prof = eng.profile_snapshot()["programs"]
    return {"tokens": [r.output for r in reqs], "keys": keys,
            "values": values, "events": events, "hbm": eng.hbm_snapshot(),
            "recompiles": eng.recompile_snapshot()["recompiles"],
            "dispatches": {k: (v["dispatches"], v["sampled"])
                           for k, v in prof.items()},
            "windows": eng.timeline_snapshot()["windows"],
            "cost_requests": eng.cost_snapshot()["requests_finished"]}, [
        e for e in eng._tracer.events()
        if e["kind"] == "step" and e["args"].get("profiled")]


def obs_reference_phase():
    """Card vs CPU, the tiny float32 Llama (hidden 256) from the same
    weights, paged, the observability layer on (``obs_reference_run``):
    equal tokens, Prometheus sample names and label sets, counters and
    histogram counts, per-request tracer event names, ``hbm_snapshot()``,
    recompile counts, profiler dispatch and sample counts and time-series
    windows; on the card each sampled dispatch's ``device_ms`` (CUDA
    events) is positive and no larger than its step's wall."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    smi = nvidia_smi_line()
    cpu, card = card_and_cpu(lambda dev, seed: LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256), device=dev, seed=seed), 8)
    try:
        reset_launches()
        got, sampled = obs_reference_run(card, "cuda")
        launches = read_launches()["fused_paged_decode_attention"]
        want, _ = obs_reference_run(cpu, "cpu")
    finally:
        flags.set_flags(dict(SERVING_DEFAULTS, **OBS_DEFAULTS))
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"obs reference {key}: card {got[key]}, "
                                 f"CPU {want[key]}")
    if not sampled or got["windows"] < 1 or launches <= 0:
        raise AssertionError(f"obs reference: {len(sampled)} sampled "
                             f"dispatches, {got['windows']} windows, row 2 "
                             f"launched {launches} times")
    ratios = []
    for e in sampled:
        wall_ms = (e["t1"] - e["t0"]) * 1e3
        dev_ms = e["args"]["device_ms"]
        if not 0 < dev_ms <= wall_ms:
            raise AssertionError(f"obs reference: {e['name']} device_ms "
                                 f"{dev_ms} outside (0, {wall_ms}]")
        ratios.append(dev_ms / wall_ms)
    print(f"obs reference ({smi}): card = CPU for {len(got['tokens'])} "
          f"requests: tokens, {len(got['keys'])} Prometheus samples (names "
          f"and label sets), {len(got['values'])} counters and histogram "
          f"counts, tracer events of every request, hbm {got['hbm']}, "
          f"recompiles {got['recompiles']}, dispatches/sampled "
          f"{got['dispatches']}, {got['windows']} time-series windows; "
          f"{len(sampled)} sampled dispatches with 0 < device_ms <= wall "
          f"(device/wall {min(ratios):.3f}..{max(ratios):.3f}); row 2 "
          f"launched {launches} times", flush=True)


def obs_serve_run(model, prompts, new_tokens, **flag_values):
    """One timed run of ``prompts`` through a fresh 8-slot paged engine
    (64-token pages) under ``OBS_DEFAULTS`` with ``flag_values`` over
    them; the fused paged kernel must run. Returns TTFT p50, TPOT p50,
    served tokens/s, the wall and the engine."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig)

    flags.set_flags({**SERVING_DEFAULTS, **OBS_DEFAULTS, **flag_values})
    eng = ContinuousBatchingEngine(
        model, EngineConfig(max_slots=8, max_len=1024, paged=True,
                            page_size=PAGE), device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if read_launches()["fused_paged_decode_attention"] <= 0 or any(
            len(r.output) != new_tokens for r in reqs):
        raise AssertionError("obs 7b: row 2 not launched, or short output")
    check_pool("obs 7b", eng)
    return {"ttft_p50_ms": float(np.median([r.ttft_ms for r in reqs])),
            "tpot_p50_ms": float(np.median([r.tpot_ms for r in reqs])),
            "tokens_per_s": sum(len(r.output) for r in reqs) / wall,
            "wall_s": wall, "tokens": [r.output for r in reqs]}, eng


def program_split(prof, program, forwards=1):
    """A program's measured schedule / dispatch / device means (ms) from
    ``profile_snapshot()``, per forward of the program."""
    st = prof["programs"][program]
    return {"sampled": st["sampled"],
            "schedule_ms": st["schedule_ms_mean"] / forwards,
            "dispatch_ms": st["dispatch_ms_mean"] / forwards,
            "device_ms": st["device_ms_mean"] / forwards,
            "device_ms_max": st["device_ms_max"] / forwards}


def obs_7b_phase(model, prompts):
    """Llama-2-7B width (32 layers, bf16), paged, 8 slots, the 8 prompts
    of 120 tokens with 32 new tokens: one untimed warm-up run each, then
    five runs each with telemetry off and with JAX's defaults (telemetry
    on, ``trace_sample`` 1.0), interleaved, the same tokens every run;
    TTFT p50, TPOT p50 and served tok/s of each and their medians. Then ``profile_programs`` at every
    dispatch: the ``schedule`` / ``dispatch`` / ``device`` split of the
    prefill chunk and of the decode chunk (8 forwards, per forward), and of
    the one-token decode step over ``step()`` ticks."""
    from paddle_tpu_torch import flags

    smi = nvidia_smi_line()
    runs = {"off": [], "on": []}
    tokens = None
    try:
        for i in range(6):
            for mode in ("off", "on"):
                res, _ = obs_serve_run(model, prompts, 32,
                                       telemetry=(mode == "on"))
                if tokens is None:
                    tokens = res["tokens"]
                elif res["tokens"] != tokens:
                    raise AssertionError(f"obs 7b {mode}: tokens differ "
                                         "from the first run's")
                if i:  # the first of each is a warm-up
                    runs[mode].append({k: v for k, v in res.items()
                                       if k != "tokens"})
        med = {mode: {k: float(np.median([r[k] for r in rs]))
                      for k in ("ttft_p50_ms", "tpot_p50_ms",
                                "tokens_per_s")}
               for mode, rs in runs.items()}
        print(f"obs 7b ({smi}): telemetry off / on (JAX defaults), medians "
              f"of 5 interleaved runs after a warm-up each: TTFT p50 "
              f"{med['off']['ttft_p50_ms']:.2f} / "
              f"{med['on']['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{med['off']['tpot_p50_ms']:.3f} / "
              f"{med['on']['tpot_p50_ms']:.3f} ms, served "
              f"{med['off']['tokens_per_s']:.1f} / "
              f"{med['on']['tokens_per_s']:.1f} tok/s; the same tokens in "
              "all 12 runs", flush=True)
        res, eng = obs_serve_run(model, prompts, 32, profile_programs=True,
                                 profile_sample_every=1)
        if res["tokens"] != tokens:
            raise AssertionError("obs 7b profiled: tokens differ")
        prof = eng.profile_snapshot()
        split = {"prefill_chunk": program_split(prof, "prefill_chunk"),
                 "decode_chunk": program_split(prof, "decode_chunk"),
                 "decode_chunk_per_forward": program_split(
                     prof, "decode_chunk", 8)}
        # one-token decode steps: step() ticks after a chunked admission
        from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                                EngineConfig)

        eng = ContinuousBatchingEngine(
            model, EngineConfig(max_slots=8, max_len=1024, paged=True,
                                page_size=PAGE), device="cuda")
        for p in prompts:
            eng.add_request(p, 32)
        while eng.step() or eng._queue or eng.active.any():
            pass
        split["decode_step"] = program_split(eng.profile_snapshot(),
                                             "decode_step")
        for st in split.values():
            if not (st["sampled"] > 0 and st["device_ms"] > 0):
                raise AssertionError(f"obs 7b split: {split}")
    finally:
        flags.set_flags(dict(SERVING_DEFAULTS, **OBS_DEFAULTS))
    for name, st in split.items():
        print(f"obs 7b split {name} ({smi}): schedule "
              f"{st['schedule_ms']:.3f} ms, dispatch {st['dispatch_ms']:.3f} "
              f"ms, device {st['device_ms']:.3f} ms (max "
              f"{st['device_ms_max']:.3f}) over {st['sampled']} sampled "
              "dispatches (CUDA events on the engine's stream)", flush=True)
    print(json.dumps({"obs_7b": {
        "model": "llama2_7b width, 32 layers, random bf16 weights (seed 0)",
        "engine": "paged, 8 slots, max_len 1024, 64-token pages, 8 prompts "
                  "of 120 + 32 tokens", "card": smi,
        "runs": runs, "medians": med, "split": split}}), flush=True)


def obs_get(url, path):
    """(status, body) of one GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + path, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_front_door_phase(model, prompts):
    """The front door over one 32-layer paged engine and over a 2-replica
    ``EngineRouter`` of the same model, the time series on: 4 SSE streams
    each (120 + 16 tokens), then ``/metrics`` (parsed; the target's
    finished counter equals its streams), ``/trace`` (Chrome JSON with
    every stream's ``active`` span; ``?fleet=1`` on the router) and
    ``/timeline`` (JSON with windows) each answer 200."""
    import threading

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            EngineConfig, EngineRouter)
    from paddle_tpu_torch.serving_api import start_api_server

    flags.set_flags({**SERVING_DEFAULTS, **OBS_DEFAULTS,
                     "timeseries": True, "timeseries_cadence": 2})
    config = EngineConfig(max_slots=8, max_len=1024, paged=True,
                          page_size=PAGE)
    report = {}
    try:
        for label in ("engine", "router"):
            target = (ContinuousBatchingEngine(model, config, device="cuda")
                      if label == "engine" else
                      EngineRouter(model, config, n_replicas=2,
                                   device="cuda"))
            srv = start_api_server(target, max_chunk=8)
            out = {}
            try:
                threads = [threading.Thread(
                    target=sse_request, args=(srv.url, {
                        "prompt": p.tolist(), "max_tokens": 16}, out, i))
                    for i, p in enumerate(prompts[:4])]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                if any("error" in g or not g["done"] for g in out.values()):
                    raise AssertionError(f"obs front door {label}: {out}")
                codes = {}
                paths = ["/metrics", "/trace", "/timeline"]
                if label == "router":
                    paths.append("/trace?fleet=1")
                bodies = {}
                for path in paths:
                    codes[path], bodies[path] = obs_get(srv.url, path)
            finally:
                srv.shutdown()
            if any(c != 200 for c in codes.values()):
                raise AssertionError(f"obs front door {label}: {codes}")
            text = bodies["/metrics"].decode()
            ids = ([target._tel.engine_id] if label == "engine" else
                   [rep.engine._tel.engine_id for rep in target._replicas])
            finished = sum(v for eid in ids for (name, _), v in
                           prom_untimed(text, eid)[1].items()
                           if name == "pt_serve_requests_finished_total")
            trace = json.loads(bodies["/trace?fleet=1" if label == "router"
                                      else "/trace"])
            spans = sum(1 for e in trace["traceEvents"]
                        if e["name"] == "active" and e["ph"] == "X")
            timeline = json.loads(bodies["/timeline"])
            windows = (timeline["windows"] if label == "engine"
                       else timeline["router"]["windows"])
            if finished != 4 or spans != 4 or not timeline["enabled"] \
                    or windows < 1:
                raise AssertionError(
                    f"obs front door {label}: finished {finished}, active "
                    f"spans {spans}, timeline {timeline.get('enabled')} "
                    f"with {windows} windows")
            report[label] = {"codes": codes, "metrics_bytes": len(text),
                             "trace_events": len(trace["traceEvents"]),
                             "timeline_windows": windows}
            print(f"obs front door {label}: {codes}; /metrics "
                  f"{len(text)} bytes parsed (4 finished), /trace "
                  f"{len(trace['traceEvents'])} events (4 active spans), "
                  f"/timeline {windows} windows", flush=True)
            del target
    finally:
        flags.set_flags(dict(SERVING_DEFAULTS, **OBS_DEFAULTS))
    print(json.dumps({"obs_front_door": report}), flush=True)


def timed_step_ms(ts, batch):
    """One ``TrainStep.run`` between two CUDA events: its ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ts.run(batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def train_7b_telemetry_phase():
    """``train_7b_phase``'s configuration, weights, optimizer and batch:
    2 warm-up and 3 timed steps with the step's telemetry off, then the
    same ``TrainStep`` with ``TrainTelemetry(sample_every=2)`` and
    ``log_memory_stats`` for 6 more steps (3 sampled; the first sampled
    step runs the FLOPs probe, whose time the next interval holds, so the
    third is reported): the sampled step's loss, grad norm, tokens/s, MFU
    against 989 TFLOP/s (FLOPs from ``FlopCounterMode``, aten operations
    only, and from the analytic count) and peak bytes beside the
    untelemetered step's time. Rows 6 and 8 run once per layer a
    step."""
    from paddle_tpu_torch import flags, observability

    smi = nvidia_smi_line()
    cfg = train_7b_config()
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    flags.set_flags({"log_memory_stats": True})
    try:
        model, ts, batch = train_7b_step(cfg)
        # the step with its telemetry off: no grad norm, no record
        ts.telemetry = None
        for _ in range(2):
            ts.run(batch)
        reset_launches()
        off_ms = [timed_step_ms(ts, batch) for _ in range(3)]
        counts = read_launches()
        want = train_launches_want(3, cfg.num_hidden_layers)
        if {n: counts[n] for n in want} != want \
                or ts.last_grad_norm is not None:
            raise AssertionError(f"train 7b telemetry: launches {counts}, "
                                 f"grad norm {ts.last_grad_norm}")
        tel = observability.TrainTelemetry(sample_every=2)
        ts.telemetry = tel
        # the peak the sampled steps report: this phase's own
        torch.cuda.reset_peak_memory_stats()
        step_ms, samples = [], []
        while tel.samples < 3:
            step_ms.append(timed_step_ms(ts, batch))
            if tel.last_sample and (not samples
                                    or tel.last_sample is not samples[-1]):
                samples.append(tel.last_sample)
    finally:
        flags.set_flags({"log_memory_stats": False})
    rec = samples[-1]
    flops, _ = train_flops(cfg, b, s)
    off_med = float(np.median(off_ms))
    mfu_analytic = (flops * rec["tokens_per_sec"] / (b * s)
                    / H100_BF16_FLOPS)
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])
            and rec["tokens_per_sec"] > 0 and "mfu_est" in rec
            and (ts._flops_per_step or 0) > 0
            and rec["memory"]["peak_bytes_in_use"] > 0):
        raise AssertionError(f"train 7b telemetry: sample {rec}")
    print(f"train 7b telemetry ({smi}): sampled step {rec['step']}: loss "
          f"{rec['loss']:.6f}, grad norm {rec['grad_norm']:.6f}, "
          f"{rec['tokens_per_sec']:.1f} tokens/s, MFU {rec['mfu_est']:.4f} "
          f"(FlopCounterMode {ts._flops_per_step / 1e12:.2f} TFLOP a step, "
          f"attention kernels uncounted) / {mfu_analytic:.4f} (analytic "
          f"{flops / 1e12:.2f} TFLOP), peak "
          f"{rec['memory']['peak_bytes_in_use']} bytes; telemetered steps "
          f"{[round(x, 3) for x in step_ms]} ms beside the untelemetered "
          f"median {off_med:.3f} ms", flush=True)
    print(json.dumps({"train_7b_telemetry": {
        "card": smi, "untelemetered_step_ms": off_ms,
        "telemetered_step_ms": step_ms, "samples": samples,
        "probe_tflop_per_step": ts._flops_per_step / 1e12,
        "analytic_tflop_per_step": flops / 1e12,
        "mfu_analytic": mfu_analytic}}, default=str), flush=True)
    del model, ts, batch


# ---------------------------------------------------------------------------
# the transformer families: GPT, BERT/ERNIE, T5 and ERNIE-MoE on rows 5-9
# ---------------------------------------------------------------------------
# each family's attention shape: (name, b, sq, sk, heads, d, dtype, causal,
# scale, padding segments)
FAMILY_FLASH_SHAPES = (
    ("gpt2", 8, 1024, 1024, 12, 64, torch.bfloat16, True, None, False),
    ("bert_base", 16, 512, 512, 12, 64, torch.bfloat16, False, None, True),
    ("t5_small_cross", 16, 128, 512, 8, 64, torch.bfloat16, False, 1.0,
     False),
    ("ernie_moe", 4, 1024, 1024, 8, 128, torch.float32, True, None, False),
)


def family_pairs(b, sq, sk, causal, padded):
    """Visible (query, key) pairs a (batch row, head), on average over the
    batch: under the padding segments a real token sees the real ones and
    a padded token the padded ones."""
    if not padded:
        return fa_pairs(sq, sk, causal, 0)
    return sum(n * n + (sq - n) ** 2 for n in padded_lengths(b, sq)) / b


def family_flash_phase():
    """Rows 5-9 against their plain versions (``fa_check``) at the four
    families' attention shapes, then timed there beside their bounds and
    ``scaled_dot_product_attention`` (forward, and its backward for the
    backward rows; the padding as a boolean mask; a yardstick the port
    never calls)."""
    from paddle_tpu_torch.kernels import mha as fa

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for i, (name, b, sq, sk, h, d, dtype, causal, scale,
            padded) in enumerate(FAMILY_FLASH_SHAPES):
        segments = "padding" if padded else None
        errs = fa_check(name, b, sq, h, h, d, dtype, causal=causal,
                        segments=segments, seed=90 + i, sk=sk, scale=scale)
        q, k, v, do, _ = fa_inputs(b, sq, h, h, d, dtype, seed=95 + i, sk=sk)
        qseg, kseg = fa.split_segments(fa_segments(segments, b, sq), q, k)
        sm_scale = d ** -0.5 if scale is None else scale
        kw = dict(causal=causal, sm_scale=sm_scale, qseg=qseg, kseg=kseg)
        o, lse = fa.flash_forward(q, k, v, with_lse=True, **kw)
        args = (q, k, v, do, lse, fa.attention_delta(o, do))
        span = fa.fit_block(1024, sk)
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        mask = None if qseg is None else \
            qseg[:, None, :, None] == kseg[:, None, None, :]
        skw = dict(attn_mask=mask, is_causal=causal, scale=sm_scale)
        qg, kg, vg = (x.detach().clone().requires_grad_()
                      for x in (qh, kh, vh))
        ref = sdpa(qg, kg, vg, **skw)
        lib_fwd = time_ms(lambda: sdpa(qh, kh, vh, **skw), flush, iters=30)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            ref, (qg, kg, vg), doh, retain_graph=True), flush, iters=30)
        calls = {
            "flash_attention_fwd": (
                lambda: fa.flash_forward(q, k, v, **kw), lib_fwd),
            "flash_attention_fwd_lse": (
                lambda: fa.flash_forward(q, k, v, with_lse=True, **kw),
                lib_fwd),
            "flash_attention_bwd_dq": (
                lambda: fa.flash_bwd_dq(*args, **kw), lib_bwd),
            "flash_attention_bwd_fused": (
                lambda: fa.flash_bwd_fused(*args, span=span, **kw), lib_bwd),
            "flash_attention_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(*args, **kw), lib_bwd),
        }
        pairs = family_pairs(b, sq, sk, causal, padded)
        kind = (f"b={b} sq={sq} sk={sk} h={h} d={d} "
                f"{'causal' if causal else 'non-causal'} "
                f"{str(dtype).removeprefix('torch.')} scale={sm_scale:.4g}"
                + (" padding segments" if padded else ""))
        rows = {}
        for row, (fn, lib_ms) in calls.items():
            ms = time_ms(fn, flush, iters=30)
            bound_ms, bound_by, ops = fa_bound(row, b, sq, h, h, d,
                                               q.element_size(), pairs, sk)
            print(f"flash shape {name} {row} {kind}: kernel {ms:.4f} ms "
                  f"({ops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
                  f"({bound_by}), sdpa "
                  f"{'forward' if 'fwd' in row else 'backward'} "
                  f"{lib_ms:.4f} ms; max abs err against the plain version "
                  f"{errs[row]:.3e}", flush=True)
            rows[row] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                             sdpa_ms=lib_ms, max_abs_err=errs[row])
        out[name] = dict(shape=kind, rows=rows)
        del q, k, v, do, o, lse, args, qh, kh, vh, doh, qg, kg, vg, ref
    print(json.dumps({"family_flash_shapes": out}), flush=True)
    return out


# card vs CPU, float32 both ways: each tensor's max abs difference over its
# largest magnitude. Logits: the kernels' and the card's GEMMs' sums against
# the CPU's, through 2 layers and the head, a few 1e-6 of the scale. The loss
# is a mean over hundreds of tokens (relative). Gradients add the backward's
# sums over every token, and a tensor whose gradient mostly cancels (a
# position row, a bias) carries that rounding at a larger share of its
# largest entry.
FAMILY_REF_TOL = {"logits": 1e-4, "loss": 1e-5, "grads": 1e-3}


def max_rel(got, want):
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def family_reference(label, make, batch, logits_keys, flash_layers):
    """One float32 model on the CPU and the same weights on the card:
    a ``no_grad`` forward's logits (row 5 once a flash layer on the card),
    then the loss and every gradient (rows 6 and 8 once a flash layer),
    held within ``FAMILY_REF_TOL``."""
    cpu, card = card_and_cpu(make, 11)
    got = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        data = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        reset_launches()
        with torch.no_grad():
            logits = model(**{k: data[k] for k in logits_keys})
        fwd = read_launches()
        reset_launches()
        loss = model(**data)
        loss.backward()
        train = read_launches()
        # (a masked LM's pooler takes no gradient)
        got[dev] = (logits, loss.detach(), {
            n: p.grad for n, p in model.named_parameters()
            if p.grad is not None})
        if dev == "cuda":
            check_counts(f"{label} reference no_grad forward", fwd,
                         {"flash_attention_fwd": flash_layers,
                          "flash_attention_fwd_lse": 0})
            check_counts(f"{label} reference step", train,
                         {"flash_attention_fwd_lse": flash_layers,
                          "flash_attention_bwd_fused": flash_layers,
                          "flash_attention_fwd": 0})
    (cl, closs, cg), (pl, ploss, pg) = got["cuda"], got["cpu"]
    if set(cg) != set(pg):
        raise AssertionError(f"{label} reference: gradients of "
                             f"{sorted(set(cg) ^ set(pg))} on one side only")
    errs = {"logits": max_rel(cl, pl), "loss": max_rel(closs, ploss),
            "grads": max(max_rel(cg[n], pg[n]) for n in pg)}
    worst = max(pg, key=lambda n: max_rel(cg[n], pg[n]))
    bad = [k for k, e in errs.items() if not e <= FAMILY_REF_TOL[k]]
    if bad or not torch.isfinite(cl).all():
        raise AssertionError(f"{label} reference: card vs CPU {errs} "
                             f"(worst gradient {worst}), tol "
                             f"{FAMILY_REF_TOL}")
    print(f"family reference {label}: float32, card (kernels) vs CPU "
          f"(plain versions) from the same weights: logits "
          f"{errs['logits']:.3e}, loss {float(closs):.6f} vs "
          f"{float(ploss):.6f} ({errs['loss']:.3e}), {len(pg)} gradients "
          f"worst {errs['grads']:.3e} ({worst}) of each tensor's largest "
          f"magnitude (tol "
          f"{FAMILY_REF_TOL}); launches {flash_layers} of row 5 in the "
          f"no_grad forward, {flash_layers} of rows 6 and 8 in the step",
          flush=True)


def family_reference_phase():
    """GPT, BERT (masked LM over padded rows), T5 and ERNIE-MoE (the
    capacity and the dropless arm), each float32 at its full published
    width cut to 2 layers (T5: 2 + 2), on the card and the CPU from the
    same weights (``family_reference``); then the greedy ``generate`` of
    32 tokens of a float32 T5 with an untied head on the card, cached and
    uncached: identical tokens, and at least 8 distinct ones."""
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         ErnieMoEForCausalLM, GPTConfig,
                                         GPTForCausalLM, T5Config,
                                         T5ForConditionalGeneration)

    rng = np.random.default_rng(12)
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gpt = GPTConfig(num_hidden_layers=2, **no_drop)
    ids = rng.integers(0, gpt.vocab_size, (2, 256))
    family_reference("gpt2 2 layers", lambda dev, seed: GPTForCausalLM(
        gpt, device=dev, seed=seed), {"input_ids": ids, "labels": ids},
        ("input_ids",), 2)
    bert = BertConfig(num_hidden_layers=2, **no_drop)
    mask = np.arange(256)[None] < np.array(padded_lengths(2, 256))[:, None]
    ids = rng.integers(0, bert.vocab_size, (2, 256))
    labels = np.where(rng.random((2, 256)) < 0.15, ids, -100)
    family_reference("bert-base 2 layers", lambda dev, seed: BertForMaskedLM(
        bert, device=dev, seed=seed),
        {"input_ids": ids, "attention_mask": mask.astype(np.int64),
         "labels": labels}, ("input_ids", "attention_mask"), 2)
    t5cfg = T5Config(num_layers=2, dropout_rate=0.0)
    src = rng.integers(1, t5cfg.vocab_size, (2, 256))
    tgt = rng.integers(1, t5cfg.vocab_size, (2, 64))
    # the decoder reads the labels shifted right (decoder_start_token_id
    # 0), as the model's own shift gives them
    shifted = np.concatenate([np.zeros((2, 1), np.int64), tgt[:, :-1]], 1)
    family_reference(
        "t5-small 2+2 layers", lambda dev, seed: T5ForConditionalGeneration(
            t5cfg, device=dev, seed=seed),
        {"input_ids": src, "decoder_input_ids": shifted, "labels": tgt},
        ("input_ids", "decoder_input_ids"), 2)
    # generate with an untied head: the tied one, at random weights, only
    # repeats the start token (its own embedding dominates the residual)
    t5 = T5ForConditionalGeneration(dataclasses.replace(
        t5cfg, tie_word_embeddings=False), device="cuda", seed=3).eval()
    src_t = torch.as_tensor(src, device="cuda")
    cached = t5.generate(src_t, max_length=33, use_cache=True)
    uncached = t5.generate(src_t, max_length=33, use_cache=False)
    if not torch.equal(cached, uncached) \
            or len(set(cached[:, 1:].flatten().tolist())) < 8:
        raise AssertionError(f"t5 float32 generate: cached {cached.tolist()}"
                             f" vs uncached {uncached.tolist()}")
    print(f"family reference t5: float32 greedy generate of 32 tokens (an "
          f"untied head), cached = uncached on the card: "
          f"{cached[:, 1:9].tolist()}...", flush=True)
    for dropless in (False, True):
        moe = bench_moe_config(num_hidden_layers=2, moe_dropless=dropless)
        ids = rng.integers(0, moe.vocab_size, (2, 256))
        family_reference(
            f"ernie-moe 2 layers {'dropless' if dropless else 'gshard'}",
            lambda dev, seed, cfg=moe: ErnieMoEForCausalLM(
                cfg, device=dev, seed=seed),
            {"input_ids": ids, "labels": ids}, ("input_ids",), 2)


def bench_moe_config(**kw):
    """``benchmarks/suite.py: bench_moe``'s ERNIE-MoE (vocab 32000,
    hidden 1024, 8 layers, 8 heads, positions 1024, 8 experts, MoE every
    2nd layer, dropouts 0)."""
    from paddle_tpu_torch.models import ErnieMoEConfig

    cfg = dict(vocab_size=32000, hidden_size=1024, num_hidden_layers=8,
               num_attention_heads=8, max_position_embeddings=1024,
               num_experts=8, moe_every=2, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    return ErnieMoEConfig(**dict(cfg, **kw))


def family_train(label, model, batch, flops, tokens, flash_layers, rate,
                 optimizer, residency="master_only", eval_batch=None):
    """2 warm-up and 5 timed ``TrainStep`` steps (``train_steps``) with
    exactly 5 x ``flash_layers`` launches of rows 6 and 8 and none of the
    others, losses finite and falling; a profile of one step (the flash
    kernels' device ms); then a ``no_grad`` eval forward of
    ``eval_batch`` (``batch`` without its labels by default) with
    ``flash_layers`` launches of row 5. Prints step ms, tokens/s, MFU
    (``flops`` a step over ``rate``) and peak GB; returns the figures."""
    from paddle_tpu_torch.trainer import TrainStep

    ts = TrainStep(model, optimizer, master_residency=residency)
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
    check_counts(label, counts, {
        "flash_attention_fwd_lse": 5 * flash_layers,
        "flash_attention_bwd_fused": 5 * flash_layers,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0})
    if not (all(math.isfinite(x) for x in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    med_ms = float(np.median(step_ms))
    tokens_per_s = tokens / (med_ms / 1e3)
    mfu = flops / (med_ms / 1e3) / rate
    prof = profile_step(label, ts, batch, FLASH_BODIES)
    ts.sync_to_model()
    model.eval()
    if eval_batch is None:
        eval_batch = {k: v for k, v in batch.items() if k != "labels"}
    reset_launches()
    with torch.no_grad():
        logits = model(**eval_batch)
    evals = read_launches()
    model.train()
    check_counts(f"{label} eval forward", evals,
                 {"flash_attention_fwd": flash_layers,
                  "flash_attention_fwd_lse": 0})
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label} eval forward: logits not finite")
    print(f"{label}: 5 timed steps {[round(x, 3) for x in step_ms]} ms "
          f"(median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{tokens_per_s:.1f} tokens/s, MFU {mfu:.4f} (analytic "
          f"{flops / 1e12:.3f} TFLOP a step / {rate / 1e12:.0f} TFLOP/s), "
          f"peak {peak_gb:.2f} GB; losses {losses}; launches per step "
          f"{flash_layers} of row 6 and of row 8; flash kernels "
          f"{prof['kernels_ms']:.3f} ms a step {prof['by_name_ms']} of "
          f"{prof['device_ms']:.3f} ms device; eval forward {flash_layers} "
          "launches of row 5", flush=True)
    return dict(step_ms=step_ms, step_ms_median=med_ms,
                tokens_per_s=tokens_per_s, mfu=mfu, peak_gb=peak_gb,
                losses=losses, flash_ms_per_step=prof["kernels_ms"],
                flash_ms_by_body=prof["by_name_ms"],
                device_ms_per_step=prof["device_ms"],
                launches_per_step={"flash_attention_fwd_lse": flash_layers,
                                   "flash_attention_bwd_fused":
                                       flash_layers},
                eval_launches={"flash_attention_fwd": flash_layers})


def lm_flops(n_matmul, tokens, attn_pairs, heads, d, layers):
    """6 N T for the N matmul weights a token passes through, plus the
    attention products 12 h d a visible pair a layer (forward once,
    backward twice)."""
    return 6 * n_matmul * tokens + 12 * heads * d * attn_pairs * layers


def train_gpt2_phase():
    """``GPTConfig()``, GPT-2 small (vocab 50304, hidden 768, 12 layers of
    12 heads, positions 1024) with dropouts 0, bf16 with float32 masters
    (``master_only``), AdamW 3e-4, batch 8 x 1024 (``family_train``);
    then ``create_predictor`` on 8 prompts of 120 tokens, 32 new tokens
    (a warm-up call, then the timed one): TTFT, decode tokens/s, no
    launch of rows 5-9 (plain SDPA over the cache)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    b, s, h, L = 8, 1024, cfg.hidden_size, cfg.num_hidden_layers
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    n = L * 12 * h * h + h * cfg.vocab_size
    flops = lm_flops(n, b * s, b * fa_pairs(s, s, True, 0),
                     cfg.num_attention_heads, cfg.head_dim, L)
    res = family_train("train gpt2", model, {"input_ids": ids,
                                             "labels": ids},
                       flops, b * s, L, H100_BF16_FLOPS,
                       topt.AdamW(3e-4, weight_decay=0.01,
                                  multi_precision=True))
    pc = Config()
    pc.max_seq_len = cfg.max_position_embeddings
    pc.seq_buckets = (128,)
    pred = create_predictor(model, pc)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 120))
    pred.generate(prompts, max_new_tokens=4)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = pred.generate(prompts, max_new_tokens=32)
    wall = time.perf_counter() - t0
    counts = read_launches()
    check_counts("gpt2 predictor generate", counts,
                 dict.fromkeys(FLASH_KERNELS, 0))
    if toks.shape != (8, 32) or not ((0 <= toks) & (toks < cfg.vocab_size)
                                     ).all():
        raise AssertionError(f"gpt2 predictor tokens {toks.shape}")
    ttft = pred.last_ttft_ms
    decode_tok_s = 8 * 31 / (wall - ttft / 1e3)
    print(f"train gpt2: Predictor (bf16 cache of {pc.max_seq_len} rows, "
          f"bucket 128) 8 prompts of 120 + 32 tokens: TTFT {ttft:.2f} ms, "
          f"decode {decode_tok_s:.1f} tokens/s, wall {wall * 1e3:.1f} ms "
          "(host clock); no launch of rows 5-9", flush=True)
    res.update(predictor_ttft_ms=ttft, predictor_decode_tok_s=decode_tok_s)
    print(json.dumps({"train_gpt2": res}), flush=True)
    return res


def train_bert_phase():
    """``BertConfig()``, bert-base (vocab 30522, hidden 768, 12 layers of
    12 heads, intermediate 3072, positions 512) with dropouts 0,
    ``BertForSequenceClassification``, bf16 with float32 masters, AdamW
    3e-5 (the published fine-tuning rate: 1e-4 swings this 16-example
    loss), batch 16 x 512 with the ragged tails of ``padded_lengths``
    (padding as segment ids on the kernels)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)

    cfg = BertConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    b, s, h, L = 16, 512, cfg.hidden_size, cfg.num_hidden_layers
    model = BertForSequenceClassification(cfg, device="cuda", seed=0).to(
        torch.bfloat16)
    rng = np.random.default_rng(0)
    lens = np.array(padded_lengths(b, s))
    batch = {"input_ids": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (b, s)), device="cuda"),
             "attention_mask": torch.as_tensor(
                 (np.arange(s)[None] < lens[:, None]).astype(np.int64),
                 device="cuda"),
             "labels": torch.as_tensor(rng.integers(0, 2, (b,)),
                                       device="cuda")}
    n = L * (4 * h * h + 2 * h * cfg.intermediate_size) + h * h + h * 2
    flops = lm_flops(n, b * s, b * family_pairs(b, s, s, False, True),
                     cfg.num_attention_heads, cfg.head_dim, L)
    res = family_train("train bert-base", model, batch, flops, b * s, L,
                       H100_BF16_FLOPS, topt.AdamW(3e-5, weight_decay=0.01,
                                                   multi_precision=True))
    print(json.dumps({"train_bert_base": res}), flush=True)
    return res


def train_t5_phase():
    """``T5Config()``, t5-small (vocab 32128, d_model 512, 6 + 6 layers of
    8 heads, d_kv 64, d_ff 2048) with dropout 0, bf16 with float32
    masters, AdamW 1e-4, batch 16, encoder 512 and decoder 128 tokens
    (the decoder's cross-attention on rows 5-9; self-attention carries
    the relative bias: plain SDPA); then greedy ``generate`` of 32 tokens
    for 4 prompts, cached and uncached: the first token equal (bf16
    near-ties may part later tokens; float32 holds them all in the
    reference phase)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration

    cfg = T5Config(dropout_rate=0.0)
    b, se, sd = 16, 512, 128
    d, inner, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    model = T5ForConditionalGeneration(cfg, device="cuda", seed=0).to(
        torch.bfloat16)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, se)),
                          device="cuda")
    tgt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, sd)),
                          device="cuda")
    L, Ld = cfg.num_layers, cfg.num_decoder_layers
    # matmul FLOPs by the tokens that pass each weight: encoder layers over
    # the source, decoder layers (self q/k/v/o, cross q/o, MLP) and the tied
    # head over the target, the cross K/V over the source
    per_enc = 4 * d * inner + 2 * d * ff
    per_dec = 6 * d * inner + 2 * d * ff
    mm = 6 * (L * per_enc * b * se + (Ld * per_dec + d * cfg.vocab_size)
              * b * sd + Ld * 2 * d * inner * b * se)
    attn = 12 * cfg.num_heads * cfg.d_kv * b * (
        L * se * se + Ld * (fa_pairs(sd, sd, True, 0) + sd * se))
    res = family_train("train t5-small", model,
                       {"input_ids": src, "labels": tgt}, mm + attn,
                       b * (se + sd), Ld, H100_BF16_FLOPS,
                       topt.AdamW(1e-4, weight_decay=0.01,
                                  multi_precision=True),
                       eval_batch={"input_ids": src,
                                   "decoder_input_ids": tgt})
    model.eval()
    gen = {}
    for use_cache in (True, False):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = model.generate(src[:4], max_length=33, use_cache=use_cache)
        torch.cuda.synchronize()
        gen[use_cache] = (toks, (time.perf_counter() - t0) * 1e3,
                          read_launches()["flash_attention_fwd"])
    model.train()
    (cached, cached_ms, n_cached), (plain, plain_ms, n_plain) = \
        gen[True], gen[False]
    if not torch.equal(cached[:, 1], plain[:, 1]) or n_cached != 0 \
            or n_plain != 32 * Ld:
        raise AssertionError(f"t5 generate: first tokens "
                             f"{cached[:, 1].tolist()} vs "
                             f"{plain[:, 1].tolist()}; row-5 launches "
                             f"cached {n_cached}, uncached {n_plain}")
    same = (cached == plain).float().mean().item()
    print(f"train t5-small: generate 4 x 32 tokens (bf16): cached "
          f"{cached_ms:.1f} ms, uncached {plain_ms:.1f} ms (host clock); "
          f"first tokens equal {cached[:, 1].tolist()}, share of all "
          f"tokens equal {same:.3f}; row 5 launched {n_plain} times "
          "uncached (cross-attention), never cached", flush=True)
    res.update(generate_cached_ms=cached_ms, generate_uncached_ms=plain_ms,
               generate_same_share=same)
    print(json.dumps({"train_t5_small": res}), flush=True)
    return res


def train_ernie_moe_phase():
    """``bench_moe``'s ERNIE-MoE (``bench_moe_config``: 8 layers, 4 of
    them MoE) in float32 (the ``*_v1`` flash bodies), AdamW 1e-4 as
    ``bench_moe``, batch 4 x 1024, both arms: the GShard top-2 capacity
    path (factor 1.25: the [4096, 8, 1280] dispatch and combine tensors)
    and the dropless path; prints each MoE layer's ``last_drop_fraction``
    (0 dropless). MFU against float32's 67 TFLOP/s (TF32 off)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import ErnieMoEForCausalLM

    b, s = 4, 1024
    out = {}
    for dropless in (False, True):
        cfg = bench_moe_config(moe_dropless=dropless)
        arm = "dropless" if dropless else "gshard"
        h, ff, L = cfg.hidden_size, cfg.intermediate_size, \
            cfg.num_hidden_layers
        model = ErnieMoEForCausalLM(cfg, device="cuda", seed=0)
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, s)), device="cuda")
        n_moe = L // cfg.moe_every
        # weights a token passes: attention 4 h^2 a layer, the dense MLPs
        # 2 h ff, top_k experts' 2 h ff and the gate in a MoE layer, head
        n = (L * 4 * h * h + (L - n_moe) * 2 * h * ff
             + n_moe * (cfg.top_k * 2 * h * ff + h * cfg.num_experts)
             + h * cfg.vocab_size)
        flops = lm_flops(n, b * s, b * fa_pairs(s, s, True, 0),
                         cfg.num_attention_heads, cfg.head_dim, L)
        res = family_train(f"train ernie-moe {arm}", model,
                           {"input_ids": ids, "labels": ids}, flops, b * s,
                           L, H100_F32_FLOPS,
                           topt.AdamW(1e-4, multi_precision=True),
                           residency="paired")
        drops = [float(blk.moe.last_drop_fraction) for blk in model.blocks
                 if blk.use_moe]
        if dropless and any(drops):
            raise AssertionError(f"dropless drop fractions {drops}")
        print(f"train ernie-moe {arm}: last_drop_fraction by MoE layer "
              f"{[round(x, 5) for x in drops]}", flush=True)
        res["drop_fractions"] = drops
        out[arm] = res
        del model, ids
        torch.cuda.empty_cache()
    print(json.dumps({"train_ernie_moe": out}), flush=True)
    return out


VISION_REF_TOL = {"logits": 1e-4, "loss": 1e-5, "grads": 1e-3,
                  "buffers": 1e-5}
# a gradient that float32 itself gets wrong (training BatchNorm's backward
# cancels terms far larger than its result: 157 of ResNet-50's 161 at
# random weights) is held to float64 instead, the card's relative error
# (in norm) within this factor of the CPU's float32 one: two float32
# paths on the CPU, NCHW and channels-last, differ by up to 3.8x so
VISION_GRAD_SLACK = 10.0


def norm_rel(got, want):
    """||got - want|| / ||want||, in float64 on the host."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return ((g - w).norm() / w.norm().clamp_min(1e-300)).item()


def bn_buffers(model):
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("._mean", "._variance"))}


def vision_reference(label, make, batch, x_key):
    """One float32 vision model on the CPU and the same weights on the
    card, and in float64 on the CPU: an eval ``no_grad`` forward's logits
    (the running statistics), then a training forward's loss, every
    gradient and the BatchNorm running statistics that forward moved.
    Logits, loss and statistics card vs CPU within ``VISION_REF_TOL`` of
    each tensor's largest magnitude; each gradient of the card within
    ``VISION_REF_TOL["grads"]`` of the float64 one in norm, or, where the
    CPU's own float32 gradient is further from float64 than that, within
    ``VISION_GRAD_SLACK`` times the CPU's error. No kernel of rows 1-13
    launches on the card."""
    cpu, card = card_and_cpu(make, 11)
    ref = make("cpu", 11).double()  # the CPU model's seed: its weights
    got = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu"), (ref, "f64")):
        data = {k: torch.as_tensor(v, device="cpu" if dev == "f64" else dev)
                for k, v in batch.items()}
        if dev == "f64":
            data = {k: v.double() if v.is_floating_point() else v
                    for k, v in data.items()}
        reset_launches()
        model.eval()
        with torch.no_grad():
            logits = model(data[x_key])
        model.train()
        loss = model(**data)
        loss.backward()
        counts = read_launches()
        got[dev] = (logits, loss.detach(), {
            n: p.grad for n, p in model.named_parameters()}, bn_buffers(model))
        if dev == "cuda":
            check_counts(f"{label} reference", counts,
                         dict.fromkeys(counts, 0))
    (cl, closs, cg, cb), (pl, ploss, pg, pb) = got["cuda"], got["cpu"]
    rg = got["f64"][2]
    card_err = {n: norm_rel(cg[n], rg[n]) for n in rg}
    cpu_err = {n: norm_rel(pg[n], rg[n]) for n in rg}
    allowed = {n: max(VISION_REF_TOL["grads"], VISION_GRAD_SLACK * cpu_err[n])
               for n in rg}
    worst = max(rg, key=lambda n: card_err[n] / allowed[n])
    errs = {"logits": max_rel(cl, pl), "loss": max_rel(closs, ploss),
            "grads": card_err[worst] / allowed[worst]
            * VISION_REF_TOL["grads"],
            "buffers": max((max_rel(cb[n], pb[n]) for n in pb),
                           default=0.0)}
    ill = sorted(n for n in rg if cpu_err[n] > VISION_REF_TOL["grads"])
    bad = [k for k, e in errs.items() if not e <= VISION_REF_TOL[k]]
    if bad or not torch.isfinite(cl).all():
        raise AssertionError(
            f"{label} reference: card vs CPU {errs}; worst gradient {worst}"
            f": card {card_err[worst]:.3e}, CPU float32 {cpu_err[worst]:.3e}"
            f" from float64; tol {VISION_REF_TOL}, slack "
            f"{VISION_GRAD_SLACK}")
    print(f"vision reference {label}: float32, card (cuDNN, channels-last "
          f"where the model takes it) vs CPU from the same weights: eval "
          f"logits {errs['logits']:.3e}, loss {float(closs):.6f} vs "
          f"{float(ploss):.6f} ({errs['loss']:.3e}), {len(pb)} BatchNorm "
          f"running statistics after the training forward "
          f"{errs['buffers']:.3e} of each tensor's largest magnitude; "
          f"{len(rg)} gradients against float64 (relative error in norm): "
          f"card worst "
          f"{max(card_err.values()):.3e} ({max(card_err, key=card_err.get)})"
          f", CPU float32 worst {max(cpu_err.values()):.3e}; {len(ill)} "
          f"gradients float32 itself gets wrong by more than "
          f"{VISION_REF_TOL['grads']} ({ill[:4]}...), held at "
          f"{VISION_GRAD_SLACK}x the CPU's error: worst {worst} card "
          f"{card_err[worst]:.3e} vs CPU {cpu_err[worst]:.3e}; no kernel "
          "launched", flush=True)
    return dict(errs, grads_card_vs_f64=max(card_err.values()),
                grads_cpu_vs_f64=max(cpu_err.values()),
                ill_conditioned=len(ill))


def vision_reference_phase():
    """ViT-L widths (1024, 16 heads, 4096) cut to 2 layers at 224 x 224,
    batch 2, and ``resnet50()`` whole at 224 x 224, batch 4, float32 on
    the card and the CPU (``vision_reference``)."""
    from paddle_tpu_torch.models import ViT, ViTConfig
    from paddle_tpu_torch.vision.models import resnet50

    rng = np.random.default_rng(13)
    vit = dataclasses.replace(ViTConfig.vit_l(), num_hidden_layers=2)
    out = {"vit_l_2_layers": vision_reference(
        "vit-l 2 layers", lambda dev, seed: ViT(vit, device=dev, seed=seed),
        {"pixel_values": rng.standard_normal((2, 3, 224, 224)).astype(
            np.float32), "labels": rng.integers(0, 1000, (2,))},
        "pixel_values")}
    out["resnet50"] = vision_reference(
        "resnet50", lambda dev, seed: resnet50(device=dev, seed=seed),
        {"x": rng.standard_normal((4, 3, 224, 224)).astype(np.float32),
         "labels": rng.integers(0, 1000, (4,))}, "x")
    print(json.dumps({"vision_reference": out}), flush=True)
    return out


def vit_flops(cfg, b):
    """6 N T for the matmul weights a token passes (the blocks' 12 h^2 a
    layer, the patch projection on the patch tokens, the head on the cls
    token) plus the attention products, 12 h s^2 a layer (every pair
    visible)."""
    h, L, s = cfg.hidden_size, cfg.num_hidden_layers, cfg.num_patches + 1
    patch = cfg.num_channels * cfg.patch_size ** 2 * h
    mm = 6 * b * (s * L * (4 * h * h + 2 * h * cfg.intermediate_size)
                  + cfg.num_patches * patch + h * cfg.num_classes)
    return mm + 12 * h * s * s * b * L


def train_vit_l_phase():
    """``benchmarks/suite.py: bench_vit`` uncut: ``ViTConfig.vit_l()`` (24
    layers of 1024, 16 heads, 4096), 224 x 224, batch 32, bf16 with
    float32 masters (``master_only``), ``AdamW(1e-4,
    multi_precision=True)``, the loss ``cross_entropy(logits,
    label).mean()`` through ``TrainStep(loss_fn=)``: 2 warm-up and 5
    timed steps (CUDA events), images/s, MFU against 989 TFLOP/s, peak
    GB, one profiled step by operator; no kernel of rows 1-13 launches
    (the plain SDPA, as in JAX)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import ViT, ViTConfig
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import layout
    from paddle_tpu_torch.trainer import TrainStep

    cfg, b = ViTConfig.vit_l(), 32
    t0 = time.perf_counter()
    model = ViT(cfg, device="cuda", seed=0).to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    batch = {"input": torch.as_tensor(rng.standard_normal(
        (b, 3, cfg.image_size, cfg.image_size)), device="cuda").to(
            torch.bfloat16),
        "label": torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.num_classes, (b,)), device="cuda")}
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True),
                   loss_fn=lambda logits, label: F.cross_entropy(
                       logits, label).mean(),
                   master_residency="master_only")
    torch.cuda.synchronize()
    print(f"train vit-l: {n_params} parameters, bf16 with float32 masters, "
          f"built in {time.perf_counter() - t0:.2f} s; patch conv "
          f"{'NHWC' if layout.decide(cfg.channels_last, 'cuda') else 'NCHW'}",
          flush=True)
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
    check_counts("train vit-l", counts, dict.fromkeys(counts, 0))
    if not (all(math.isfinite(v) for v in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train vit-l: losses {losses}, grad norms "
                             f"{norms}")
    med_ms = float(np.median(step_ms))
    flops = vit_flops(cfg, b)
    mfu = flops / (med_ms / 1e3) / H100_BF16_FLOPS
    prof = profile_step("train vit-l", ts, batch, ())
    print(f"train vit-l: 5 timed steps {[round(v, 3) for v in step_ms]} ms "
          f"(median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{b / (med_ms / 1e3):.1f} images/s, MFU {mfu:.4f} (analytic "
          f"{flops / 1e12:.3f} TFLOP a step / 989 TFLOP/s: bound "
          f"{flops / H100_BF16_FLOPS * 1e3:.2f} ms), peak {peak_gb:.2f} GB, "
          f"device busy {prof['device_ms'] / prof['wall_ms']:.3f} of the "
          f"profiled step; losses {losses}", flush=True)
    res = dict(step_ms=step_ms, step_ms_median=med_ms,
               images_per_s=b / (med_ms / 1e3), mfu=mfu,
               tflop_per_step=flops / 1e12, peak_gb=peak_gb,
               parameters=n_params, losses=losses, profile=prof)
    print(json.dumps({"train_vit_l": res}), flush=True)
    return res


RESNET_GN_SITE = dict(n=64, hw=56 * 56, c=256, g=32)  # stage 1's output


def gn_resnet_site(flush):
    """Rows 12-13 at the ResNet-50 GroupNorm arm's stage-1 site (batch
    64, 56 x 56, 256 channels, 32 groups, bf16, no activation): held
    against their plain versions (``gn_check``), then timed beside their
    bounds, their plain versions and ``F.group_norm`` forward and
    backward on the NCHW view."""
    from paddle_tpu_torch.kernels import group_norm as gn

    n, hw, c, g = (RESNET_GN_SITE[k] for k in ("n", "hw", "c", "g"))
    errs, ratio = gn_check(n, hw, c, g, torch.bfloat16, None, seed=300)
    x, dy, gamma, beta = gn_inputs(n, hw, c, torch.bfloat16, seed=301)
    _, mean, rstd = gn.group_norm_fwd(x, gamma, beta, g, 1e-5, None)
    side = int(math.isqrt(hw))
    x4 = x.view(n, side, side, c).permute(0, 3, 1, 2)
    dy4 = dy.view(n, side, side, c).permute(0, 3, 1, 2)
    wb = [t.to(torch.bfloat16).requires_grad_() for t in (gamma, beta)]
    xg = x4.detach().requires_grad_()
    fn = torch.nn.functional
    out = fn.group_norm(xg, g, wb[0], wb[1], 1e-5)
    calls = {
        "group_norm_fwd": (
            lambda: gn.group_norm_fwd(x, gamma, beta, g, 1e-5, None),
            lambda: gn.group_norm_fwd_plain(x, gamma, beta, g, 1e-5, None),
            lambda: fn.group_norm(x4, g, wb[0], wb[1], 1e-5)),
        "group_norm_bwd": (
            lambda: gn.group_norm_bwd(x, dy, gamma, beta, mean, rstd, g,
                                      None),
            lambda: gn.group_norm_bwd_plain(x, dy, gamma, beta, mean, rstd,
                                            g, None),
            lambda: torch.autograd.grad(out, [xg, *wb], dy4,
                                        retain_graph=True)),
    }
    rows = {}
    for name, (kernel, plain, library) in calls.items():
        ms = {k: time_ms(f, flush, iters=30)
              for k, f in (("kernel", kernel), ("plain", plain),
                           ("library", library))}
        bound_ms, bound_by = gn_bound(name, n, hw, c, g, 2, False)
        rows[name] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                          library_ms=ms["library"], bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs[name])
        print(f"group norm resnet site {name} n={n} hw={hw} c={c} g={g} "
              f"bf16: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} "
              f"ms, F.group_norm {ms['library']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); max abs err "
              f"{errs[name]:.3e} ({ratio:.3f} of its allowance)", flush=True)
    return rows


def train_resnet50_phase():
    """``resnet50()`` at 224 x 224, batch 64 (PaddleClas's per-card batch,
    ``ppcls/configs/ImageNet/ResNet/ResNet50.yaml``) with its
    ``Momentum(0.1, momentum=0.9)`` and L2 1e-4, bf16 with float32
    masters, channels-last by the auto policy: 2 warm-up and 5 timed
    steps, images/s, peak GB, the device's busy share in a profiled step,
    and the BatchNorm running statistics moved and finite. Then the
    GroupNorm arm (``norm_layer=lambda c: GroupNorm(32, c)``): rows 12-13
    launched once a norm a step (53), their device ms a step, and the two
    held against their plain versions at stage 1's site
    (``gn_resnet_site``)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import GroupNorm, layout
    from paddle_tpu_torch.trainer import TrainStep
    from paddle_tpu_torch.vision.models import resnet50

    b, out = 64, {}
    rng = np.random.default_rng(0)
    batch = {"x": torch.as_tensor(rng.standard_normal((b, 3, 224, 224)),
                                  device="cuda").to(torch.bfloat16),
             "labels": torch.as_tensor(np.random.default_rng(1).integers(
                 0, 1000, (b,)), device="cuda")}
    # 2 x 4.09 GMAC a 224 x 224 image forward (torchvision's count), x 3
    flops = 3 * 2 * 4.09e9 * b
    for arm, kw in (("batch_norm", {}),
                    ("group_norm", dict(norm_layer=lambda c: GroupNorm(32,
                                                                       c)))):
        label = f"train resnet50 {arm}"
        model = resnet50(device="cuda", seed=0, **kw).to(torch.bfloat16)
        before = {n: v.clone() for n, v in bn_buffers(model).items()}
        n_gn = sum(isinstance(m, GroupNorm) for m in model.modules())
        ts = TrainStep(model, topt.Momentum(0.1, momentum=0.9,
                                            weight_decay=1e-4,
                                            multi_precision=True),
                       master_residency="master_only")
        losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
        want = {k: 0 for k in counts}
        want.update(group_norm_fwd=5 * n_gn, group_norm_bwd=5 * n_gn)
        check_counts(label, counts, want)
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"{label}: losses {losses}, norms {norms}")
        prof = profile_step(label, ts, batch, GN_BODIES)
        med_ms = float(np.median(step_ms))
        busy = prof["device_ms"] / prof["wall_ms"]
        res = dict(step_ms=step_ms, step_ms_median=med_ms,
                   images_per_s=b / (med_ms / 1e3),
                   mfu=flops / (med_ms / 1e3) / H100_BF16_FLOPS,
                   peak_gb=peak_gb, device_busy=busy, losses=losses,
                   layout="NHWC" if layout.decide(None, "cuda") else "NCHW",
                   profile=prof)
        if arm == "batch_norm":
            ts.sync_to_model()
            after = bn_buffers(model)
            moved = sum(not torch.equal(after[n], before[n]) for n in after)
            finite = all(bool(torch.isfinite(v).all())
                         for v in after.values())
            if moved != len(after) or not finite:
                raise AssertionError(f"{label}: {moved} of {len(after)} "
                                     f"running statistics moved, finite "
                                     f"{finite}")
            res.update(running_stats=len(after), running_stats_moved=moved)
            extra = (f"{len(after)} running statistics moved and finite "
                     f"({after['bn1._mean'].dtype})")
        else:
            res.update(gn_launches_per_step=n_gn,
                       gn_ms_per_step=prof["kernels_ms"],
                       gn_ms_by_body=prof["by_name_ms"])
            extra = (f"rows 12-13 launched {n_gn} times each a step, "
                     f"{prof['kernels_ms']:.3f} ms of device time a step "
                     f"{prof['by_name_ms']}")
        print(f"{label}: 5 timed steps {[round(v, 3) for v in step_ms]} ms "
              f"(median {med_ms:.3f} ms), {res['images_per_s']:.1f} images/s,"
              f" MFU {res['mfu']:.4f} ({flops / 1e12:.2f} TFLOP a step), "
              f"peak {peak_gb:.2f} GB, device busy {busy:.3f} of the "
              f"profiled step ({prof['device_ms']:.2f} of "
              f"{prof['wall_ms']:.2f} ms); {extra}; losses {losses}",
              flush=True)
        out[arm] = res
        del model, ts
        torch.cuda.empty_cache()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out["gn_site"] = gn_resnet_site(flush)
    print(json.dumps({"train_resnet50": out}), flush=True)
    return out


# (constructor, input size, output classes): the 23 constructors and LeNet
ZOO_INPUTS = {"inception_v3": 299, "LeNet": 28}


def vision_zoo_phase():
    """One ``no_grad`` bf16 eval forward of each of the 24 zoo models
    (batch 8; 224 x 224, 299 for ``inception_v3``, 1 x 28 x 28 for
    ``LeNet``): the output shape and finiteness, and images/s of a
    second forward (CUDA events); no kernel of rows 1-13 launches."""
    from paddle_tpu_torch.vision import models as zoo

    b, out = 8, {}
    for i, name in enumerate([*zoo.CONSTRUCTORS, "LeNet"]):
        size = ZOO_INPUTS.get(name, 224)
        model = getattr(zoo, name)(device="cuda", seed=i).to(
            torch.bfloat16).eval()
        x = torch.as_tensor(np.random.default_rng(i).standard_normal(
            (b, 1 if name == "LeNet" else 3, size, size)),
            device="cuda").to(torch.bfloat16)
        classes = 10 if name == "LeNet" else 1000
        reset_launches()
        with torch.no_grad():
            y = model(x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x)
            end.record()
            end.synchronize()
        counts = read_launches()
        check_counts(f"zoo {name}", counts, dict.fromkeys(counts, 0))
        ms = start.elapsed_time(end)
        if tuple(y.shape) != (b, classes) or not torch.isfinite(y).all():
            raise AssertionError(f"zoo {name}: output {tuple(y.shape)}, "
                                 f"finite {bool(torch.isfinite(y).all())}")
        n_params = sum(p.numel() for p in model.parameters())
        out[name] = dict(ms=ms, images_per_s=b / (ms / 1e3),
                         parameters=n_params, size=size)
        print(f"zoo {name}: {n_params} parameters, bf16 eval forward of "
              f"{b} x {size} x {size}: {ms:.3f} ms, "
              f"{b / (ms / 1e3):.1f} images/s", flush=True)
        del model, x, y
    torch.cuda.empty_cache()
    print(json.dumps({"vision_zoo": out}), flush=True)
    return out


RWKV_REF_TOL = {"logits": 1e-5, "loss": 1e-5, "grads": 1e-4, "wkv": 1e-5}


def rwkv_wkv_checks():
    """The card's ``wkv_associative`` against the float64 per-step
    recurrence (``wkv_reference``) on [2, 1024, 64], decays as softplus
    gives them, and on the +-90 k case of ``tests/test_rwkv.py``: the
    largest error over the largest magnitude."""
    from paddle_tpu_torch.models import wkv_associative, wkv_reference

    rng = np.random.default_rng(21)
    k = rng.standard_normal((2, 1024, 64)).astype(np.float32) * 0.6
    v = rng.standard_normal((2, 1024, 64)).astype(np.float32)
    w = rng.uniform(0.13, 0.32, 64).astype(np.float32)
    u = np.full(64, 0.3, np.float32)
    big = (np.asarray([[[80.0], [-90.0], [85.0], [0.0]]], np.float32),
           np.ones((1, 4, 1), np.float32), np.asarray([0.5], np.float32),
           np.asarray([0.2], np.float32))
    errs = {}
    for name, args in (("2x1024x64", (k, v, w, u)), ("large_k", big)):
        got = wkv_associative(*(torch.as_tensor(a, device="cuda")
                                for a in args))
        ref = torch.as_tensor(wkv_reference(*args))
        errs[name] = max_rel(got.double(), ref)
        if not (torch.isfinite(got).all()
                and errs[name] <= RWKV_REF_TOL["wkv"]):
            raise AssertionError(f"rwkv wkv {name}: card vs float64 "
                                 f"{errs[name]:.3e}")
    return errs


def rwkv_reference_phase():
    """The RWKV-4 169M widths cut to 2 layers, batch 2 x 1024, float32,
    the same seeded weights on the card and the CPU: a ``no_grad``
    forward's logits, then the loss and every gradient, within
    ``RWKV_REF_TOL`` of each tensor's largest magnitude; then the card's
    WKV scan against the float64 recurrence (``rwkv_wkv_checks``). No
    kernel of rows 1-13 launches."""
    from paddle_tpu_torch.models import RWKVConfig, RWKVForCausalLM

    cfg = dataclasses.replace(RWKVConfig.rwkv4_169m(), num_hidden_layers=2)
    cpu, card = card_and_cpu(
        lambda dev, seed: RWKVForCausalLM(cfg, device=dev, seed=seed), 21)
    ids = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 1024))
    got = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        t = torch.as_tensor(ids, device=dev)
        reset_launches()
        with torch.no_grad():
            logits = model(t)
        loss = model(t, t)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
            check_counts("rwkv reference", counts, dict.fromkeys(counts, 0))
        got[dev] = (logits, loss.detach(),
                    {n: p.grad for n, p in model.named_parameters()})
    (cl, closs, cg), (pl, ploss, pg) = got["cuda"], got["cpu"]
    errs = {"logits": max_rel(cl, pl), "loss": max_rel(closs, ploss),
            "grads": max(max_rel(cg[n], pg[n]) for n in pg)}
    worst = max(pg, key=lambda n: max_rel(cg[n], pg[n]))
    bad = [k for k, e in errs.items() if not e <= RWKV_REF_TOL[k]]
    if bad or not torch.isfinite(cl).all() or len(pg) != 6 + 18 * 2:
        raise AssertionError(f"rwkv reference: card vs CPU {errs} (worst "
                             f"gradient {worst}), tol {RWKV_REF_TOL}")
    errs["wkv"] = rwkv_wkv_checks()
    print(f"rwkv reference: RWKV-4 169M widths, 2 layers, float32, batch 2 x "
          f"1024, card vs CPU from the same weights: logits "
          f"{errs['logits']:.3e}, loss {float(closs):.6f} vs "
          f"{float(ploss):.6f} ({errs['loss']:.3e}), {len(pg)} gradients "
          f"worst {errs['grads']:.3e} ({worst}) of each tensor's largest "
          f"magnitude; the card's WKV scan vs the float64 recurrence "
          f"{errs['wkv']} (tol {RWKV_REF_TOL}); no kernel launched",
          flush=True)
    return errs


def rwkv_flops(cfg, tokens):
    """6 N T for the N matmul weights a token passes (a layer's four h x h
    time-mix matrices, the channel mix's h x f, f x h and h x h, and the
    head; the embedding is a lookup); the WKV scan's elementwise work is
    not counted."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    n = cfg.num_hidden_layers * (5 * h * h + 2 * h * f) + h * cfg.vocab_size
    return 6 * n * tokens, n


def train_rwkv_phase():
    """The slice's full-width path: ``RWKVConfig.rwkv4_169m()`` (12 layers
    of 768, FFN 3072, vocab 50277), float32 (the config's dtype),
    batch 4 x 1024, ``AdamW(1e-4, multi_precision=True)`` through
    ``TrainStep``: 2 warm-up and 5 timed steps (CUDA events), tokens/s,
    MFU (6 N T against 67 TFLOP/s float32), peak GB, one profiled step's
    busy share and heaviest operators; no kernel of rows 1-13 launches."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import RWKVConfig, RWKVForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    cfg, b, s = RWKVConfig.rwkv4_169m(), 4, 1024
    t0 = time.perf_counter()
    model = RWKVForCausalLM(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    ts = TrainStep(model, topt.AdamW(1e-4, multi_precision=True))
    torch.cuda.synchronize()
    print(f"train rwkv-169m: {n_params} parameters, float32, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    losses, norms, step_ms, counts, peak_gb = train_steps(ts, batch)
    check_counts("train rwkv-169m", counts, dict.fromkeys(counts, 0))
    if not (all(math.isfinite(v) for v in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train rwkv-169m: losses {losses}, grad "
                             f"norms {norms}")
    med_ms = float(np.median(step_ms))
    flops, n_matmul = rwkv_flops(cfg, b * s)
    mfu = flops / (med_ms / 1e3) / H100_F32_FLOPS
    prof = profile_step("train rwkv-169m", ts, batch, ())
    busy = prof["device_ms"] / prof["wall_ms"]
    print(f"train rwkv-169m: 5 timed steps {[round(v, 3) for v in step_ms]} "
          f"ms (median {med_ms:.3f} ms, CUDA events around TrainStep.run), "
          f"{b * s / (med_ms / 1e3):.1f} tokens/s, MFU {mfu:.4f} (6 N T, N "
          f"{n_matmul} matmul weights: {flops / 1e12:.3f} TFLOP a step / 67 "
          f"TFLOP/s: bound {flops / H100_F32_FLOPS * 1e3:.2f} ms), peak "
          f"{peak_gb:.2f} GB, device busy {busy:.3f} of the profiled step; "
          f"losses {losses}; {nvidia_smi_line()}", flush=True)
    res = dict(step_ms=step_ms, step_ms_median=med_ms,
               tokens_per_s=b * s / (med_ms / 1e3), mfu=mfu,
               tflop_per_step=flops / 1e12, peak_gb=peak_gb,
               parameters=n_params, busy=busy, losses=losses, profile=prof)
    print(json.dumps({"train_rwkv_169m": res}), flush=True)
    return res


LOSS_REF_TOL = {"value": 1e-5, "grads": 1e-4}
# a loss of a few hundred nats (``rnnt_loss`` over T 128 x U 32) or a 256
# step recurrence is a sum float32 itself rounds by more than the
# tolerance: on the host float32 is 1.0e-4 of the largest entry off
# float64 in ``rnnt_loss``'s gradient. The card is then held to float64
# within this factor of the CPU's float32 error, as the vision reference
# holds its gradients
LOSS_REF_SLACK = 10.0


def loss_cases(rng):
    """The 22 losses at moderate sizes, float32: (name, function, inputs,
    keyword arguments); ``ctc_loss`` at T 256, B 16, C 32, labels up to
    64, ``rnnt_loss`` at B 4, T 128, U 32, V 128."""
    def f(*shape, lo=None, hi=None, scale=1.0):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ids(*shape, n):
        return rng.integers(0, n, shape)

    def sign(*shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(
            np.float32)

    n, c = 512, 1000
    logp = f(n, c)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    ctc_lab = ids(16, 64, n=31) + 1
    ctc_len = rng.integers(32, 65, 16)
    rnnt_len = rng.integers(16, 33, 4)
    return [
        ("cross_entropy", "cross_entropy", [f(n, c), ids(n, n=c)],
         dict(label_smoothing=0.1)),
        ("mse_loss", "mse_loss", [f(n, c), f(n, c)], {}),
        ("l1_loss", "l1_loss", [f(n, c), f(n, c)], {}),
        ("nll_loss", "nll_loss", [logp, ids(n, n=c)], {}),
        ("binary_cross_entropy_with_logits",
         "binary_cross_entropy_with_logits",
         [f(n, c, scale=3), f(n, c, lo=0, hi=1)], {}),
        ("ctc_loss", "ctc_loss",
         [f(256, 16, 32, scale=2), ctc_lab, rng.integers(200, 257, 16),
          ctc_len], {}),
        ("rnnt_loss", "rnnt_loss",
         [f(4, 128, 33, 128), ids(4, 32, n=127) + 1,
          rng.integers(96, 129, 4), rnnt_len], {}),
        ("kl_div", "kl_div", [logp, f(n, c, lo=0, hi=1)],
         dict(reduction="batchmean")),
        ("margin_ranking_loss", "margin_ranking_loss",
         [f(n * c), f(n * c), sign(n * c)], dict(margin=0.1)),
        ("smooth_l1_loss", "smooth_l1_loss", [f(n, c), f(n, c)], {}),
        ("triplet_margin_loss", "triplet_margin_loss",
         [f(n, 256), f(n, 256), f(n, 256)], dict(swap=True)),
        ("cosine_embedding_loss", "cosine_embedding_loss",
         [f(n, 256), f(n, 256), sign(n)], dict(margin=0.1)),
        ("soft_margin_loss", "soft_margin_loss",
         [f(n, c, scale=30), sign(n, c)], {}),
        ("hinge_embedding_loss", "hinge_embedding_loss",
         [f(n, c), sign(n, c)], {}),
        ("poisson_nll_loss", "poisson_nll_loss",
         [f(n, c, lo=0.5, hi=3), f(n, c, lo=0.2, hi=4)],
         dict(log_input=False, full=True)),
        ("gaussian_nll_loss", "gaussian_nll_loss",
         [f(n, c), f(n, c), f(n, c, lo=0.1, hi=2)], dict(full=True)),
        ("multi_label_soft_margin_loss", "multi_label_soft_margin_loss",
         [f(n, c), ids(n, c, n=2).astype(np.float32)], {}),
        ("sigmoid_focal_loss", "sigmoid_focal_loss",
         [f(n, c, scale=2), ids(n, c, n=2)], {}),
        ("dice_loss", "dice_loss", [f(16, 4096, 8, lo=0, hi=1),
                                    ids(16, 4096, 1, n=8)], {}),
        ("log_loss", "log_loss", [f(n * c, 1, lo=0.01, hi=0.99),
                                  ids(n * c, 1, n=2).astype(np.float32)], {}),
        ("square_error_cost", "square_error_cost", [f(n, c), f(n, c)], {}),
        ("binary_cross_entropy", "binary_cross_entropy",
         [f(n, c, lo=0.01, hi=0.99), f(n, c, lo=0, hi=1)], {}),
    ]


def card_cpu_value_and_grads(label, calls, inputs, weights_seed,
                             modules=None):
    """``calls[dev]`` on ``inputs`` (numpy) on the card and the CPU: the
    outputs and the gradients of a fixed random weighting of them with
    respect to every floating input and every parameter of
    ``modules[dev]``. Each tensor's error is its largest difference over
    the largest magnitude: card vs CPU within ``LOSS_REF_TOL``; where that
    fails, the CPU runs again in float64 (``"f64"``), and a tensor whose
    float32 CPU value is itself further than the tolerance from float64
    holds the card within ``LOSS_REF_SLACK`` times the CPU's error of
    float64. Returns the errors and the card's forward + backward ms (CUDA
    events, the second of two runs)."""
    def run(dev):
        where = "cpu" if dev == "f64" else dev
        params = [] if modules is None else list(modules[dev].parameters())
        for p in params:
            p.grad = None
        ts = []
        for a in inputs:
            floating = np.issubdtype(np.asarray(a).dtype, np.floating)
            t = torch.tensor(a, device=where)
            if floating and dev == "f64":
                t = t.double()
            ts.append(t.requires_grad_(floating))
        out = calls[dev](*ts)
        flat = torch.cat([o.flatten() for o in out]) \
            if isinstance(out, (tuple, list)) else out.flatten()
        w = torch.as_tensor(np.random.default_rng(weights_seed).uniform(
            0.5, 1.5, flat.numel()), device=where, dtype=flat.dtype)
        (flat * w).sum().backward()
        return [flat.detach()] + [t.grad for t in ts if t.requires_grad] \
            + [p.grad for p in params]

    run("cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    card = run("cuda")
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    cpu = run("cpu")
    # an input the function only selects on (a sign label) has no gradient
    keep = [i for i in range(1, len(cpu)) if cpu[i] is not None]
    groups = (("value", [0]), ("grads", keep))
    errs = {k: max((max_rel(card[i], cpu[i]) for i in idx), default=0.0)
            for k, idx in groups}
    worst = {}
    if any(errs[k] > LOSS_REF_TOL[k] for k, _ in groups):
        f64 = run("f64")
        for key, idx in groups:
            worst[key] = dict(card_vs_f64=0.0, cpu_vs_f64=0.0, ratio=0.0)
            for i in idx:
                if max_rel(card[i], cpu[i]) <= LOSS_REF_TOL[key]:
                    continue
                c64, h64 = max_rel(card[i], f64[i]), max_rel(cpu[i], f64[i])
                allowed = max(LOSS_REF_TOL[key], LOSS_REF_SLACK * h64)
                worst[key] = max(worst[key], dict(
                    card_vs_f64=c64, cpu_vs_f64=h64, ratio=c64 / allowed),
                    key=lambda d: d["ratio"])
            if not worst[key]["ratio"] <= 1.0:
                raise AssertionError(
                    f"{label} {key}: card vs CPU {errs[key]:.3e}; the worst "
                    f"tensor against float64 {worst[key]}; tol "
                    f"{LOSS_REF_TOL}, slack {LOSS_REF_SLACK}")
    if not torch.isfinite(card[0]).all():
        raise AssertionError(f"{label}: outputs not finite")
    return dict(errs, f64=worst, ms=ms, gradients=len(keep))


def losses_rnn_reference_phase():
    """Float32, card vs CPU, the value and every input gradient of each of
    the 22 losses (``loss_cases``), then ``SimpleRNN``, ``LSTM`` and
    ``GRU`` at 2 layers, bidirectional, input 80, hidden 512, batch 16 x
    256 from the same weights: outputs, final states, the input's and
    every parameter's gradient within ``LOSS_REF_TOL`` of each tensor's
    largest magnitude, with the card's forward + backward ms. No kernel
    of rows 1-13 launches."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn import functional as F

    reset_launches()
    out = {}
    for name, fn, inputs, kw in loss_cases(np.random.default_rng(22)):
        def call(*a, fn=fn, kw=kw):
            return getattr(F, fn)(*a, **kw)

        out[name] = card_cpu_value_and_grads(
            f"loss {name}", dict.fromkeys(("cuda", "cpu", "f64"), call),
            inputs, 1)
    if set(out) != set(F.LOSSES):
        raise AssertionError(f"losses checked {sorted(out)}")
    held = {k: r["f64"] for k, r in out.items() if r["f64"]}
    print(f"losses reference: 22 losses, float32, card vs CPU, value and "
          f"every input gradient (tol {LOSS_REF_TOL}): worst value "
          f"{max(r['value'] for r in out.values()):.3e}, worst gradient "
          f"{max(r['grads'] for r in out.values()):.3e}; held to float64 "
          f"instead (card, CPU float32 vs float64; slack "
          f"{LOSS_REF_SLACK}): {held}; forward + backward "
          f"ms on the card: " + ", ".join(
              f"{k} {r['ms']:.2f}" for k, r in out.items())
          + f"; {nvidia_smi_line()}", flush=True)
    x = np.random.default_rng(23).standard_normal((16, 256, 80)).astype(
        np.float32)
    for name in ("SimpleRNN", "LSTM", "GRU"):
        cpu, card = card_and_cpu(
            lambda dev, seed, name=name: getattr(tnn, name)(
                80, 512, num_layers=2, direction="bidirect", device=dev,
                generator=torch.Generator(dev).manual_seed(seed)), 23)

        def run(layer):
            def call(a):
                y, last = layer(a)
                return (y, *last) if isinstance(last, tuple) else (y, last)
            return call

        ref = copy.deepcopy(cpu).double()
        errs = card_cpu_value_and_grads(
            f"rnn {name}", {"cuda": run(card), "cpu": run(cpu),
                            "f64": run(ref)}, [x], 2,
            modules={"cuda": card, "cpu": cpu, "f64": ref})
        out[name] = errs
        print(f"rnn reference {name}: 2 layers bidirectional, 80 -> 512, "
              f"batch 16 x 256, float32, card vs CPU from the same weights: "
              f"outputs and final states {errs['value']:.3e}, the input's "
              f"and {errs['gradients'] - 1} parameters' gradients "
              f"{errs['grads']:.3e} (tol {LOSS_REF_TOL}; held to float64 "
              f"where over: {errs['f64']}); forward + backward "
              f"{errs['ms']:.2f} ms on the card; {nvidia_smi_line()}",
              flush=True)
    counts = read_launches()
    check_counts("losses and rnn reference", counts, dict.fromkeys(counts, 0))
    print(json.dumps({"losses_rnn_reference": out}), flush=True)
    return out


class SpeechCTC(torch.nn.Module):
    """A composition of the ported modules, not a model of the repo:
    ``LogMelSpectrogram`` (16 kHz, n_fft 512, hop 160, 80 mels) ->
    2-layer bidirectional ``GRU`` (hidden 512) -> ``Linear`` to 32 classes
    -> ``ctc_loss`` (blank 0)."""

    def __init__(self, device, seed):
        super().__init__()
        from paddle_tpu_torch import audio
        from paddle_tpu_torch.nn import GRU, Linear

        gen = torch.Generator(device).manual_seed(seed)
        self.features = audio.LogMelSpectrogram(
            sr=16000, n_fft=512, hop_length=160, n_mels=80, device=device)
        self.rnn = GRU(80, 512, num_layers=2, direction="bidirect",
                       device=device, generator=gen)
        self.head = Linear(1024, 32, device=device, generator=gen)

    def forward(self, wave, labels, label_lengths):
        from paddle_tpu_torch.nn import functional as F

        feats = self.features(wave).transpose(1, 2) / 40.0  # [b, t, mels]
        h, _ = self.rnn(feats)
        logits = self.head(h).transpose(0, 1)  # [t, b, classes]
        lengths = torch.full((wave.shape[0],), logits.shape[0],
                             device=wave.device)
        return F.ctc_loss(logits, labels, lengths, label_lengths)


def speech_phase():
    """``LogMelSpectrogram(sr=16000, n_fft=512, hop_length=160,
    n_mels=80)`` and ``MFCC`` on [8, 64000] seeded waveforms, card vs CPU
    within 1e-5 of the largest magnitude; then ``SpeechCTC`` (features ->
    GRU -> Linear -> ``ctc_loss``) from the same weights: the card's
    forward + backward ms and its loss beside the CPU's. No kernel of rows
    1-13 launches."""
    from paddle_tpu_torch import audio

    rng = np.random.default_rng(24)
    wave = rng.standard_normal((8, 64000)).astype(np.float32)
    reset_launches()
    errs = {}
    for name, make in (
            ("logmel", lambda dev: audio.LogMelSpectrogram(
                sr=16000, n_fft=512, hop_length=160, n_mels=80,
                device=dev)),
            ("mfcc", lambda dev: audio.MFCC(
                sr=16000, n_mfcc=40, n_fft=512, hop_length=160, n_mels=80,
                device=dev))):
        card = make("cuda")(torch.as_tensor(wave, device="cuda"))
        cpu = make("cpu")(torch.as_tensor(wave))
        errs[name] = max_rel(card, cpu)
        if card.shape != (8, 80 if name == "logmel" else 40, 401) \
                or not errs[name] <= 1e-5:
            raise AssertionError(f"speech {name}: {tuple(card.shape)}, card "
                                 f"vs CPU {errs[name]:.3e}")
    labels = rng.integers(1, 32, (8, 64))
    label_lengths = rng.integers(32, 65, 8)
    cpu, card = card_and_cpu(lambda dev, seed: SpeechCTC(dev, seed), 24)
    losses = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        for _ in range(2 if dev == "cuda" else 1):  # the second run timed
            model.zero_grad()
            args = [torch.as_tensor(a, device=dev)
                    for a in (wave, labels, label_lengths)]
            if dev == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            loss = model(*args)
            loss.backward()
            if dev == "cuda":
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
        losses[dev] = loss.detach()
    rel = max_rel(losses["cuda"], losses["cpu"])
    counts = read_launches()
    check_counts("speech surface", counts, dict.fromkeys(counts, 0))
    if not (torch.isfinite(losses["cuda"]) and rel <= 1e-5):
        raise AssertionError(f"speech ctc: card {float(losses['cuda'])} vs "
                             f"CPU {float(losses['cpu'])}")
    print(f"speech surface: [8, 64000] at 16 kHz, card vs CPU: log-mel "
          f"{errs['logmel']:.3e}, MFCC {errs['mfcc']:.3e} of the largest "
          f"magnitude; log-mel -> 2-layer bidirectional GRU (512) -> Linear "
          f"-> ctc_loss (401 frames, labels up to 64): loss "
          f"{float(losses['cuda']):.6f} card vs {float(losses['cpu']):.6f} "
          f"CPU ({rel:.3e}), forward + backward {ms:.2f} ms on the card; "
          f"{nvidia_smi_line()}", flush=True)
    res = dict(errs, ctc_loss_card=float(losses["cuda"]),
               ctc_loss_cpu=float(losses["cpu"]), ctc_rel=rel,
               fwd_bwd_ms=ms)
    print(json.dumps({"speech_surface": res}), flush=True)
    return res


# ---------------------------------------------------------------------------
# the distributed core: the launcher, every collective over NCCL at world
# size 1, the 7B train step over a mesh at ZeRO-3 against the meshless
# step, and a gloo dp = 2 host check
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the distributed core's second half: ring attention, sharded checkpoints
# and pipelines on the card (the gloo worker below adds pp, sep, ep and a
# checkpoint across meshes on the host)
# ---------------------------------------------------------------------------
RING_SHAPE = dict(n=4, b=1, s=8192, h=32, d=128)
RING_ROWS = ("flash_attention_fwd_lse", "flash_attention_bwd_fused",
             "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def ring_rows(kind, r, n, sl):
    """The sequence rows rank ``r``'s ring state holds: its contiguous
    chunk, or (zigzag) half-chunks r and 2n-1-r."""
    if kind != "zigzag":
        return list(range(r * sl, (r + 1) * sl))
    h = sl // 2
    return list(range(r * h, (r + 1) * h)) + list(
        range((2 * n - 1 - r) * h, (2 * n - r) * h))


def ring_phase():
    """Ring attention (``kernels/ring_attention.py``) as n = 4 virtual
    ranks on one card (``run_ring_virtual`` drives their bodies in
    lockstep), b 1, s 8192, 32 x 128 heads, bf16: the zigzag causal, the
    contiguous causal and the non-causal layouts, each forward and
    backward, held against one whole-sequence call of row 6 and its
    backward (rows 7 and 9 at s 8192) with ``fa_check``'s row-wise
    tolerance (bf16 2e-2) and the LSE within n x 1e-5 absolutely (each
    row's LSE is the logsumexp merge of up to n block LSEs, each with the
    kernel's own float32 rounding; the first run saw 1.34e-5). The
    contiguous layout's backward runs at ``flash_attention_block_k=256``
    (its 2048-row kv blocks take rows 7 and 9), the others at the default
    (row 8). Launches of rows 6-9 are counted over the ring's own calls;
    device ms from CUDA events around the ring (all 4 ranks' blocks in
    turn, after one untimed forward and backward) and around the whole
    call."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.kernels import mha as fa
    from paddle_tpu_torch.kernels import ring_attention as ring

    t = RING_SHAPE
    n, b, s, h, d = (t[x] for x in ("n", "b", "s", "h", "d"))
    sl = s // n
    scale = d ** -0.5
    smi = nvidia_smi_line()

    def events(fn):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        z.record()
        z.synchronize()
        return out, a.elapsed_time(z)

    out_rows = {}
    for seed, (kind, causal, block_k) in enumerate((
            ("zigzag", True, 1024), ("contiguous", True, 256),
            ("plain", False, 1024))):
        q, k, v, do, _ = fa_inputs(b, s, h, h, d, torch.bfloat16,
                                   seed=90 + seed)
        parts = [[x[:, r * sl:(r + 1) * sl] for x in (q, k, v, do)]
                 for r in range(n)]

        def forward():
            return ring.run_ring_virtual([
                ring.ring_forward_body(kind, *parts[r][:3], r, n, scale)
                for r in range(n)])

        def backward(fwd):
            return ring.run_ring_virtual([
                ring.ring_backward_body(kind, fwd[r][1], parts[r][3], r, n,
                                        scale) for r in range(n)])

        flags.set_flags({"flash_attention_block_k": block_k})
        try:
            backward(forward())  # warm-up: the first launches load them
            reset_launches()
            fwd, fwd_ms = events(forward)
            grads, bwd_ms = events(lambda: backward(fwd))
            counts = {r_: read_launches()[r_] for r_ in RING_ROWS}
        finally:
            flags.set_flags({"flash_attention_block_k": 1024})
        (o, lse), whole_fwd_ms = events(lambda: fa.flash_forward(
            q, k, v, causal, scale, with_lse=True))
        want, whole_bwd_ms = events(lambda: fa.mha_backward(
            q, k, v, o, lse, do, None, causal, scale))
        got = {"o": torch.cat([f[0] for f in fwd], dim=1),
               "lse": torch.cat([f[1][4] for f in fwd], dim=2),
               "dq": torch.cat([g[0] for g in grads], dim=1),
               "dk": torch.cat([g[1] for g in grads], dim=1),
               "dv": torch.cat([g[2] for g in grads], dim=1)}
        rows = [i for r in range(n) for i in ring_rows(kind, r, n, sl)]
        ref = {"o": o, "lse": lse[:, :, rows], "dq": want[0],
               "dk": want[1], "dv": want[2]}
        errs, failed = fa_compare(f"ring {kind}", got, ref,
                                  FA_ROW_TOL[torch.bfloat16],
                                  lse_tol=n * FA_LSE_TOL)
        blocks = {"zigzag": n * n, "plain": n * n,
                  "contiguous": n * (n + 1) // 2}[kind]
        two = block_k == 256
        want_counts = {"flash_attention_fwd_lse": blocks,
                       "flash_attention_bwd_fused": 0 if two else blocks,
                       "flash_attention_bwd_dq": blocks if two else 0,
                       "flash_attention_bwd_dkv": blocks if two else 0}
        if failed or counts != want_counts:
            raise AssertionError(f"ring {kind}: failed {failed} ({errs}); "
                                 f"launches {counts}, want {want_counts}")
        out_rows[kind] = {
            "causal": causal, "flash_attention_block_k": block_k,
            "ring_fwd_ms": fwd_ms, "ring_bwd_ms": bwd_ms,
            "whole_fwd_ms": whole_fwd_ms, "whole_bwd_ms": whole_bwd_ms,
            "errors": {key: e[0] for key, e in errs.items()},
            "launches": counts}
        print(f"ring {kind}: {n} virtual ranks, b={b} s={s} h={h} d={d} "
              f"bf16, causal {causal}: forward {fwd_ms:.3f} ms, backward "
              f"{bwd_ms:.3f} ms (CUDA events around the ring's {blocks} "
              f"blocks in turn, with the merges and the exchanges as "
              f"list passing) against the whole-sequence call's "
              f"{whole_fwd_ms:.3f} / {whole_bwd_ms:.3f} ms; row errors "
              f"{ {key: round(e[0], 7) for key, e in errs.items()} } "
              f"(bf16 2e-2, lse {n} x 1e-5 abs); launches {counts}; {smi}",
              flush=True)
        del q, k, v, do, parts, fwd, grads, got, ref, o, lse, want
        torch.cuda.empty_cache()
    print(json.dumps({"ring_attention": {
        "shape": dict(t), "dtype": "bfloat16", "device": smi,
        **out_rows}}), flush=True)
    return out_rows


def state_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def ckpt_train_step(cfg, mesh):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt = topt.AdamW(learning_rate=3e-4, weight_decay=0.01,
                     multi_precision=True,
                     grad_clip=topt.ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, mesh, master_residency="master_only")


def checkpoint_phase():
    """Llama-2-7B width cut to 2 layers (0.67 B parameters: about 8 GB of
    float32 masters and AdamW moments), bf16 ``master_only``, b 4 x 2048,
    through ``TrainStep(mesh=build_mesh())`` over NCCL at world size 1:
    3 steps, ``AsyncCheckpointer.save(ts.state_dict(), dir)``, steps 4-5
    while the chunks are written, ``wait_until_finished``; then a fresh
    step loads the checkpoint (``load_state_dict(dir, shardings=
    ts.state_shardings())``) and runs steps 4-5 again: the losses equal
    the uninterrupted ones (identical, or within 1e-5 relative where the
    step is not deterministic; which one is printed). The directory is
    removed after."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.io import native

    cfg = dataclasses.replace(train_7b_config(), num_hidden_layers=2)
    mesh = D.build_mesh()
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    smi = nvidia_smi_line()
    ts = ckpt_train_step(cfg, mesh)
    first = [float(ts.run(batch)) for _ in range(3)]
    state = ts.state_dict()
    nbytes = state_bytes(state)
    root = tempfile.mkdtemp(prefix="pt_ckpt_")
    path = os.path.join(root, "step_3")
    try:
        free = shutil.disk_usage(root).free
        if free < 2 * nbytes:
            raise RuntimeError(f"checkpoint phase: {free / 1e9:.1f} GB free "
                               f"under {root}, the state is "
                               f"{nbytes / 1e9:.2f} GB")
        saver = ckpt.AsyncCheckpointer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(state, path)
        blocking_s = time.perf_counter() - t0
        del state
        cont = [float(ts.run(batch)) for _ in range(2)]
        t0 = time.perf_counter()
        saver.wait_until_finished()
        waited_s = time.perf_counter() - t0
        commit_s = saver.last["commit_s"]
        if not ckpt.is_committed(path):
            raise AssertionError("the checkpoint was not committed")
        del ts
        torch.cuda.empty_cache()
        fresh = ckpt_train_step(cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.set_state_dict(ckpt.load_state_dict(
            path, shardings=fresh.state_shardings()))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resumed = [float(fresh.run(batch)) for _ in range(2)]
        identical = resumed == cont
        gap = max(abs(a - c) / abs(c) for a, c in zip(resumed, cont))
        if not (identical or gap <= 1e-5) or fresh.step_count != 5:
            raise AssertionError(f"resumed losses {resumed}, uninterrupted "
                                 f"{cont} (rel gap {gap})")
        writer = native.build("ckptio.cpp")
        files = len(os.listdir(path))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"model": "llama2_7b width, 2 layers, random bf16 weights (seed "
                    "0), master_only", "batch": b, "seq": s,
           "state_gb": nbytes / 1e9, "blocking_snapshot_s": blocking_s,
           "commit_s": commit_s, "commit_gb_per_s": nbytes / 1e9 / commit_s,
           "wait_after_steps_s": waited_s, "load_s": load_s,
           "files": files, "losses_1_3": first, "losses_4_5": cont,
           "resumed_losses_4_5": resumed, "identical": identical,
           "rel_gap": gap, "native_writer": str(writer), "device": smi}
    print(f"checkpoint: {nbytes / 1e9:.2f} GB of state (bf16 weights cast "
          f"from the masters, float32 masters and moments) in {files} "
          f"files; blocking snapshot {blocking_s:.3f} s, write and commit "
          f"{commit_s:.3f} s ({nbytes / 1e9 / commit_s:.2f} GB/s, native "
          f"writer {writer}, fsync on; the page cache was warm) beside "
          f"steps 4-5; wait after them {waited_s:.3f} s; load into a fresh "
          f"step {load_s:.3f} s; resumed losses {resumed} "
          f"{'identical to' if identical else f'within {gap:.2e} of'} "
          f"the uninterrupted {cont}; {smi}", flush=True)
    print(json.dumps({"checkpoint": out}), flush=True)
    del fresh
    torch.cuda.empty_cache()
    return out


def pipeline_phase():
    """``llama_pipeline_module`` at Llama-2-7B width, 4 layers, untied,
    bf16 (float32 masters, ``master_only``), b 4 x 2048 in
    ``accumulate_steps`` 4 micro-batches, through ``PipelineTrainStep``
    at pp = 1 over NCCL (``build_mesh()``) under 1F1B, VPP
    (``vpp_degree`` 2: two virtual stages of 2 layers) and F-then-B, 3
    steps each from the same seed-0 weights: the losses agree within rtol
    2e-4 (the JAX suite's ``test_llama_pipeline_module_trains``), rows 6
    and 8 once a layer a micro-batch. Prints each schedule's ms a step
    (CUDA events, median of steps 2-3), tokens/s, peak GB and
    launches."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import llama_pipeline_module
    from paddle_tpu_torch.nn import functional as F

    cfg = train_7b_config()
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    n_micro, layers = 4, cfg.num_hidden_layers
    mesh = D.build_mesh()
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                          device="cuda")
    labels = torch.roll(ids, -1, dims=1)
    smi = nvidia_smi_line()

    def loss_fn(logits, lab):
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size).float(),
                               lab.reshape(-1))

    runs = {}
    for schedule, vpp in (("1F1B", 1), ("VPP", 2), ("F-then-B", 1)):
        module = llama_pipeline_module(cfg, 1, device="cuda", seed=0)
        strategy = D.DistributedStrategy()
        strategy.pipeline_configs.schedule_mode = schedule
        strategy.pipeline_configs.vpp_degree = vpp
        strategy.pipeline_configs.accumulate_steps = n_micro
        opt = topt.AdamW(learning_rate=3e-4, weight_decay=0.01,
                         multi_precision=True,
                         grad_clip=topt.ClipGradByGlobalNorm(1.0))
        ts = D.PipelineTrainStep(module, opt, mesh, strategy, loss_fn,
                                 master_residency="master_only")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, step_ms = [], []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            loss = ts.run(ids, labels)
            z.record()
            z.synchronize()
            step_ms.append(a.elapsed_time(z))
            losses.append(float(loss))
        counts = read_launches()
        got = {r_: counts[r_] for r_ in ("flash_attention_fwd_lse",
                                          "flash_attention_bwd_fused")}
        want = dict.fromkeys(got, 3 * n_micro * layers)
        if got != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"pipeline {schedule}: launches {got}, "
                                 f"want {want}; losses {losses}")
        med = float(np.median(step_ms[1:]))
        runs[schedule] = {"vpp_degree": vpp, "losses": losses,
                          "step_ms": step_ms, "step_ms_median_2_3": med,
                          "tokens_per_s": b * s / (med / 1e3),
                          "peak_memory_gb":
                              torch.cuda.max_memory_allocated() / 1e9,
                          "launches": got}
        print(f"pipeline {schedule} (vpp {vpp}, {n_micro} micro-batches of "
              f"{b // n_micro} x {s}): steps {[round(x, 3) for x in step_ms]}"
              f" ms (median of 2-3 {med:.3f} ms), "
              f"{b * s / (med / 1e3):.1f} tokens/s, peak "
              f"{runs[schedule]['peak_memory_gb']:.2f} GB, losses {losses}, "
              f"launches {got}; {smi}", flush=True)
        del module, ts, opt
        torch.cuda.empty_cache()
    base = runs["1F1B"]["losses"]
    for name, r_ in runs.items():
        gap = max(abs(a - c) / abs(c) for a, c in zip(r_["losses"], base))
        r_["rel_gap_to_1f1b"] = gap
        if not gap <= 2e-4:
            raise AssertionError(f"pipeline {name} losses {r_['losses']} "
                                 f"against 1F1B {base}")
    print(json.dumps({"pipeline": {
        "model": "llama2_7b width, 4 layers, untied, random bf16 weights "
                 "(seed 0), master_only", "batch": b, "seq": s,
        "accumulate_steps": n_micro, "pp": 1, "backend": "nccl",
        "device": smi, **runs}}), flush=True)
    return runs


def leave_process_group():
    """Leave the NCCL group the checkpoint and pipeline phases joined."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import topology

    if dist.is_initialized():
        topology.set_hybrid_communicate_group(None)
        dist.destroy_process_group()


DIST_TIMEOUT = 600


def dist_collectives_check(device):
    """Every collective of ``distributed/collective.py`` over the whole
    job on ``device`` tensors, each result checked against what the ranks
    hold; ``comm_log()`` must record each op. Returns the ops logged."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import stream
    from paddle_tpu_torch.observability import comm

    n, r = D.get_world_size(), D.get_rank()
    prev = flags.flag("telemetry")
    flags.set_flags({"telemetry": True})
    comm.reset_comm_log()

    def ints(*shape, base=0.0):
        return (torch.arange(int(np.prod(shape)), dtype=torch.float32,
                             device=device).reshape(shape) + base)

    def check(name, got, want):
        if not torch.equal(got.float().cpu(), torch.as_tensor(
                want, dtype=torch.float32).cpu()):
            raise AssertionError(f"{name}: got {got}, want {want}")

    every = torch.stack([ints(6, base=10.0 * k) for k in range(n)])
    try:
        check("all_reduce sum", D.all_reduce(ints(6, base=10.0 * r)),
              every.sum(0))
        for op, want in (("max", every.amax(0)), ("min", every.amin(0)),
                         ("avg", every.mean(0)), ("prod", every.prod(0))):
            check(f"all_reduce {op}", D.all_reduce(
                ints(6, base=10.0 * r), op=op), want)
        check("all_gather", D.all_gather(ints(6, base=10.0 * r)),
              every.reshape(-1))
        gl = D.all_gather([], ints(6, base=10.0 * r))
        check("all_gather list", torch.stack(gl), every)
        rs = torch.stack([ints(n, 3, base=10.0 * k) for k in range(n)])
        check("reduce_scatter", D.reduce_scatter(ints(n, 3, base=10.0 * r)),
              rs.sum(0)[r:r + 1])
        a2a = torch.stack([ints(n, 2, base=100.0 * k) for k in range(n)])
        check("alltoall", D.alltoall(ints(n, 2, base=100.0 * r)),
              a2a[:, r].reshape(-1, 2))
        check("alltoall_single", D.alltoall_single(
            ints(n, 2, base=100.0 * r)), a2a[:, r].reshape(-1, 2))
        sizes = [[(i + j) % 3 + 1 for j in range(n)] for i in range(n)]
        local = ints(sum(sizes[r]), base=1000.0 * r)
        got = D.alltoall_single(local, in_split_sizes=sizes)
        want = []
        for src in range(n):
            off = sum(sizes[src][:r])
            want += [1000.0 * src + off + i for i in range(sizes[src][r])]
        check("alltoall_single ragged", got, want)
        check("broadcast", D.broadcast(ints(6, base=10.0 * r), src=0),
              every[0])
        red = D.reduce(ints(6, base=10.0 * r), dst=0)
        check("reduce", red, every.sum(0) if r == 0 else every[r])
        pieces = [ints(3, base=7.0 * k) for k in range(n)]
        check("scatter", D.scatter(None, pieces, src=0), pieces[r])
        check("gather", torch.stack(D.gather(ints(6, base=10.0 * r))),
              every)
        recv = torch.zeros(6, device=device)
        tasks = D.batch_isend_irecv([
            D.P2POp(D.isend, ints(6, base=10.0 * r), (r + 1) % n),
            D.P2POp(D.irecv, recv, (r - 1) % n)])
        for t in tasks:
            t.wait()
        check("batch_isend_irecv", D.wait(recv), every[(r - 1) % n])
        check("stream all_reduce", stream.all_reduce(
            ints(6, base=10.0 * r), sync_op=False).wait(), every.sum(0))
        D.barrier()
        objs = D.all_gather_object([], {"rank": r})
        box = [f"from {r}"]
        D.broadcast_object_list(box, src=0)
        if objs != [{"rank": k} for k in range(n)] or box != ["from 0"]:
            raise AssertionError(f"object collectives: {objs}, {box}")
        ops = sorted({e["op"] for e in comm.comm_log()})
    finally:
        flags.set_flags({"telemetry": prev})
        comm.reset_comm_log()
    want_ops = {"all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                "alltoall_single", "broadcast", "reduce", "scatter",
                "gather", "send", "recv"}
    if not want_ops <= set(ops):
        raise AssertionError(f"comm_log recorded {ops}")
    return ops


def dist_train_run(mesh, strategy, cfg, batch, steps, residency, device):
    """``steps`` AdamW steps of the seed-0 Llama of ``cfg`` through
    ``TrainStep(model, opt, mesh, strategy)``: losses, step ms (CUDA
    events on the card), peak GB and the flash launches."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    model = LlamaForCausalLM(cfg, device=device, seed=0)
    opt = topt.AdamW(learning_rate=3e-4, weight_decay=0.01,
                     multi_precision=True,
                     grad_clip=topt.ClipGradByGlobalNorm(1.0))
    ts = TrainStep(model, opt, mesh, strategy, master_residency=residency)
    card = device == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(steps):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = ts.run(batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            loss = ts.run(batch)
        losses.append(float(loss))
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9 if card else None
    del ts, model, opt
    if card:
        torch.cuda.empty_cache()
    return losses, step_ms, peak, counts


def dist_train_7b():
    """Llama-2-7B width at 4 layers (``train_7b_config``), 3 AdamW steps
    through ``TrainStep(mesh=build_mesh(), strategy)`` at ZeRO stage 3
    (degree 1) and 3 through the meshless step from the same weights and
    batch: the losses within ``same_losses``'s 1e-4, rows 6 and 8 once
    per layer a step on the mesh path. With one rank on every axis no
    gather, reduce-scatter or tp collective runs: the arm times the mesh
    step's own code, not ZeRO-3's communication."""
    from paddle_tpu_torch import distributed as D

    cfg = train_7b_config()
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    strategy = D.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs.stage = 3
    runs = {}
    for label, mesh, strat in (("mesh_zero3", D.build_mesh(), strategy),
                               ("meshless", None, None)):
        losses, ms, peak, counts = dist_train_run(
            mesh, strat, cfg, batch, 3, "master_only", "cuda")
        timed = float(np.median(ms[1:]))
        runs[label] = {"losses": losses, "step_ms": ms,
                       "step_ms_median_2_3": timed,
                       "tokens_per_s": b * s / (timed / 1e3),
                       "peak_memory_gb": peak}
        if label == "mesh_zero3":
            want = train_launches_want(3, cfg.num_hidden_layers)
            got = {k: counts[k] for k in want}
            if got != want:
                raise AssertionError(f"mesh step launches {got}, want {want}")
            runs[label]["launches"] = got
    gap = same_losses("distributed 7b", runs["mesh_zero3"]["losses"],
                      runs["meshless"]["losses"])
    return {"model": "llama2_7b width, 4 layers, random bf16 weights "
                     "(seed 0), master_only", "batch": b, "seq": s,
            "world_size": D.get_world_size(), "backend": "nccl",
            "loss_rel_gap": gap, **runs}


def dist_train_host_dp2():
    """gloo, 2 ranks on the host: a tiny float32 Llama 3 steps at dp = 2
    over the global batch (ignored labels on rank 0's rows only) against
    the meshless step on each rank; the losses within 1e-5."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny()
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    labels = ids.copy()
    labels[0, 4:20] = -100
    batch = {"input_ids": ids, "labels": labels}
    strategy = D.DistributedStrategy()
    strategy.hybrid_configs.dp_degree = 2
    mesh_l = dist_train_run(D.build_mesh(dp=2), strategy, cfg, batch, 3,
                            "paired", "cpu")[0]
    plain_l = dist_train_run(None, None, cfg, batch, 3, "paired", "cpu")[0]
    gap = max(abs(a - b) / abs(b) for a, b in zip(mesh_l, plain_l))
    if not gap <= 1e-5:
        raise AssertionError(f"dp2 losses {mesh_l}, meshless {plain_l}")
    return {"backend": "gloo", "world_size": D.get_world_size(),
            "losses_dp2": mesh_l, "losses_meshless": plain_l,
            "loss_rel_gap": gap}


def dist_host_pipeline():
    """gloo, 2 ranks on the host: the tiny Llama's pipeline module (4
    layers, untied, float32) 3 AdamW steps of ``PipelineTrainStep`` at
    pp = 2 under 1F1B (2 micro-batches) against the same module's
    meshless ``PipelineTrainStep`` on each rank: the losses within 1e-5
    relative, the gathered parameters within 1e-4 (atol 1e-6)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import LlamaConfig, llama_pipeline_module
    from paddle_tpu_torch.nn import functional as F

    cfg = LlamaConfig.tiny(num_hidden_layers=4)
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))

    def loss_fn(logits, lab):
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               lab.reshape(-1))

    strategy = D.DistributedStrategy()
    strategy.pipeline_configs.schedule_mode = "1F1B"
    strategy.pipeline_configs.accumulate_steps = 2
    out = {}
    for label, mesh in (("pp2", D.build_mesh(pp=2)), ("meshless", None)):
        ts = D.PipelineTrainStep(
            llama_pipeline_module(cfg, 2, device="cpu", seed=0),
            topt.AdamW(learning_rate=1e-3, epsilon=1e-6), mesh, strategy,
            loss_fn)
        losses = [float(ts.run(ids, labels)) for _ in range(3)]
        out[label] = (losses, ts.state_dict()["params"])
    (got, gp), (want, wp) = out["pp2"], out["meshless"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    for n, w in wp.items():
        if not torch.allclose(gp[n], w, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"pp2 parameter {n} differs")
    if not gap <= 1e-5:
        raise AssertionError(f"pp2 losses {got}, meshless {want}")
    return {"losses_pp2": got, "losses_meshless": want,
            "loss_rel_gap": gap}


def dist_host_sep(mode):
    """gloo, 2 ranks: the tiny Llama 3 AdamW steps at sep = 2 (``mode``:
    ring or Ulysses attention; the sequence cut over the ranks, the
    labels shifted before the cut, -100 on the chunk boundary) against
    the meshless step: the losses within 1e-5 relative."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny(sep_attention=mode)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    labels = ids.copy()
    labels[0, 15:17] = -100
    batch = {"input_ids": ids, "labels": labels}
    strategy = D.DistributedStrategy()
    strategy.hybrid_configs.sep_degree = 2
    mesh_l = dist_train_run(D.build_mesh(sep=2), strategy, cfg, batch, 3,
                            "paired", "cpu")[0]
    plain_l = dist_train_run(None, None, cfg, batch, 3, "paired", "cpu")[0]
    gap = max(abs(a - b) / abs(b) for a, b in zip(mesh_l, plain_l))
    if not gap <= 1e-5:
        raise AssertionError(f"sep2 {mode} losses {mesh_l}, meshless "
                             f"{plain_l}")
    return {"losses_sep2": mesh_l, "losses_meshless": plain_l,
            "loss_rel_gap": gap}


def dist_host_ep():
    """gloo, 2 ranks: a dropless MoE layer (4 experts, top 2) over ep = 2,
    forward and backward of ``sum(y**2) + aux``, against the meshless
    layer from the same weights: y and aux within 1e-5, every gradient
    (the experts' gathered from their ranks) within 1e-4."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.distributed import sharding as shd

    def build():
        return moe.DroplessMoELayer(16, 4, d_hidden=32, top_k=2,
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(
                                        4))

    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 8, 16)).astype(np.float32))
    ref = build()
    y_ref, aux_ref = ref(x)
    ((y_ref ** 2).sum() + aux_ref).backward()
    layer = build()
    mesh = D.build_mesh(ep=2)
    D.place_params_on_mesh(layer, mesh, D.DistributedStrategy())
    with shd.mesh_context(mesh):
        y, aux = layer(x)
    ((y ** 2).sum() + aux).backward()
    err = {"y": (y - y_ref).abs().max().item(),
           "aux": abs(aux.item() - aux_ref.item())}
    for n, p in layer.named_parameters():
        g = shd.gather_full(p.grad.contiguous(), p.placement,
                            p.global_shape, mesh)
        want = dict(ref.named_parameters())[n].grad
        err[n] = ((g - want).abs().max() / want.abs().max()).item()
    if err["y"] > 1e-5 or err["aux"] > 1e-5 or any(
            e > 1e-4 for k, e in err.items() if k not in ("y", "aux")):
        raise AssertionError(f"ep2 errors {err}")
    return {"max_errors": err,
            "local_w1": list(layer.experts.w1.shape)}


def dist_host_checkpoint():
    """gloo, 2 ranks: the tiny Llama 2 steps at dp = 2, its state saved
    block by block (``state_dict(sharded=True)``), 2 more steps; a step at
    fsdp = 2 (ZeRO-3) loads the checkpoint (each rank its blocks) and its
    2 steps match: losses within 1e-5 relative."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep

    cfg = LlamaConfig.tiny()
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 16))
    batch = {"input_ids": ids, "labels": ids}
    box = [tempfile.mkdtemp(prefix="pt_ckpt_") if D.get_rank() == 0
           else None]
    D.broadcast_object_list(box, src=0)
    path = os.path.join(box[0], "step_2")

    def step(mesh, strategy):
        model = LlamaForCausalLM(cfg, device="cpu", seed=0)
        return TrainStep(model, topt.AdamW(learning_rate=1e-3,
                                           epsilon=1e-6), mesh, strategy)

    try:
        s_dp = D.DistributedStrategy()
        s_dp.hybrid_configs.dp_degree = 2
        ts = step(D.build_mesh(dp=2), s_dp)
        for _ in range(2):
            ts.run(batch)
        ckpt.save_state_dict(ts.state_dict(sharded=True), path)
        want = [float(ts.run(batch)) for _ in range(2)]
        s_f = D.DistributedStrategy()
        s_f.hybrid_configs.sharding_degree = 2
        s_f.sharding = True
        s_f.sharding_configs.stage = 3
        ts2 = step(D.build_mesh(fsdp=2), s_f)
        ts2.set_state_dict(ckpt.load_state_dict(
            path, shardings=ts2.state_shardings()))
        got = [float(ts2.run(batch)) for _ in range(2)]
        files = len(os.listdir(path))
    finally:
        D.barrier()
        if D.get_rank() == 0:
            shutil.rmtree(box[0], ignore_errors=True)
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if not gap <= 1e-5:
        raise AssertionError(f"fsdp2 resumed {got}, dp2 went on {want}")
    return {"losses_dp2_steps_3_4": want, "losses_fsdp2_resumed": got,
            "loss_rel_gap": gap, "files": files}


def dist_worker(backend: str) -> int:
    """One rank under ``python -m paddle_tpu_torch.distributed.launch``:
    joins the group (``init_parallel_env``), checks every collective and
    trains (NCCL: the 7B step on the card; gloo: the host checks at dp 2,
    pp 2, sep 2 with ring and with Ulysses attention, ep 2, and a
    checkpoint saved at dp 2 and loaded at fsdp 2), printing its figures
    as JSON lines."""
    from paddle_tpu_torch import distributed as D

    D.init_parallel_env(backend=backend, timeout=300)
    device = "cuda" if backend == "nccl" else "cpu"
    if device == "cuda":
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build()
        print(nvidia_smi_line(), flush=True)
    ops = dist_collectives_check(device)
    print(f"collectives ok over {backend} at world size "
          f"{D.get_world_size()}, rank {D.get_rank()}: {ops}", flush=True)
    if device == "cuda":
        out = dist_train_7b()
    else:
        out = {"dp2": dist_train_host_dp2(), "pp2": dist_host_pipeline(),
               "sep2_ring": dist_host_sep("ring"),
               "sep2_ulysses": dist_host_sep("ulysses"),
               "ep2_dropless_moe": dist_host_ep(),
               "checkpoint_dp2_to_fsdp2": dist_host_checkpoint()}
    print(json.dumps({f"distributed_{backend}": out}), flush=True)
    if device == "cuda":
        print(nvidia_smi_line(), flush=True)
    D.destroy_process_group()
    print("dist worker ok", flush=True)
    return 0


def distributed_phase():
    """The launcher: ``--nproc_per_node 1`` over NCCL on the card (every
    collective, then the 7B step over a mesh at ZeRO-3 against the
    meshless step), then ``--nproc_per_node 2`` over gloo on the host
    (``dist_worker``'s host checks against the meshless results). Each
    run's exit code must be 0 and each worker's log must end its run;
    the logs are printed. A run past
    ``DIST_TIMEOUT`` s is killed with every process it started."""
    import os
    import shutil
    import signal
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="pt_dist_")
    try:
        for backend, nproc in (("nccl", 1), ("gloo", 2)):
            log_dir = os.path.join(root, backend)
            cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                   "--nproc_per_node", str(nproc), "--log_dir", log_dir,
                   "--poll_interval", "0.5", os.path.join(here,
                                                          "chip_smoke.py"),
                   "--dist-worker", backend]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            try:
                out, _ = proc.communicate(timeout=DIST_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise
            wall = time.perf_counter() - t0
            print(f"launch {backend} x{nproc}: exit {proc.returncode} in "
                  f"{wall:.1f} s; {out.strip()}", flush=True)
            logs = []
            for rank in range(nproc):
                with open(os.path.join(log_dir, f"workerlog.{rank}")) as f:
                    logs.append(f.read())
                for line in logs[-1].splitlines():
                    print(f"dist {backend} rank {rank}: {line}", flush=True)
            if proc.returncode != 0 or any(
                    "dist worker ok" not in log for log in logs):
                raise AssertionError(f"launch {backend}: exit "
                                     f"{proc.returncode}")
            if backend == "gloo":
                print("distributed host checks (gloo, 2 ranks on the CPU: "
                      "dp 2, pp 2, sep 2 ring and Ulysses, ep 2, a "
                      "checkpoint from dp 2 to fsdp 2): ok", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the paddle namespace's high-level path: Model.fit at the 7B width
# ---------------------------------------------------------------------------
HAPI_WARMUP, HAPI_TIMED = 2, 5
HAPI_LOSS_TOL = 1e-3    # Model.fit against TrainStep, relative, per step
HAPI_OWN_TOL = 1e-3     # the first step's loss against the model's own


def hapi_lm_loss(logits, labels):
    """The next-token loss of the Llama's own ``forward(labels=)``, as a
    ``Model.prepare`` loss of (logits, labels)."""
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits[:, :-1], labels[:, 1:], ignore_index=-100)


def hapi_build(layers, seed):
    """The seed's Llama-2-7B-width model at ``layers`` layers on the card
    through ``amp.decorate`` at O2 with the JAX ``Model``'s optimizer
    (AdamW lr 3e-4, weight decay 0.01, no clip): float32 masters. The
    optimizer notes the host time its update was enqueued by."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import LlamaForCausalLM

    class TimedAdamW(paddle.optimizer.AdamW):
        t_update = 0.0

        def update(self, *args, **kw):
            out = super().update(*args, **kw)
            self.t_update = time.perf_counter()
            return out

    cfg = dataclasses.replace(train_7b_config(), num_hidden_layers=layers)
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    opt = TimedAdamW(learning_rate=3e-4, weight_decay=0.01)
    return paddle.amp.decorate(model, opt, level="O2", dtype="bfloat16")


def hapi_timer(opt, warmup):
    """A callback timing each train batch: CUDA events from its begin to
    its end (``fit`` copies the batch to the card after the begin and
    reads the loss to the host before the end), the host
    clock, and the share of the step the host spent waiting for the card
    (from the end of the optimizer's enqueue to the end of the step); the
    peak memory from the first timed step on."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepTimer(Callback):
        def __init__(self):
            self.losses, self.ms, self.wall_ms, self.host_idle = \
                [], [], [], []

        def on_train_batch_begin(self, step, logs=None):
            if step == warmup:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

        def on_train_batch_end(self, step, logs=None):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            t1 = time.perf_counter()
            end.synchronize()
            self.losses.append(logs["loss"])
            if step >= warmup:
                self.ms.append(self.start.elapsed_time(end))
                self.wall_ms.append((t1 - self.t0) * 1e3)
                self.host_idle.append((t1 - opt.t_update) / (t1 - self.t0))

    return StepTimer()


def hapi_phase(train_7b):
    """The paddle namespace's high-level path at the Llama-2-7B width, 4
    layers (``train_7b_config``), bf16 through ``amp.decorate`` (O2,
    float32 masters), with ``import paddle_tpu_torch as paddle``:

    1. ``paddle.Model(model).prepare(AdamW, loss).fit`` over a
       ``DataLoader(TensorDataset([ids, labels]), batch_size=4,
       shuffle=True, num_workers=2)`` of 7 seeded batches of 4 x 2048,
       one epoch: 2 warm-up and 5 timed steps, rows 6 and 8 once per
       layer a step and no other flash row; the first loss equals the
       model's own loss on that batch (within ``HAPI_OWN_TOL``);
    2. a ``TrainStep`` from the same weights with the same optimizer (no
       clip, as in the JAX ``Model``), the same loss and the same batches
       in the loader's order: the losses agree within ``HAPI_LOSS_TOL``
       relative (the same kernels in the same order: identical unless the
       float32 atomics of a backward sum in another order; which one is
       printed); its timed steps beside fit's and beside
       ``train_7b_phase``'s clipped master-only step;
    3. ``evaluate`` and ``predict`` on 2 batches: row 5 once per layer a
       batch and no other; finite logits of [8, 2048, 32000];
    4. rows 5, 6 and 8 against their plain versions at this path's shape
       (``fa_check``);
    5. ``summary`` and ``flops`` at full width on the ``meta`` device:
       the parameter count and 2 x tokens x matmul weights;
    6. ``prefetch_to_device`` over the same loader equals synchronous
       copies, batch for batch, each read as soon as it is handed out;
    7. ``Model.save`` of a 2-layer model after one step, ``Model.load``
       into a fresh 2-layer model of another seed: the same ``evaluate``
       loss and optimizer step. Two layers keep the pickle (bf16 weights,
       float32 masters and moments) near 9 GB; the directory is removed
       after.
    Returns the phase's figures."""
    import os
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.trainer import TrainStep

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    cfg = train_7b_config()
    layers = cfg.num_hidden_layers
    smi = nvidia_smi_line()
    n_batches = HAPI_WARMUP + HAPI_TIMED
    # seeded tokens of the first 1024 ids: a unigram the steps can learn,
    # so the loss falls over distinct batches
    ids = np.random.default_rng(24).integers(
        0, 1024, (n_batches * b, s)).astype(np.int64)
    loader = paddle.io.DataLoader(paddle.io.TensorDataset([ids, ids]),
                                  batch_size=b, shuffle=True, num_workers=2)
    loader.batch_sampler.set_epoch(0)  # fit's first epoch
    order = list(loader.batch_sampler)

    # 1. Model.fit
    model, opt = hapi_build(layers, 0)
    first = torch.from_numpy(ids[order[0]]).cuda()
    with torch.no_grad():
        own = float(model(input_ids=first, labels=first))
    del first
    hm = paddle.Model(model).prepare(opt, hapi_lm_loss)
    timer = hapi_timer(opt, HAPI_WARMUP)
    reset_launches()
    t0 = time.perf_counter()
    hm.fit(loader, epochs=1, verbose=0, callbacks=[timer])
    fit_s = time.perf_counter() - t0
    fit_counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = train_launches_want(n_batches, layers)
    if {n: fit_counts[n] for n in want} != want:
        raise AssertionError(f"hapi fit launches {fit_counts}, want {want}")
    losses = timer.losses
    if len(losses) != n_batches or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"hapi fit losses {losses}")
    own_gap = abs(losses[0] - own) / abs(own)
    if not own_gap <= HAPI_OWN_TOL:
        raise AssertionError(f"hapi fit: first loss {losses[0]} against the "
                             f"model's own {own} (rel {own_gap})")

    # 3. evaluate and predict on 2 batches
    two = ids[:2 * b]
    reset_launches()
    ev = hm.evaluate(paddle.io.TensorDataset([two, two]), batch_size=b,
                     verbose=0)["loss"]
    eval_counts = read_launches()
    reset_launches()
    pred = hm.predict(paddle.io.TensorDataset([two]), batch_size=b)
    pred_counts = read_launches()
    row5 = {"flash_attention_fwd": 2 * layers, "flash_attention_fwd_lse": 0,
            "flash_attention_bwd_fused": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    for label, c in (("evaluate", eval_counts), ("predict", pred_counts)):
        if {n: c[n] for n in row5} != row5:
            raise AssertionError(f"hapi {label} launches {c}, want {row5}")
    if pred.shape != (2 * b, s, cfg.vocab_size) or not math.isfinite(ev) \
            or not np.isfinite(pred).all():
        raise AssertionError(f"hapi predict {pred.shape}, evaluate {ev}")
    del pred

    # 5. summary and flops on meta, at full width
    t0 = time.perf_counter()
    info = paddle.summary(model, (b, s), dtypes="int64")
    fl = paddle.flops(model, (b, s), dtypes="int64")
    meta_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    _, n_matmul = train_flops(cfg, b, s)
    if info != {"total_params": n_params, "trainable_params": n_params} \
            or fl != 2 * b * s * n_matmul:
        raise AssertionError(f"hapi summary {info}, flops {fl}; want "
                             f"{n_params} parameters, "
                             f"{2 * b * s * n_matmul} FLOPs")
    del hm, model, opt
    torch.cuda.empty_cache()

    # 2. TrainStep from the same weights over the same batches
    model, opt = hapi_build(layers, 0)
    ts = TrainStep(model, opt, loss_fn=hapi_lm_loss)
    ts_losses, ts_ms = [], []
    for i, idx in enumerate(order):
        x = torch.from_numpy(ids[idx]).cuda()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = float(ts.run({"input": x, "label": x}))
        end.record()
        end.synchronize()
        ts_losses.append(loss)
        if i >= HAPI_WARMUP:
            ts_ms.append(start.elapsed_time(end))
    gap = max(abs(a - c) / abs(c) for a, c in zip(losses, ts_losses))
    identical = losses == ts_losses
    if not gap <= HAPI_LOSS_TOL:
        raise AssertionError(f"hapi fit losses {losses} against TrainStep "
                             f"{ts_losses} (rel gap {gap})")
    ts.sync_to_model()
    with torch.no_grad():
        ts_ev = float(np.mean([float(hapi_lm_loss(model(x), x)) for x in (
            torch.from_numpy(two[i * b:(i + 1) * b]).cuda()
            for i in range(2))]))
    if not abs(ts_ev - ev) <= HAPI_LOSS_TOL * abs(ev):
        raise AssertionError(f"hapi evaluate {ev} against the TrainStep "
                             f"model's {ts_ev}")
    del ts, model, opt
    torch.cuda.empty_cache()

    # 4. rows 5, 6 and 8 against their plain versions at this shape
    errs = fa_check("hapi path", b, s, cfg.num_attention_heads,
                    cfg.num_key_value_heads, cfg.head_dim, torch.bfloat16,
                    seed=24)

    # 6. prefetch_to_device against synchronous copies
    loader.batch_sampler.set_epoch(0)
    sync = [[torch.from_numpy(a).cuda() for a in batch] for batch in loader]
    loader.batch_sampler.set_epoch(0)
    n_pref = 0
    for got, want_b in zip(paddle.io.prefetch_to_device(iter(loader)), sync):
        if not all(torch.equal(g, w) for g, w in zip(got, want_b)):
            raise AssertionError(f"prefetch_to_device batch {n_pref} "
                                 "differs from its synchronous copy")
        torch.cuda._sleep(2_000_000)  # a consumer slower than the copies
        n_pref += 1
    if n_pref != len(sync):
        raise AssertionError(f"prefetch_to_device gave {n_pref} of "
                             f"{len(sync)} batches")
    del sync

    # 7. save and load at 2 layers
    m2, o2 = hapi_build(2, 0)
    hm2 = paddle.Model(m2).prepare(o2, hapi_lm_loss)
    hm2.fit(paddle.io.TensorDataset([ids[:b], ids[:b]]), batch_size=b,
            verbose=0)
    ev_ds = paddle.io.TensorDataset([two, two])
    ev_a = hm2.evaluate(ev_ds, batch_size=b, verbose=0)["loss"]
    root = tempfile.mkdtemp(prefix="pt_hapi_")
    path = os.path.join(root, "llama")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hm2.save(path)
        save_s = time.perf_counter() - t0
        file_gb = sum(os.path.getsize(path + ext)
                      for ext in (".pdparams", ".pdopt")) / 1e9
        del hm2, m2, o2
        torch.cuda.empty_cache()
        m3, o3 = hapi_build(2, 1)
        hm3 = paddle.Model(m3).prepare(o3, hapi_lm_loss)
        t0 = time.perf_counter()
        hm3.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ev_b = hm3.evaluate(ev_ds, batch_size=b, verbose=0)["loss"]
        steps_b = int(hm3._opt_state["step"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not abs(ev_b - ev_a) <= 1e-6 * abs(ev_a) or steps_b != 1:
        raise AssertionError(f"hapi save/load: evaluate {ev_b} against "
                             f"{ev_a}, optimizer step {steps_b}")
    del hm3, m3, o3
    torch.cuda.empty_cache()

    med = float(np.median(timer.ms))
    ts_med = float(np.median(ts_ms))
    out = {"model": "llama2_7b width, 4 layers, random bf16 weights (seed "
                    "0), amp.decorate O2 (float32 masters), AdamW no clip",
           "batch": b, "seq": s, "losses": losses,
           "trainstep_losses": ts_losses, "identical": identical,
           "rel_gap": gap, "own_loss": own, "step_ms": timer.ms,
           "step_ms_median": med, "wall_ms": timer.wall_ms,
           "tokens_per_s": b * s / (med / 1e3), "peak_memory_gb": peak_gb,
           "host_idle_share": float(np.median(timer.host_idle)),
           "trainstep_step_ms": ts_ms, "trainstep_step_ms_median": ts_med,
           "train_7b_step_ms_median": train_7b["step_ms_median"],
           "fit_s": fit_s, "launches": {
               "fit": {n: fit_counts[n] for n in FLASH_TRAIN_ROWS},
               "evaluate": row5, "predict": row5},
           "evaluate_loss": ev, "trainstep_evaluate_loss": ts_ev,
           "kernel_max_abs_err": errs, "summary": info, "flops": fl,
           "meta_pass_s": meta_s, "prefetched_batches": n_pref,
           "save_s": save_s, "load_s": load_s, "file_gb": file_gb,
           "reloaded_evaluate_loss": ev_b, "device": smi}
    print(f"hapi: Model.fit (amp O2, AdamW no clip) 5 timed steps "
          f"{[round(x, 3) for x in timer.ms]} ms (median {med:.3f} ms, "
          f"CUDA events from on_train_batch_begin to on_train_batch_end), "
          f"{b * s / (med / 1e3):.1f} tokens/s, peak {peak_gb:.2f} GB, host "
          f"idle share {out['host_idle_share']:.3f}; TrainStep on the same "
          f"batches {[round(x, 3) for x in ts_ms]} ms (median "
          f"{ts_med:.3f} ms); train_7b_phase's clipped master-only step "
          f"median {train_7b['step_ms_median']:.3f} ms; losses "
          f"{'identical to' if identical else f'within {gap:.2e} of'} "
          f"TrainStep's {ts_losses}; first loss {losses[0]:.6f} against "
          f"the model's own {own:.6f}; evaluate {ev:.6f} (TrainStep's "
          f"model {ts_ev:.6f}); save {save_s:.2f} s, load {load_s:.2f} s "
          f"of {file_gb:.2f} GB at 2 layers, reloaded evaluate {ev_b:.6f} "
          f"against {ev_a:.6f}; summary {info}, flops {fl} on meta in "
          f"{meta_s:.2f} s; prefetch {n_pref} batches equal; {smi}",
          flush=True)
    print(json.dumps({"hapi": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 61-66: the kernel entries as torch.library ops, jit save/load on
# torch.export, the abstract step's memory plan, the profiler, and the
# vision, linalg, distribution and sparse surfaces
# ---------------------------------------------------------------------------
OPCHECK_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def kernel_ops_phase():
    """``torch.library.opcheck`` of every ``paddle_tpu::*`` op on the card
    at every dtype its library is built for (``kernels/op_samples.py``):
    the schema and its mutations, the fake against the kernel's outputs
    (shapes, dtypes, strides), a dynamic-shape trace. Launches made here
    are comparisons, not the main path's."""
    from paddle_tpu_torch.kernels import _ops, op_samples

    done = {}
    t0 = time.perf_counter()
    for name, args in op_samples.samples("cuda", OPCHECK_DTYPES):
        res = torch.library.opcheck(_ops.OPS[name][1], args)
        bad = {k: v for k, v in res.items() if v != "SUCCESS"}
        tags = sorted({str(a.dtype).split(".")[1] for a in args
                       if isinstance(a, torch.Tensor)
                       and (a.is_floating_point() or a.dtype == torch.int8)
                       and a.dim() > 1})
        if bad:
            raise AssertionError(f"opcheck {name} {tags}: {bad}")
        done.setdefault(name, []).append("/".join(tags))
    missing = set(_ops.OPS) - set(done)
    if missing:
        raise AssertionError(f"ops never checked: {sorted(missing)}")
    out = {name: {"row": _ops.OPS[name][0], "opcheck": "passed",
                  "cases": cases} for name, cases in sorted(done.items())}
    print(f"kernel ops: opcheck passed for all {len(out)} ops of rows 1-13 "
          f"in {sum(len(c) for c in done.values())} cases, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernel_ops": out}), flush=True)


def events_ms(fn, runs=3):
    """Median of ``runs`` CUDA-event timings of ``fn()``."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def jit_check(label, model, spec, calls, op, launch_key, per_call, tol,
              workdir):
    """Export ``model`` for ``spec``, save it, load it; per call in
    ``calls`` (argument tuples) the loaded output against the eager
    ``no_grad`` forward (bitwise, or within ``tol`` of the eager output's
    largest magnitude) and exactly ``per_call`` launches of
    ``launch_key``; the graph holds ``per_call`` ``op`` nodes."""
    from paddle_tpu_torch import jit

    path = str(workdir / label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program, meta = jit.export_program(model, spec)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jit.write_program(program, meta, path)
    save_s = time.perf_counter() - t0
    size_gb = (workdir / f"{label}.pdmodel").stat().st_size / 1e9
    del program
    t0 = time.perf_counter()
    loaded = jit.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nodes = loaded.op_counts()[f"paddle_tpu.{op}.default"]
    if nodes != per_call or loaded.meta["device_type"] != "cuda":
        raise AssertionError(f"jit {label}: {nodes} {op} nodes, want "
                             f"{per_call}; meta {loaded.meta}")
    rows = []
    for args in calls:
        with torch.no_grad():
            eager = model(*args)
            reset_launches()
            got = loaded(*args)
            torch.cuda.synchronize()
            n = read_launches()[launch_key]
            eager_ms = events_ms(lambda: model(*args))
            loaded_ms = events_ms(lambda: loaded(*args))
        if n != per_call:
            raise AssertionError(f"jit {label}: {n} launches of "
                                 f"{launch_key} a call, want {per_call}")
        bitwise = bool(torch.equal(got, eager))
        err = float((got.float() - eager.float()).abs().max())
        scale = float(eager.float().abs().max())
        if not (bitwise or err <= tol * scale) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"jit {label}: loaded differs from eager by "
                                 f"{err} (scale {scale}, tol {tol})")
        rows.append({"batch": int(args[0].shape[0]), "bitwise": bitwise,
                     "max_abs_err": err, "eager_ms": eager_ms,
                     "loaded_ms": loaded_ms, "launches": n})
    (workdir / f"{label}.pdmodel").unlink()
    del loaded
    torch.cuda.empty_cache()
    out = {"export_s": export_s, "save_s": save_s, "load_s": load_s,
           "file_gb": size_gb, "nodes": nodes, "calls": rows}
    print(f"jit {label}: export {export_s:.2f} s, save {save_s:.2f} s "
          f"({size_gb:.3f} GB), load {load_s:.2f} s; {nodes} {op} nodes; "
          + "; ".join(f"b {r['batch']}: eager {r['eager_ms']:.2f} ms, "
                      f"loaded {r['loaded_ms']:.2f} ms, "
                      f"{'bitwise equal' if r['bitwise'] else 'max err ' + format(r['max_abs_err'], '.3g')}, "
                      f"{r['launches']} launches" for r in rows)
          + f"; {nvidia_smi_line()}", flush=True)
    return out


def jit_7b_phase():
    """``jit.save``/``jit.load`` on the card (the programs hold the kernel
    ops): ``train_7b_config()`` (Llama-2-7B width, 4 layers, bf16) in eval
    with ``InputSpec([None, 2048], "int64")`` called at b 1 and 4 (row 5
    four times a call); the int8 weight-only Llama at those widths and 2
    layers (row 4: 7 a layer and the head, 15 a call); Mamba-130m at b 4 x
    1024 (row 10 without states, 24 a call); the SD-UNet at sample 32, b
    4, bf16 channels-last (row 12, 56 a call). The loaded outputs against
    the eager ones (the same kernels: bitwise, or bf16's 2e-2 / float32's
    1e-5 of the largest magnitude where the exported graph orders an
    operation otherwise)."""
    from pathlib import Path

    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import (LlamaForCausalLM, MambaConfig,
                                         MambaForCausalLM,
                                         UNet2DConditionModel, UNetConfig,
                                         unet_gn_sites)
    from paddle_tpu_torch.quantization import quantize_model_weight_only

    workdir = Path(__file__).resolve().parent / "build" / "jit_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    s = TRAIN_SHAPE["s"]
    rng = np.random.default_rng(0)
    out = {"card": nvidia_smi_line()}
    cfg = train_7b_config()

    def ids(b, vocab, n=s):
        return (torch.as_tensor(rng.integers(0, vocab, (b, n)),
                                device="cuda"),)

    model = LlamaForCausalLM(cfg, device="cuda", seed=0).eval()
    out["llama_7b_4l"] = jit_check(
        "llama_7b_4l", model, [static.InputSpec([None, s], "int64")],
        [ids(1, cfg.vocab_size), ids(4, cfg.vocab_size)], "flash_forward",
        "flash_attention_fwd", cfg.num_hidden_layers, 2e-2, workdir)
    del model
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    model = quantize_model_weight_only(
        LlamaForCausalLM(cfg2, device="cuda", seed=0), "int8",
        group_size=128).eval()
    out["llama_7b_2l_int8w"] = jit_check(
        "llama_7b_2l_int8w", model, [static.InputSpec([None, s], "int64")],
        [ids(1, cfg.vocab_size), ids(4, cfg.vocab_size)],
        "weight_only_matmul", "weight_only_matmul",
        7 * cfg2.num_hidden_layers + 1, 2e-2, workdir)
    del model
    torch.cuda.empty_cache()
    mcfg = MambaConfig(use_chunked_scan=True)
    model = MambaForCausalLM(mcfg, device="cuda", seed=0).eval()
    b, ms = SCAN_SHAPE["b"], SCAN_SHAPE["s"]
    out["mamba_130m"] = jit_check(
        "mamba_130m", model, [static.InputSpec([None, ms], "int64")],
        [ids(b, mcfg.vocab_size, ms)], "selective_scan_fwd",
        "selective_scan_fwd", mcfg.num_hidden_layers, 1e-5, workdir)
    del model
    torch.cuda.empty_cache()
    ucfg = UNetConfig(sample_size=UNET_SIZE)
    unet = UNet2DConditionModel(ucfg, device="cuda", seed=0).to(
        torch.bfloat16).eval()
    x = torch.as_tensor(rng.standard_normal(
        (UNET_BATCH, ucfg.in_channels, UNET_SIZE, UNET_SIZE)),
        device="cuda").to(torch.bfloat16)
    t = torch.as_tensor(rng.integers(0, 1000, (UNET_BATCH,)), device="cuda")
    ctx = torch.as_tensor(rng.standard_normal(
        (UNET_BATCH, 77, ucfg.cross_attention_dim)),
        device="cuda").to(torch.bfloat16)
    out["sd_unet"] = jit_check(
        "sd_unet", unet, [x, t, ctx], [(x, t, ctx)], "group_norm_fwd",
        "group_norm_fwd", len(unet_gn_sites(ucfg, UNET_SIZE)), 2e-2, workdir)
    del unet
    torch.cuda.empty_cache()
    print(json.dumps({"jit_7b": out}), flush=True)
    return out


def abstract_7b_phase():
    """``TrainStep(abstract=True)``: Llama-2-7B at all 32 layers (6.74 B
    parameters) under ``meta_init``, ``master_only`` AdamW, lowered at 4 x
    2048 on the card's fake tensors: the plan printed, and
    ``memory_allocated`` grows by at most 64 MB over it. Then the 4-layer
    step of phase 20: its planned arguments exactly the bytes the real
    step holds, its planned peak (arguments + temp) against
    ``max_memory_allocated`` over 5 real steps, less what was allocated
    before the step was built (within 25%), and the trace
    reaching the fakes of rows 6 and 8 once a layer. Returns the real
    4-layer step and its batch for the profiler phase."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.core.meta import meta_init
    from paddle_tpu_torch.kernels import _ops
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.trainer import TrainStep, memplan

    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    batch = {"input_ids": np.zeros((b, s), np.int64),
             "labels": np.zeros((b, s), np.int64)}

    def plan(layers):
        cfg = dataclasses.replace(train_7b_config(), num_hidden_layers=layers)
        with meta_init():
            model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        n = sum(p.numel() for p in model.parameters())
        ts = TrainStep(model, topt.AdamW(
            learning_rate=3e-4, weight_decay=0.01, multi_precision=True,
            grad_clip=topt.ClipGradByGlobalNorm(1.0)), abstract=True,
            master_residency="master_only")
        before = dict(_ops.FAKE_CALLS)
        t0 = time.perf_counter()
        ma = ts.lower(batch).compile().memory_analysis()
        secs = time.perf_counter() - t0
        fakes = {k: _ops.FAKE_CALLS[k] - before[k] for k in before
                 if _ops.FAKE_CALLS[k] != before[k]}
        return n, ma, fakes, secs

    smi = nvidia_smi_line()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    n32, ma32, fakes32, secs32 = plan(32)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - mem0
    print(f"abstract 7b: Llama-2-7B, 32 layers, {n32} parameters, "
          f"master_only AdamW at {b} x {s}: arguments "
          f"{ma32.argument_size_in_bytes / 1e9:.3f} GB, temp "
          f"{ma32.temp_size_in_bytes / 1e9:.3f} GB, output "
          f"{ma32.output_size_in_bytes / 1e9:.3f} GB, alias "
          f"{ma32.alias_size_in_bytes / 1e9:.3f} GB (peak "
          f"{(ma32.argument_size_in_bytes + ma32.temp_size_in_bytes) / 1e9:.3f}"
          f" GB against the card's 80) in {secs32:.2f} s; fakes {fakes32}; "
          f"memory_allocated grew {grew / 2**20:.2f} MiB; {smi}", flush=True)
    if grew > 64 * 2**20:
        raise AssertionError(f"the abstract plan allocated {grew} bytes")
    if fakes32.get("flash_forward_lse") != 32 or \
            fakes32.get("flash_bwd_fused") != 32:
        raise AssertionError(f"abstract 7b fakes: {fakes32}")
    n4, ma4, fakes4, secs4 = plan(4)
    if fakes4.get("flash_forward_lse") != 4 or \
            fakes4.get("flash_bwd_fused") != 4:
        raise AssertionError(f"abstract 4-layer fakes: {fakes4}")
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    model, ts, tbatch = train_7b_step(train_7b_config())
    # telemetry's one-off FLOPs probe (a forward and backward under
    # FlopCounterMode) would land inside the profiler phase's window
    ts._flops_probed = True
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - mem1
    held = memplan.nbytes({n: p for n, p in ts._param_objs.items()
                           if n not in ts._master_dtypes}) \
        + memplan.nbytes(ts.opt_state) + memplan.nbytes(tbatch)
    if held != ma4.argument_size_in_bytes:
        raise AssertionError(f"planned arguments "
                             f"{ma4.argument_size_in_bytes} != held {held}")
    losses, _, step_ms, counts, peak_gb = train_steps(ts, tbatch, warmup=1,
                                                      timed=5)
    planned = (ma4.argument_size_in_bytes + ma4.temp_size_in_bytes) / 1e9
    # the step's own peak: what earlier phases left allocated is not its
    base_gb = mem1 / 1e9
    ratio = planned / (peak_gb - base_gb)
    print(f"abstract 4 layers: {n4} parameters; planned arguments "
          f"{ma4.argument_size_in_bytes / 1e9:.4f} GB = the real step's "
          f"{held / 1e9:.4f} GB (memory_allocated grew "
          f"{built / 1e9:.4f} GB building it); temp "
          f"{ma4.temp_size_in_bytes / 1e9:.4f} GB; planned peak "
          f"{planned:.3f} GB against max_memory_allocated {peak_gb:.3f} GB "
          f"less the {base_gb:.3f} GB allocated before the step was built, "
          f"over 5 steps ({float(np.median(step_ms)):.1f} ms each): ratio "
          f"{ratio:.4f}; planned in {secs4:.2f} s; {smi}", flush=True)
    if not 0.75 <= ratio <= 1.25:
        raise AssertionError(f"the planned peak is {ratio:.3f} of the real")
    print(json.dumps({"abstract_7b": {
        "card": smi, "params_32": n32, "plan_32": ma32._asdict(),
        "plan_32_s": secs32, "allocated_growth_bytes": grew,
        "params_4": n4, "plan_4": ma4._asdict(), "held_4": held,
        "built_4_bytes": built, "peak_4_gb": peak_gb, "base_gb": base_gb,
        "planned_peak_4_gb": planned, "ratio": ratio, "fakes_32": fakes32,
        "fakes_4": fakes4, "step_ms": step_ms, "losses": losses}}),
        flush=True)
    return model, ts, tbatch


def profiler_7b_phase(model, ts, batch):
    """``paddle.profiler.Profiler`` (CPU and CUDA activities) with
    ``make_scheduler(closed=1, ready=1, record=2)`` over 4 steps of the
    4-layer step: one window over steps 2-3, its chrome trace written and
    parsed; ``summary()`` names the flash kernel ops with calls equal to
    the launches over the recorded steps."""
    from pathlib import Path

    from paddle_tpu_torch import profiler

    log_dir = Path(__file__).resolve().parent / "build" / "profiler_7b"
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2),
        log_dir=str(log_dir))
    grew = None
    with prof:
        for i in range(4):
            if i == 2:
                torch.cuda.synchronize()
                reset_launches()
            ts.run(batch)
            if i == 3:
                torch.cuda.synchronize()
                grew = read_launches()
            prof.step()
    ops = prof.op_summary()
    want = {"paddle_tpu::flash_forward_lse": grew["flash_attention_fwd_lse"],
            "paddle_tpu::flash_bwd_fused": grew["flash_attention_bwd_fused"]}
    got = {k: ops.get(k, {}).get("calls") for k in want}
    if got != want or min(want.values()) != 8:
        raise AssertionError(f"profiler 7b: op calls {got}, launches {want}")
    with open(prof.traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "fwd_kernel" in e.get("name", "")
             or "dkv_kernel" in e.get("name", "")]
    size_mb = Path(prof.traces[0]).stat().st_size / 1e6
    text = prof.summary(op_top=12)
    print(text, flush=True)
    print(f"profiler 7b: window over steps 2-3, trace {size_mb:.1f} MB with "
          f"{len(events)} events, {len(kernels)} kernels ({len(flash)} of "
          f"the flash bodies); op calls {got} = launches; "
          f"{nvidia_smi_line()}", flush=True)
    if not flash:
        raise AssertionError("profiler 7b: no flash kernel in the trace")
    for p in prof.traces:
        Path(p).unlink()
    print(json.dumps({"profiler_7b": {
        "op_calls": got, "trace_events": len(events),
        "kernel_events": len(kernels), "flash_kernel_events": len(flash),
        "trace_mb": size_mb,
        "device_ms": {k: ops[k]["device_ms"] for k in want}}}), flush=True)


def held_to_f64(label, card, cpu32, ref64, tol=VISION_REF_TOL["logits"]):
    """``card`` within ``tol`` of the float64 reference (relative to its
    largest magnitude) or, where the CPU's own float32 result is further
    from float64 than that, within 10x the CPU's error: the pattern of
    ``vision_reference``."""
    scale = max(float(ref64.abs().max()), 1e-30)
    card_err = float((card.double().cpu() - ref64).abs().max()) / scale
    cpu_err = float((cpu32.double() - ref64).abs().max()) / scale
    if card_err > max(tol, VISION_GRAD_SLACK * cpu_err):
        raise AssertionError(f"{label}: card error {card_err:.3g} against "
                             f"the CPU's {cpu_err:.3g} (tol {tol})")
    return {"card_err": card_err, "cpu_err": cpu_err}


def vision_data_ops_phase():
    """The vision surface on the card: ``FakeData`` -> ``Compose(
    [RandomResizedCrop(224), RandomHorizontalFlip(), Normalize,
    Transpose()])`` -> ``DataLoader`` with 4 workers -> ResNet-50 eval in
    bf16 (images/s with the host work included); then the Faster R-CNN
    R50-FPN sizes: ``nms`` of 2000 proposals at IoU 0.7 (indices identical
    to the CPU's), ``roi_align`` of 512 RoIs on [2, 256, 200, 304] at 7 x
    7, ``sampling_ratio`` 2, forward and backward, and ``deform_conv2d``
    on [2, 256, 100, 152], 3 x 3, 256 -> 256, each held to float64 on the
    CPU (image 0) by ``held_to_f64`` (1e-4 of the scale for values, 1e-3
    for the gradient: float32 resolves a sampling coordinate of a few
    hundred pixels to ~3e-5 of a pixel), and timed."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.vision import datasets, ops, transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    smi = nvidia_smi_line()
    pipeline = T.Compose([
        T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
        T.Normalize([123.675, 116.28, 103.53], [58.395, 57.12, 57.375],
                    data_format="HWC"), T.Transpose()])
    n_img, bsz = 512, 64
    loader = tio.DataLoader(
        datasets.FakeData(n_img, (256, 256, 3), 1000, transform=pipeline),
        batch_size=bsz, num_workers=4)
    model = resnet50(device="cuda", seed=0).to(torch.bfloat16).eval()
    with torch.no_grad():
        model(torch.zeros(bsz, 3, 224, 224, device="cuda",
                          dtype=torch.bfloat16))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen = 0
        for x, y in loader:
            logits = model(torch.as_tensor(x).to("cuda").to(torch.bfloat16))
            seen += x.shape[0]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if seen != n_img or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"vision data: {seen} images, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    ips = n_img / wall
    print(f"vision data: FakeData 256 x 256 -> RandomResizedCrop(224), "
          f"flip, Normalize, Transpose -> DataLoader (4 workers, b {bsz}) "
          f"-> ResNet-50 bf16 eval: {ips:.1f} images/s with the host work "
          f"({n_img} images in {wall:.2f} s); {smi}", flush=True)
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    out = {"images_per_s": ips, "card": smi}
    # nms: 2000 proposals over an 800 x 1216 image
    xy = rng.random((2000, 2)) * [1216, 800]
    wh = rng.random((2000, 2)) * 200 + 8
    boxes = torch.as_tensor(np.concatenate([xy, xy + wh], 1),
                            dtype=torch.float32)
    scores = torch.as_tensor(rng.random(2000), dtype=torch.float32)
    keep = ops.nms(boxes.cuda(), 0.7, scores.cuda())
    keep_cpu = ops.nms(boxes, 0.7, scores)
    if not torch.equal(keep.cpu(), keep_cpu):
        raise AssertionError("nms: card indices differ from the CPU's")
    out["nms"] = {"kept": int(keep.numel()), "ms": events_ms(
        lambda: ops.nms(boxes.cuda(), 0.7, scores.cuda()), 5)}
    # roi_align at the FPN level-2 map
    feat = torch.as_tensor(rng.standard_normal((2, 256, 200, 304)),
                           dtype=torch.float32)
    rxy = rng.random((512, 2)) * [1100, 700]
    rwh = rng.random((512, 2)) * 300 + 16
    rois = torch.as_tensor(np.concatenate([rxy, rxy + rwh], 1),
                           dtype=torch.float32)
    num = np.array([256, 256])
    kw = dict(output_size=7, spatial_scale=0.25, sampling_ratio=2)
    g = torch.as_tensor(rng.standard_normal((512, 256, 7, 7)),
                        dtype=torch.float32)

    def align(x, r, n, grad_of):
        x = x.clone().requires_grad_(True)
        y = ops.roi_align(x, r, n, **kw)
        (y * grad_of).sum().backward()
        return y.detach(), x.grad

    fc, gc, rc = feat.cuda(), g.cuda(), rois.cuda()
    y_card, dx_card = align(fc, rc, num, gc)
    xr = fc.clone().requires_grad_(True)

    def fwd_bwd():
        xr.grad = None
        (ops.roi_align(xr, rc, num, **kw) * gc).sum().backward()

    half = (rois[:256], np.array([256]), g[:256])
    y32, dx32 = align(feat[:1], half[0], half[1], half[2])
    y64, dx64 = align(feat[:1].double(), half[0].double(), half[1],
                      half[2].double())
    out["roi_align"] = {
        "forward": held_to_f64("roi_align", y_card[:256], y32, y64),
        "backward": held_to_f64("roi_align grad", dx_card[:1], dx32, dx64,
                                VISION_REF_TOL["grads"]),
        "ms": events_ms(lambda: ops.roi_align(fc, rc, num, **kw), 5),
        "fwd_bwd_ms": events_ms(fwd_bwd, 5)}
    del fc, gc, xr, y_card, dx_card
    # deform_conv2d at the FPN level-3 map
    x = torch.as_tensor(rng.standard_normal((2, 256, 100, 152)) * 0.5,
                        dtype=torch.float32)
    off = torch.as_tensor(rng.standard_normal((2, 18, 100, 152)) * 2,
                          dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((256, 256, 3, 3)) * 0.02,
                        dtype=torch.float32)
    d_card = ops.deform_conv2d(x.cuda(), off.cuda(), w.cuda(), padding=1)
    d32 = ops.deform_conv2d(x[:1], off[:1], w, padding=1)
    d64 = ops.deform_conv2d(x[:1].double(), off[:1].double(), w.double(),
                            padding=1)
    xc, oc, wc = x.cuda(), off.cuda(), w.cuda()
    out["deform_conv2d"] = {
        **held_to_f64("deform_conv2d", d_card[:1], d32, d64),
        "ms": events_ms(lambda: ops.deform_conv2d(xc, oc, wc, padding=1),
                        5)}
    print(f"vision ops ({smi}): nms of 2000 at IoU 0.7 kept "
          f"{out['nms']['kept']} (= CPU) in {out['nms']['ms']:.3f} ms; "
          f"roi_align 512 RoIs {out['roi_align']['ms']:.3f} ms, forward + "
          f"backward {out['roi_align']['fwd_bwd_ms']:.3f} ms, errors "
          f"{out['roi_align']['forward']} / {out['roi_align']['backward']}; "
          f"deform_conv2d {out['deform_conv2d']['ms']:.3f} ms, error "
          f"{out['deform_conv2d']['card_err']:.3g} (CPU "
          f"{out['deform_conv2d']['cpu_err']:.3g})", flush=True)
    print(json.dumps({"vision_data_ops": out}), flush=True)


def linalg_dist_sparse_phase():
    """``linalg`` at 4096 in float32 (solve, cholesky, eigh, svd, qr, inv,
    lstsq), each held to the card's float64 result by what it defines
    (residuals and reconstructions, values) within 10 n eps of the scale
    (4.9e-3: a backward-stable float32 factorization errs by about n
    eps), and timed; a batch of 1024
    matrices of 32 x 32 held to float64 on the CPU (``held_to_f64``);
    ``distribution`` log_prob, entropy and kl card = CPU at 1e-5, the
    means and variances of 10^7 draws within 5 standard errors;
    ``sparse.matmul`` of 8192 x 8192 at 1% by 8192 x 256, card = CPU."""
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import linalg as L
    from paddle_tpu_torch import sparse as S

    smi = nvidia_smi_line()
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 4096
    a = torch.randn(n, n, device="cuda", generator=g) / n ** 0.5 \
        + 2 * torch.eye(n, device="cuda")
    spd = a @ a.T
    rhs = torch.randn(n, 64, device="cuda", generator=g)
    # a backward-stable float32 factorization errs by about n eps of the
    # matrix's scale; 10 n eps is the allowance (4.9e-3 at 4096)
    tol = 10 * n * torch.finfo(torch.float32).eps
    out = {"card": smi, "tol_4096": tol}

    def rel(x, y):
        return float((x.double() - y).abs().max() / y.abs().max())

    checks = {
        "solve": (lambda m: L.solve(m, rhs.to(m.dtype)), a,
                  lambda m, x: rel(m.double() @ x.double(),
                                   rhs.double())),
        "inv": (L.inv, a, lambda m, x: rel(m.double() @ x.double(),
                                           torch.eye(n, device="cuda",
                                                     dtype=torch.float64))),
        "cholesky": (L.cholesky, spd, lambda m, x: rel(
            x.double() @ x.double().T, m.double())),
        "qr": (L.qr, a, lambda m, qr_: rel(
            qr_[0].double() @ qr_[1].double(), m.double())),
        "eigh": (L.eigh, spd, lambda m, wv: rel(
            (wv[1].double() * wv[0].double()) @ wv[1].double().T,
            m.double())),
        "svd": (L.svd, a, lambda m, usv: rel(
            (usv[0].double() * usv[1].double()) @ usv[2].double(),
            m.double())),
        "lstsq": (lambda m: L.lstsq(m, rhs.to(m.dtype))[0], a,
                  lambda m, x: rel(m.double() @ x.double(),
                                   rhs.double())),
    }
    res = {}
    for name, (fn, m, err_of) in checks.items():
        got = fn(m)
        torch.cuda.synchronize()
        err = err_of(m, got)
        if name in ("eigh", "svd"):
            vals = got[0] if name == "eigh" else got[1]
            want = (L.eigvalsh(m.double()) if name == "eigh"
                    else L.svdvals(m.double()))
            err = max(err, rel(vals, want))
        if not err <= tol:
            raise AssertionError(f"linalg {name} at {n}: error {err} > "
                                 f"{tol}")
        res[name] = {"err": err, "ms": events_ms(lambda: fn(m), 1)}
        del got
    # a batch of 1024 small systems, held to float64 on the CPU
    bm = torch.randn(1024, 32, 32, generator=torch.Generator().manual_seed(
        1)) + 4 * torch.eye(32)
    br = torch.randn(1024, 32, 4, generator=torch.Generator().manual_seed(2))
    batch = {}
    for name, fn in (("solve", lambda m: L.solve(m, br.to(m))),
                     ("inv", L.inv), ("det", L.det),
                     ("eigvalsh", lambda m: L.eigvalsh(m @ m.mT))):
        card = fn(bm.cuda())
        batch[name] = held_to_f64(f"batched {name}", card, fn(bm),
                                  fn(bm.double()))
        batch[name]["ms"] = events_ms(lambda: fn(bm.cuda()), 3)
    out["linalg_4096"] = res
    out["linalg_batch_1024x32"] = batch
    # distributions: densities card = CPU; moments of 10^7 draws
    v = torch.linspace(0.05, 0.95, 64)
    def t(x, dev):
        return torch.tensor(x, device=dev)

    # each distribution as a function of the device and a shift of its
    # parameters (the shifted one is the other side of the KL)
    dists = {
        "Normal": lambda dev, k=0: D.Normal(t(0.3 - k, dev), t(1.7 - k, dev)),
        "Gamma": lambda dev, k=0: D.Gamma(t(2.5 + k, dev), t(1.5 - k, dev)),
        "Beta": lambda dev, k=0: D.Beta(t(2.0 + k, dev), t(3.5 - k, dev)),
        "Laplace": lambda dev, k=0: D.Laplace(t(0.1 + k, dev),
                                              t(0.8 + k, dev)),
        "Exponential": lambda dev, k=0: D.Exponential(t(1.3 + k, dev)),
    }
    moments = {"Normal": (0.3, 1.7 ** 2), "Gamma": (2.5 / 1.5, 2.5 / 2.25),
               "Beta": (2.0 / 5.5, 2.0 * 3.5 / (5.5 ** 2 * 6.5)),
               "Laplace": (0.1, 2 * 0.8 ** 2),
               "Exponential": (1 / 1.3, 1 / 1.69)}
    dres = {}
    for name, make in dists.items():
        card, cpu = make("cuda"), make("cpu")
        pairs = [("log_prob", card.log_prob(v.cuda()), cpu.log_prob(v)),
                 ("entropy", card.entropy(), cpu.entropy())]
        if name != "Laplace":  # no closed form among the built-in pairs
            pairs.append(("kl", D.kl_divergence(card, make("cuda", 0.4)),
                          D.kl_divergence(cpu, make("cpu", 0.4))))
        for what, tc, tp in pairs:
            diff = float((tc.cpu() - tp).abs().max())
            if diff > 1e-5 * max(1.0, float(tp.abs().max())):
                raise AssertionError(f"{name} {what}: card - CPU {diff}")
        x = card.sample((10 ** 7,), generator=torch.Generator(
            device="cuda").manual_seed(3)).double()
        mean, var = moments[name]
        m, s2 = float(x.mean()), float(x.var())
        m4 = float(((x - m) ** 4).mean())
        se_m, se_v = (var / 1e7) ** 0.5, ((m4 - s2 ** 2) / 1e7) ** 0.5
        if abs(m - mean) > 5 * se_m or abs(s2 - var) > 5 * se_v:
            raise AssertionError(f"{name} draws: mean {m} (want {mean}, se "
                                 f"{se_m}), var {s2} (want {var}, se {se_v})")
        dres[name] = {"mean_z": (m - mean) / se_m, "var_z": (s2 - var) / se_v,
                      "sample_ms": events_ms(lambda: card.sample(
                          (10 ** 7,)), 3)}
    out["distribution"] = dres
    # sparse: 8192 x 8192 at 1% by 8192 x 256
    gen = torch.Generator().manual_seed(4)
    nnz = 8192 * 8192 // 100
    idx = torch.randint(0, 8192, (2, nnz), generator=gen)
    vals = torch.randn(nnz, generator=gen)
    sp = S.coalesce(S.sparse_coo_tensor(idx, vals, (8192, 8192)))
    dense = torch.randn(8192, 256, generator=gen)
    want = S.matmul(sp, dense)
    spc, dc = sp.cuda(), dense.cuda()
    got = S.matmul(spc, dc)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    if err > 1e-5:
        raise AssertionError(f"sparse matmul: card - CPU {err}")
    out["sparse_matmul"] = {"nnz": int(S.nnz(sp)), "rel_err": err,
                            "ms": events_ms(lambda: S.matmul(spc, dc), 5)}
    print(f"linalg 4096 ({smi}): " + ", ".join(
        f"{k} {r['ms']:.1f} ms (err {r['err']:.2g})" for k, r in res.items())
        + "; batch 1024 x 32: " + ", ".join(
            f"{k} {r['ms']:.2f} ms" for k, r in batch.items())
        + "; distributions card = CPU, 10^7 draws: " + ", ".join(
            f"{k} z {r['mean_z']:+.2f}/{r['var_z']:+.2f}"
            for k, r in dres.items())
        + f"; sparse matmul {out['sparse_matmul']['ms']:.3f} ms "
          f"(err {err:.2g})", flush=True)
    print(json.dumps({"linalg_dist_sparse": out}), flush=True)


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
    phase("kernel ops", kernel_ops_phase)
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
    phase("resilience reference", resilience_reference_phase)
    phase("router reference", router_reference_phase)
    phase("router 7b", router_7b_phase, model)
    phase("obs reference", obs_reference_phase)
    phase("obs 7b", obs_7b_phase, model, prompts)
    phase("obs front door", obs_front_door_phase, model, prompts)
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
    phase("train 7b telemetry", train_7b_telemetry_phase)
    torch.cuda.empty_cache()
    phase("hapi 7b", hapi_phase, unfused)
    torch.cuda.empty_cache()
    phase("jit 7b", jit_7b_phase)
    torch.cuda.empty_cache()
    step = phase("abstract 7b", abstract_7b_phase)
    phase("profiler 7b", profiler_7b_phase, *step)
    del step
    torch.cuda.empty_cache()
    phase("vision data and ops", vision_data_ops_phase)
    torch.cuda.empty_cache()
    phase("linalg, distribution, sparse", linalg_dist_sparse_phase)
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
    torch.cuda.empty_cache()
    phase("flash shapes", family_flash_phase)
    torch.cuda.empty_cache()
    phase("model references", family_reference_phase)
    torch.cuda.empty_cache()
    phase("train gpt2", train_gpt2_phase)
    torch.cuda.empty_cache()
    phase("train bert-base", train_bert_phase)
    torch.cuda.empty_cache()
    phase("train t5-small", train_t5_phase)
    torch.cuda.empty_cache()
    phase("train ernie-moe", train_ernie_moe_phase)
    torch.cuda.empty_cache()
    phase("vision reference", vision_reference_phase)
    torch.cuda.empty_cache()
    phase("train vit-l", train_vit_l_phase)
    torch.cuda.empty_cache()
    phase("train resnet50", train_resnet50_phase)
    torch.cuda.empty_cache()
    phase("vision zoo", vision_zoo_phase)
    torch.cuda.empty_cache()
    phase("rwkv reference", rwkv_reference_phase)
    torch.cuda.empty_cache()
    phase("train rwkv-169m", train_rwkv_phase)
    torch.cuda.empty_cache()
    phase("losses and rnn reference", losses_rnn_reference_phase)
    phase("speech surface", speech_phase)
    torch.cuda.empty_cache()
    phase("ring attention", ring_phase)
    torch.cuda.empty_cache()
    phase("checkpoint", checkpoint_phase)
    torch.cuda.empty_cache()
    phase("pipeline", pipeline_phase)
    leave_process_group()
    torch.cuda.empty_cache()
    phase("distributed", distributed_phase)
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
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main())
