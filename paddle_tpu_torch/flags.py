"""Process-level flag registry of the PyTorch port.

Counterpart of ``paddle_tpu/flags.py``: the same ``define_flag`` /
``flag`` / ``set_flags`` surface and the same
``PT_FLAGS_<name>`` environment prefix. It holds only the flags the
serving and training slices read, under the JAX package's names and
defaults, so an environment that configures one package configures the
other alike.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def define_flag(name: str, default, help_: str = ""):
    env = os.environ.get(f"PT_FLAGS_{name}")
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = {"value": value, "default": default, "help": help_}
    return value


def set_flags(flags: Dict[str, Any]):
    """Parity: paddle.set_flags({"FLAGS_x": v})."""
    for name, value in flags.items():
        key = name.removeprefix("FLAGS_")
        if key not in _REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        _REGISTRY[key]["value"] = value


def flag(name: str):
    return _REGISTRY[name]["value"]


define_flag("benchmark", False,
            "print per-step wall timing + loss from TrainStep.run "
            "(blocks on the step's outputs each step — a debug/bench "
            "knob, not a production setting)")
define_flag("check_nan_inf", False,
            "debug-check each TrainStep's loss/grad-norm for NaN/Inf "
            "and raise FloatingPointError at the offending step "
            "(forces a per-step host sync; read at every run, since the "
            "port's step always computes the grad norm)")
define_flag("fused_decode", "auto",
            "fused single-pass decode attention (RoPE + KV append + "
            "length-pruned attention in one kernel): auto and on = the "
            "Hopper kernel for CUDA tensors, its plain version for CPU "
            "tensors; off = the unfused llama branch")
define_flag("prefill_chunk", 256,
            "serving prefill chunk length: one fixed [slots, C] chunk "
            "forward driven in a host loop, clamped to [2, max_len] (a "
            "1-token chunk would enter the decode branch). 0 selects the "
            "legacy bucketed prefill: each request prefilled alone as a "
            "[1, bucket] forward, without the prefix cache")
define_flag("prefix_cache", True,
            "serving prefix KV reuse: admission looks up the longest "
            "cached block-aligned prompt prefix and prefills only the "
            "suffix (paged mode shares pages copy-on-write; contiguous "
            "mode copies cached token blocks into the slot). off = "
            "every request recomputes its full prompt")
define_flag("spec_decode", "off",
            "speculative decoding in the serving engine: draft up to "
            "spec_k candidate tokens per slot per step (host-side n-gram "
            "prompt lookup, no draft model) and score them in one "
            "[slots, spec_k+1] target-model pass with greedy acceptance, "
            "so one weight stream buys accepted+1 tokens. ngram = draft "
            "whenever the slot's history matches; auto = ngram with a "
            "per-request throttle that stops drafting traffic that never "
            "accepts; off = one token per decode pass (greedy outputs are "
            "identical in every mode)")
define_flag("kv_cache_dtype", "auto",
            "serving KV-cache dtype when EngineConfig.cache_dtype is "
            "'auto': auto = bfloat16 on the card, float32 on the CPU; or "
            "explicit bfloat16|float16|float32|int8 (int8: per-row float32 "
            "scales beside the cache, quantize on append, dequantize in "
            "the decode kernels)")
define_flag("serve_weight_dtype", "bf16",
            "serving weight stream when EngineConfig.weight_dtype is "
            "'auto': bf16 = serve the model's own weights; int8|int4 = "
            "group-wise weight-only quantization at engine init "
            "(quantization.quantize_model_weight_only); every grouped "
            "quantized linear runs the Hopper weight-only matmul kernel "
            "on the card")
define_flag("flash_attention_block_k", 1024,
            "flash-attention k/v block length of the JAX package, clamped "
            "to the sequence (fit_block). In the port it chooses the "
            "backward pass as on the TPU: the fused pass when "
            "ceil(sk / block_k) <= 4 (one float32 dq partial per block_k "
            "kv rows), else the dq and dk/dv passes")
define_flag("fused_group_norm", True,
            "NHWC GroupNorm(+SiLU) through the fused kernels: on = rows "
            "12/13 (the Hopper kernels for CUDA tensors, whatever the "
            "shape; their plain versions for CPU tensors within the JAX "
            "package's VMEM budget); off = the plain reference")
define_flag("default_matmul_precision", "",
            "process-wide float32 matmul precision, applied at import of "
            "paddle_tpu_torch (apply_matmul_precision re-applies it): "
            "float32|highest = exact float32 (TF32 off for matmuls and "
            "cuDNN); tensorfloat32 = TF32 tensor cores for both; bfloat16 "
            "= torch's 'medium' (bf16 passes) with cuDNN TF32; empty = "
            "torch's own defaults")
define_flag("tenant_prefix_namespace", True,
            "multi-tenant prefix-cache isolation: tenant-tagged requests "
            "hash their prompt blocks under a per-tenant namespace seed, "
            "so tenants can neither probe for nor borrow each other's "
            "cached KV, and pool-pressure eviction spends the requesting "
            "tenant's own cold entries first. Untagged requests always "
            "share the default chain. off = all tenants share one "
            "namespace")
define_flag("sched_policy", "fifo",
            "serving front door's default admission scheduler when none "
            "is passed to start_api_server: fifo = the engine's "
            "submission-order admission; slo_fair = "
            "serving_api.SLOFairScheduler (weighted fair share per tenant "
            "and TTFT urgency decide admission order, chunk split and "
            "preemption). An explicit scheduler= argument always wins")
define_flag("api_max_tenants", 256,
            "serving front door: the most DISTINCT tenant ids accepted "
            "over the server's lifetime (each mints accounting buckets "
            "and fair-share entries); past the cap a request carrying a "
            "new tenant is rejected with HTTP 429 (known tenants and "
            "untagged requests always pass; 0 rejects every tenant-tagged "
            "request)")
define_flag("sched_preempt", True,
            "let the SLO-fair scheduler preempt an active batch-class "
            "slot (release its slot and pages, re-queue it with its "
            "history for replay through the chunked prefill) when an "
            "interactive request is about to miss its TTFT target and no "
            "slot is free; bounded per request. off = admission order and "
            "quotas only")

_PRECISIONS = {"float32": "highest", "highest": "highest",
               "tensorfloat32": "high", "bfloat16": "medium"}


def apply_matmul_precision(value=None):
    """Apply ``PT_FLAGS_default_matmul_precision`` (or ``value``) to
    torch: ``torch.set_float32_matmul_precision`` and
    ``torch.backends.cudnn.allow_tf32``. ``float32``/``highest`` are
    exact float32, ``tensorfloat32`` TF32, ``bfloat16`` torch's
    ``medium``; empty leaves torch as it is. An unknown value raises the
    JAX package's ``ValueError``."""
    val = flag("default_matmul_precision") if value is None else value
    if not val:
        return
    mode = _PRECISIONS.get(str(val))
    if mode is None:
        raise ValueError(
            f"PT_FLAGS_default_matmul_precision={val!r} is not a valid "
            "matmul precision (use bfloat16|tensorfloat32|float32|highest, "
            "or empty for the default)")
    import torch

    torch.set_float32_matmul_precision(mode)
    torch.backends.cudnn.allow_tf32 = mode != "highest"
