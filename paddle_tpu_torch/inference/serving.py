"""Continuous-batching decode engine (counterpart of
``paddle_tpu/inference/serving.py: ContinuousBatchingEngine``).

Slot-based continuous batching over a causal LM, with contiguous per-slot
KV caches or a paged pool (``EngineConfig.paged``). Sequences enter and
leave as data: per-slot lengths, an active mask, a FIFO heap of free slots
and, in paged mode, the page pool's block tables live on the host, and
three forwards run on the device:

- ``prefill_chunk``: one fixed ``[slots, C]`` chunk written straight into
  the live caches at per-slot offsets, driven in a host loop; slots not
  prefilling carry the ``start = max_len`` sentinel and their rows drop
  (paged: land on the sink page 0);
- ``decode_step``: one ``[slots, 1]`` token per slot;
- ``decode_chunk``: K decode steps in a Python loop whose sampled tokens
  stay on the device, with one host sync per chunk.

Admission in ``step_chunk`` is queued on the stream behind the in-flight
decode chunk, as in the JAX engine. Caches are updated in place (JAX
donates them). Greedy tokens match the JAX engine's.

Paged mode claims ``pages_needed(prompt + max_new_tokens)`` pages per
request at admission, waits for a finisher when the pool is short, frees
the pages at finish or cancel, and uploads a snapshot of the block table
once per prefill wave and once per decode step, chunk or verify pass.

Prefix caching (``PT_FLAGS_prefix_cache``, on by default as in JAX):
admission looks up the longest cached block-aligned prompt prefix
(``prefix_cache.py``) and prefills only the suffix. Paged mode adopts the
cached pages into the slot's block table and copies a shared page before
any write can reach it (``_cow_block``: a full-cover hit's recomputed
last token, and ``_cow_for_decode`` before every decode dispatch, ahead
of the block-table upload, since the fused paged kernel appends through
that table). Contiguous mode copies the cached blocks into the slot's
rows. A wave publishes its prompts' full blocks once it has run.

Speculative decoding (``PT_FLAGS_spec_decode=ngram|auto``): a host-side
drafter proposes up to ``spec_k`` tokens per greedy slot, one ``[slots,
spec_k+1]`` verify forward scores them through the models' s > 1 branches,
and each slot advances by its accepted drafts plus one token; rows past
that stay in the cache above every later causal mask.

Quantized serving: ``EngineConfig(weight_dtype="int8"|"int4")`` swaps
every linear of (a deep copy of, unless ``quantize_inplace``) the model for
a group-wise ``WeightOnlyLinear`` at init, so every forward's linears run
the weight-only matmul kernel on the card; ``cache_dtype="int8"`` gives
int8 caches or pools with per-row float32 scales, quantized on append and
dequantized in the fused decode kernels.

Legacy bucketed prefill (``PT_FLAGS_prefill_chunk=0``, the JAX engine's
parity oracle): each admitted request is prefilled alone, padded to its
``seq_buckets`` bucket, in one ``[1, bucket]`` forward at the shared
``cache_index`` 0 into a fresh contiguous cache, whose rows are then
copied into the slot (paged: scattered into the slot's first ``bucket //
page_size`` pages). Float caches only, and without the prefix cache, as
in JAX; decode is the same as after chunked prefill.

Requests, SLOs and tenants: a request may carry an SLO class
(``SLO_CLASSES``) or its own TTFT/TPOT targets, a hard ``deadline_ms``
(expired at the top of every tick: queued or active, it finishes with
``"timeout"`` through the one teardown path) and a tenant, which names
its prefix-cache namespace (``PT_FLAGS_tenant_prefix_namespace``) and its
accounting bucket. Attainment is counted at finish (``slo_snapshot``,
``tenant_snapshot``). ``set_scheduler`` installs an admission policy
(``serving_api.SLOFairScheduler``) on the chunked path: it picks the
admission order, may ``preempt`` a slot (the request re-queues with its
history and replays prompt + output through the chunked prefill, so its
greedy tokens are unchanged) and caps per-slot chunk budgets.
``step_adaptive`` shortens the decode chunk while admission work waits.

The port runs chunked and legacy prefill, float or int8 caches
(contiguous or paged), bf16, int8 or int4 weights, prefix caching,
speculative decoding, SLO/deadline/tenant accounting and the scheduler
seam. Telemetry, tracing, resilience (replay after faults, the
degradation ladder, drain), the sanitizer, the profiler and the router
are later slices (ROADMAP.md Queue A): the engine behaves as the JAX
engine does with ``PT_FLAGS_telemetry=off`` and
``PT_FLAGS_degradation=off``.
"""

from __future__ import annotations

import bisect
import collections
import copy
import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import flags
from ..core.device import resolve_device
from ..core.random import make_generator
from ..generation import process_logits_batch
from .paged import PagedState, PagePool, QuantizedKV, init_paged_pool
from .prefix_cache import ContigPrefixStore, PagedPrefixStore, block_hashes
from .spec_decode import Drafter, NgramDrafter


@dataclass
class EngineConfig:
    """The JAX engine's configuration, field for field and default for
    default. Fields outside this slice must keep values that select the
    ported path; the engine raises at init otherwise."""
    max_slots: int = 4
    max_len: int = 1024
    # legacy bucketed prefill only (PT_FLAGS_prefill_chunk=0)
    seq_buckets: Sequence[int] = (64, 128, 256, 512, 1024)
    # paged KV pool: page_size tokens per page; n_pages defaults to
    # max_slots * (max_len // page_size) + 1 (page 0 is the write sink)
    paged: bool = False
    page_size: int = 64
    n_pages: Optional[int] = None
    # "auto" resolves through PT_FLAGS_kv_cache_dtype: bfloat16 on the
    # card, float32 on the CPU; explicit dtypes win. "int8" keeps per-row
    # float32 scales beside the cache (quantize on append)
    cache_dtype: object = "auto"
    # "auto" resolves through PT_FLAGS_serve_weight_dtype; "bf16" serves
    # the model's own weights, "int8"/"int4" quantize them group-wise at
    # init (layers whose in_features weight_group_size does not divide
    # take one whole-column group)
    weight_dtype: str = "auto"
    weight_group_size: int = 128
    # quantize the caller's model in place (frees its float linears as
    # they are replaced); by default the engine quantizes a deep copy
    quantize_inplace: bool = False
    prefix_cache_blocks: Optional[int] = None
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    spec_k: int = 4
    max_retries: int = 2


_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                 "float16": torch.float16, "fp16": torch.float16,
                 "float32": torch.float32, "fp32": torch.float32,
                 "int8": torch.int8}
_WEIGHT_DTYPES = ("bf16", "int8", "int4")


def _resolve_cache_dtype(requested, device: torch.device) -> torch.dtype:
    """EngineConfig.cache_dtype -> torch dtype. ``"auto"`` defers to
    ``PT_FLAGS_kv_cache_dtype``, whose ``auto`` means bfloat16 on the card
    and float32 on the CPU; ``"int8"`` selects quantized caches."""

    def lookup(val, origin):
        if val not in _CACHE_DTYPES:
            raise ValueError(f"{origin} must be 'auto' or one of "
                             f"{sorted(_CACHE_DTYPES)}; got {val!r}")
        return _CACHE_DTYPES[val]

    if isinstance(requested, torch.dtype):
        if requested not in _CACHE_DTYPES.values():
            raise ValueError(f"EngineConfig.cache_dtype must be one of "
                             f"{sorted(set(_CACHE_DTYPES.values()), key=str)}"
                             f"; got {requested}")
        return requested
    if requested not in (None, "auto"):
        return lookup(str(requested), "EngineConfig.cache_dtype")
    val = str(flags.flag("kv_cache_dtype")).lower()
    if val == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return lookup(val, "PT_FLAGS_kv_cache_dtype")


def _validate_buckets(cfg: EngineConfig) -> List[int]:
    """The working bucket table: entries must be positive ints; it is
    sorted, deduplicated and clamped to max_len, as the JAX engine's."""
    buckets = list(cfg.seq_buckets)
    if not buckets:
        raise ValueError("EngineConfig.seq_buckets must be non-empty")
    for b in buckets:
        if isinstance(b, bool) or not isinstance(b, (int, np.integer)) \
                or b <= 0:
            raise ValueError(f"EngineConfig.seq_buckets entries must be "
                             f"positive ints; got {b!r}")
    return sorted({min(int(b), cfg.max_len) for b in buckets})


def _resolve_weight_dtype(requested) -> str:
    """EngineConfig.weight_dtype -> "bf16" | "int8" | "int4". ``"auto"``
    defers to ``PT_FLAGS_serve_weight_dtype``; "bf16" (or "bfloat16")
    serves the model's weights as they are."""
    origin = "EngineConfig.weight_dtype"
    if requested in (None, "auto"):
        requested = flags.flag("serve_weight_dtype")
        origin = "PT_FLAGS_serve_weight_dtype"
    val = str(requested).lower()
    if val == "bfloat16":
        val = "bf16"
    if val not in _WEIGHT_DTYPES:
        raise ValueError(
            f"{origin} must be 'auto' or one of {list(_WEIGHT_DTYPES)}; "
            f"got {requested!r}")
    return val


# per-request SLO classes: TTFT and per-request TPOT targets (soft,
# counted at finish) and the class's default hard deadline; explicit
# add_request arguments override each
SLO_CLASSES: Dict[str, Dict[str, float]] = {
    "interactive": {"ttft_target_ms": 250.0, "tpot_target_ms": 100.0,
                    "deadline_ms": 30_000.0},
    "batch": {"ttft_target_ms": 5000.0, "tpot_target_ms": 1000.0,
              "deadline_ms": 300_000.0},
}


def new_slo_bucket() -> Dict[str, int]:
    """One per-class SLO accounting bucket."""
    return {"met": 0, "violated": 0, "cancelled": 0,
            "ttft_violations": 0, "tpot_violations": 0,
            "timeouts": 0, "met_tokens": 0, "total_tokens": 0}


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    output: List[int] = field(default_factory=list)
    ttft_ms: Optional[float] = None
    slot: Optional[int] = None
    done: bool = False
    cancelled: bool = False
    # why the request left its slot: eos | max_new_tokens | max_len |
    # cancel | timeout (None while in flight)
    finish_reason: Optional[str] = None
    # hard deadline from submission: past it the request finishes with
    # "timeout", queued or active
    deadline_ms: Optional[float] = None
    # replay-retry bound of the JAX engine's recovery (kept on the
    # request; the port has no fault recovery yet)
    max_retries: Optional[int] = None
    # tenant (None = the untagged tenant "-"): fair share and quotas of
    # the scheduler, the prefix-cache namespace, the accounting bucket
    tenant: Optional[str] = None
    # SLO class and targets (None = untracked); tpot_ms is the mean
    # decode latency, set at finish
    slo: Optional[str] = None
    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    slo_met: Optional[bool] = None
    # per-request sampling params (None = the engine-global config); any
    # explicit temperature/top_k/top_p implies sampling unless ``greedy``
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: Optional[bool] = None
    _submit_t: float = 0.0
    # first admission (perf_counter seconds): kept across preemption
    _admit_t: float = 0.0
    # absolute deadline instant (perf_counter seconds; 0 = none)
    _deadline_t: float = 0.0
    # replay re-queues consumed (the JAX engine's recovery counter)
    _retries: int = 0
    # the prefill ids' prefix-cache block digests (hashed once a
    # admission, reset when a preemption grows the ids)
    _hashes: Optional[List[bytes]] = None
    # speculative-decoding tallies (the ``auto`` mode's throttle reads
    # them)
    _spec_proposed: int = 0
    _spec_accepted: int = 0


def build_request(rid: int, prompt, max_new_tokens: int = 32,
                  eos_token_id: Optional[int] = None,
                  temperature: Optional[float] = None,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  greedy: Optional[bool] = None,
                  tenant: Optional[str] = None,
                  slo: Optional[str] = None,
                  ttft_target_ms: Optional[float] = None,
                  tpot_target_ms: Optional[float] = None,
                  deadline_ms: Optional[float] = None,
                  max_retries: Optional[int] = None,
                  *, max_len: int) -> Request:
    """Validate request arguments and build a :class:`Request` (the JAX
    engine's admission checks and error messages). An SLO class fills the
    targets and the deadline it leaves unset; targets alone make the
    class ``"custom"``."""
    prompt = np.asarray(prompt).reshape(-1)
    if prompt.size == 0:
        raise ValueError("add_request needs a non-empty prompt")
    if prompt.size + max_new_tokens > max_len:
        raise ValueError(
            f"prompt({prompt.size}) + max_new_tokens({max_new_tokens}) "
            f"exceeds max_len={max_len}")
    if temperature is not None and temperature <= 0:
        raise ValueError(f"temperature must be > 0; got {temperature}")
    if top_k is not None and top_k < 0:
        raise ValueError(f"top_k must be >= 0; got {top_k}")
    if top_p is not None and not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    if tenant is not None:
        # the tenant is a hash namespace and a dict key: no shapes that
        # could mangle either
        if not isinstance(tenant, str) or not tenant \
                or len(tenant) > 64 \
                or any(c.isspace() or not c.isprintable() for c in tenant):
            raise ValueError(
                "tenant must be a non-empty printable string without "
                f"whitespace, at most 64 chars; got {tenant!r}")
        if tenant == "-":
            raise ValueError('tenant "-" is reserved for untagged requests')
    if slo is None and (ttft_target_ms is not None
                        or tpot_target_ms is not None):
        slo = "custom"
    if slo is not None and slo != "custom" and slo not in SLO_CLASSES:
        raise ValueError(f"slo must be one of {sorted(SLO_CLASSES)} (or "
                         f"custom targets); got {slo!r}")
    if slo == "custom" and ttft_target_ms is None \
            and tpot_target_ms is None:
        # a target-less custom request would count as met every time
        raise ValueError('slo="custom" needs ttft_target_ms and/or '
                         "tpot_target_ms")
    for tname, t in (("ttft_target_ms", ttft_target_ms),
                     ("tpot_target_ms", tpot_target_ms)):
        if t is not None and t <= 0:
            raise ValueError(f"{tname} must be > 0; got {t}")
    if slo is not None:
        defaults = SLO_CLASSES.get(slo, {})
        if ttft_target_ms is None:
            ttft_target_ms = defaults.get("ttft_target_ms")
        if tpot_target_ms is None:
            tpot_target_ms = defaults.get("tpot_target_ms")
        if deadline_ms is None:
            deadline_ms = defaults.get("deadline_ms")
    if deadline_ms is not None:
        if deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0; got {deadline_ms}")
        if deadline_ms < 1.0:
            raise ValueError(
                f"deadline_ms={deadline_ms} is shorter than a single "
                "scheduler step can honor (deadlines are checked once per "
                "step; minimum 1 ms)")
    if max_retries is not None and (
            isinstance(max_retries, bool)
            or not isinstance(max_retries, (int, np.integer))
            or max_retries < 0):
        raise ValueError(f"max_retries must be a non-negative int; got "
                         f"{max_retries!r}")
    req = Request(rid, prompt, max_new_tokens, eos_token_id,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  greedy=greedy, tenant=tenant, slo=slo,
                  ttft_target_ms=ttft_target_ms,
                  tpot_target_ms=tpot_target_ms, deadline_ms=deadline_ms,
                  max_retries=max_retries, _submit_t=time.perf_counter())
    if deadline_ms is not None:
        req._deadline_t = req._submit_t + deadline_ms / 1e3
    return req


def request_namespace(req: Request) -> str:
    """The request's prefix-cache namespace: its tenant while
    ``PT_FLAGS_tenant_prefix_namespace`` is on, else the shared chain."""
    if req.tenant and bool(flags.flag("tenant_prefix_namespace")):
        return req.tenant
    return ""


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a causal LM that exposes
    ``init_kv_caches`` and takes ``kv_caches`` with a per-slot vector
    ``cache_index`` (a shared scalar one for the legacy prefill) in its
    forward, as ``models/llama.py`` does.

    ``device`` defaults to ``"cuda"`` and must be where the model's
    weights are; with no CUDA device the engine raises unless the caller
    passes ``device="cpu"``. With int8/int4 weights ``self.model`` is the
    quantized model (a deep copy of ``model`` unless
    ``quantize_inplace``). ``drafter`` replaces the n-gram drafter when
    speculative decoding is on."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 device="cuda", drafter: Optional[Drafter] = None):
        self.cfg = config or EngineConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}; the engine "
                             f"was asked for {self.device}")
        # quantized-serving validation first, with the JAX engine's errors
        self.weight_dtype = _resolve_weight_dtype(cfg.weight_dtype)
        self.cache_dtype = _resolve_cache_dtype(cfg.cache_dtype,
                                                self.device)
        g = cfg.weight_group_size
        if not isinstance(g, (int, np.integer)) or isinstance(g, bool) \
                or g < 1:
            raise ValueError(f"EngineConfig.weight_group_size must be a "
                             f"positive int; got {g!r}")
        if self.cache_dtype == torch.int8 \
                and int(flags.flag("prefill_chunk")) <= 0:
            raise ValueError(
                "cache_dtype='int8' requires the chunked prefill path "
                "(PT_FLAGS_prefill_chunk > 0): the legacy per-bucket "
                "prefill has no quantize-on-append path")
        self._check_slice(cfg)
        self._buckets = _validate_buckets(cfg)
        # speculative decoding: host-side drafting and one [slots,
        # spec_k+1] verify forward; "off" leaves the decode path as it is
        mode = str(flags.flag("spec_decode")).lower()
        if mode not in ("off", "ngram", "auto"):
            raise ValueError(f"PT_FLAGS_spec_decode must be off|ngram|auto;"
                             f" got {mode!r}")
        if cfg.spec_k < 1:
            raise ValueError(f"EngineConfig.spec_k must be >= 1; got "
                             f"{cfg.spec_k}")
        self._spec_mode = mode
        self._drafter = None
        if mode != "off":
            self._drafter = drafter if drafter is not None \
                else NgramDrafter()
        self.spec_stats = {"proposed": 0, "accepted": 0, "emitted": 0,
                           "verify_calls": 0, "fallback_steps": 0}
        if self.weight_dtype != "bf16":
            from ..quantization import quantize_model_weight_only

            if not cfg.quantize_inplace:
                model = copy.deepcopy(model)
            model = quantize_model_weight_only(
                model, weight_dtype=self.weight_dtype, group_size=int(g))
        self.model = model
        model.eval()

        self.seq_lens = np.zeros((cfg.max_slots,), np.int64)
        self.active = np.zeros((cfg.max_slots,), bool)
        self.last_tok = np.zeros((cfg.max_slots,), np.int64)
        # free slots, lowest index first
        self._free_heap = list(range(cfg.max_slots))
        self._slot_req: Dict[int, Request] = {}
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._finished: Dict[int, Request] = {}
        self._gen = make_generator(cfg.seed, self.device)
        if cfg.paged:
            max_pages = cfg.max_len // cfg.page_size
            n_pages = cfg.n_pages or cfg.max_slots * max_pages + 1
            self.pool = PagePool(n_pages, cfg.page_size, cfg.max_slots,
                                 max_pages, reserve_sink=True)
            mcfg = model.config
            self.caches = init_paged_pool(
                mcfg.num_hidden_layers, n_pages, cfg.page_size,
                mcfg.num_key_value_heads, mcfg.head_dim,
                dtype=self.cache_dtype, device=self.device)
        else:
            self.pool = None
            self.caches = model.init_kv_caches(cfg.max_slots, cfg.max_len,
                                               dtype=self.cache_dtype)
        # the last admission pass stopped because the pool could not fit
        # the head request (it waits for a finisher)
        self._pool_blocked = False
        # the chunk length floors at 2: a 1-token chunk would enter the
        # model's s == 1 decode branch, which has no sentinel drop; 0 is
        # the legacy bucketed prefill
        chunk = int(flags.flag("prefill_chunk"))
        self._chunk_len = max(2, min(chunk, cfg.max_len)) if chunk > 0 \
            else 0
        # prefix KV reuse, hashed in blocks of page_size tokens in both
        # cache modes; chunked prefill only (suffix-only prefill needs the
        # per-slot chunk program, which the legacy path does not have)
        self._prefix = None
        self._prefix_block = cfg.page_size
        if flags.flag("prefix_cache") and self._chunk_len:
            if cfg.paged:
                self._prefix = PagedPrefixStore()
            else:
                cap = cfg.prefix_cache_blocks
                if cap is None:
                    cap = max(cfg.max_slots * cfg.max_len
                              // self._prefix_block // 4, 1)
                self._prefix = ContigPrefixStore(cap)
        self.prefix_stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                             "prompt_tokens": 0, "evictions": 0,
                             "cow_copies": 0}
        # forwards run per program (host counters: a decode forward is one
        # [slots, 1] model call, so kernel launches per run are
        # num_hidden_layers x decode_forwards on the fused path; a verify
        # forward is one [slots, spec_k+1] call through the s > 1
        # branches, which launch no decode kernel)
        self.stats = {"prefill_chunk": 0, "prefill_bucket": 0,
                      "decode_forwards": 0, "verify_forwards": 0}
        self._note_free_pages()
        # rid minting is a read-modify-write that producer threads (the
        # front door's handlers) share
        self._rid_lock = threading.Lock()
        # SLO attainment per class and cumulative tenant counters (host
        # counters, written at finish and preempt)
        self.slo_stats: Dict[str, Dict[str, int]] = {}
        self.tenant_stats: Dict[str, Dict[str, int]] = {}
        # the admission policy (None = FIFO) and the previous admission
        # pass's pool verdict, which its preemption window reads
        self._sched = None
        self.sched_stats = {"policy": "fifo", "preemptions": 0}
        self._pool_blocked_prev = False

    @staticmethod
    def _check_slice(cfg: EngineConfig):
        """Configurations the JAX engine refuses raise its ``ValueError``."""
        if cfg.max_slots < 1 or cfg.max_len < 2:
            raise ValueError("EngineConfig needs max_slots >= 1 and "
                             "max_len >= 2")
        if cfg.page_size < 1:
            raise ValueError(f"EngineConfig.page_size must be >= 1; got "
                             f"{cfg.page_size}")
        if cfg.paged:
            if cfg.max_len % cfg.page_size:
                raise ValueError("max_len must be divisible by page_size")
            for bkt in cfg.seq_buckets:
                if min(bkt, cfg.max_len) % cfg.page_size:
                    raise ValueError(
                        f"seq bucket {bkt} not divisible by page_size="
                        f"{cfg.page_size}")

    # ---------------- scheduler policy seam ----------------
    def set_scheduler(self, policy):
        """Install (or clear, with ``None``) the admission policy. It is
        consulted on the scheduler thread only: ``pick(engine,
        candidates)`` chooses the next queued request to claim a slot;
        ``before_admission(engine)`` may ``preempt`` slots before each
        admission wave and returns the preempted rids (kept out of that
        wave); ``slot_caps(engine)`` caps per-slot decode budgets of a
        chunk; ``note_admit(engine, req)`` hears each committed claim.
        Host policy only: greedy tokens are the same under any admission
        order. The legacy bucketed prefill stays FIFO, as in JAX."""
        self._sched = policy
        self.sched_stats["policy"] = (
            "fifo" if policy is None
            else getattr(policy, "name", type(policy).__name__))

    def _pick_admission(self, skip, fifo_cursor):
        """The next queued request to try (a peek: it leaves the queue
        when its claim commits), or None to end the wave. ``skip``: rids
        preempted or claimed in this wave. FIFO without a policy: the
        head, or with skips a wave-local ``[snapshot, index]`` cursor;
        with one, the policy ranks a fresh snapshot per pick."""
        if self._sched is None:
            if not skip:
                return self._queue[0] if self._queue else None
            cands, i = fifo_cursor
            if cands is None:
                cands = fifo_cursor[0] = list(self._queue)
            while i < len(cands) and cands[i].rid in skip:
                i += 1
            fifo_cursor[1] = i
            return cands[i] if i < len(cands) else None
        cands = [r for r in list(self._queue) if r.rid not in skip]
        if not cands:
            return None
        return self._sched.pick(self, cands)

    def preempt(self, slot: int) -> bool:
        """Preempt the active request in ``slot``: its slot and pages go
        back through the one teardown path and it re-queues at the front
        with its output. Re-admission prefills prompt + output through
        the chunked prefill, so its greedy tokens are the ones it would
        have made; its TTFT and admit instant are kept. Scheduler thread
        only, as ``cancel``: tokens an in-flight chunk still computes for
        the slot are discarded."""
        req = self._slot_req.get(slot)
        if req is None:
            return False
        self._release_slot(slot)
        req.slot = None
        # the replay ids grow by the output: the digests are stale
        req._hashes = None
        self._queue.appendleft(req)
        self.sched_stats["preemptions"] += 1
        self._tenant_bucket(req.tenant)["preemptions"] += 1
        return True

    # ---------------- requests ----------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    temperature: Optional[float] = None,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    greedy: Optional[bool] = None,
                    tenant: Optional[str] = None,
                    slo: Optional[str] = None,
                    ttft_target_ms: Optional[float] = None,
                    tpot_target_ms: Optional[float] = None,
                    deadline_ms: Optional[float] = None,
                    max_retries: Optional[int] = None) -> int:
        """Queue a request; returns its id. Safe from producer threads.
        Setting any of ``temperature``/``top_k``/``top_p`` makes this
        request sample (``greedy=True`` overrides back to argmax).
        ``tenant``: a non-empty printable string without whitespace, at
        most 64 chars (None = untagged). ``slo``: ``"interactive"`` or
        ``"batch"`` (``SLO_CLASSES``), whose targets and deadline
        ``ttft_target_ms``/``tpot_target_ms``/``deadline_ms`` override;
        targets alone make the class ``"custom"``. ``deadline_ms`` (>= 1)
        is a hard budget from submission: past it the request finishes
        with ``"timeout"``. ``max_retries`` is validated and kept on the
        request for the JAX engine's fault recovery, which the port does
        not have yet."""
        req = build_request(
            0, prompt, max_new_tokens, eos_token_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            greedy=greedy, tenant=tenant, slo=slo,
            ttft_target_ms=ttft_target_ms, tpot_target_ms=tpot_target_ms,
            deadline_ms=deadline_ms, max_retries=max_retries,
            max_len=self.cfg.max_len)
        # minted after validation (a rejected request burns no rid) and
        # under the lock (two producers must not share a rid)
        with self._rid_lock:
            req.rid = self._next_rid
            self._next_rid += 1
        return self.submit_request(req)

    def submit_request(self, req: Request) -> int:
        """Queue a request built by ``build_request`` that has never run
        (the caller owns its rid); later rids are minted past it."""
        with self._rid_lock:
            self._next_rid = max(self._next_rid, req.rid + 1)
        self._queue.append(req)
        return req.rid

    def _req_greedy(self, req: Request) -> bool:
        if req.greedy is not None:
            return req.greedy
        if (req.temperature is not None or req.top_k is not None
                or req.top_p is not None):
            return False
        return self.cfg.greedy

    def _req_nondefault(self, req: Request) -> bool:
        """True when the request's next-token selection differs from the
        engine-global config, so the per-slot sampling arm must run."""
        g = self._req_greedy(req)
        if g != bool(self.cfg.greedy):
            return True
        if g:
            return False
        return ((req.temperature is not None
                 and req.temperature != self.cfg.temperature)
                or bool(req.top_k)
                or (req.top_p is not None and req.top_p < 1.0))

    def _slot_sampling(self, reqs=None):
        """(use_samp, per-slot (greedy, temperature, top_k, top_p)
        tensors) for the forwards; ``reqs``: explicit (slot, Request)
        pairs, default the active slot map."""
        cfg = self.cfg
        items = list(self._slot_req.items()) if reqs is None else reqs
        greedy = np.full((cfg.max_slots,), bool(cfg.greedy))
        temp = np.full((cfg.max_slots,), max(cfg.temperature, 1e-6),
                       np.float32)
        tk = np.zeros((cfg.max_slots,), np.int64)
        tp = np.ones((cfg.max_slots,), np.float32)
        use = False
        for slot, req in items:
            use = use or self._req_nondefault(req)
            greedy[slot] = self._req_greedy(req)
            if req.temperature is not None:
                temp[slot] = max(req.temperature, 1e-6)
            if req.top_k is not None:
                tk[slot] = req.top_k
            if req.top_p is not None:
                tp[slot] = req.top_p
        if not use:
            return False, None
        dev = self.device
        return True, (torch.as_tensor(greedy, device=dev),
                      torch.as_tensor(temp, device=dev),
                      torch.as_tensor(tk, device=dev),
                      torch.as_tensor(tp, device=dev))

    def _sample_rows(self, rows, samp, use_samp):
        """Next token per row of ``[slots, vocab]`` logits, on the device.
        Greedy is argmax over float32 logits (the first maximum, as
        ``jnp.argmax``); sampling draws from the engine's generator, so
        sampled tokens differ from the JAX engine's."""
        rows = rows.float()
        if use_samp:
            greedy_mask, temp, tk, tp = samp
            g = torch.argmax(rows, dim=-1)
            probs = torch.softmax(process_logits_batch(rows, temp, tk, tp),
                                  dim=-1)
            s = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            return torch.where(greedy_mask, g, s)
        if self.cfg.greedy:
            return torch.argmax(rows, dim=-1)
        probs = torch.softmax(rows / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    # ---------------- device programs ----------------
    def _block_tables(self):
        """A device copy of the pool's block table (None for contiguous
        caches). ``torch.tensor`` copies the host buffer, so a later
        ``alloc``/``free`` cannot reach work already queued."""
        if self.pool is None:
            return None
        return torch.tensor(self.pool.block_tables, device=self.device)

    def _layer_caches(self, bt, lens):
        """What the model takes as ``kv_caches``: the contiguous
        ``(ck, cv)`` pairs, or each layer's pool with the shared
        ``PagedState(bt, lens)``."""
        if bt is None:
            return self.caches
        state = PagedState(bt, lens.to(torch.int32))
        return [(c, state) for c in self.caches]

    def _prefill_chunk(self, ids, start, last_idx, samp, use_samp, bt):
        """THE prefill program: one ``[slots, C]`` chunk written into the
        live caches at per-slot offsets ``start`` (sentinel ``max_len``
        for slots not prefilling). Samples one token per slot from its
        ``last_idx`` row; only the final chunk's sample is used."""
        self.stats["prefill_chunk"] += 1
        C = ids.shape[1]
        pos = start[:, None] + torch.arange(C, dtype=start.dtype,
                                            device=start.device)
        logits, _ = self.model(ids, position_ids=pos,
                               kv_caches=self._layer_caches(bt, start),
                               cache_index=start)
        rows = logits[torch.arange(logits.shape[0], device=logits.device),
                      last_idx]
        return self._sample_rows(rows, samp, use_samp)

    def _bucket(self, n: int) -> int:
        """The smallest bucket that holds ``n`` tokens, else max_len."""
        i = bisect.bisect_left(self._buckets, n)
        return self._buckets[i] if i < len(self._buckets) \
            else self.cfg.max_len

    def _prefill_bucket(self, req: Request, seq, bucket: int):
        """THE legacy prefill program: ``seq`` (``req``'s prefill ids)
        padded to ``[1, bucket]``, one forward at the shared
        ``cache_index`` 0 into a fresh ``[1, bucket]`` contiguous cache.
        Samples the next token from row ``n - 1`` on the device; returns
        it and the filled cache."""
        self.stats["prefill_bucket"] += 1
        n = seq.size
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = seq
        one = self.model.init_kv_caches(1, bucket, dtype=self.cache_dtype)
        ids = torch.as_tensor(padded, device=self.device)
        logits, one = self.model(
            ids, position_ids=torch.arange(bucket, device=self.device)[None],
            kv_caches=one, cache_index=0)
        use_samp, samp = self._slot_sampling([(0, req)])
        if use_samp:  # [1] vectors: the request's own params
            samp = tuple(t[:1] for t in samp)
        return self._sample_rows(logits[:, n - 1], samp, use_samp)[0], one

    def _insert_contig(self, one, slot: int):
        """Copy a ``[1, bucket]`` prefill cache into ``slot``'s rows of
        every layer, padded with zero rows to max_len."""
        for (gk, gv), (ok, ov) in zip(self.caches, one):
            b = ok.shape[1]
            for dst, src in ((gk, ok), (gv, ov)):
                dst[slot, :b] = src[0]
                dst[slot, b:] = 0

    def _scatter_paged(self, one, slot: int):
        """Scatter a ``[1, bucket]`` prefill cache into the first ``bucket
        // page_size`` pages of ``slot``'s block table, head-major."""
        ps = self.cfg.page_size
        n_used = one[0][0].shape[1] // ps
        pages = torch.as_tensor(self.pool.block_tables[slot, :n_used],
                                dtype=torch.long, device=self.device)
        for cache, (ok, ov) in zip(self.caches, one):
            for dst, src in ((cache.k_pages, ok), (cache.v_pages, ov)):
                # [1, bucket, kvh, d] -> [kvh, n_used, ps, d]
                dst[:, pages] = src[0].reshape(
                    n_used, ps, *src.shape[2:]).permute(2, 0, 1, 3) \
                    .to(dst.dtype)

    def _decode_forward(self, toks, lens, samp, use_samp, bt):
        """One ``[slots, 1]`` decode forward at per-slot lengths ``lens``;
        returns the sampled next token per slot, on the device."""
        self.stats["decode_forwards"] += 1
        logits, _ = self.model(toks, position_ids=lens[:, None],
                               kv_caches=self._layer_caches(bt, lens),
                               cache_index=lens)
        return self._sample_rows(logits[:, -1, :], samp, use_samp)

    def _decode_chunk(self, toks, lens, active, budget, K, samp,
                      use_samp, bt):
        """K decode steps with the sampled token fed back on the device.
        A slot advances only while active and under its budget; frozen
        slots rewrite their own row with discarded values (inactive paged
        slots write the sink page). Returns the ``[K, slots]`` tokens,
        still on the device."""
        out = []
        for k in range(K):
            nxt = self._decode_forward(toks, lens, samp, use_samp, bt)
            advance = active & (k < budget)
            lens = lens + advance.to(lens.dtype)
            toks = torch.where(advance[:, None], nxt[:, None].to(toks.dtype),
                               toks)
            out.append(nxt)
        return torch.stack(out)

    def _verify_forward(self, ids, start, n_draft, samp, use_samp, bt):
        """THE speculative-decoding program: one ``[slots, S]`` forward
        (S = spec_k + 1) over each slot's last token and its drafts at
        rows ``start..start+S-1``, through the s > 1 branches the prefill
        chunk takes (slots not decoding carry the ``max_len`` sentinel).
        Every row's K/V is written; the host advances ``seq_lens`` past
        the accepted rows only. Greedy acceptance: draft j stands iff it
        equals the argmax after rows 0..j and every earlier draft stood.
        Row 0 of a sampling slot is sampled. Returns ``preds [slots, S]``
        and ``accepted [slots]``, on the device."""
        self.stats["verify_forwards"] += 1
        S = ids.shape[1]
        pos = start[:, None] + torch.arange(S, dtype=start.dtype,
                                            device=start.device)
        logits, _ = self.model(ids, position_ids=pos,
                               kv_caches=self._layer_caches(bt, start),
                               cache_index=start)
        preds = torch.argmax(logits.float(), dim=-1)
        match = (preds[:, :-1] == ids[:, 1:]) & (
            torch.arange(S - 1, device=ids.device)[None, :]
            < n_draft[:, None])
        accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
        if use_samp:
            preds[:, 0] = self._sample_rows(logits[:, 0], samp, use_samp)
        return preds, accepted

    def _copy_page(self, src: int, dst: int):
        """Copy-on-write's device copy: page ``src`` into ``dst`` in every
        layer's pool, an int8 pool's scale rows with it."""
        for cache in self.caches:
            for t in cache:
                if t is not None:
                    t[:, dst] = t[:, src]

    def _insert_prefix_contig(self, kblk, vblk, slot: int, start: int):
        """Copy one cached block (``[n_layers, B, kvh, d]`` per side, or
        ``QuantizedKV`` with its scale rows) into ``slot``'s contiguous
        rows ``start..start+B-1``: the contiguous prefix hit is a copy."""
        end = start + self._prefix_block
        for i, pair in enumerate(self.caches):
            for dst, blk in zip(pair, (kblk, vblk)):
                if isinstance(dst, QuantizedKV):
                    dst.q[slot, start:end] = blk.q[i]
                    dst.scale[slot, start:end] = blk.scale[i]
                else:
                    dst[slot, start:end] = blk[i]

    def _read_block_contig(self, slot: int, start: int):
        """A copy of one block of ``slot``'s rows from every layer, stacked
        ``[n_layers, B, kvh, d]`` per side (``QuantizedKV`` for int8
        caches): the store's entry for a new prefix block."""
        end = start + self._prefix_block

        def stack(side):
            rows = [pair[side] for pair in self.caches]
            if isinstance(rows[0], QuantizedKV):
                return QuantizedKV(
                    torch.stack([r.q[slot, start:end] for r in rows]),
                    torch.stack([r.scale[slot, start:end] for r in rows]))
            return torch.stack([r[slot, start:end] for r in rows])

        return stack(0), stack(1)

    # ---------------- prefix cache ----------------
    @staticmethod
    def _prefill_ids(req: Request) -> np.ndarray:
        """What admission prefills for ``req``: its prompt, and for a
        preempted request the tokens it has made too. Prefilling prompt +
        output samples the next token of the same greedy chain."""
        if req.output:
            return np.concatenate([req.prompt,
                                   np.asarray(req.output, np.int64)])
        return req.prompt

    def _match_prefix(self, req: Request, ids=None):
        """The longest cached block-aligned prefix of the request's
        prefill ids (``ids``, else ``_prefill_ids``), hashed in its
        namespace: (hashes, matched entries, prefix_len, full_cover). A
        sequence cached whole still recomputes its last token, so that
        prefill has a row to sample from (``full_cover``: that row lands
        inside the last matched block)."""
        if ids is None:
            ids = self._prefill_ids(req)
        if req._hashes is None:
            req._hashes = block_hashes(ids, self._prefix_block,
                                       namespace=request_namespace(req))
        matched = self._prefix.match(req._hashes)
        prefix_len = len(matched) * self._prefix_block
        full_cover = prefix_len >= ids.size
        if full_cover:
            prefix_len = ids.size - 1
        return req._hashes, matched, prefix_len, full_cover

    def _note_prefix(self, prefix_len: int, n: int):
        """Hit/miss counters of one admitted prompt of ``n`` tokens. A
        prompt shorter than a block can never hit and is not counted."""
        if n < self._prefix_block:
            return
        st = self.prefix_stats
        st["prompt_tokens"] += n
        if prefix_len > 0:
            st["hits"] += 1
            st["hit_tokens"] += prefix_len
        else:
            st["misses"] += 1

    def _evict_pages(self, n_pages: int,
                     prefer_ns: Optional[str] = None) -> int:
        """Free up to ``n_pages`` pool pages from store-only entries
        (LRU), namespace ``prefer_ns``'s first."""
        if self._prefix is None or self.pool is None:
            return 0
        freed = self._prefix.evict(self.pool, n_pages, prefer_ns=prefer_ns)
        self.prefix_stats["evictions"] += freed
        return freed

    def _cow_block(self, slot: int, block_idx: int) -> bool:
        """Copy-on-write the shared page at ``block_idx`` of ``slot``: a
        fresh page (evicting one if the free list is empty), the device
        copy, the block-table swap. False when no page can be had."""
        old = int(self.pool.block_tables[slot, block_idx])
        if self.pool.free_pages == 0 and not self._evict_pages(1):
            return False
        new = self.pool.cow(slot, block_idx)
        if new is None:
            return False
        self._copy_page(old, new)
        self.prefix_stats["cow_copies"] += 1
        return True

    def _cow_for_decode(self, k_steps: int):
        """Before a decode dispatch, and before its block table is
        uploaded: every page the next ``k_steps`` appends of an active
        slot can reach must be the slot's alone. A shared page (the store
        or another owner holds a reference) is copied first, so no decode
        write reaches a cached prefix. Reads the pool's own refcounts, so
        it catches sharing from any source."""
        if self._prefix is None or self.pool is None \
                or self.pool.shared_pages == 0:
            return
        ps = self.cfg.page_size
        for slot in range(self.cfg.max_slots):
            if not self.active[slot]:
                continue
            lo = int(self.seq_lens[slot]) // ps
            hi = (int(self.seq_lens[slot]) + max(k_steps, 1) - 1) // ps
            n_have = len(self.pool.pages_of[slot])
            for b_idx in range(lo, min(hi, n_have - 1) + 1):
                page = int(self.pool.block_tables[slot, b_idx])
                if self.pool.ref.get(page, 0) > 1 \
                        and not self._cow_block(slot, b_idx):
                    raise RuntimeError(
                        "copy-on-write needs a free page but the pool is "
                        "exhausted — size n_pages up")
        self._note_free_pages()

    def _paged_prefix_admit(self, slot: int, req: Request, need: int, ids):
        """Claim pages for ``req`` (prefilling ``ids``) in ``slot``,
        adopting the longest cached prefix's pages. Returns
        ``prefix_len`` (the tokens prefill skips), or None when the pool
        cannot fit the request even after eviction (the slot left clean).
        A full-cover hit copies the last adopted page before its
        recomputed row is written; when no page can be had for that copy,
        the last block is recomputed into a fresh page instead. Eviction
        spends the request's own namespace first."""
        pool = self.pool
        store = self._prefix
        shared: List[int] = []
        prefix_len, full_cover = 0, False
        if store is not None:
            _, shared, prefix_len, full_cover = self._match_prefix(req, ids)
        # feasibility first: a pool-blocked request retries every tick,
        # and must not pay adopt/release churn, a wasted copy or evictions
        # that cannot cover the shortfall
        required = pool.pages_needed(need) - len(shared)
        if full_cover and shared:
            required += 1  # the copy's private page
        supply = pool.free_pages
        if required > supply and store is not None:
            supply += store.evictable_pages(pool, exclude=shared)
            if full_cover and shared and pool.ref.get(shared[-1], 0) == 1:
                # the copy leaves the last shared page to the store alone,
                # and eviction can take it then
                supply += 1
        if required > supply:
            return None
        try:
            if shared:
                if not pool.adopt(slot, shared):
                    raise RuntimeError(
                        f"prefix share of {len(shared)} pages exceeds "
                        f"max_pages_per_slot={pool.max_pages_per_slot}")
                if full_cover and not self._cow_block(slot, len(shared) - 1):
                    pool.release(pool.pages_of[slot].pop())
                    pool.block_tables[slot, len(shared) - 1] = 0
                    prefix_len = (len(shared) - 1) * self.cfg.page_size
            if not pool.alloc(slot, need):
                missing = pool.pages_needed(need) - len(pool.pages_of[slot])
                self._evict_pages(missing - pool.free_pages,
                                  prefer_ns=request_namespace(req))
                if not pool.alloc(slot, need):
                    pool.free(slot)  # releases the adopted pages too
                    return None
            return prefix_len
        except BaseException:
            # the slot never joined the wave, so the wave's rollback will
            # not free it
            pool.free(slot)
            raise

    def _prefix_store_insert(self, slot: int, hashes: List[bytes],
                             n_matched: int, ns: str = ""):
        """Publish a prefilled sequence's full blocks under namespace
        ``ns``. Paged: the store takes a reference to each of the slot's
        pages (no copy; the prefill writes are already queued on the
        stream). Contiguous: copies of the blocks the store lacks, read
        from the slot's rows."""
        store = self._prefix
        if store is None or not hashes:
            return
        if self.pool is not None:
            for i, digest in enumerate(hashes):
                store.insert(digest, int(self.pool.block_tables[slot, i]),
                             self.pool, ns=ns)
            return
        for i in range(n_matched, len(hashes)):
            if hashes[i] not in store:
                k, v = self._read_block_contig(slot,
                                               i * self._prefix_block)
                store.insert(hashes[i], k, v, ns=ns, protect=hashes)
        self.prefix_stats["evictions"] = store.evictions

    # ---------------- admission ----------------
    def _admit_dispatch(self):
        """Queue the admission of waiting requests on the device, by the
        chunked path or the legacy bucketed one; returns the pending (req,
        slot, n_ctx, first_token) list for ``_admit_integrate``."""
        # the previous pass's verdict survives for the policy's
        # preemption window, which runs before this pass judges again
        self._pool_blocked_prev = self._pool_blocked
        self._pool_blocked = False
        if not self._queue:
            return []
        if self._chunk_len:
            return self._admit_dispatch_chunked()
        return self._admit_dispatch_bucketed()

    def _admit_dispatch_bucketed(self):
        """Legacy admission (``PT_FLAGS_prefill_chunk=0``): FIFO, one
        ``[1, bucket]`` prefill a request (prompt, plus the output of a
        preempted one), copied into the claimed slot (paged: the claim
        covers the whole bucket too, since the scatter writes ``bucket //
        page_size`` whole pages). When the pool cannot fit the head
        request the pass stops and it waits for a finisher; with nothing
        running it raises. A failure gives the request's slot and pages
        back, requeues it and integrates the requests admitted before it
        in this pass, then propagates."""
        pending = []
        while self._queue and self._free_heap:
            req = self._queue[0]
            slot = self._free_heap[0]  # claimed only on success
            ids = self._prefill_ids(req)
            n = ids.size
            bucket = self._bucket(n)
            need = max(n + req.max_new_tokens - len(req.output), bucket)
            if self.pool is not None and not self.pool.alloc(slot, need):
                if not self.active.any() and not pending:
                    raise RuntimeError(
                        f"request {req.rid} needs "
                        f"{self.pool.pages_needed(need)} pages but the pool "
                        f"has {self.pool.free_pages} free with no request "
                        "running — size n_pages up")
                self._pool_blocked = True
                break
            self._queue.popleft()
            heapq.heappop(self._free_heap)
            try:
                first, one = self._prefill_bucket(req, ids, bucket)
                if self.pool is not None:
                    self._scatter_paged(one, slot)
                else:
                    self._insert_contig(one, slot)
            except BaseException:
                heapq.heappush(self._free_heap, slot)
                if self.pool is not None:
                    self.pool.free(slot)
                self._queue.appendleft(req)
                self._note_free_pages()
                self._admit_integrate(pending)
                raise
            self.active[slot] = True
            req.slot = slot
            self._slot_req[slot] = req
            pending.append((req, slot, n, first))
        self._note_free_pages()
        return pending

    def _admit_dispatch_chunked(self):
        """Claim free slots (and, paged, pages, adopting cached prefixes)
        for queued requests and queue their chunked prefill on the device
        without a host sync. The order is FIFO, or the policy's
        (``set_scheduler``), whose preemption window runs first; a
        preempted request prefills its prompt and output. Returns the
        pending (req, slot, n_ctx, first_token) list for
        ``_admit_integrate``. When the pool cannot fit the picked request
        the wave stops there and it waits for a finisher; with nothing
        running that would be forever, so it raises. A failure rolls
        every claimed request back into the queue (and frees its pages)
        before propagating. Within one wave a request cannot hit the
        blocks of another request of the same wave: a wave publishes once
        its prefill has run."""
        B = self._prefix_block
        # [req, slot, cursor, prefix_len, hashes, n_matched, ids]
        jobs = []
        # rids preempted or claimed in this wave; the FIFO cursor
        skip = set()
        fifo_cursor = [None, 0]
        if self._sched is not None:
            # a preempted request must not take its own slot back
            skip.update(self._sched.before_admission(self) or ())
        try:
            while self._free_heap:
                req = self._pick_admission(skip, fifo_cursor)
                if req is None:
                    break
                slot = self._free_heap[0]
                ids = self._prefill_ids(req)
                prefix_len, hashes, n_matched = 0, [], 0
                if self.pool is not None:
                    # a replay's page need is its first admission's
                    need = ids.size + req.max_new_tokens - len(req.output)
                    prefix_len = self._paged_prefix_admit(slot, req, need,
                                                          ids)
                    if prefix_len is None:
                        if not jobs and not self.active.any():
                            raise RuntimeError(
                                f"request {req.rid} needs "
                                f"{self.pool.pages_needed(need)} pages but "
                                f"the pool has {self.pool.free_pages} free "
                                "with no request running — size n_pages up")
                        self._pool_blocked = True
                        break
                    hashes = req._hashes or []
                elif self._prefix is not None:
                    hashes, matched, prefix_len, _ = self._match_prefix(
                        req, ids)
                    n_matched = len(matched)
                    for i, (kb, vb) in enumerate(matched):
                        self._insert_prefix_contig(kb, vb, slot, i * B)
                # the head pops; a policy's mid-queue pick is removed by
                # identity
                if self._queue[0] is req:
                    self._queue.popleft()
                else:
                    self._queue.remove(req)
                if skip:
                    skip.add(req.rid)  # the cursor's snapshot still has it
                heapq.heappop(self._free_heap)
                self.active[slot] = True
                req.slot = slot
                self._slot_req[slot] = req
                if self._sched is not None:
                    self._sched.note_admit(self, req)
                jobs.append([req, slot, prefix_len, prefix_len, hashes,
                             n_matched, ids])
            self._note_free_pages()
            return self._drive_prefill_chunks(jobs)
        except BaseException:
            for req, slot, *_ in reversed(jobs):
                self.active[slot] = False
                self._slot_req.pop(slot, None)
                req.slot = None
                heapq.heappush(self._free_heap, slot)
                if self.pool is not None:
                    self.pool.free(slot)
                self._queue.appendleft(req)
            self._note_free_pages()
            raise

    def _note_free_pages(self):
        if self.pool is not None:
            self.stats["free_pages"] = self.pool.free_pages

    def _drive_prefill_chunks(self, jobs):
        """Host loop over the suffix chunks of a wave of claimed requests
        (each job's cursor starts at its prefix length): each iteration
        packs every still-prefilling request's next C tokens into one
        ``[slots, C]`` call. Then the wave's sequences publish their
        blocks and count their hits."""
        C = self._chunk_len
        cfg = self.cfg
        dev = self.device
        pending = []
        remaining = list(jobs)
        bt = self._block_tables()  # fixed for the wave: upload once
        use_samp, samp = self._slot_sampling(
            [(job[1], job[0]) for job in jobs])
        while remaining:
            ids = np.zeros((cfg.max_slots, C), np.int64)
            start = np.full((cfg.max_slots,), cfg.max_len, np.int64)
            last_idx = np.zeros((cfg.max_slots,), np.int64)
            finishing = []
            for job in remaining:
                slot, p, job_ids = job[1], job[2], job[6]
                take = min(C, job_ids.size - p)
                ids[slot, :take] = job_ids[p:p + take]
                start[slot] = p
                if p + take >= job_ids.size:
                    last_idx[slot] = job_ids.size - 1 - p
                    finishing.append(job)
                job[2] = p + take
            toks = self._prefill_chunk(
                torch.as_tensor(ids, device=dev),
                torch.as_tensor(start, device=dev),
                torch.as_tensor(last_idx, device=dev), samp, use_samp, bt)
            for job in finishing:
                pending.append((job[0], job[1], job[6].size,
                                toks[job[1]]))
            done = {job[1] for job in finishing}
            remaining = [job for job in remaining if job[1] not in done]
        if self._prefix is not None:
            for req, slot, _, prefix_len, hashes, n_matched, ids in jobs:
                self._prefix_store_insert(slot, hashes, n_matched,
                                          ns=request_namespace(req))
                self._note_prefix(prefix_len, ids.size)
        return pending

    def _admit_integrate(self, pending):
        """Sync each admitted request's first token (a scalar) and finish
        its bookkeeping; the sequence joins the next decode step. A
        preempted request's re-admission keeps its first TTFT and admit
        instant."""
        for req, slot, n_ctx, first_dev in pending:
            first = int(first_dev)
            if req.ttft_ms is None:
                now = time.perf_counter()
                req._admit_t = now
                req.ttft_ms = (now - req._submit_t) * 1e3
            req.output.append(first)
            self.seq_lens[slot] = n_ctx
            self.last_tok[slot] = first
            self._maybe_finish(slot, first)

    def _admit(self):
        """Blocking admission: dispatch, then integrate."""
        self._admit_integrate(self._admit_dispatch())

    # ---------------- finish / cancel ----------------
    def _release_slot(self, slot: int):
        """Return a slot to the free heap, and its pages to the pool; the
        one teardown path finish and cancel share."""
        self.active[slot] = False
        self.seq_lens[slot] = 0
        heapq.heappush(self._free_heap, slot)
        del self._slot_req[slot]
        if self.pool is not None:
            self.pool.free(slot)
            self._note_free_pages()

    def _finish(self, req: Request, reason: str):
        """Terminal bookkeeping of a request that has left the queue or
        its slot: the finish record and the accounting."""
        req.done = True
        self._finished[req.rid] = req
        self._finish_accounting(req, reason)

    def _slo_bucket(self, slo: str) -> Dict[str, int]:
        st = self.slo_stats.get(slo)
        if st is None:
            st = self.slo_stats[slo] = new_slo_bucket()
        return st

    def _tenant_bucket(self, tenant: Optional[str]) -> Dict[str, int]:
        """Cumulative counters of a tenant (``"-"`` = untagged), written
        at finish and preempt. The JAX bucket's ``failed`` and
        ``device_ms`` come with fault recovery and cost attribution."""
        key = tenant or "-"
        st = self.tenant_stats.get(key)
        if st is None:
            st = self.tenant_stats[key] = {
                "finished": 0, "cancelled": 0, "timeouts": 0, "tokens": 0,
                "slo_met": 0, "slo_violated": 0, "preemptions": 0}
        return st

    def _finish_accounting(self, req: Request, reason: str):
        """The finish reason, TPOT (mean decode latency from the first
        admission), SLO attainment and the tenant's counters. A timeout
        is a violation whatever its TTFT was; a cancel is counted apart,
        never as a violation."""
        now = time.perf_counter()
        req.finish_reason = reason
        n_decode = len(req.output) - 1  # the first token is in the TTFT
        if req._admit_t and n_decode > 0:
            req.tpot_ms = (now - req._admit_t) * 1e3 / n_decode
        tst = self._tenant_bucket(req.tenant)
        tst["tokens"] += len(req.output)
        if reason == "cancel":
            tst["cancelled"] += 1
        elif reason == "timeout":
            tst["timeouts"] += 1
        else:
            tst["finished"] += 1
        if req.slo is None:
            return
        st = self._slo_bucket(req.slo)
        if reason == "cancel":
            st["cancelled"] += 1
            return
        if reason == "timeout":
            req.slo_met = False
            st["violated"] += 1
            st["timeouts"] += 1
            tst["slo_violated"] += 1
            st["total_tokens"] += len(req.output)
            return
        ttft_ok = (req.ttft_target_ms is None
                   or (req.ttft_ms is not None
                       and req.ttft_ms <= req.ttft_target_ms))
        tpot_ok = (req.tpot_target_ms is None or req.tpot_ms is None
                   or req.tpot_ms <= req.tpot_target_ms)
        req.slo_met = ttft_ok and tpot_ok
        st["met" if req.slo_met else "violated"] += 1
        tst["slo_met" if req.slo_met else "slo_violated"] += 1
        if not ttft_ok:
            st["ttft_violations"] += 1
        if not tpot_ok:
            st["tpot_violations"] += 1
        st["total_tokens"] += len(req.output)
        if req.slo_met:
            st["met_tokens"] += len(req.output)

    def _maybe_finish(self, slot: int, tok: int):
        req = self._slot_req.get(slot)
        if req is None:
            return
        if req.eos_token_id is not None and tok == req.eos_token_id:
            reason = "eos"
        elif len(req.output) >= req.max_new_tokens:
            reason = "max_new_tokens"
        elif self.seq_lens[slot] + 1 >= self.cfg.max_len:
            reason = "max_len"
        else:
            return
        self._release_slot(slot)
        self._finish(req, reason)

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or active request; False for unknown or
        finished ids. An active request's slot and pages are freed at
        once: tokens an in-flight chunk still computes for it are
        discarded. Scheduler thread only (the front door defers a
        client's cancel to its engine thread)."""
        # a snapshot, then removal by identity: producers may append
        req = next((r for r in list(self._queue) if r.rid == request_id),
                   None)
        if req is not None:
            try:
                self._queue.remove(req)
            except ValueError:
                req = None
        if req is None:
            slot = next((s for s, r in self._slot_req.items()
                         if r.rid == request_id), None)
            if slot is None:
                return False
            req = self._slot_req[slot]
            self._release_slot(slot)
        req.cancelled = True
        self._finish(req, "cancel")
        return True

    def _expire_deadlines(self):
        """Finish every request past its deadline with ``"timeout"``: a
        queued one leaves the queue, an active one gives its slot and
        pages back through the one teardown path. Checked once a tick,
        the granularity ``build_request`` holds deadlines to."""
        now = time.perf_counter()
        for req in list(self._queue):
            if req._deadline_t and now >= req._deadline_t:
                try:
                    self._queue.remove(req)
                except ValueError:
                    continue
                self._finish(req, "timeout")
        for slot in range(self.cfg.max_slots):
            if not self.active[slot]:
                continue
            req = self._slot_req[slot]
            if req._deadline_t and now >= req._deadline_t:
                self._release_slot(slot)
                self._finish(req, "timeout")

    # ---------------- scheduler ticks ----------------
    def step(self) -> bool:
        """Admit waiting requests, then one decode step for every active
        slot, or one verify pass when speculative decoding is on and any
        slot drafted. Returns False when there is nothing left to do."""
        self._expire_deadlines()
        self._admit()
        if not self.active.any():
            return bool(self._queue)
        if self._spec_mode != "off":
            drafts = self._propose_drafts()
            if drafts:
                return self._spec_step(drafts)
            self.spec_stats["fallback_steps"] += 1
        self._cow_for_decode(1)
        use_samp, samp = self._slot_sampling()
        dev = self.device
        toks = torch.as_tensor(self.last_tok[:, None], device=dev)
        lens = torch.as_tensor(self.seq_lens, device=dev)
        nxt = self._decode_forward(toks, lens, samp, use_samp,
                                   self._block_tables()).cpu().numpy()
        for slot in range(self.cfg.max_slots):
            if not self.active[slot]:
                continue
            tok = int(nxt[slot])
            self._slot_req[slot].output.append(tok)
            self.seq_lens[slot] += 1
            self.last_tok[slot] = tok
            self._maybe_finish(slot, tok)
        return True

    # ---------------- speculative decoding ----------------
    def _draft_budget(self, slot: int) -> int:
        """The most drafts ``slot`` may carry in a verify pass, 0 when it
        may not draft: it must decode greedily, have room for a draft and
        the bonus token, and (``auto``) not have proven undraftable (16
        proposed tokens at under 1/8 accepted)."""
        req = self._slot_req[slot]
        if not self._req_greedy(req):
            return 0
        remaining = min(req.max_new_tokens - len(req.output),
                        self.cfg.max_len - 1 - int(self.seq_lens[slot]))
        max_d = min(self.cfg.spec_k, remaining - 1)
        if max_d <= 0:
            return 0
        if self._spec_mode == "auto" and req._spec_proposed >= 16 \
                and req._spec_accepted * 8 < req._spec_proposed:
            return 0
        return max_d

    def _propose_drafts(self) -> Dict[int, np.ndarray]:
        """slot -> proposed tokens (1..spec_k) of every eligible active
        slot whose drafter proposes."""
        out: Dict[int, np.ndarray] = {}
        for slot in range(self.cfg.max_slots):
            if not self.active[slot]:
                continue
            max_d = self._draft_budget(slot)
            if max_d <= 0:
                continue
            req = self._slot_req[slot]
            hist = np.concatenate([req.prompt,
                                   np.asarray(req.output, np.int64)])
            d = np.asarray(self._drafter.propose(hist, max_d)).reshape(-1)
            if d.size:
                out[slot] = d[:max_d]
        return out

    def _spec_step(self, drafts: Dict[int, np.ndarray]) -> bool:
        """One verify pass over every active slot (slots without drafts
        decode one token in it), admission queued behind it, then one
        sync and each slot advanced by ``accepted + 1`` tokens. Leaving
        ``seq_lens`` short of the rejected rows is the whole rollback. The
        copy-on-write guard covers the whole ``spec_k + 1`` window, pad
        rows included, before the block table is uploaded."""
        cfg = self.cfg
        S = cfg.spec_k + 1
        # the pass's occupants: admission behind it may re-fill a slot
        chunk_reqs = {s: self._slot_req[s]
                      for s in range(cfg.max_slots) if self.active[s]}
        self._cow_for_decode(S)
        ids = np.zeros((cfg.max_slots, S), np.int64)
        start = np.full((cfg.max_slots,), cfg.max_len, np.int64)
        n_draft = np.zeros((cfg.max_slots,), np.int64)
        for slot in chunk_reqs:
            ids[slot, 0] = self.last_tok[slot]
            d = drafts.get(slot)
            if d is not None and d.size:
                ids[slot, 1:1 + d.size] = d
                n_draft[slot] = d.size
            start[slot] = self.seq_lens[slot]
        use_samp, samp = self._slot_sampling()
        dev = self.device
        preds, accepted = self._verify_forward(
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(n_draft, device=dev), samp, use_samp,
            self._block_tables())
        pending = self._admit_dispatch()
        preds_np = preds.cpu().numpy()  # one sync for S tokens a slot
        acc_np = accepted.cpu().numpy()
        st = self.spec_stats
        for slot, req in chunk_reqs.items():
            if self._slot_req.get(slot) is not req:
                continue
            n = int(n_draft[slot])
            a = min(int(acc_np[slot]), n)
            for tok in [int(t) for t in ids[slot, 1:1 + a]] \
                    + [int(preds_np[slot, a])]:
                if req.done:
                    break  # eos inside the chain: the rest is dropped
                req.output.append(tok)
                self.seq_lens[slot] += 1
                self.last_tok[slot] = tok
                st["emitted"] += 1
                self._maybe_finish(slot, tok)
            if n:
                req._spec_proposed += n
                req._spec_accepted += a
                st["proposed"] += n
                st["accepted"] += a
        st["verify_calls"] += 1
        self._admit_integrate(pending)
        return True

    def _slot_budgets(self) -> np.ndarray:
        """Per-slot remaining token budget (max_new_tokens and max_len
        caps); frozen slots stop advancing inside the chunk. The policy's
        ``slot_caps`` may lower it slot by slot (what a slot commits,
        not what the chunk computes); caps that would freeze every
        active slot are ignored, since such a chunk would emit nothing."""
        budget = np.zeros((self.cfg.max_slots,), np.int64)
        for slot, req in self._slot_req.items():
            budget[slot] = max(0, min(
                req.max_new_tokens - len(req.output),
                self.cfg.max_len - 1 - int(self.seq_lens[slot])))
        if self._sched is not None:
            caps = self._sched.slot_caps(self)
            if caps is not None:
                capped = np.minimum(budget, np.asarray(caps, np.int64))
                if capped.max(initial=0) > 0 or budget.max(initial=0) == 0:
                    budget = capped
        return budget

    def step_chunk(self, max_chunk: int = 8) -> bool:
        """``max_chunk`` decode steps with one host sync, with admission
        queued on the device behind the in-flight chunk: newly admitted
        slots join the next chunk. Expired deadlines are enforced
        first."""
        self._expire_deadlines()
        if not self.active.any():
            self._admit()
            if not self.active.any():
                return bool(self._queue)
        if self._spec_mode != "off":
            # a verify pass emits one token for a slot without drafts
            # against the chunk's K, so it takes over the chunk only when
            # at least half the active slots draft (the cheap eligibility
            # count first, the drafter's scan only if it can pass)
            n_active = int(self.active.sum())
            eligible = sum(1 for s in range(self.cfg.max_slots)
                           if self.active[s] and self._draft_budget(s) > 0)
            drafts = (self._propose_drafts() if 2 * eligible >= n_active
                      else {})
            if drafts and 2 * len(drafts) >= n_active:
                return self._spec_step(drafts)
            self.spec_stats["fallback_steps"] += 1
        K = max_chunk
        chunk_slots = self.active.copy()
        chunk_reqs = {s: self._slot_req[s]
                      for s in range(self.cfg.max_slots) if chunk_slots[s]}
        self._cow_for_decode(K)
        budget = self._slot_budgets()
        use_samp, samp = self._slot_sampling()
        dev = self.device
        toks_all = self._decode_chunk(
            torch.as_tensor(self.last_tok[:, None], device=dev),
            torch.as_tensor(self.seq_lens, device=dev),
            torch.as_tensor(chunk_slots, device=dev),
            torch.as_tensor(budget, device=dev), K, samp, use_samp,
            self._block_tables())
        pending = self._admit_dispatch()
        toks_np = toks_all.cpu().numpy()  # one sync for K tokens
        for k in range(K):
            for slot in range(self.cfg.max_slots):
                # the slot advances only while its chunk-time occupant
                # still owns it (not finished at an earlier k, not
                # cancelled)
                req = chunk_reqs.get(slot)
                if (req is None or k >= budget[slot]
                        or self._slot_req.get(slot) is not req):
                    continue
                tok = int(toks_np[k, slot])
                req.output.append(tok)
                self.seq_lens[slot] += 1
                self.last_tok[slot] = tok
                self._maybe_finish(slot, tok)
        self._admit_integrate(pending)
        return True

    def step_adaptive(self, max_chunk: int = 8,
                      probe_chunk: int = 2) -> bool:
        """``step_chunk`` whose length follows the load: ``probe_chunk``
        steps while requests wait and a slot is free, or an active slot's
        budget ends inside a full chunk (admission can come soon, and a
        short chunk reaches it sooner); ``max_chunk`` otherwise. The JAX
        engine's third branch, the degradation ladder's throttle, comes
        with the resilience slice."""
        k = max_chunk
        if self._queue:
            if not self.active.all():
                k = min(probe_chunk, max_chunk)
            else:
                budgets = self._slot_budgets()
                soonest = min((budgets[s] for s in range(self.cfg.max_slots)
                               if self.active[s]), default=max_chunk + 1)
                if soonest <= max_chunk:
                    k = min(probe_chunk, max_chunk)
        return self.step_chunk(k)

    def run(self, prompts: Sequence, max_new_tokens: int = 32,
            eos_token_id: Optional[int] = None,
            max_chunk: int = 8) -> List[Request]:
        """Submit all prompts, drive ``step_chunk`` until every request
        finishes, and return the Requests in submission order."""
        rids = [self.add_request(p, max_new_tokens, eos_token_id)
                for p in prompts]
        while self.step_chunk(max_chunk) or self._queue or \
                self.active.any():
            pass
        return [self._finished[r] for r in rids]

    # ---------------- readers ----------------
    def prefix_snapshot(self) -> dict:
        """Prefix-cache counters, with ``enabled``, ``cached_blocks`` and
        ``hit_rate_tokens`` (the JAX engine's keys)."""
        st = dict(self.prefix_stats)
        st["enabled"] = self._prefix is not None
        st["cached_blocks"] = (self._prefix.cached_pages
                               if self._prefix is not None else 0)
        tot = st["prompt_tokens"]
        st["hit_rate_tokens"] = st["hit_tokens"] / tot if tot else 0.0
        return st

    def spec_snapshot(self) -> dict:
        """Speculative-decoding counters, with ``enabled``, ``mode``,
        ``k`` and ``acceptance_rate`` (the JAX engine's keys)."""
        st = dict(self.spec_stats)
        st["enabled"] = self._spec_mode != "off"
        st["mode"] = self._spec_mode
        st["k"] = self.cfg.spec_k
        st["acceptance_rate"] = (st["accepted"] / st["proposed"]
                                 if st["proposed"] else 0.0)
        return st

    def slo_snapshot(self) -> dict:
        """SLO attainment per class and overall goodput: met / (met +
        violated) over SLO-tracked finishes (None before any); cancels
        are counted apart. Safe from another thread (copies)."""
        classes = {}
        met = violated = 0
        for cls, st in list(self.slo_stats.items()):
            d = dict(st)
            tracked = d["met"] + d["violated"]
            d["goodput"] = d["met"] / tracked if tracked else None
            classes[cls] = d
            met += d["met"]
            violated += d["violated"]
        tracked = met + violated
        return {"classes": classes, "met": met, "violated": violated,
                "goodput": met / tracked if tracked else None}

    def tenant_snapshot(self) -> dict:
        """Per tenant (``"-"`` = untagged): the cumulative counters joined
        with live usage (active slots, held pages, queued requests), and
        the scheduler's policy name and preemption count."""
        tenants: Dict[str, dict] = {}

        def bucket(key):
            d = tenants.get(key)
            if d is None:
                d = tenants[key] = {"active_slots": 0, "pages": 0,
                                    "queued": 0}
            return d

        for key, st in list(self.tenant_stats.items()):
            bucket(key).update(st)
        for slot, req in list(self._slot_req.items()):
            d = bucket(req.tenant or "-")
            d["active_slots"] += 1
            if self.pool is not None:
                d["pages"] += len(self.pool.pages_of[slot])
        for req in list(self._queue):
            bucket(req.tenant or "-")["queued"] += 1
        return {"tenants": tenants, "scheduler": dict(self.sched_stats)}

    def slo_window_reset(self):
        """Zero the SLO counters: one window per load step."""
        self.slo_stats = {}

    def backpressure(self) -> dict:
        """Admission readiness for ``/healthz``: queue depth, free slots
        (and pages), and ``saturated`` when requests wait with no free
        slot or behind a pool-blocked admission pass. ``draining`` and
        ``degraded`` stay False and the level 0 until the resilience
        slice brings drain and the degradation ladder."""
        qd = len(self._queue)
        free = len(self._free_heap)
        out = {"queue_depth": qd, "free_slots": free,
               "occupancy": float(self.active.sum()) / self.cfg.max_slots,
               "saturated": qd > 0 and (free == 0 or self._pool_blocked),
               "draining": False, "degraded": False,
               "degradation_level": 0}
        if self.pool is not None:
            out["free_pages"] = self.pool.free_pages
            out["pool_blocked"] = self._pool_blocked
        return out

    def prefix_affinity_tokens(self, hashes: List[bytes]) -> int:
        """How many leading tokens of a block-hash chain this engine's
        prefix store holds, without refreshing its LRU order (0 with the
        store off): the router's affinity probe."""
        if self._prefix is None:
            return 0
        return self._prefix.match_len(hashes) * self._prefix_block

    def metrics_window_reset(self):
        """Reset the telemetry windows. The port has no telemetry yet (the
        JAX engine with ``PT_FLAGS_telemetry=off``), so there is nothing
        to reset; the cumulative host counters keep running."""

    def metrics_snapshot(self) -> dict:
        """The one serving document, as the JAX engine gives it with
        telemetry off: ``{"telemetry": "off", "slots", "prefix_cache",
        "spec_decode", "slo", "tenants"}``. The observability and
        resilience slices add their sub-documents."""
        return {"telemetry": "off",
                "slots": {"active": int(self.active.sum()),
                          "max": self.cfg.max_slots},
                "prefix_cache": self.prefix_snapshot(),
                "spec_decode": self.spec_snapshot(),
                "slo": self.slo_snapshot(),
                "tenants": self.tenant_snapshot()}
