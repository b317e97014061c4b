"""OpenAI-style wire shapes of the serving front door (counterpart of
``paddle_tpu/serving_api/protocol.py``).

The front door speaks the ``/v1/completions`` request and response
shapes. The repo ships no tokenizer, so ``prompt`` is an array of token
ids and every response carries the generated ids in
``choices[0].token_ids`` beside a space-joined ``text``. SSE chunks are
``data: {json}\\n\\n`` frames ending in ``data: [DONE]``; errors are
``{"error": {"message", "type"}}``.

Parsing and formatting only: no engine, no threads.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class ProtocolError(ValueError):
    """A malformed request; ``status`` is the HTTP code to answer."""

    def __init__(self, status: int, message: str):
        self.status = int(status)
        super().__init__(message)


# the request fields the parser knows; any other is rejected (a typo such
# as "max_new_tokens" must not silently serve 16 tokens)
_KNOWN_FIELDS = {
    "model", "prompt", "max_tokens", "stream", "temperature", "top_k",
    "top_p", "greedy", "eos_token_id", "stop", "tenant", "slo",
    "ttft_target_ms", "tpot_target_ms", "deadline_ms", "user", "n",
    "echo",
}


@dataclass
class CompletionRequest:
    """A validated ``/v1/completions`` body, mapped onto
    ``engine.add_request`` keyword for keyword."""

    prompt: np.ndarray = field(default_factory=lambda: np.zeros(0))
    max_tokens: int = 16
    stream: bool = False
    echo: bool = False
    model: str = ""
    tenant: Optional[str] = None
    slo: Optional[str] = None
    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: Optional[bool] = None
    eos_token_id: Optional[int] = None

    def engine_kwargs(self) -> dict:
        """The ``add_request`` keywords (the transport fields stream,
        echo and model stay behind)."""
        return {
            "max_new_tokens": self.max_tokens,
            "eos_token_id": self.eos_token_id,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "greedy": self.greedy,
            "tenant": self.tenant,
            "slo": self.slo,
            "ttft_target_ms": self.ttft_target_ms,
            "tpot_target_ms": self.tpot_target_ms,
            "deadline_ms": self.deadline_ms,
        }


def _opt_num(body: dict, key: str, kind=float):
    val = body.get(key)
    if val is None:
        return None
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise ProtocolError(400, f"{key} must be a number; got {val!r}")
    return kind(val)


def parse_completion_request(body) -> CompletionRequest:
    """Validate a decoded ``/v1/completions`` JSON body. Shape errors
    raise :class:`ProtocolError` (HTTP 400); value errors (a bad
    temperature, an unknown slo class, a malformed tenant) are left to
    ``build_request``, so the API and the library raise the same ones."""
    if not isinstance(body, dict):
        raise ProtocolError(400, "request body must be a JSON object")
    unknown = sorted(set(body) - _KNOWN_FIELDS)
    if unknown:
        raise ProtocolError(
            400, f"unknown request field(s) {unknown}; supported: "
            f"{sorted(_KNOWN_FIELDS)}")
    if body.get("n", 1) not in (1, None):
        raise ProtocolError(400, "n > 1 is not supported")
    if body.get("stop") not in (None, [], ()):
        raise ProtocolError(
            400, "stop sequences are not supported — pass "
            "eos_token_id (token-level engine)")
    prompt = body.get("prompt")
    if isinstance(prompt, (int, np.integer)) \
            and not isinstance(prompt, bool):
        prompt = [prompt]
    if not isinstance(prompt, (list, tuple)) or not prompt or not all(
            isinstance(t, (int, np.integer))
            and not isinstance(t, bool) for t in prompt):
        raise ProtocolError(
            400, "prompt must be a non-empty array of token ids "
            "(this deployment serves token-level requests; there is "
            "no tokenizer)")
    max_tokens = body.get("max_tokens", 16)
    if isinstance(max_tokens, bool) or not isinstance(max_tokens, int) \
            or max_tokens < 1:
        raise ProtocolError(
            400, f"max_tokens must be a positive int; got {max_tokens!r}")
    for key in ("stream", "echo", "greedy"):
        if key in body and body[key] is not None \
                and not isinstance(body[key], bool):
            raise ProtocolError(400, f"{key} must be a boolean")
    for key in ("tenant", "slo", "model"):
        if key in body and body[key] is not None \
                and not isinstance(body[key], str):
            raise ProtocolError(400, f"{key} must be a string")
    eos = body.get("eos_token_id")
    if eos is not None and (isinstance(eos, bool)
                            or not isinstance(eos, int)):
        raise ProtocolError(400, "eos_token_id must be an int")
    top_k = body.get("top_k")
    if top_k is not None and (isinstance(top_k, bool)
                              or not isinstance(top_k, int)):
        raise ProtocolError(400, "top_k must be an int")
    return CompletionRequest(
        prompt=np.asarray(prompt, np.int64),
        max_tokens=max_tokens,
        stream=bool(body.get("stream", False)),
        echo=bool(body.get("echo", False)),
        model=body.get("model") or "",
        tenant=body.get("tenant"),
        slo=body.get("slo"),
        ttft_target_ms=_opt_num(body, "ttft_target_ms"),
        tpot_target_ms=_opt_num(body, "tpot_target_ms"),
        deadline_ms=_opt_num(body, "deadline_ms"),
        temperature=_opt_num(body, "temperature"),
        top_k=top_k,
        top_p=_opt_num(body, "top_p"),
        greedy=body.get("greedy"),
        eos_token_id=eos,
    )


def render_text(tokens: List[int]) -> str:
    """The tokenizer-less ``text``: space-joined token ids."""
    return " ".join(str(int(t)) for t in tokens)


def completion_chunk(cid: str, model: str, tokens: List[int],
                     finish_reason: Optional[str] = None) -> dict:
    """One SSE chunk: the tokens committed since the previous chunk (a
    verify pass's accepted drafts arrive as one multi-token delta)."""
    return {
        "id": cid,
        "object": "text_completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": render_text(tokens),
            "token_ids": [int(t) for t in tokens],
            "finish_reason": finish_reason,
        }],
    }


def completion_response(cid: str, model: str, tokens: List[int],
                        finish_reason: Optional[str],
                        prompt_tokens: int,
                        echo_tokens: Optional[List[int]] = None) -> dict:
    """The non-streaming (aggregate) completion body."""
    ids = ([int(t) for t in echo_tokens] if echo_tokens else []) \
        + [int(t) for t in tokens]
    return {
        "id": cid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": render_text(ids),
            "token_ids": ids,
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": int(prompt_tokens),
            "completion_tokens": len(tokens),
            "total_tokens": int(prompt_tokens) + len(tokens),
        },
    }


def error_body(message: str, etype: str = "invalid_request_error") -> bytes:
    return json.dumps(
        {"error": {"message": str(message), "type": etype}}).encode()


def models_payload(model_id: str) -> dict:
    return {
        "object": "list",
        "data": [{
            "id": model_id,
            "object": "model",
            "owned_by": "paddle_tpu_torch",
        }],
    }


def sse_data(obj: dict) -> bytes:
    """One server-sent-event frame."""
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"
