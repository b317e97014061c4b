"""Streaming HTTP front door of the continuous-batching engine
(counterpart of ``paddle_tpu/serving_api/server.py``).

A stdlib threaded HTTP server with OpenAI-style ``POST /v1/completions``
(server-sent-event token streaming, or one aggregate JSON body),
``GET /v1/models`` and ``GET /healthz`` (200, or 503 while the engine's
``backpressure()`` reports it saturated).

Threads: ONE engine thread owns the engine. It ticks ``step_chunk`` (the
chunk length from the scheduler policy), applies deferred cancels and
flushes newly committed tokens into per-request stream queues; nothing
else touches scheduler state. HTTP handler threads only submit (through
``add_request``, which is safe from producer threads) and read their
stream queue. A client that disconnects mid-stream shows as a failed
socket write; the handler defers ``cancel(rid)`` to the engine thread, which
frees the slot and pages through the engine's one teardown path. If the
engine thread dies, every open stream gets the error and the exception
is raised on in that thread.

CUDA's current device and autograd's grad mode are per thread: the
engine thread selects the engine's device and runs under
``torch.no_grad()``.

The target is a ``ContinuousBatchingEngine``; a router target comes with
the port of ``inference/router.py``. ``/metrics``, ``/trace`` and
``/timeline`` answer 404 until the observability slice.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
from typing import Dict, Optional

import torch

from .. import flags
from ..inference.serving import ContinuousBatchingEngine
from . import protocol
from .scheduler import default_scheduler

# what a stream queue carries
_TOKENS, _DONE, _ERROR = "tokens", "done", "error"

# endpoints of the JAX front door that come with the observability slice
_LATER = ("/metrics", "/trace", "/timeline")


class _Stream:
    """Engine thread (producer) to one handler thread (consumer): token
    deltas, then one terminal item. ``sent`` (how much of
    ``req.output`` was pushed) is the engine thread's own."""

    __slots__ = ("q", "sent")

    def __init__(self):
        self.q: "queue.Queue" = queue.Queue()
        self.sent = 0

    def push_tokens(self, toks):
        self.q.put((_TOKENS, toks))

    def finish(self, reason: Optional[str], meta: dict):
        self.q.put((_DONE, reason, meta))

    def error(self, message: str):
        self.q.put((_ERROR, message))


def healthz(engine) -> tuple:
    """``/healthz``: ``(status, body, content type)``; 503 while the
    engine is saturated (requests wait and no slot, or no page, can take
    them)."""
    bp = engine.backpressure()
    payload = {"status": "ok", "telemetry": False, "backpressure": bp,
               "engine": engine.metrics_snapshot(),
               "degraded": bool(bp["degraded"]),
               "degradation_level": int(bp["degradation_level"])}
    code = 200
    if bp["saturated"]:
        payload["status"] = "saturated"
        code = 503
    return (code, json.dumps(payload, default=str).encode(),
            "application/json")


class ServingFrontDoor:
    """The engine thread and the rid -> stream registry over one
    engine."""

    def __init__(self, target, scheduler=None, max_chunk: int = 8,
                 model_id: str = "paddle-tpu"):
        if not isinstance(target, ContinuousBatchingEngine):
            raise TypeError(
                "the front door serves a ContinuousBatchingEngine; got "
                f"{type(target).__name__} (a router target comes with "
                "the port of inference/router.py)")
        self.target = target
        self.model_id = model_id
        self.max_chunk = int(max_chunk)
        self._sched = scheduler
        if scheduler is not None:
            target.set_scheduler(scheduler)
        # the engine thread's CUDA device: the engine's
        self._cuda_index = None
        if target.device.type == "cuda":
            self._cuda_index = (target.device.index
                                if target.device.index is not None
                                else torch.cuda.current_device())
        self._streams: Dict[int, _Stream] = {}
        self._streams_lock = threading.Lock()
        # distinct tenants admitted (PT_FLAGS_api_max_tenants caps them);
        # the lock makes check and reserve one step across handlers
        self._tenants_seen: set = set()
        self._tenant_lock = threading.Lock()
        # cancels for the engine thread (engine.cancel is scheduler-thread
        # only)
        self._cancels: "collections.deque" = collections.deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._dead: Optional[str] = None
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="pt-api-engine")
        self._thread.start()

    # ---------------- handler threads ----------------
    def submit(self, creq: "protocol.CompletionRequest"):
        """Validate and queue one request; returns ``(rid, stream)``. The
        stream registers after the submit and catches up from
        ``output[0]``, so no token is lost in between."""
        if self._dead is not None:
            raise RuntimeError(f"the serving engine thread died: {self._dead}")
        reserved = False
        if creq.tenant is not None:
            with self._tenant_lock:
                if creq.tenant not in self._tenants_seen:
                    cap = int(flags.flag("api_max_tenants"))
                    if len(self._tenants_seen) >= cap:
                        raise protocol.ProtocolError(
                            429, f"tenant cardinality cap reached ({cap} "
                            "distinct tenants; PT_FLAGS_api_max_tenants) "
                            "— new tenant ids are rejected to bound "
                            "per-tenant accounting state")
                    self._tenants_seen.add(creq.tenant)
                    reserved = True
        try:
            rid = self.target.add_request(creq.prompt,
                                          **creq.engine_kwargs())
        except BaseException:
            if reserved:
                # a rejected request must not spend a place under the cap
                with self._tenant_lock:
                    self._tenants_seen.discard(creq.tenant)
            raise
        stream = _Stream()
        with self._streams_lock:
            self._streams[rid] = stream
        self._wake.set()
        return rid, stream

    def defer_cancel(self, rid: int):
        """Cancel from a handler thread (a client disconnect): the engine
        thread applies it at its next tick."""
        self._cancels.append(rid)
        self._wake.set()

    # ---------------- the engine thread ----------------
    def _tick(self) -> bool:
        k = self.max_chunk
        if self._sched is not None:
            k = self._sched.chunk_len(self.target, self.max_chunk)
        return self.target.step_chunk(k)

    def _request_index(self) -> Dict[int, object]:
        """rid -> queued, active or finished request, once a flush."""
        eng = self.target
        idx: Dict[int, object] = {}
        for req in list(eng._queue):
            idx[req.rid] = req
        for req in list(eng._slot_req.values()):
            idx[req.rid] = req
        idx.update(eng._finished)
        return idx

    def _flush_streams(self):
        with self._streams_lock:
            items = list(self._streams.items())
        if not items:
            return
        index = self._request_index()
        for rid, st in items:
            req = index.get(rid)
            if req is None:
                continue
            out = req.output
            if len(out) > st.sent:
                st.push_tokens([int(t) for t in out[st.sent:]])
                st.sent = len(out)
            if req.done:
                st.finish(req.finish_reason, {
                    "prompt_tokens": int(req.prompt.size),
                    "completion_tokens": len(out),
                    "ttft_ms": req.ttft_ms,
                    "tpot_ms": req.tpot_ms,
                    "slo_met": req.slo_met,
                })
                with self._streams_lock:
                    self._streams.pop(rid, None)
                # reap: a server must not keep every served request (the
                # accounting landed at finish)
                self.target._finished.pop(rid, None)

    def _apply_cancels(self):
        while self._cancels:
            # the cancel marks the request done: the flush then delivers
            # the terminal item to a waiting handler
            self.target.cancel(self._cancels.popleft())

    def _drive(self):
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            with torch.no_grad():
                while not self._stop.is_set():
                    self._apply_cancels()
                    busy = self._tick()
                    self._flush_streams()
                    if not busy and not self._cancels:
                        # idle until a submit or cancel; the timeout keeps
                        # deadlines of queued requests expiring
                        self._wake.wait(timeout=0.02)
                        self._wake.clear()
        except BaseException as e:
            self._dead = f"{type(e).__name__}: {e}"
            with self._streams_lock:
                streams, self._streams = dict(self._streams), {}
            for st in streams.values():
                st.error(self._dead)
            raise

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
        with self._streams_lock:
            streams, self._streams = dict(self._streams), {}
        for st in streams.values():
            st.error("server shutting down")


class ServingAPIServer:
    """A running front door: ``url`` of the bound port, and an idempotent
    ``shutdown()`` that joins the engine thread, stops the listener and closes
    its socket. Also a context manager."""

    def __init__(self, server, thread, front_door):
        self._server = server
        self._thread = thread
        self.front_door = front_door
        self._closed = False

    @property
    def server_address(self):
        return self._server.server_address

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        self.front_door.shutdown()
        self._server.shutdown()
        self._thread.join(timeout=10)
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def start_api_server(target, host: str = "127.0.0.1", port: int = 0,
                     scheduler="auto", max_chunk: int = 8,
                     model_id: str = "paddle-tpu"):
    """Serve the OpenAI-style streaming API over ``target`` (a
    ``ContinuousBatchingEngine``) on daemon threads.

    Endpoints: ``POST /v1/completions`` (SSE with ``"stream": true``,
    one JSON body otherwise), ``GET /v1/models``, ``GET /healthz``.
    ``scheduler``: a policy object (installed with
    ``engine.set_scheduler``), ``None`` for FIFO, or ``"auto"`` (the
    default) for ``PT_FLAGS_sched_policy``. Returns a
    :class:`ServingAPIServer` (``.url``, ``.shutdown()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if scheduler == "auto":
        scheduler = default_scheduler()
    fd = ServingFrontDoor(target, scheduler=scheduler, max_chunk=max_chunk,
                          model_id=model_id)

    class _Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj, default=str).encode(),
                       "application/json")

        def _send_error(self, code, message, etype):
            self._send(code, protocol.error_body(message, etype),
                       "application/json")

        def log_message(self, fmt, *args):  # no per-request log lines
            pass

        def do_GET(self):
            path = self.path.split("?")[0]
            try:
                if path == "/v1/models":
                    self._send_json(200, protocol.models_payload(
                        fd.model_id))
                elif path == "/healthz":
                    self._send(*healthz(fd.target))
                elif path in _LATER:
                    self._send_error(
                        404, f"{path} comes with the observability slice "
                        "of the port", "not_found_error")
                else:
                    self._send_error(404, "not found", "not_found_error")
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client left; nothing was queued for it

        # ---------------- completions ----------------
        def do_POST(self):
            try:
                if self.path.split("?")[0] != "/v1/completions":
                    self._send_error(404, "not found", "not_found_error")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, TypeError) as e:
                    self._send_error(400, f"invalid JSON body: {e}",
                                     "invalid_request_error")
                    return
                try:
                    creq = protocol.parse_completion_request(body)
                    rid, stream = fd.submit(creq)
                except protocol.ProtocolError as e:
                    self._send_error(e.status, str(e),
                                     "invalid_request_error")
                    return
                except ValueError as e:
                    # build_request's validation: the library's errors
                    self._send_error(400, str(e), "invalid_request_error")
                    return
                except RuntimeError as e:
                    # the engine thread is dead: nothing can be served
                    self._send_error(500, str(e), "internal_error")
                    return
                if creq.stream:
                    self._stream_response(creq, rid, stream)
                else:
                    self._aggregate_response(creq, rid, stream)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client left before a request was queued

        def _wait(self, stream):
            """The next stream item; a dead engine thread ends the wait."""
            while True:
                try:
                    return stream.q.get(timeout=30.0)
                except queue.Empty:
                    if fd._dead is not None:
                        return (_ERROR, fd._dead)
                    # the engine's deadlines end every request in time

        def _stream_response(self, creq, rid, stream):
            cid = f"cmpl-{rid}"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                if creq.echo:
                    self.wfile.write(protocol.sse_data(
                        protocol.completion_chunk(
                            cid, fd.model_id,
                            [int(t) for t in creq.prompt])))
                    self.wfile.flush()
                while True:
                    item = self._wait(stream)
                    if item[0] == _TOKENS:
                        self.wfile.write(protocol.sse_data(
                            protocol.completion_chunk(
                                cid, fd.model_id, item[1])))
                        self.wfile.flush()
                    elif item[0] == _DONE:
                        self.wfile.write(protocol.sse_data(
                            protocol.completion_chunk(
                                cid, fd.model_id, [],
                                finish_reason=item[1])))
                        self.wfile.write(protocol.SSE_DONE)
                        self.wfile.flush()
                        return
                    else:
                        self.wfile.write(protocol.sse_data(
                            {"error": {"message": item[1],
                                       "type": "internal_error"}}))
                        self.wfile.flush()
                        return
            except OSError:
                # the client disconnected mid-stream: the engine thread cancels
                # the request, which frees its slot and pages
                fd.defer_cancel(rid)

        def _aggregate_response(self, creq, rid, stream):
            cid = f"cmpl-{rid}"
            tokens = []
            while True:
                item = self._wait(stream)
                if item[0] == _TOKENS:
                    tokens.extend(item[1])
                elif item[0] == _DONE:
                    reason, meta = item[1], item[2]
                    break
                else:
                    self._send_error(500, item[1], "internal_error")
                    return
            try:
                self._send_json(200, protocol.completion_response(
                    cid, fd.model_id, tokens, reason, meta["prompt_tokens"],
                    echo_tokens=([int(t) for t in creq.prompt]
                                 if creq.echo else None)))
            except OSError:
                pass  # finished engine-side already: nothing to free

    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="pt-api-server")
    thread.start()
    return ServingAPIServer(server, thread, fd)
