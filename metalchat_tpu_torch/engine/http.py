"""OpenAI-compatible HTTP serving over the continuous-batching engine
(port of the JAX package's ``engine/http.py``).

A front end on the standard library's ``http.server`` exposing

  POST /v1/completions        (prompt in, text out; stream=true → SSE)
  POST /v1/chat/completions   (messages rendered via a chat formatter)
  GET  /v1/models             (model card)
  GET  /health
  GET  /metrics               (engine TTFT/throughput counters)

Architecture: HTTP handler threads `submit()` into the engine under a lock
and block on per-request token queues; ONE scheduler thread drives
`engine.step()`, so every CUDA call of the engine happens on that thread
(the lock is the device queue), and fans emitted tokens out to the waiting
handlers. The engine captures its decode step (a CUDA graph) on that thread
too. The handler threads run Python only (tokenizer, queues, the engine's
host-side `submit`, `completion` and `metrics`) and make no CUDA call, so
the capture keeps `torch.cuda.graph`'s default, process-wide error mode. Streaming uses `text.tokenizer.StreamingDecoder` so multi-byte
UTF-8 split across tokens renders correctly chunk by chunk.

Over ranks (``mesh``: a `parallel.mesh.GridMesh` whose ranks each hold an
engine that must step in lockstep, as pipeline and context parallelism
need) rank 0 runs this server, and each scheduler round it first
broadcasts what its handlers submitted and what it cancels since the last
round (a stop at the end); the other ranks run `follow`, which applies the
same submissions and cancels in the same order and steps their engine, so
every rank makes the same model calls and collectives. Those ranks serve
no HTTP.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.sampling import SamplerConfig
from metalchat_tpu_torch.text.tokenizer import StreamingDecoder

_END = object()


def default_chat_formatter(messages: Sequence[Mapping[str, str]]) -> str:
    """Llama-3-style header format (the framework's native default)."""
    parts = []
    for m in messages:
        parts.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
            f"{m['content']}<|eot_id|>"
        )
    parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


class InferenceServer:
    """Engine + tokenizer behind a threaded OpenAI-compatible HTTP API."""

    def __init__(
        self,
        engine: ContinuousBatchingEngine,
        tokenizer,
        *,
        model_name: str = "metalchat-tpu-torch",
        chat_formatter: Optional[Callable[[Sequence[Mapping[str, str]]], str]] = None,
        default_max_tokens: int = 256,
        eos_ids: Sequence[int] = (),
        request_timeout: Optional[float] = None,
        mesh=None,
    ):
        self.engine = engine
        # Ranks in lockstep (the module docstring): rank 0's requests
        # submitted since the last scheduler round.
        self.mesh = mesh
        self._submitted: List[Request] = []
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.chat_formatter = chat_formatter or default_chat_formatter
        self.default_max_tokens = default_max_tokens
        self.eos_ids = tuple(eos_ids)
        # Wall-clock budget per request: on expiry the request is cancelled
        # in the engine (slot freed) and the tokens so far are returned with
        # finish_reason "timeout".
        self.request_timeout = request_timeout

        self._lock = threading.Lock()          # guards engine state
        self._wake = threading.Event()
        # Cancels are queued here and applied by the scheduler thread at the
        # start of its next iteration: a cancel that contended on _lock could
        # starve behind the step loop (an unfair lock the scheduler
        # re-acquires immediately), leaving a dead client's slot decoding.
        # Appends are atomic, so callers never block.
        self._cancels: "deque" = deque()
        self._streams: Dict[int, "queue.Queue"] = {}
        self._done: set = set()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- engine plumbing ----------------------------------------------------

    def submit(self, prompt_ids, max_tokens: int, sampler: SamplerConfig,
               stop_ids: Sequence[int]) -> int:
        q: "queue.Queue" = queue.Queue()
        request = Request(prompt=list(prompt_ids), max_new_tokens=max_tokens,
                          sampler=sampler, eos_ids=tuple(stop_ids) or self.eos_ids)
        with self._lock:
            rid = self.engine.submit(request)
            if self.mesh is not None:
                self._submitted.append(request)
            completion = self.engine.completion(rid)
            self._streams[rid] = q
            if completion.finished:  # rejected at submit (validation)
                self._done.add(rid)
                q.put(_END)
        self._wake.set()
        return rid

    def _scheduler(self) -> None:
        while self._running:
            with self._lock:
                cancels = []
                while self._cancels:
                    cancels.append(self._cancels.popleft())
                if self.mesh is not None:
                    self.mesh.broadcast_object((self._submitted, cancels))
                    self._submitted = []
                for rid, reason in cancels:
                    cancelled = self.engine.cancel(rid, reason=reason)
                    if cancelled and rid not in self._done:
                        self._done.add(rid)
                        q = self._streams.get(rid)
                        if q is not None:
                            q.put(_END)
                had_work = self.engine.has_work
                emitted = self.engine.step() if had_work else []
                for rid, token in emitted:
                    if rid in self._streams and rid not in self._done:
                        self._streams[rid].put(token)
                for rid, qd in list(self._streams.items()):
                    if rid in self._done:
                        continue
                    if self.engine.completion(rid).finished:
                        self._done.add(rid)
                        qd.put(_END)
            if not had_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            else:
                # Yield the GIL: without this, the step loop can convoy the
                # handler threads, and a streaming client then receives its
                # first token only after the whole generation finishes.
                time.sleep(0)
        if self.mesh is not None:
            self.mesh.broadcast_object(None)  # the other ranks' `follow` returns

    # -- lifecycle ------------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start scheduler + HTTP threads; returns the bound port."""
        self._running = True
        self._thread = threading.Thread(target=self._scheduler, daemon=True)
        self._thread.start()

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _json(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                elif self.path == "/metrics":
                    with server._lock:
                        self._json(200, server.engine.metrics())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid JSON"})
                    return
                if self.path == "/v1/completions":
                    self._completion(body, chat=False)
                elif self.path == "/v1/chat/completions":
                    self._completion(body, chat=True)
                else:
                    self._json(404, {"error": "not found"})

            def _completion(self, body: Dict[str, Any], chat: bool) -> None:
                try:
                    if chat:
                        text = server.chat_formatter(body["messages"])
                    else:
                        text = body["prompt"]
                except (KeyError, TypeError):
                    self._json(400, {"error": "missing prompt/messages"})
                    return
                ids = server.tokenizer.encode(text, allow_special=True)
                sampler = SamplerConfig(
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 50)),
                    top_p=float(body.get("top_p", 0.9)),
                )
                max_tokens = int(body.get("max_tokens",
                                          server.default_max_tokens))
                stop_ids = [int(t) for t in body.get("stop_token_ids", [])]
                rid = server.submit(ids, max_tokens, sampler, stop_ids)
                if body.get("stream"):
                    self._stream_response(rid, chat)
                else:
                    self._block_response(rid, chat)

            def _block_response(self, rid: int, chat: bool) -> None:
                tokens = server.collect(rid)
                comp = server.engine.completion(rid)
                if comp.error:
                    self._json(400, {"error": comp.error})
                    return
                text = server.tokenizer.decode(tokens)
                self._json(200, _openai_payload(
                    server.model_name, rid, text, comp.finish_reason, chat))

            def _stream_response(self, rid: int, chat: bool) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                decoder = StreamingDecoder(server.tokenizer)
                try:
                    for token in server.iter_tokens(rid):
                        chunk = decoder.feed(token)
                        if chunk:
                            self._sse(_openai_chunk(server.model_name, rid, chunk, chat))
                    tail = decoder.flush()
                    if tail:
                        self._sse(_openai_chunk(server.model_name, rid, tail, chat))
                    self._sse_raw("[DONE]")
                    self._chunk(b"")  # terminating chunk
                except OSError:
                    # Client went away mid-stream: free the engine slot
                    # instead of decoding the rest to nobody.
                    server.cancel(rid)

            def _sse(self, payload: Dict[str, Any]) -> None:
                self._sse_raw(json.dumps(payload))

            def _sse_raw(self, data: str) -> None:
                self._chunk(f"data: {data}\n\n".encode())

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        http_thread = threading.Thread(target=self._httpd.serve_forever,
                                       daemon=True)
        http_thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- token plumbing -------------------------------------------------------

    def cancel(self, rid: int, reason: str = "cancelled",
               wait: float = 5.0) -> None:
        """Abort a request: the scheduler thread frees its engine slot at the
        next loop iteration and wakes any waiting reader (see _cancels).
        Waits (bounded, lock-free) until applied so callers can read the
        completion's finish_reason immediately after."""
        self._cancels.append((rid, reason))
        self._wake.set()
        deadline = time.monotonic() + wait
        while self._running and time.monotonic() < deadline:
            completion = self.engine._completions.get(rid)
            if completion is None or completion.finished:
                return
            time.sleep(0.002)

    def iter_tokens(self, rid: int):
        """Yield tokens; on request_timeout expiry, cancel and stop."""
        deadline = (time.monotonic() + self.request_timeout
                    if self.request_timeout else None)
        with self._lock:
            q = self._streams[rid]
        finished = False
        try:
            while True:
                try:
                    if deadline is None:
                        item = q.get()
                    else:
                        item = q.get(timeout=max(deadline - time.monotonic(),
                                                 1e-4))
                except queue.Empty:
                    self.cancel(rid, reason="timeout")
                    return
                if item is _END:
                    finished = True
                    return
                yield item
        finally:
            with self._lock:
                self._streams.pop(rid, None)
                self._done.discard(rid)
            if not finished:
                # The consumer abandoned the stream (client disconnect, any
                # transport error): free the engine slot.
                self.cancel(rid)

    def collect(self, rid: int):
        return list(self.iter_tokens(rid))


def follow(engine: ContinuousBatchingEngine, mesh) -> None:
    """The loop of a rank beside rank 0's `InferenceServer` over ``mesh``:
    each round, rank 0's broadcast (the requests its handlers submitted and
    the cancels it applied since the last round), applied in rank 0's
    order, then one engine step when there is work; returns at rank 0's
    stop. It serves no HTTP."""
    while True:
        round_ = mesh.broadcast_object(None)
        if round_ is None:
            return
        submitted, cancels = round_
        for request in submitted:
            engine.submit(request)
        for rid, reason in cancels:
            engine.cancel(rid, reason=reason)
        if engine.has_work:
            engine.step()


def _openai_payload(model, rid, text, finish_reason, chat) -> Dict[str, Any]:
    base = {
        "id": f"cmpl-{uuid.uuid4().hex[:12]}",
        "object": "chat.completion" if chat else "text_completion",
        "created": int(time.time()),
        "model": model,
    }
    if chat:
        base["choices"] = [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish_reason or "stop",
        }]
    else:
        base["choices"] = [{
            "index": 0, "text": text,
            "finish_reason": finish_reason or "stop",
        }]
    return base


def _openai_chunk(model, rid, text, chat) -> Dict[str, Any]:
    if chat:
        delta = {"choices": [{"index": 0, "delta": {"content": text}}]}
    else:
        delta = {"choices": [{"index": 0, "text": text}]}
    return {"id": f"cmpl-{rid}", "object": "chat.completion.chunk" if chat
            else "text_completion.chunk", "model": model, **delta}
