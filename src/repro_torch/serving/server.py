"""Dependency-light HTTP/SSE front end (stdlib only; DESIGN.md §8); port
of ``repro/serving/server.py`` over the port's engine.

Routes:

* ``POST /v1/generate`` — JSON body ``{"prompt": [ids...]}`` or
  ``{"text": "..."}`` (byte-level stub tokenizer) plus optional
  ``max_new_tokens``, ``temperature``, ``top_p``, ``seed``.  Responds
  ``text/event-stream``: a ``start`` event, one ``token`` event per
  decoded token, and a terminal ``done`` (or ``cancelled``) event with
  usage stats.  ``429 Too Many Requests`` + ``Retry-After`` when the
  admission queue is full; ``503`` while draining.
* ``GET /v1/health`` — liveness + model identity.
* ``GET /v1/stats`` — queue depth, live slots, admission counters,
  TTFT / inter-token latency histograms (``loop.EngineLoop.stats``).

A client disconnect surfaces as a failed SSE write; the handler cancels
the request and the engine loop retires its slot at the next step
boundary — the slot is immediately free for the next admission.
"""

from __future__ import annotations

import json
import queue as stdlib_queue
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.serve import Engine
from repro_torch.serving.controller import Controller
from repro_torch.serving.loop import EngineLoop, Stream
from repro_torch.serving.queue import QueueClosed, QueueFull

#: ceiling on waiting for the next token of one request before the
#: server gives up on it (prevents a wedged engine from pinning
#: handler threads forever)
TOKEN_TIMEOUT_S = 300.0


def tokenize_stub(text: str, vocab_size: int) -> np.ndarray:
    """Deterministic byte-level stand-in for a real tokenizer: one token
    per UTF-8 byte, folded into the model's vocab.  Good enough to
    exercise the serving path with ``{"text": ...}`` bodies; real
    deployments submit ``{"prompt": [ids...]}``."""
    data = np.frombuffer(text.encode("utf-8"), np.uint8)
    return (data.astype(np.int32) % vocab_size)


def _sse(event: str, payload: dict) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(payload)}\n\n"
            ).encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_HTTPServer"

    # quiet: the load generator would otherwise spam stderr per request
    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, payload: dict, headers: dict = ()):
        body = (json.dumps(payload, indent=2) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------------------
    def do_GET(self):
        srv = self.server.serving
        if self.path == "/v1/health":
            self._json(200, {
                "status": "draining" if srv.loop.admission.closed
                else "ok",
                "arch": srv.engine.model.cfg.arch_id,
                "family": srv.engine.model.cfg.family,
                "collective": srv.engine.policy.collective.shorthand(),
                "kv": srv.engine.policy.kv.shorthand(),
            })
        elif self.path == "/v1/stats":
            self._json(200, srv.loop.stats())
        else:
            self._json(404, {"error": f"no route {self.path!r}"})

    # ------------------------------------------------------------------
    def do_POST(self):
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no route {self.path!r}"})
            return
        srv = self.server.serving
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            prompt = self._prompt_ids(body, srv.engine.model.cfg.vocab_size)
            kwargs = self._sampling_kwargs(body)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return

        try:
            stream = srv.loop.submit(prompt, **kwargs)
        except QueueFull as e:
            self._json(429, {"error": str(e),
                             "retry_after_s": e.retry_after},
                       headers={"Retry-After": f"{e.retry_after:g}"})
            return
        except QueueClosed as e:
            self._json(503, {"error": str(e)})
            return
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return

        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            self.wfile.write(_sse("start", {"rid": stream.rid}))
            self.wfile.flush()
            self._pump(stream)
        except (BrokenPipeError, ConnectionResetError, socket.timeout,
                OSError):
            # client went away mid-stream: retire the slot at the next
            # step boundary so it frees for admission
            srv.loop.cancel(stream.rid)

    def _pump(self, stream: Stream):
        while True:
            try:
                kind, payload = stream.events.get(timeout=TOKEN_TIMEOUT_S)
            except stdlib_queue.Empty:
                self.server.serving.loop.cancel(stream.rid)
                self.wfile.write(_sse("error",
                                      {"error": "token timeout"}))
                self.wfile.flush()
                return
            if kind == "token":
                self.wfile.write(_sse("token", payload))
                self.wfile.flush()
            else:                      # "done" | "cancelled": terminal
                self.wfile.write(_sse(kind, {"usage": payload}))
                self.wfile.flush()
                return

    # ------------------------------------------------------------------
    @staticmethod
    def _prompt_ids(body: dict, vocab_size: int) -> np.ndarray:
        if "prompt" in body:
            ids = body["prompt"]
            if (not isinstance(ids, list) or not ids
                    or not all(isinstance(t, int) for t in ids)):
                raise ValueError("'prompt' must be a non-empty list of "
                                 "token ids")
            if max(ids) >= vocab_size or min(ids) < 0:
                raise ValueError(f"token id out of range [0, {vocab_size})")
            return np.asarray(ids, np.int32)
        if "text" in body:
            if not isinstance(body["text"], str) or not body["text"]:
                raise ValueError("'text' must be a non-empty string")
            return tokenize_stub(body["text"], vocab_size)
        raise ValueError("body needs 'prompt' (token ids) or 'text'")

    @staticmethod
    def _sampling_kwargs(body: dict) -> dict:
        out = {}
        max_new = body.get("max_new_tokens", 16)
        if not isinstance(max_new, int) or max_new < 1:
            raise ValueError("'max_new_tokens' must be a positive int")
        out["max_new_tokens"] = max_new
        for key, typ in (("temperature", (int, float)),
                         ("top_p", (int, float)), ("seed", int)):
            if body.get(key) is not None:
                if not isinstance(body[key], typ) or isinstance(
                        body[key], bool):
                    raise ValueError(f"'{key}' must be {typ[0].__name__}")
                out[key] = body[key]
        if "top_p" in out and not (0.0 < out["top_p"] <= 1.0):
            raise ValueError("'top_p' must be in (0, 1]")
        if "temperature" in out and out["temperature"] < 0.0:
            raise ValueError("'temperature' must be >= 0")
        return out


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    serving: "ServingServer"


class ServingServer:
    """The network front end: one ``EngineLoop`` + a threaded stdlib
    HTTP server.  ``port=0`` binds an ephemeral port (tests/bench).

    ``group``: serve a tensor-parallel engine from rank 0 of that group;
    the loop sends each step boundary to the other ranks, which run
    ``controller.follow`` on a ``Scheduler`` built with the same
    arguments (``beat``: the idle beat's seconds)."""

    def __init__(self, engine: Engine, *, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 4,
                 prompt_budget: int = 128,
                 scfg: SamplingConfig = SamplingConfig(),
                 seed: int = 0, queue_capacity: int = 64,
                 retry_after: float = 1.0, n_pages: Optional[int] = None,
                 cache_idle: float = 30.0, group=None, beat: float = 30.0):
        self.engine = engine
        self.loop = EngineLoop(
            Scheduler(engine, max_batch=max_batch,
                      prompt_budget=prompt_budget, scfg=scfg, seed=seed,
                      n_pages=n_pages),
            queue_capacity=queue_capacity, retry_after=retry_after,
            cache_idle=cache_idle,
            controller=None if group is None else Controller(
                group, beat=beat))
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.serving = self
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "ServingServer":
        """Run the engine loop + HTTP server on background threads."""
        self.loop.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-server",
            daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        """Foreground variant for the CLI (Ctrl-C -> graceful drain)."""
        self.loop.start()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0):
        """Drain (default) or abort in-flight requests, then stop (under
        TP the loop's last boundary is ``stop``: the followers return)."""
        self.loop.shutdown(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
