"""Streaming HTTP/SSE serving front end over the continuous-batching
engine (DESIGN.md §8); port of ``repro/serving``.

Layers, bottom up:

* ``repro_torch.runtime.scheduler.Scheduler`` — the fixed-shape continuous
  decode program (one ``step()`` = one admission + decode step).
* ``loop.EngineLoop`` — a background thread that owns the scheduler,
  admits from the bounded queue only when a slot is free, fans decoded
  tokens out to per-request subscriber queues, and records TTFT /
  inter-token latency.
* ``queue.AdmissionQueue`` — bounded FIFO wait line with backpressure
  (``QueueFull`` -> HTTP 429 + ``Retry-After``) and drain-on-shutdown.
* ``server.ServingServer`` — the stdlib threaded HTTP server:
  ``POST /v1/generate`` (SSE token stream), ``GET /v1/health``,
  ``GET /v1/stats``.
* ``controller`` — the same front end over tensor-parallel rank
  processes: rank 0's loop broadcasts each step boundary (``Boundary``:
  admissions, cancels, cache release, then step / idle / stop) and the
  other ranks ``follow`` it on their own schedulers.

No dependencies beyond the Python stdlib (and torch.distributed under
tensor parallelism).
"""

from repro_torch.serving.queue import AdmissionQueue, QueueClosed, QueueFull
from repro_torch.serving.controller import Boundary, Controller, follow
from repro_torch.serving.loop import EngineLoop, Stream
from repro_torch.serving.server import ServingServer, tokenize_stub

__all__ = [
    "AdmissionQueue", "QueueClosed", "QueueFull",
    "Boundary", "Controller", "follow",
    "EngineLoop", "Stream",
    "ServingServer", "tokenize_stub",
]
