"""The background step loop that owns the Scheduler (DESIGN.md §8); port
of ``repro/serving/loop.py`` over the port's ``Scheduler``.

One thread drives the continuous-batching decode program; HTTP handler
threads never touch the engine.  On the card that thread is also the one
that captures the engine's decode step (``Engine.decode``: on the
engine's own stream, ``torch.inference_mode`` per call) and replays it;
no engine call comes from a handler thread.  The loop:

* admits from the bounded ``AdmissionQueue`` into the scheduler only
  when a decode slot is free (the admission queue is the wait line, the
  scheduler queue stays empty — ``/v1/stats`` queue depth is therefore
  the real backlog);
* runs ``Scheduler.step()`` and fans each emitted token out to the
  request's private subscriber queue (``Stream.events``);
* records per-request TTFT (submit -> first token) and inter-token
  latency, aggregated into the histograms ``/v1/stats`` reports;
* finalizes cancelled requests: a client disconnect flips
  ``Request.cancelled``; the scheduler retires the slot at the next
  step boundary and the loop emits the terminal ``cancelled`` event.

Request lifecycle:  submitted -> queued (wait line) -> running (slot)
-> {done | cancelled}.  Every terminal state posts exactly one
``("done", usage)`` or ``("cancelled", reason)`` event and sets
``Stream.finished``.

Under tensor parallelism (a ``controller.Controller``, on rank 0 of the
group) the loop makes each decision once and sends it to the other
ranks before it steps (``controller.py``): the admissions, the cancels
and an idle ``release_cache``, then ``step``; while idle, an ``idle``
beat.  A handler's cancel there only records the rid, which the loop
applies at the next boundary, on rank 0 and in the message together: a
flag flipped between the broadcast and rank 0's ``step()`` would retire
a slot on rank 0 alone.  ``shutdown`` ends with ``stop``.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as stdlib_queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.serving.controller import IDLE, STOP, Boundary, Controller
from repro_torch.serving.queue import AdmissionQueue

_PERCENTILES = (50, 90, 99)
_RESERVOIR = 8192          # latency samples kept per histogram


@dataclasses.dataclass
class Stream:
    """Server-side handle for one in-flight request: the subscriber
    queue the HTTP handler reads, plus latency bookkeeping."""

    rid: int
    request: Request
    events: stdlib_queue.SimpleQueue = dataclasses.field(
        default_factory=stdlib_queue.SimpleQueue)
    submitted: float = dataclasses.field(default_factory=time.monotonic)
    started: Optional[float] = None       # admitted into the engine
    first_token: Optional[float] = None
    last_token: Optional[float] = None
    itl_ms: list = dataclasses.field(default_factory=list)
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def usage(self, finish_reason: str) -> dict:
        now = time.monotonic()
        return {
            "prompt_tokens": int(self.request.prompt.size),
            "completion_tokens": len(self.request.output),
            "queue_ms": round(1e3 * ((self.started or now)
                                     - self.submitted), 3),
            "ttft_ms": (None if self.first_token is None else
                        round(1e3 * (self.first_token - self.submitted),
                              3)),
            "itl_ms_mean": (round(float(np.mean(self.itl_ms)), 3)
                            if self.itl_ms else None),
            "total_ms": round(1e3 * (now - self.submitted), 3),
            "finish_reason": finish_reason,
        }


def _histogram(samples) -> dict:
    if not samples:
        return {"count": 0}
    arr = np.asarray(samples, np.float64)
    out = {"count": int(arr.size),
           "mean": round(float(arr.mean()), 3)}
    for p in _PERCENTILES:
        out[f"p{p}"] = round(float(np.percentile(arr, p)), 3)
    # log2-spaced ms buckets, upper-edge labelled, zero buckets elided
    edges = [2.0 ** e for e in range(-2, 15)]   # 0.25ms .. 16384ms
    counts, _ = np.histogram(arr, bins=[0.0] + edges + [np.inf])
    labels = [f"le_{e:g}ms" for e in edges] + [f"gt_{edges[-1]:g}ms"]
    out["buckets"] = {lab: int(c)
                      for lab, c in zip(labels, counts) if c}
    return out


class EngineLoop:
    """Background thread owning a continuous-mode ``Scheduler``."""

    def __init__(self, scheduler: Scheduler, *, queue_capacity: int = 64,
                 retry_after: float = 1.0, idle_wait: float = 0.02,
                 cache_idle: float = 30.0,
                 controller: Optional[Controller] = None):
        if not scheduler.engine.supports_continuous:
            raise ValueError(
                "HTTP serving needs token-granularity stepping; family "
                f"'{scheduler.engine.model.cfg.family}' only supports "
                "batch-drain scheduling (see Scheduler docstring)")
        self.scheduler = scheduler
        self.admission = AdmissionQueue(queue_capacity,
                                        retry_after=retry_after)
        self.idle_wait = idle_wait
        #: seconds of idle before the decode cache (dense rows or the
        #: whole page pool + prefix LRU) is released back to the
        #: allocator — a long-lived loop must not pin peak-batch cache
        #: memory between traffic bursts (the next request rebuilds it)
        self.cache_idle = cache_idle
        self._idle_since: Optional[float] = None
        #: head-of-line request a full page pool could not admit yet —
        #: held here (NOT in the scheduler queue) so the admission queue
        #: keeps backpressuring into 429s while it waits for pages
        self._pending: Optional[Stream] = None
        #: rank 0 of a TP group: sends each boundary to the other ranks
        self.controller = controller
        #: rids whose cancel the loop applies at the next boundary (TP)
        self._cancels: set = set()
        #: what ended a TP loop early (the process must exit non-zero)
        self.error: Optional[BaseException] = None
        self._rids = itertools.count()
        self._streams: dict[int, Stream] = {}      # not yet finalized
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run if controller is None else self._run_group,
            name="engine-loop", daemon=True)
        # counters + latency reservoirs (read by /v1/stats)
        self.started_at = time.monotonic()
        self.admitted = 0            # entered the engine
        self.completed = 0
        self.cancelled = 0
        self.tokens_out = 0
        self._ttft_ms: deque = deque(maxlen=_RESERVOIR)
        self._itl_ms: deque = deque(maxlen=_RESERVOIR)

    # ------------------------------------------------------------------
    # request API (called from HTTP handler threads)
    # ------------------------------------------------------------------

    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None) -> Stream:
        """Enqueue a request; raises QueueFull/QueueClosed (backpressure)
        or ValueError (bad prompt/max_new vs the engine's budgets)."""
        sched = self.scheduler
        if prompt.size > sched.prompt_budget:
            raise ValueError(f"prompt {prompt.size} > budget "
                             f"{sched.prompt_budget}")
        if prompt.size + max_new_tokens > sched.engine.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"> engine max_seq {sched.engine.max_seq}")
        rid = next(self._rids)
        req = Request(rid=rid, prompt=prompt.astype(np.int32),
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_p=top_p, seed=seed)
        stream = Stream(rid=rid, request=req)
        with self._lock:
            self._streams[rid] = stream
        try:
            self.admission.offer(stream)
        except Exception:
            with self._lock:
                self._streams.pop(rid, None)
            raise
        self._wake.set()
        return stream

    def cancel(self, rid: int) -> bool:
        """Client went away: drop a queued request immediately, or flag a
        running one so the scheduler retires its slot at the next step
        boundary (freeing it for admission)."""
        with self._lock:
            stream = self._streams.get(rid)
        if stream is None or stream.finished.is_set():
            return False
        if self.controller is not None:
            # only the loop touches requests in the engine (module doc)
            if self.admission.cancel(rid):
                self._finalize(stream, "cancelled")
            else:
                with self._lock:
                    self._cancels.add(rid)
            self._wake.set()
            return True
        stream.request.cancelled = True
        if self.admission.cancel(rid):
            # never reached the engine: finalize here, the loop owns
            # only requests it admitted
            self._finalize(stream, "cancelled")
        self._wake.set()
        return True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "EngineLoop":
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0):
        """Stop the loop.  ``drain=True`` (graceful): close the wait
        line (new offers -> QueueClosed/503), let queued + running
        requests finish, then stop.  ``drain=False``: cancel everything
        in flight first."""
        self.admission.close()
        if not drain:
            with self._lock:
                rids = list(self._streams)
            for rid in rids:
                self.cancel(rid)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._streams:
                    break
            time.sleep(0.01)
        self._stop = True
        self._wake.set()
        # under TP the loop's last act is the stop boundary, after a step
        # that may take a while
        self._thread.join(timeout=5.0 if self.controller is None else 60.0)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def _free_capacity(self) -> int:
        sched = self.scheduler
        return sched.max_batch - sched.live_slots - len(sched.queue)

    def _admit(self, cancelled, msg: Optional[Boundary] = None):
        """Admit from the wait line while a slot can take a request (and,
        in paged mode, only while the head's worst-case page reservation
        fits — it stays parked in _pending, not the scheduler queue, so
        /v1/stats queue depth remains the real backlog and the bounded
        wait line 429s under pressure).  ``cancelled(stream)``: whether
        to finalize a popped stream instead; each admission is recorded
        in ``msg`` (TP)."""
        sched = self.scheduler
        while self._free_capacity() > 0:
            stream = self._pending or self.admission.pop(timeout=0)
            self._pending = None
            if stream is None:
                break
            if cancelled(stream):
                self._finalize(stream, "cancelled")
                continue
            if not sched.can_admit(stream.request):
                self._pending = stream
                break
            stream.started = time.monotonic()
            sched.submit(stream.request)
            if msg is not None:
                msg.admissions.append(stream.request)
            self.admitted += 1

    def _release_when_idle(self) -> bool:
        """The idle clock: release the cache after ``cache_idle`` seconds
        without work (nothing parked); True when it was released."""
        now = time.monotonic()
        if self._idle_since is None:
            self._idle_since = now
        elif (self._pending is None
                and now - self._idle_since >= self.cache_idle):
            if self.scheduler.release_cache():
                self._idle_since = now
                return True
        return False

    def _run(self):
        sched = self.scheduler
        while not self._stop:
            self._admit(lambda stream: stream.request.cancelled)
            if not sched.has_work:
                self._release_when_idle()
                self._wake.wait(self.idle_wait)
                self._wake.clear()
                continue
            self._idle_since = None
            self._emit(sched.step())

    def _take_cancel(self, stream: Stream) -> bool:
        with self._lock:
            if stream.rid in self._cancels:
                self._cancels.discard(stream.rid)
                return True
        return False

    def _boundary_cancels(self, msg: Boundary):
        """Apply the cancels handlers recorded since the last boundary
        (those of requests the loop had popped from the wait line): a
        request in the engine is cancelled on rank 0 and in ``msg``; one
        parked for pages is finalized here (no other rank has seen it)."""
        with self._lock:
            rids, self._cancels = sorted(self._cancels), set()
            streams = [self._streams.get(rid) for rid in rids]
        for rid, stream in zip(rids, streams):
            if stream is None:
                continue
            if stream.started is not None:
                if self.scheduler.cancel(rid):
                    msg.cancels.append(rid)
            elif self._pending is stream:
                self._pending = None
                self._finalize(stream, "cancelled")

    def _run_group(self):
        """The loop on rank 0 of a TP group: every mutation of the
        scheduler is made here, recorded in a ``Boundary`` and sent to
        the other ranks before ``step()``; idle, a boundary goes out when
        it carries something or a beat is due."""
        sched, ctl = self.scheduler, self.controller
        try:
            while not self._stop:
                msg = Boundary()
                self._boundary_cancels(msg)
                self._admit(self._take_cancel, msg)
                if not sched.has_work:
                    msg.release_cache = self._release_when_idle()
                    if (msg.cancels or msg.admissions or msg.release_cache
                            or ctl.beat_due()):
                        msg.action = IDLE
                        ctl.send(msg)
                    self._wake.wait(self.idle_wait)
                    self._wake.clear()
                    continue
                self._idle_since = None
                ctl.send(msg)
                events = sched.step()
                ctl.record(events)
                self._emit(events)
            ctl.send(Boundary(action=STOP))
        except BaseException as e:     # the server exits non-zero on it
            self.error = e
            raise

    def _emit(self, events):
        """Fan one step's events out to the streams."""
        for ev in events:
            with self._lock:
                stream = self._streams.get(ev.rid)
            if stream is None:        # already finalized (races are
                continue              # benign: events are terminal)
            if ev.cancelled:
                self._finalize(stream, "cancelled")
                continue
            now = time.monotonic()
            if stream.first_token is None:
                stream.first_token = now
                self._ttft_ms.append(1e3 * (now - stream.submitted))
            else:
                itl = 1e3 * (now - stream.last_token)
                stream.itl_ms.append(itl)
                self._itl_ms.append(itl)
            stream.last_token = now
            self.tokens_out += 1
            index = len(stream.request.output) - 1
            stream.events.put(("token", {"index": index,
                                         "token": ev.token}))
            if ev.final:
                self._finalize(stream, "length")

    def _finalize(self, stream: Stream, reason: str):
        with self._lock:
            self._streams.pop(stream.rid, None)
        if reason == "cancelled":
            self.cancelled += 1
            stream.events.put(("cancelled", stream.usage(reason)))
        else:
            self.completed += 1
            stream.events.put(("done", stream.usage(reason)))
        stream.finished.set()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        sched = self.scheduler
        with self._lock:
            in_flight = len(self._streams)
        uptime = time.monotonic() - self.started_at
        return {
            "uptime_s": round(uptime, 3),
            "queue": {
                "depth": self.admission.depth,
                "capacity": self.admission.capacity,
                "offered": self.admission.offered,
                "rejected": self.admission.rejected,
                "cancelled_queued": self.admission.cancelled,
                "closed": self.admission.closed,
            },
            "engine": {
                "live_slots": sched.live_slots,
                "max_batch": sched.max_batch,
                "prompt_budget": sched.prompt_budget,
                "max_seq": sched.engine.max_seq,
                "steps": sched.steps,
            },
            "requests": {
                "admitted": self.admitted,
                "completed": self.completed,
                "cancelled": self.cancelled,
                "in_flight": in_flight,
            },
            "tokens": {
                "generated": self.tokens_out,
                "per_s": round(self.tokens_out / uptime, 3) if uptime
                else 0.0,
            },
            "latency_ms": {
                "ttft": _histogram(self._ttft_ms),
                "itl": _histogram(self._itl_ms),
            },
            "cache": sched.cache_stats(),
        }
