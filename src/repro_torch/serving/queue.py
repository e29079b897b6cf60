"""Bounded FIFO admission queue with backpressure (DESIGN.md §8); port
of ``repro/serving/queue.py`` (stdlib only, copied verbatim).

The queue is the server's *wait line*: the engine loop pops from it only
when a decode slot is free, so its depth is exactly the number of
admitted-but-not-yet-running requests.  When the line is full, ``offer``
raises ``QueueFull`` — the HTTP layer turns that into ``429 Too Many
Requests`` with a ``Retry-After`` hint — instead of letting latency grow
without bound.  ``close()`` starts the drain-on-shutdown path: no new
admissions (``QueueClosed`` -> 503), already-queued items still pop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional


class QueueFull(Exception):
    """Wait line at capacity — retry after ``retry_after`` seconds."""

    def __init__(self, capacity: int, retry_after: float):
        super().__init__(f"admission queue full ({capacity})")
        self.capacity = capacity
        self.retry_after = retry_after


class QueueClosed(Exception):
    """Server is draining; no new admissions."""


class AdmissionQueue:
    """Thread-safe bounded FIFO of items carrying a ``.rid`` attribute."""

    def __init__(self, capacity: int = 64, *, retry_after: float = 1.0):
        self.capacity = capacity
        self.retry_after = retry_after
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        # counters (exported by /v1/stats)
        self.offered = 0
        self.rejected = 0
        self.cancelled = 0

    # ------------------------------------------------------------------
    def offer(self, item) -> None:
        """Enqueue or raise ``QueueFull`` / ``QueueClosed``."""
        with self._lock:
            if self._closed:
                raise QueueClosed("admission queue closed (draining)")
            if len(self._items) >= self.capacity:
                self.rejected += 1
                raise QueueFull(self.capacity, self.retry_after)
            self._items.append(item)
            self.offered += 1
            self._nonempty.notify()

    def pop(self, timeout: Optional[float] = None):
        """Dequeue the oldest item, or None on timeout / closed-empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._items:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._nonempty.wait(remaining)
            return self._items.popleft()

    def cancel(self, rid: int) -> bool:
        """Remove a still-queued item by rid (client gave up waiting)."""
        with self._lock:
            for item in self._items:
                if item.rid == rid:
                    self._items.remove(item)
                    self.cancelled += 1
                    return True
        return False

    def close(self) -> None:
        """Stop accepting; wake any blocked ``pop`` so drains finish."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def depth(self) -> int:
        return len(self._items)

    def __len__(self) -> int:
        return len(self._items)
