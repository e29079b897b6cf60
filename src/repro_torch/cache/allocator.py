"""Free-list page allocator with refcounts, reservations, and a
content-retaining LRU for shared prefix pages; port of
``repro/cache/allocator.py`` (host-side, copied verbatim).

Invariants (asserted throughout, cheap — all host-side bookkeeping):

* every page id is in exactly ONE of: the free list, the live refcount
  map, or the cached LRU (refcount 0 but content retained for prefix
  reuse);
* ``available() == len(free) + len(cached) - reserved`` never goes
  negative: admission *reserves* its worst-case page count up front
  (``reserve``), then draws the pages down one ``alloc(reserved=True)``
  at a time as the sequence grows — so mid-decode growth can never
  deadlock against other requests;
* a cached page is evicted (oldest first) only when the free list is
  empty; eviction fires ``evict_cb(pid)`` so the prefix store drops its
  key before the content is reused.

The allocator knows nothing about devices or page contents — it hands
out indices into the device pool (``cache/paged.py``); the manager
(``cache/manager.py``) maps requests to pages.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional


class OutOfPages(RuntimeError):
    """A page was requested beyond the reserved/available budget."""


class PageAllocator:
    def __init__(self, n_pages: int,
                 evict_cb: Optional[Callable[[int], None]] = None):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        self.n_pages = n_pages
        self.evict_cb = evict_cb
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._refs: dict[int, int] = {}
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU order
        self.reserved = 0
        # counters (telemetry)
        self.allocs = 0
        self.evictions = 0
        self.peak_live = 0

    # ------------------------------------------------------------------

    @property
    def live_pages(self) -> int:
        return len(self._refs)

    @property
    def free_pages(self) -> int:
        """Pages holding no content at all (excludes the cached LRU)."""
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def available(self) -> int:
        """Pages a new reservation could still claim."""
        return len(self._free) + len(self._cached) - self.reserved

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    # ------------------------------------------------------------------

    def can_reserve(self, n: int) -> bool:
        return n <= self.available()

    def reserve(self, n: int):
        if not self.can_reserve(n):
            raise OutOfPages(
                f"reserve({n}) > available {self.available()} "
                f"(pool {self.n_pages}, live {self.live_pages}, "
                f"cached {self.cached_pages}, reserved {self.reserved})")
        self.reserved += n

    def unreserve(self, n: int):
        if n > self.reserved:
            raise AssertionError(
                f"unreserve({n}) > outstanding {self.reserved}")
        self.reserved -= n

    # ------------------------------------------------------------------

    def alloc(self, *, reserved: bool = False) -> int:
        """Claim a fresh page (refcount 1).  ``reserved=True`` draws down
        a prior reservation; otherwise the page must fit in the
        unreserved headroom."""
        if reserved:
            if self.reserved < 1:
                raise AssertionError("alloc(reserved=True) with no "
                                     "outstanding reservation")
            self.reserved -= 1
        elif self.available() < 1:
            raise OutOfPages(
                f"pool exhausted ({self.n_pages} pages, "
                f"{self.live_pages} live, {self.cached_pages} cached, "
                f"{self.reserved} reserved)")
        if self._free:
            pid = self._free.pop()
        else:
            # evict the least-recently-released cached prefix page
            pid, _ = self._cached.popitem(last=False)
            self.evictions += 1
            if self.evict_cb is not None:
                self.evict_cb(pid)
        self._refs[pid] = 1
        self.allocs += 1
        self.peak_live = max(self.peak_live, len(self._refs))
        return pid

    def retain(self, pid: int) -> int:
        """Add a reference: a prefix-share hit on a live page, or the
        resurrection of a cached (refcount-0) one."""
        if pid in self._refs:
            self._refs[pid] += 1
        elif pid in self._cached:
            del self._cached[pid]
            self._refs[pid] = 1
            self.peak_live = max(self.peak_live, len(self._refs))
        else:
            raise AssertionError(f"retain of free page {pid}")
        return self._refs[pid]

    def release(self, pid: int, *, keep_cached: bool = False):
        """Drop a reference.  At refcount 0 the page returns to the free
        list — or, with ``keep_cached`` (a registered complete prefix
        page), to the LRU so an identical future prompt can resurrect
        it."""
        refs = self._refs.get(pid)
        if refs is None:
            raise AssertionError(f"release of non-live page {pid}")
        if refs > 1:
            self._refs[pid] = refs - 1
            return
        del self._refs[pid]
        if keep_cached:
            self._cached[pid] = None
            self._cached.move_to_end(pid)
        else:
            self._free.append(pid)

    def drop_cached(self, pid: int):
        """Forget a cached page outright (manager reset)."""
        if pid in self._cached:
            del self._cached[pid]
            self._free.append(pid)

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "total": self.n_pages,
            "live": self.live_pages,
            "cached": self.cached_pages,
            "free": self.free_pages,
            "reserved": self.reserved,
            "peak_live": self.peak_live,
            "allocs": self.allocs,
            "evictions": self.evictions,
        }
