"""PagedCacheManager — host-side page tables bridging scheduler slots to
the device page pool; port of ``repro/cache/manager.py`` (host-side,
copied verbatim).

Lifecycle per request (driven by ``runtime/scheduler.py``):

* ``admit(slot, prompt, max_new)`` — reserve the worst-case page count
  (``ceil((plen + max_new - 1) / ps)`` minus prefix-shared pages) so
  mid-decode growth can never deadlock, retain every complete shared
  prefix page, allocate + register the owned full prompt pages, and
  return ``fed0``: the first prompt position this slot must actually
  feed (shared complete pages are skipped — their K/V already exists —
  capped at ``plen - 1`` so the last prompt token always runs and
  yields the first logits).
* ``ensure(slot, pos)`` — before each decode step: allocate the page
  ``pos`` scatters into if the table doesn't cover it yet (drawing down
  the admission reservation).
* ``advance(slot, fed)`` — after each step: mark owned prompt pages
  complete once fully written, making them shareable.
* ``release(slot)`` — retire: return the unused reservation, drop one
  reference per page; refcount-0 pages go back to the free list, except
  registered complete prefix pages which park in the allocator's LRU so
  an identical future prompt can resurrect them (evicted only under
  pressure).

The page table itself is a dense ``(max_batch, pmax)`` int32 array
(``table()``) handed to the decode step each step (on the card the
captured step copies it into its static table buffer).  The device pool
carries ONE extra physical page (``pool_pages == n_pages + 1``) the
allocator never hands out: the *scratch* page.  Unallocated table
entries point at it (hidden by the position mask on gather), and —
crucially — idle lanes of the fixed-shape decode program scatter their
dummy token there.  Without it an empty slot's table row would alias a
live page (the allocator hands out page 0 first) and every idle step
would corrupt that page's first K/V row.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cache.allocator import PageAllocator
from repro_torch.cache.prefix import PrefixStore, chain_keys
from repro_torch.cache.spec import PageSpec


@dataclasses.dataclass
class _SlotPages:
    pages: list            # pids, table order (index i covers tokens
                           # [i * ps, (i + 1) * ps))
    full_prompt: int       # prompt full-page count (shareable prefix run)
    shared: int            # leading pages retained from the prefix store
    reserved_left: int     # admission reservation not yet drawn down
    next_complete: int     # first owned prompt page not yet complete


class PagedCacheManager:
    def __init__(self, spec: PageSpec, *, max_batch: int, max_seq: int,
                 n_pages: int = None):
        if not spec.paged:
            raise ValueError("PagedCacheManager needs a paged PageSpec")
        self.spec = spec
        self.page_size = spec.page_size
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.pmax = spec.pages_for(max_seq)
        # default pool == dense worst case (B slots x full-length rows):
        # paging is then strictly better under sharing, never worse
        self.n_pages = n_pages if n_pages else max_batch * self.pmax
        # physical page n_pages is the scratch page (see module docstring)
        self.scratch = self.n_pages
        self.alloc = PageAllocator(self.n_pages, evict_cb=self._on_evict)
        self.prefix = PrefixStore()
        self._tables = np.full((max_batch, self.pmax), self.scratch,
                               np.int32)
        self._slots: dict[int, _SlotPages] = {}
        # (actual, fp-equivalent) bytes per page; set by the scheduler
        # once the device pool exists (layer dims live there)
        self.page_bytes = 0
        self.page_bytes_fp = 0

    def _on_evict(self, pid: int):
        self.prefix.unregister(pid)

    # ------------------------------------------------------------------

    @property
    def pool_pages(self) -> int:
        """Physical pages the device pool must hold: the allocatable
        ``n_pages`` plus the trailing scratch page idle decode lanes
        scatter into."""
        return self.n_pages + 1

    def pages_needed(self, plen: int, max_new: int) -> int:
        """Worst-case pages one request can touch: positions
        ``0 .. plen + max_new - 2`` get written (the final sampled token
        is never fed back)."""
        return self.spec.pages_for(plen + max_new - 1)

    def can_admit(self, plen: int, max_new: int, *,
                  pending_pages: int = 0) -> bool:
        """Conservative (sharing ignored) admission check; the manager
        may admit on less once shared pages are credited."""
        return self.alloc.can_reserve(self.pages_needed(plen, max_new)
                                      + pending_pages)

    def admit(self, slot: int, prompt: np.ndarray, max_new: int) -> int:
        """Bind a request to ``slot``; returns ``fed0`` (see module
        docstring).  Raises ``OutOfPages`` if the worst case (minus
        shared pages) doesn't fit — callers gate on ``can_admit``."""
        assert slot not in self._slots, f"slot {slot} already bound"
        plen = int(prompt.size)
        worst = self.pages_needed(plen, max_new)
        keys = chain_keys(prompt, self.page_size)

        shared = []
        for key in keys:
            pid = self.prefix.lookup(key)
            if pid is None:
                break
            shared.append(pid)
        m, full = len(shared), len(keys)
        self.alloc.reserve(worst - m)
        for pid in shared:
            self.alloc.retain(pid)
        self.prefix.hits += m
        self.prefix.misses += full - m

        sp = _SlotPages(pages=list(shared), full_prompt=full, shared=m,
                        reserved_left=worst - m, next_complete=m)
        # owned full prompt pages: allocated (and keyed) up front so a
        # concurrent identical prompt can find + share them on completion
        for i in range(m, full):
            pid = self.alloc.alloc(reserved=True)
            sp.reserved_left -= 1
            self.prefix.register(pid, keys[i])
            sp.pages.append(pid)
        self._slots[slot] = sp
        self._tables[slot, :len(sp.pages)] = sp.pages
        return min(m * self.page_size, plen - 1)

    def ensure(self, slot: int, pos: int):
        """Guarantee the page covering ``pos`` exists before the scatter."""
        sp = self._slots[slot]
        idx = pos // self.page_size
        while len(sp.pages) <= idx:
            pid = self.alloc.alloc(reserved=True)
            sp.reserved_left -= 1
            self._tables[slot, len(sp.pages)] = pid
            sp.pages.append(pid)

    def advance(self, slot: int, fed: int):
        """``fed`` tokens are now in the cache: owned prompt pages whose
        last position was just written become shareable."""
        sp = self._slots[slot]
        while (sp.next_complete < sp.full_prompt
               and fed >= (sp.next_complete + 1) * self.page_size):
            self.prefix.mark_complete(sp.pages[sp.next_complete])
            sp.next_complete += 1

    def release(self, slot: int):
        """Retire the slot: refund the unused reservation and drop this
        request's reference on every page."""
        sp = self._slots.pop(slot, None)
        if sp is None:
            return
        self.alloc.unreserve(sp.reserved_left)
        for pid in sp.pages:
            if self.prefix.is_complete(pid):
                self.alloc.release(pid, keep_cached=True)
            else:
                # an owned prompt page that never completed (cancel
                # mid-prompt) is unshareable: drop its key with it
                if self.alloc.refcount(pid) == 1:
                    self.prefix.unregister(pid)
                self.alloc.release(pid)
        self._tables[slot] = self.scratch

    # ------------------------------------------------------------------

    def table(self) -> np.ndarray:
        """The (max_batch, pmax) int32 page table the decode step takes."""
        return self._tables

    def slot_pages(self, slot: int) -> int:
        sp = self._slots.get(slot)
        return len(sp.pages) if sp else 0

    @property
    def live_slots(self) -> int:
        return len(self._slots)

    def reset(self):
        """Drop everything, including the retained prefix LRU (the
        device pool is being released)."""
        assert not self._slots, "reset with live slots"
        for pid in list(self.prefix._by_pid):
            self.prefix.unregister(pid)
            self.alloc.drop_cached(pid)
        self._tables[:] = self.scratch

    def stats(self) -> dict:
        a = self.alloc.stats()
        out = {
            "spec": self.spec.shorthand(),
            "page_size": self.page_size,
            "pages": a,
            "prefix": self.prefix.stats(),
            "per_slot_pages": {int(s): len(sp.pages)
                               for s, sp in sorted(self._slots.items())},
        }
        if self.page_bytes:
            out["bytes"] = {
                "per_page": self.page_bytes,
                "pool": self.page_bytes * self.n_pages,
                "live": self.page_bytes * a["live"],
                "peak_live": self.page_bytes * a["peak_live"],
                "dense_equiv": (self.page_bytes_fp * self.pmax
                                * self.max_batch),
                "saved_quantized": ((self.page_bytes_fp - self.page_bytes)
                                    * self.n_pages),
                "saved_prefix": self.page_bytes * self.prefix.hits,
            }
        return out
