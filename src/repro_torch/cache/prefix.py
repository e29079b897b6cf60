"""Prefix sharing: content-addressed prompt pages via chained hashes;
port of ``repro/cache/prefix.py`` (host-side, copied verbatim: the keys
are the reference's).

A prompt's cacheable unit is a FULL page of prompt tokens.  Page ``i``'s
key is ``hash(key_{i-1} || tokens[i*ps : (i+1)*ps])`` — chaining makes
the key a commitment to the *entire* prefix, so two prompts share page
``i`` iff their first ``(i+1) * ps`` tokens are identical.  K/V entries
are position-dependent but a shared page always holds the same tokens at
the same positions, so its contents are identical across sharers —
writes into shared pages are idempotent, which is what makes concurrent
sharing (and replay-skip over complete pages) safe without any actual
copy; see DESIGN.md §9 for the full copy-on-write protocol.

A page becomes *complete* (lookupable) once its last position has been
written; incomplete registrations exist so the owner can be found for
completion marking, but ``lookup`` never returns them — a request racing
an unfinished identical prompt simply allocates its own pages.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def chain_keys(tokens: np.ndarray, page_size: int) -> list[bytes]:
    """One chained key per FULL page of ``tokens`` (the ragged tail page
    is never shareable — its contents keep changing as decode appends)."""
    tokens = np.asarray(tokens, np.int64)
    keys = []
    h = b"kv-prefix-v1"
    for i in range(tokens.size // page_size):
        page = tokens[i * page_size:(i + 1) * page_size]
        h = hashlib.sha1(h + page.tobytes()).digest()
        keys.append(h)
    return keys


class PrefixStore:
    """key <-> page-id registry with completion state + hit counters."""

    def __init__(self):
        self._by_key: dict[bytes, int] = {}
        self._by_pid: dict[int, tuple[bytes, bool]] = {}  # pid -> (key, done)
        self.hits = 0            # pages resolved to an existing complete page
        self.misses = 0          # full prompt pages that had to be allocated

    def lookup(self, key: bytes) -> Optional[int]:
        """Page id holding this exact prefix page, if complete."""
        pid = self._by_key.get(key)
        if pid is None or not self._by_pid[pid][1]:
            return None
        return pid

    def register(self, pid: int, key: bytes):
        """Claim ``key`` for a page being filled (incomplete).  First
        writer wins: a key already registered (complete or in flight)
        is left alone and the new page stays anonymous."""
        if key in self._by_key or pid in self._by_pid:
            return
        self._by_key[key] = pid
        self._by_pid[pid] = (key, False)

    def mark_complete(self, pid: int):
        ent = self._by_pid.get(pid)
        if ent is not None:
            self._by_pid[pid] = (ent[0], True)

    def is_registered(self, pid: int) -> bool:
        return pid in self._by_pid

    def is_complete(self, pid: int) -> bool:
        ent = self._by_pid.get(pid)
        return ent is not None and ent[1]

    def unregister(self, pid: int):
        ent = self._by_pid.pop(pid, None)
        if ent is not None:
            self._by_key.pop(ent[0], None)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "registered": len(self._by_key),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
        }
