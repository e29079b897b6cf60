"""Overlapped quantized TP epilogues: the down GEMM pipelined against the
quantized ring one row microbatch at a time; port of
``repro/dist/overlap.py``.

The synchronous quantized collectives (``comm/dispatch.py``) close a
row-TP layer with the ring issued after the whole down GEMM.  Here the
GEMM runs over two row microbatches, and the first microbatch's ring is
on the wire while the second's GEMM runs:

    gemm(mb0) -> ring_start(mb0) -> gemm(mb1) -> ring_start(mb1)
              -> ring_finish(mb0) -> ring_finish(mb1)

The ring is the synchronous strategies' own, in its two halves
(``comm.dispatch.ring_start`` posts phase 1's all-to-alls without
waiting, ``ring_finish`` waits and runs the rest), so the arithmetic and
the counted wire bytes are theirs.  The reference decomposes the ring
into single-step rotations because JAX has no asynchronous collectives;
torch posts the same all-to-all asynchronously.

What can be seen: each microbatch's ring window runs from the start of
its ``torch.profiler`` range ``overlap.post mb<i>`` to the end of
``overlap.wait mb<i>``; both microbatches' GEMMs run on the current
stream (the wire kernel keeps its counters per stream).  mb1's GEMM is
launched inside mb0's window by construction, so ``stats`` also records
whether mb0's phase 1 was still incomplete once that GEMM had been
launched: the witness that a transfer was in flight beside it.

The split.  The largest leading dim is split in two (``m0 = n // 2``, as
in the reference); each output row is its own dot product, so a split
changes no arithmetic as long as both halves' GEMMs sum each row as the
whole call would.  K1 and K3 sum in another order on their tensor-core
loop (float32 at ``M >= 256``) than on their decode loop, so
``pipelined_epilogue`` takes the kernel's ``loop`` and splits only where
both halves take the whole call's loop (``split_rows``); otherwise it
runs the ring on the whole call.  torch's CPU GEMM gives the rows of a
one-row call in another order than those of a larger one, so on the CPU
an odd batch of 3 (1 + 2) is equal to the per-microbatch GEMMs followed
by the synchronous ring, not to the whole GEMM's.

At tp=1 the epilogue is the GEMM.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.comm import dispatch as comm

__all__ = ["OverlapStats", "stats", "pipelined_epilogue", "split_rows"]


class OverlapStats:
    """Pipelined sites this process ran, and of them those whose mb0 ring
    was still in flight once mb1's GEMM had been launched."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sites = 0
        self.in_flight = 0

    def record(self, in_flight: bool):
        self.sites += 1
        self.in_flight += int(in_flight)


stats = OverlapStats()


def split_rows(lead: tuple, loop: Optional[Callable[[int], Any]] = None
               ) -> Optional[tuple[int, int]]:
    """Where ``pipelined_epilogue`` splits leading dims ``lead``:
    ``(axis, m0)`` (the largest dim, at half), or None when no dim has two
    rows, or when ``loop`` (rows -> the GEMM's main loop) names another
    loop for either half than for the whole call."""
    if not lead:
        return None
    ax = max(range(len(lead)), key=lambda i: lead[i])
    if lead[ax] < 2:
        return None
    m0 = lead[ax] // 2
    if loop is not None:
        other = math.prod(lead) // lead[ax]
        whole = loop(lead[ax] * other)
        if (loop(m0 * other) != whole
                or loop((lead[ax] - m0) * other) != whole):
            return None
    return ax, m0


def pipelined_epilogue(y1: torch.Tensor, group, spec, gemm: Callable,
                       gemm_wire: Optional[Callable] = None, *,
                       loop: Optional[Callable[[int], Any]] = None
                       ) -> torch.Tensor:
    """Down GEMM and the quantized ring, pipelined over two row
    microbatches.

    ``y1`` is the first GEMM's activation ``(..., k)``; ``gemm`` maps rows
    of it to this rank's partial output, and ``gemm_wire`` (where the
    ``:fused`` wire kernel serves the site) to a ``WirePayload`` instead.
    ``loop`` names the main loop a GEMM of so many rows takes
    (``kernels.dispatch.main_loop``); the split is ``split_rows``'.  An
    input it does not split runs the ring on the whole GEMM."""
    if comm.axis_size(group) == 1:
        return gemm(y1)

    def down(rows):
        return gemm(rows) if gemm_wire is None else gemm_wire(rows)

    def post(out, mb: int) -> comm.PendingRing:
        with record_function(f"overlap.post mb{mb}"):
            if gemm_wire is None:
                return comm.ring_start(out, group, spec)
            return comm.ring_start_wire(out, group, spec)

    def finish(pend: comm.PendingRing, mb: int) -> torch.Tensor:
        with record_function(f"overlap.wait mb{mb}"):
            pend.wait()
        return comm.ring_finish(pend)

    split = split_rows(tuple(y1.shape[:-1]), loop)
    if split is None:
        return finish(post(down(y1), 0), 0)
    ax, m0 = split
    first = post(down(y1.narrow(ax, 0, m0)), 0)
    out1 = down(y1.narrow(ax, m0, y1.shape[ax] - m0))
    stats.record(first.in_flight())
    second = post(out1, 1)
    return torch.cat([finish(first, 0), finish(second, 1)], dim=ax)
