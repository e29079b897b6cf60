"""The HTTP front end over tensor-parallel ranks: rank 0's boundary
messages and the other ranks' follower loop.

Under ``--tp N`` the ranks are separate processes (``launch/mesh.py``),
and each runs its own ``Scheduler`` over its share of the weights; their
decode steps meet in the row-TP collectives, so every rank must mutate
its scheduler the same way and step it the same number of times.  Rank
0 owns the HTTP server, the admission queue and the ``EngineLoop``; at
every step boundary it decides what to do once, records it in a
``Boundary`` and broadcasts that over the row group before it steps.
The other ranks run ``follow``: receive a boundary, apply it in the
same order, and step when rank 0 does.  No rank but 0 ever
decides: a follower never asks ``can_admit``, so a paged pool agrees by
construction.

A request keeps rank 0's rid on every rank: an unseeded request's
sample stream derives from it (``Scheduler._request_generator``).

A follower waits in the broadcast between boundaries; gloo fails a
collective that waits longer than the group's timeout (30 minutes by
default), so rank 0 sends an ``idle`` boundary every ``beat`` seconds
of quiet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch.distributed as dist

from repro_torch.runtime.scheduler import Scheduler

#: what the followers do after applying a boundary
STEP, IDLE, STOP = "step", "idle", "stop"


@dataclasses.dataclass
class Boundary:
    """What rank 0 does to its scheduler at one step boundary, in order:
    cancel the rids ``cancels``, submit the ``Request``s ``admissions``
    (as they stand at the boundary: no output yet), ``release_cache()``
    if asked, then ``action`` (``step()``, nothing, or stop)."""

    action: str = STEP
    cancels: list = dataclasses.field(default_factory=list)
    admissions: list = dataclasses.field(default_factory=list)
    release_cache: bool = False


class Controller:
    """Rank 0's end: broadcasts each ``Boundary`` over ``group`` (from
    the one thread that also steps the scheduler, so the boundaries and
    the steps' collectives keep one order), and keeps the emitted
    ``(rid, token)`` log.  ``beat``: the longest quiet (seconds) before
    an ``idle`` boundary is due."""

    def __init__(self, group: Any, *, beat: float = 30.0):
        self.group = group
        self.beat = beat
        self.src = dist.get_global_rank(group, 0)
        self.log: list = []
        self.sent = {STEP: 0, IDLE: 0, STOP: 0}
        self._last = time.monotonic()

    def send(self, msg: Boundary) -> None:
        dist.broadcast_object_list([msg], src=self.src, group=self.group)
        self.sent[msg.action] += 1
        self._last = time.monotonic()

    def beat_due(self) -> bool:
        return time.monotonic() - self._last >= self.beat

    def record(self, events) -> None:
        self.log += _tokens(events)


def _tokens(events) -> list:
    return [(ev.rid, ev.token) for ev in events if ev.token is not None]


def follow(scheduler: Scheduler, group: Any) -> dict:
    """Ranks 1..N-1: apply each boundary rank 0 broadcasts over ``group``
    to ``scheduler``, in rank 0's order, and step when it steps, until
    ``stop``.  Returns the emitted ``(rid, token)`` log and the count of
    boundaries by action."""
    src = dist.get_global_rank(group, 0)
    log: list = []
    received = {STEP: 0, IDLE: 0, STOP: 0}
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=src, group=group)
        msg = box[0]
        received[msg.action] += 1
        for rid in msg.cancels:
            scheduler.cancel(rid)
        for req in msg.admissions:
            scheduler.submit(req)
        if msg.release_cache:
            scheduler.release_cache()
        if msg.action == STOP:
            return {"log": log, "received": received}
        if msg.action == STEP:
            log += _tokens(scheduler.step())
