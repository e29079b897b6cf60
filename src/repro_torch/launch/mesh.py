"""One process per tensor-parallel rank; counterpart of
``repro/launch/mesh.py`` (which joins JAX processes into one mesh).

The backend rule:

* on the card, NCCL with one card per rank when at least ``tp`` cards
  are visible;
* on the card with fewer cards than ranks, gloo: every rank sits on
  ``cuda:0`` and ``comm/dispatch.py`` copies each payload to host memory
  before the gloo call and back after it ("gloo via host");
* on the CPU, gloo.

A failure to set up the group raises; nothing switches backend.  The
group meets through a file under a temporary directory, never a TCP
port, so runs side by side do not collide.  A rank on the CPU runs one
intra-op thread, so ``tp`` ranks take ``tp`` cores.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(tp: int, device_type: str) -> str:
    """``"nccl"`` when each of ``tp`` ranks can have its own card, else
    ``"gloo"``."""
    if device_type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def transport(tp: int, device_type: str) -> str:
    """What carries the collectives of ``tp`` ranks, as every TP report
    names it."""
    if backend_for(tp, device_type) == "nccl":
        return f"nccl, {tp} cards"
    if device_type == "cuda":
        return f"gloo via host, {tp} ranks on 1 card"
    return f"gloo, {tp} ranks on the CPU"


@dataclasses.dataclass(frozen=True)
class RankContext:
    """This process's place in the ring."""

    rank: int
    tp: int
    group: Optional[Any]          # the ranks' process group
    device: torch.device

    @property
    def transport(self) -> str:
        return transport(self.tp, self.device.type)


def init_rank(rank: int, tp: int, init_file: str,
              device_type: str = "cuda") -> RankContext:
    """Join the ``tp``-rank group that meets at ``init_file`` and pick this
    rank's device by the backend rule."""
    backend = backend_for(tp, device_type)
    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=tp, rank=rank)
    return RankContext(rank=rank, tp=tp, group=dist.group.WORLD,
                       device=device)


def _rank_main(rank: int, fn: Callable, tp: int, init_file: str,
               device_type: str, out_dir: str, args: tuple):
    if device_type == "cpu":
        torch.set_num_threads(1)
    ctx = init_rank(rank, tp, init_file, device_type)
    try:
        result = fn(ctx, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run(fn: Callable, tp: int, *args, device_type: str = "cuda",
        timeout: float = 600.0) -> list:
    """Run ``fn(ctx, *args)`` in ``tp`` spawned rank processes and return
    each rank's result, in rank order.  ``fn`` must be a module-level
    function and its arguments and result picklable.  A rank that raises
    makes this raise (the others are stopped); so does a run that
    outlasts ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="tp-ranks-") as tmp:
        init_file = os.path.join(tmp, "group")
        procs = mp.start_processes(
            _rank_main, args=(fn, tp, init_file, device_type, tmp, args),
            nprocs=tp, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not procs.join(timeout=max(0.0, deadline
                                             - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{tp} ranks did not finish within "
                                       f"{timeout:.0f} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        # the ranks' own files, written by this program
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(tp)]
