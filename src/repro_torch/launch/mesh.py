"""One process per rank of a ``(dp, tp)`` grid; counterpart of
``repro/launch/mesh.py`` (which joins JAX processes into one mesh).

Process ``p`` sits at data rank ``p // tp`` and model rank ``p % tp``
(``dist.topology.local_model_ranks``), row-major as the reference's
``build_mesh`` orders its devices.  Each row of ``tp`` processes is one
tensor-parallel group (``RankContext.group``): its row-TP epilogues
reduce over it, and it serves on its own, as a data-parallel replica.
Each column of ``dp`` processes is a data group
(``RankContext.data_group``), for collectives over the data axis.

The backend rule, over all ``dp * tp`` ranks:

* on the card, NCCL with one card per rank when at least ``dp * tp``
  cards are visible;
* on the card with fewer cards than ranks, gloo: every rank sits on
  ``cuda:0`` and ``comm/dispatch.py`` copies each payload to host memory
  before the gloo call and back after it ("gloo via host");
* on the CPU, gloo.

A failure to set up the group raises; nothing switches backend.  The
group meets through a file under a temporary directory, never a TCP
port, so runs side by side do not collide.  A rank on the CPU runs one
intra-op thread, so ``dp * tp`` ranks take as many cores.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import tempfile
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.topology import MeshPlan, local_model_ranks


def backend_for(ranks: int, device_type: str) -> str:
    """``"nccl"`` when each of ``ranks`` ranks can have its own card, else
    ``"gloo"``."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def transport(tp: int, device_type: str, dp: int = 1) -> str:
    """What carries the collectives of a ``dp x tp`` grid, as every TP
    report names it."""
    n = dp * tp
    grid = "" if dp == 1 else f" (dp{dp} x tp{tp})"
    if backend_for(n, device_type) == "nccl":
        return f"nccl, {n} cards{grid}"
    if device_type == "cuda":
        return f"gloo via host, {n} ranks{grid} on 1 card"
    return f"gloo, {n} ranks{grid} on the CPU"


@dataclasses.dataclass(frozen=True)
class RankContext:
    """This process's place in the grid."""

    rank: int                     # model-axis rank: its place in the ring
    tp: int
    group: Optional[Any]          # its row's tp ranks (None at tp=1)
    device: torch.device
    dp: int = 1
    dp_rank: int = 0              # data-axis rank: its row
    data_group: Optional[Any] = None   # its column's dp ranks (None at dp=1)

    @property
    def process(self) -> int:
        """Its index in the grid, row-major."""
        return self.dp_rank * self.tp + self.rank

    @property
    def transport(self) -> str:
        return transport(self.tp, self.device.type, self.dp)


def init_rank(process: int, tp: int, init_file: str,
              device_type: str = "cuda", dp: int = 1) -> RankContext:
    """Join the ``dp * tp``-rank group that meets at ``init_file``, pick
    this process's device by the backend rule, and make the row and
    column groups (every process makes every group, in the same order,
    as ``dist.new_group`` requires)."""
    plan = MeshPlan(dp=dp, tp=tp)
    backend = backend_for(plan.size, device_type)
    if device_type == "cuda":
        device = torch.device("cuda", process if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=plan.size, rank=process)
    (rank,) = local_model_ranks(plan, process)
    dp_rank = process // tp
    if dp == 1:
        group, data_group = dist.group.WORLD, None
    else:
        rows = [dist.new_group([d * tp + t for t in range(tp)])
                for d in range(dp)]
        cols = [dist.new_group([d * tp + t for d in range(dp)])
                for t in range(tp)]
        group, data_group = rows[dp_rank], cols[rank]
    if tp == 1:
        group = None
    elif dist.get_rank(group) != rank:
        raise RuntimeError(f"process {process}: rank {dist.get_rank(group)} "
                           f"of its row, expected {rank}")
    # every process holds its connections before any returns: one that
    # raised early (a mismatched plan) and exited would otherwise fail
    # another's set-up, and that error would hide its own
    dist.barrier()
    return RankContext(rank=rank, tp=tp, group=group, device=device, dp=dp,
                       dp_rank=dp_rank, data_group=data_group)


def _rank_main(process: int, fn: Callable, tp: int, dp: int, init_file: str,
               device_type: str, out_dir: str, args: tuple):
    if device_type == "cpu":
        torch.set_num_threads(1)
    ctx = init_rank(process, tp, init_file, device_type, dp)
    try:
        result = fn(ctx, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{process}.pt"))
    # The result is on disk: leave without the interpreter's teardown.
    # Under load, a C++ static destructor run there aborts the process
    # now and then ("terminate called without an active exception",
    # SIGABRT, no Python frame left), which failed a run whose work was
    # done.  A rank that raised still exits through the spawn wrapper,
    # which reports its traceback.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run(fn: Callable, tp: int, *args, device_type: str = "cuda",
        timeout: Optional[float] = 600.0, dp: int = 1,
        interrupt_to: Optional[int] = None) -> list:
    """Run ``fn(ctx, *args)`` in ``dp * tp`` spawned processes and return
    each one's result, in process order (row-major: data rank, then
    model rank).  ``fn`` must be a module-level function and its
    arguments and result picklable.  A process that raises makes this
    raise (the others are stopped); so does a run that outlasts
    ``timeout`` seconds (``None``: no deadline, as a server runs).

    ``interrupt_to``: while the processes run, a SIGINT to this one is
    passed on to that process, which decides what an interrupt means
    (the HTTP front end drains), instead of stopping the run."""
    n = dp * tp
    with tempfile.TemporaryDirectory(prefix="tp-ranks-") as tmp:
        init_file = os.path.join(tmp, "group")
        procs = mp.start_processes(
            _rank_main, args=(fn, tp, dp, init_file, device_type, tmp, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        previous = None
        if interrupt_to is not None:
            target = procs.processes[interrupt_to]
            previous = signal.signal(
                signal.SIGINT, lambda *_: target.is_alive()
                and os.kill(target.pid, signal.SIGINT))
        try:
            while not procs.join(timeout=None if deadline is None else
                                 max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{timeout:.0f} s")
        finally:
            if previous is not None:
                signal.signal(signal.SIGINT, previous)
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        # the ranks' own files, written by this program
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
