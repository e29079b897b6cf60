"""Per-rank artifact loading: each rank reads only its own file; port of
``repro/dist/loader.py`` (``RankLoadStats``, ``rank_file``,
``load_per_rank``).

In the reference one process may own several devices of a mesh, so
``load_per_rank`` reads the files of the ranks it owns and assembles
global sharded arrays from them.  In the port every rank of the
``(dp, tp)`` grid is a process of its own (``launch/mesh.py``) and runs
on its slices of the params (``runtime/serve.py``), so there is no
global array to assemble: a process reads ``rank_NN.npz`` for its
model-axis rank ``NN`` (``dist.topology.local_model_ranks``: the same
file in every row of the grid, since the artifact pins only the TP
degree) and nothing else.  The other ranks' files are only
``os.path.getsize``d, for the byte ledger.

Rank files are cut by the model axis only, so under expert parallelism
a process reads its whole rank file and keeps its data rank's share of
each layer's experts (``runtime/serve.make_engine``);
``expert_bytes_resident`` against ``expert_bytes_loaded`` is that
share.

``RankLoadStats`` is the proof: ``file_bytes_loaded`` (the bytes of the
file this rank read) against ``file_bytes_total`` (all rank files); at
tp > 1 the first is less.  The serve banner prints both.  An artifact's
``aux.npz`` (the attention folds) is read whole by every rank, as the
reference's ``load_for_mesh`` reads it (``load_aux``); its bytes are
``aux_bytes_loaded``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from repro_torch import interop
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import checkpoint

__all__ = ["RankLoadStats", "load_aux", "load_per_rank", "rank_file"]

AUX = "aux.npz"


@dataclasses.dataclass(frozen=True)
class RankLoadStats:
    """What this rank read off disk."""

    ranks: tuple                 # the model-axis ranks whose files were read
    bytes_loaded: int            # sum of leaf nbytes across those files
    file_bytes_loaded: int       # on-disk bytes of the files read
    file_bytes_total: int        # on-disk bytes of all rank files
    aux_bytes_loaded: int = 0    # on-disk bytes of the aux.npz read
    # an MoE model under expert parallelism: the experts' leaf bytes in
    # the file read, and those this process keeps (its data rank's share)
    expert_bytes_loaded: int = 0
    expert_bytes_resident: int = 0

    @property
    def resident_fraction(self) -> float:
        if not self.file_bytes_total:
            return 1.0
        return self.file_bytes_loaded / self.file_bytes_total


def rank_file(dirpath: str, r: int) -> str:
    return os.path.join(dirpath, f"rank_{r:02d}.npz")


def load_per_rank(dirpath: str, manifest: dict, rank: int, *,
                  device: DeviceLike = None) -> tuple[Any, RankLoadStats]:
    """Rank ``rank``'s planned tree from the artifact at ``dirpath``, in
    the port's layout (a list of layers) on ``device`` (default: the CUDA
    card), read from its own file only; and the byte ledger."""
    tp = int(manifest["tp"])
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} is not one of the artifact's "
                         f"{tp} ranks")
    missing = [r for r in range(tp)
               if not os.path.exists(rank_file(dirpath, r))]
    if missing:
        raise FileNotFoundError(
            f"{dirpath} is missing rank files {missing} (artifact was "
            f"prepared for tp={tp})")
    dev = resolve_device(device)
    tree = interop.to_port_layout(checkpoint.load(rank_file(dirpath, rank)))
    stats = RankLoadStats(
        ranks=(rank,),
        bytes_loaded=sum(t.nbytes for t in
                         checkpoint.flatten_keys(tree).values()),
        file_bytes_loaded=os.path.getsize(rank_file(dirpath, rank)),
        file_bytes_total=sum(os.path.getsize(rank_file(dirpath, r))
                             for r in range(tp)))
    return checkpoint.map_tensors(tree, lambda _, t: t.to(dev)), stats


def load_aux(dirpath: str, *, device: DeviceLike = None
             ) -> tuple[Any, int]:
    """The artifact's aux tree (the reference's layout: folds stacked
    over the layers) on ``device`` (default: the CUDA card), and the
    bytes of its file; ``(None, 0)`` when it has none."""
    path = os.path.join(dirpath, AUX)
    if not os.path.exists(path):
        return None, 0
    dev = resolve_device(device)
    return (checkpoint.map_tensors(checkpoint.load(path),
                                   lambda _, t: t.to(dev)),
            os.path.getsize(path))
