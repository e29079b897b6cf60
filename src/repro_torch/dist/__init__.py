"""Distributed runtime; port of ``repro/dist``: the ``MeshPlan`` grid of
``topology``, the per-rank artifact loader of ``loader``, and the
``:overlap`` epilogue of ``overlap`` (imported where it runs)."""

from repro_torch.dist.loader import RankLoadStats, load_per_rank, rank_file
from repro_torch.dist.topology import MeshPlan, local_model_ranks

__all__ = ["MeshPlan", "RankLoadStats", "load_per_rank",
           "local_model_ranks", "rank_file"]
