"""Distributed runtime; port of ``repro/dist``: the ``MeshPlan`` of
``topology`` and the per-rank artifact loader of ``loader`` (the
overlapped ring follows in a later slice, ROADMAP.md queue 1 item 9)."""

from repro_torch.dist.loader import RankLoadStats, load_per_rank, rank_file
from repro_torch.dist.topology import MeshPlan

__all__ = ["MeshPlan", "RankLoadStats", "load_per_rank", "rank_file"]
