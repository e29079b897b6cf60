"""Distributed runtime; port of ``repro/dist`` (so far the ``MeshPlan``
of ``topology``; the per-rank artifact loader and the overlapped ring
follow in a later slice, ROADMAP.md queue 1 item 9)."""

from repro_torch.dist.topology import MeshPlan

__all__ = ["MeshPlan"]
