"""TP epilogue collectives: the spec (``CollectiveSpec``), the per-layer
plan (``CollectivePlan``) and the strategy registry (``comm/dispatch.py``);
port of ``repro/comm``."""

from repro_torch.comm.spec import (CollectivePlan, CollectiveSpec,
                                   parse_collective)
from repro_torch.comm import dispatch

__all__ = ["CollectivePlan", "CollectiveSpec", "parse_collective",
           "dispatch"]
