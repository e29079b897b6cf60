"""MeshPlan, the device-grid half of the deployment plan; port of
``repro/dist/topology.py`` (``parse``, ``shorthand``, ``size``).

Shorthands as in the reference: ``dp1xtp1`` (the default), ``dp1xtp2``,
``dp2xtp4``, ``dp4xtp2xep2``.  The port runs tensor parallelism only:
a plan with ``dp > 1`` or an ``ep`` degree raises, naming the slice that
ports it.  The ranks themselves are processes set up by
``launch/mesh.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

__all__ = ["MeshPlan"]

_AXIS_RE = re.compile(r"^(dp|tp|ep)(\d+)$")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One DP x TP (x EP) grid: ``dp`` the data-parallel degree, ``tp``
    the tensor-parallel degree the row-TP epilogues reduce over."""

    dp: int = 1
    tp: int = 1
    ep: Optional[int] = None

    def __post_init__(self):
        for field in ("dp", "tp"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.ep is not None and (not isinstance(self.ep, int)
                                    or self.ep < 1):
            raise ValueError(f"ep must be a positive int, got {self.ep!r}")
        if self.dp > 1 or self.ep is not None:
            raise ValueError(
                f"mesh {self.shorthand()}: data and expert parallelism are "
                f"not ported yet; the port runs dp1xtpN until the "
                f"distributed-runtime slice (ROADMAP.md queue 1, item 9)")

    @classmethod
    def parse(cls, value: Union["MeshPlan", str, None]) -> "MeshPlan":
        """Parse a plan, a ``"dp<N>xtp<M>[xep<K>]"`` shorthand (terms in
        any order, each once), or None (-> dp1xtp1)."""
        if value is None:
            return cls()
        if isinstance(value, MeshPlan):
            return value
        if not isinstance(value, str):
            raise TypeError(f"expected MeshPlan or string shorthand, "
                            f"got {type(value).__name__}")
        seen = {}
        for part in value.split("x"):
            m = _AXIS_RE.match(part)
            if m is None:
                raise ValueError(f"unknown mesh spec {value!r}, expected "
                                 f"'dp<N>xtp<M>[xep<K>]' (e.g. 'dp1xtp2')")
            axis, deg = m.group(1), int(m.group(2))
            if axis in seen:
                raise ValueError(f"mesh spec {value!r} repeats the {axis!r} "
                                 f"axis")
            seen[axis] = deg
        if "dp" not in seen or "tp" not in seen:
            raise ValueError(f"mesh spec {value!r} must name both dp and tp "
                             f"degrees")
        return cls(dp=seen["dp"], tp=seen["tp"], ep=seen.get("ep"))

    def shorthand(self) -> str:
        s = f"dp{self.dp}xtp{self.tp}"
        if self.ep is not None:
            s += f"xep{self.ep}"
        return s

    @property
    def size(self) -> int:
        """Ranks the plan spans."""
        return self.dp * self.tp
