"""MeshPlan, the device-grid half of the deployment plan; port of
``repro/dist/topology.py`` (``parse``, ``shorthand``, ``size``,
``local_model_ranks``).

Shorthands as in the reference: ``dp1xtp1`` (the default), ``dp1xtp2``,
``dp2xtp4``, ``dp4xtp2xep2`` (``ep`` must divide ``dp``: expert groups
are carved out of the data axis).  The grid is ``(dp, tp)``, the data
axis by the model axis, its processes numbered row-major as the
reference's ``build_mesh`` reshapes its devices: process ``p`` sits at
data rank ``p // tp`` and model rank ``p % tp``.  The processes are set
up by ``launch/mesh.py``: each row of ``tp`` ranks is one tensor-parallel
group and serves on its own, each column of ``dp`` ranks a data group.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

__all__ = ["MeshPlan", "local_model_ranks"]

_AXIS_RE = re.compile(r"^(dp|tp|ep)(\d+)$")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """One DP x TP (x EP) grid: ``dp`` the data-parallel degree, ``tp``
    the tensor-parallel degree the row-TP epilogues reduce over, ``ep``
    an optional expert-parallel degree that divides ``dp``."""

    dp: int = 1
    tp: int = 1
    ep: Optional[int] = None

    def __post_init__(self):
        for field in ("dp", "tp"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.ep is not None:
            if not isinstance(self.ep, int) or self.ep < 1:
                raise ValueError(f"ep must be a positive int, got "
                                 f"{self.ep!r}")
            if self.dp % self.ep != 0:
                raise ValueError(
                    f"ep={self.ep} must divide dp={self.dp} (expert groups "
                    f"are carved out of the data axis)")

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
                                 f"'dp<N>xtp<M>[xep<K>]' (e.g. 'dp2xtp4')")
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


def local_model_ranks(plan: MeshPlan, process: int) -> tuple:
    """The model-axis ranks process ``process`` of the ``(dp, tp)`` grid
    owns: one process per rank in the port, so ``(process % tp,)``, the
    rank file ``dist/loader.py`` lets it read."""
    if not 0 <= process < plan.size:
        raise ValueError(f"process {process} is not one of mesh "
                         f"{plan.shorthand()}'s {plan.size}")
    return (process % plan.tp,)
