"""Offline reordering plans (paper Algorithm 1 and the TP-aware fold);
port of ``repro/core/reorder.py``.

Schemes: ``naive-actorder`` (original rows + ``g_idx`` gather),
``exllama`` (Algorithm-1 sorted rows, runtime P2 permute) and ``tp-aware``
(Algorithm 3: P2 folded offline into the column-TP weights).
``shard_pair`` splits a plan into the per-rank plans of tensor
parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.quantization import QuantizedLinear

SCHEMES = ("naive-actorder", "exllama", "tp-aware")


@dataclasses.dataclass(frozen=True)
class PlannedPair:
    """A column-TP -> row-TP quantized GEMM pair, deployment-ready.

    ``gate`` is the optional second column-TP matrix of a SwiGLU pair;
    ``p1_gate`` None means the gate shares ``p1_up``'s gather.
    """

    up: QuantizedLinear                    # (K1, N1)
    gate: Optional[QuantizedLinear]        # (K1, N1)
    down: QuantizedLinear                  # (N1, N2)
    p1_up: Optional[torch.Tensor]          # (K1,) X-gather perm
    p1_gate: Optional[torch.Tensor]
    p2: Optional[torch.Tensor]             # (N1,) down-rows perm
    scheme: str

    def forward(self, x: torch.Tensor, policy=None, group=None, *,
                activation: Optional[str] = None,
                pair_path: Optional[str] = None) -> torch.Tensor:
        """Run the pair under ``policy`` (an ``ExecutionPolicy``; None =
        defaults).  ``group=None`` runs it on one device; with the process
        group of the TP ranks, ``self`` is this rank's shard
        (``shard_pair``) and the row-TP epilogue closes with the
        collective ``policy.collective.resolve(pair_path)``."""
        from repro_torch.core import schemes

        if group is None:
            return schemes.pair_forward_reference(x, self, policy,
                                                  activation=activation)
        return schemes.pair_forward_tp(x, self, group, policy,
                                       activation=activation,
                                       pair_path=pair_path)

    @property
    def k1(self) -> int:
        return self.up.k

    @property
    def n1(self) -> int:
        return self.up.n

    @property
    def n2(self) -> int:
        return self.down.n


@dataclasses.dataclass(frozen=True)
class PairBundle:
    """Quantize-stage output for one pair: every layout, no scheme yet."""

    up: qz.QuantResult
    gate: Optional[qz.QuantResult]
    down: qz.QuantResult


def quantize_pair(
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    w_gate: Optional[torch.Tensor] = None,
    group_size_up: int = 128,
    group_size_down: int = 128,
    act_order: bool = True,
    generator: Optional[torch.Generator] = None,
    importance_up: Optional[torch.Tensor] = None,
    importance_down: Optional[torch.Tensor] = None,
    hessian_up: Optional[torch.Tensor] = None,
    hessian_down: Optional[torch.Tensor] = None,
    use_gptq: bool = False,
) -> PairBundle:
    """Compiler stage 1 for one pair: quantize, no layout decision yet.

    Each matrix's processing order follows ``qz.quantize``'s precedence
    (importance, then its Hessian's diagonal, then ``generator``, which
    draws up's order before down's).  ``use_gptq`` runs GPTQ over
    ``hessian_up`` (up and gate) and ``hessian_down``.  The gate is
    quantized with ``proc_order=q_up.perm`` (the reference's default
    ``share_p1``, its argument as the reference passes it), so the
    runtime gathers ``X[:, P1]`` once for both.
    """
    k1, n1 = w_up.shape
    n1_d, _ = w_down.shape
    if n1_d != n1:
        raise ValueError(f"pair mismatch: up is {tuple(w_up.shape)}, "
                         f"down is {tuple(w_down.shape)}")
    if w_gate is not None and tuple(w_gate.shape) != (k1, n1):
        raise ValueError(f"gate shape {tuple(w_gate.shape)} != up shape "
                         f"{(k1, n1)}")

    q_up = qz.quantize(w_up, group_size_up, act_order,
                       importance=importance_up, hessian=hessian_up,
                       use_gptq=use_gptq, generator=generator)
    q_down = qz.quantize(w_down, group_size_down, act_order,
                         importance=importance_down, hessian=hessian_down,
                         use_gptq=use_gptq, generator=generator)
    q_gate = None
    if w_gate is not None:
        q_gate = qz.quantize(w_gate, group_size_up, act_order,
                             hessian=hessian_up, use_gptq=use_gptq,
                             proc_order=q_up.perm)
    return PairBundle(up=q_up, gate=q_gate, down=q_down)


def layout_pair(bundle: PairBundle, scheme: str = "tp-aware") -> PlannedPair:
    """Compiler stage 2 for one pair: pick the deployment layout."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}, expected one of "
                         f"{SCHEMES}")
    q_up, q_gate, q_down = bundle.up, bundle.gate, bundle.down

    if scheme == "naive-actorder":
        return PlannedPair(
            up=q_up.naive, gate=(q_gate.naive if q_gate else None),
            down=q_down.naive, p1_up=None, p1_gate=None, p2=None,
            scheme=scheme)

    p2 = q_down.perm
    up = q_up.ordered
    gate = q_gate.ordered if q_gate else None
    if scheme == "tp-aware":
        # Algorithm 3: permute the column-TP layers' columns by P2 so Y1
        # comes out aligned with down's sorted rows
        up = qz.permute_columns(up, p2)
        if gate is not None:
            gate = qz.permute_columns(gate, p2)
    # p1_gate None: the gate shares p1_up's gather
    return PlannedPair(up=up, gate=gate, down=q_down.ordered,
                       p1_up=q_up.perm, p1_gate=None, p2=p2, scheme=scheme)


def plan_pair(
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    w_gate: Optional[torch.Tensor] = None,
    scheme: str = "tp-aware",
    group_size_up: int = 128,
    group_size_down: int = 128,
    act_order: bool = True,
    generator: Optional[torch.Generator] = None,
    importance_up: Optional[torch.Tensor] = None,
    importance_down: Optional[torch.Tensor] = None,
    hessian_up: Optional[torch.Tensor] = None,
    hessian_down: Optional[torch.Tensor] = None,
    use_gptq: bool = False,
) -> PlannedPair:
    """Quantize and lay out one pair in ``scheme`` (``quantize_pair`` then
    ``layout_pair``): the one-shot entry for a pair planned outside the
    compiler, e.g. with calibration Hessians."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}, expected one of "
                         f"{SCHEMES}")
    return layout_pair(quantize_pair(
        w_up, w_down, w_gate=w_gate, group_size_up=group_size_up,
        group_size_down=group_size_down, act_order=act_order,
        generator=generator, importance_up=importance_up,
        importance_down=importance_down, hessian_up=hessian_up,
        hessian_down=hessian_down, use_gptq=use_gptq), scheme)


# ---------------------------------------------------------------------------
# TP sharding of a plan
# ---------------------------------------------------------------------------

def _own(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def shard_pair(pp: PlannedPair, tp: int) -> list[PlannedPair]:
    """Split a planned pair into ``tp`` per-rank plans.

    Column-TP layers split along N1 (qweight and metadata dim 1); the
    row-TP layer splits along its K == N1 (packed rows and metadata
    groups), which needs shards that are whole packed words and whole
    groups of the down projection.  The naive layout's row shard keeps
    the whole metadata table and global ``g_idx`` values: a shard of
    unordered rows touches arbitrary groups (the paper's locality
    problem).  ``p1`` stays replicated, ``p2`` splits into local chunks.
    Every slice is a contiguous copy, so a rank's plan holds no reference
    to the whole one.
    """
    n1 = pp.n1
    if n1 % tp:
        raise ValueError(f"N1={n1} not divisible by tp={tp}")
    shard = n1 // tp
    gs_d = pp.down.group_size
    if shard % qz.PACK:
        raise ValueError(f"row-TP shard {shard} must be a multiple of the "
                         f"int4 packing factor {qz.PACK}")
    if shard % gs_d:
        raise ValueError(
            f"row-TP shard {shard} not aligned to down group_size {gs_d}; "
            f"re-plan with group_size_down="
            f"{qz.choose_group_size(shard, gs_d)}")

    def col_slice(ql: QuantizedLinear, r: int) -> QuantizedLinear:
        sl = slice(r * shard, (r + 1) * shard)
        return dataclasses.replace(ql, qweight=_own(ql.qweight[:, sl]),
                                   scales=_own(ql.scales[:, sl]),
                                   zeros=_own(ql.zeros[:, sl]))

    def row_slice(ql: QuantizedLinear, r: int) -> QuantizedLinear:
        ksl = slice(r * shard // qz.PACK, (r + 1) * shard // qz.PACK)
        if ql.kind == "naive":
            return dataclasses.replace(
                ql, qweight=_own(ql.qweight[ksl]),
                g_idx=_own(ql.g_idx[r * shard:(r + 1) * shard]))
        gsl = slice(r * (shard // gs_d), (r + 1) * (shard // gs_d))
        return dataclasses.replace(ql, qweight=_own(ql.qweight[ksl]),
                                   scales=_own(ql.scales[gsl]),
                                   zeros=_own(ql.zeros[gsl]))

    return [PlannedPair(
        up=col_slice(pp.up, r),
        gate=col_slice(pp.gate, r) if pp.gate is not None else None,
        down=row_slice(pp.down, r),
        p1_up=pp.p1_up, p1_gate=pp.p1_gate,
        p2=(_own(pp.p2[r * shard:(r + 1) * shard]) if pp.p2 is not None
            else None),
        scheme=pp.scheme) for r in range(tp)]
