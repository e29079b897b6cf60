"""Runtime dequant-GEMM schemes (paper Algorithms 2 and 3); port of
``repro/core/schemes.py`` (``ACTIVATIONS``, ``qmatmul``,
``pair_forward_reference``, ``pair_forward_tp``).

* ``naive-actorder``: original rows, metadata gathered through ``g_idx``;
  under TP only the trailing collective.
* ``exllama``: sorted rows; under TP the paper's "Naive Algorithm"
  (Algorithm 2): all-gather Y1, permute by P2, keep the local chunk.
* ``tp-aware``: Algorithm 3, P2 folded offline, so the TP path is GEMM,
  GEMM, trailing collective.

Under TP the kernel half of the plan dispatches through
``kernels/dispatch.py`` (``policy.backend``) and the collective half
through ``comm/dispatch.py`` (``policy.collective``); the ranks are the
processes of a ``torch.distributed`` group.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.comm import dispatch as comm
from repro_torch.core.policy import ExecutionPolicy, resolve_policy
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PlannedPair


def _silu(x):
    return x * torch.sigmoid(x)


ACTIVATIONS: dict[str, Callable] = {
    "silu": _silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "identity": lambda x: x,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


def qmatmul(x: torch.Tensor, ql: QuantizedLinear,
            policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """``x @ dequantize(ql)`` via the kernel ``policy.backend`` names."""
    from repro_torch.kernels import dispatch

    return dispatch.qmatmul(x, ql, resolve_policy(policy))


def column_step(x, pp: PlannedPair, policy, activation):
    """Y1 of the column-TP layers: up (and the gated product), after the
    P1 gather of the sorted schemes.  Under TP ``pp`` holds this rank's
    column shards and Y1 is this rank's chunk."""
    act = ACTIVATIONS[activation or "identity"]
    xg = x if pp.scheme == "naive-actorder" else x.index_select(-1,
                                                                pp.p1_up)
    y1 = qmatmul(xg, pp.up, policy)
    if pp.gate is not None:
        # p1_gate None: the gate shares p1_up's gather
        xgate = (xg if pp.p1_gate is None or pp.scheme == "naive-actorder"
                 else x.index_select(-1, pp.p1_gate))
        y1 = act(qmatmul(xgate, pp.gate, policy)) * y1
    elif activation:
        y1 = act(y1)
    return y1


def pair_forward_reference(
    x: torch.Tensor,
    pp: PlannedPair,
    policy: Optional[ExecutionPolicy] = None,
    *,
    activation: Optional[str] = None,
) -> torch.Tensor:
    """Single-device forward of a planned pair."""
    policy = resolve_policy(policy)
    y1 = column_step(x, pp, policy, activation)
    if pp.scheme == "exllama":
        y1 = y1.index_select(-1, pp.p2)   # runtime P2 permute
    return qmatmul(y1, pp.down, policy)


_UNFUSABLE_WARNED: set = set()


def _warn_unfusable(pair_path, pp: PlannedPair, reason: str) -> None:
    """Warn once per (site, reason) when a ':fused' collective cannot use
    the wire kernel here; the dense GEMM and the plain collective run
    instead."""
    import warnings

    key = (pair_path, reason)
    if key in _UNFUSABLE_WARNED:
        return
    _UNFUSABLE_WARNED.add(key)
    warnings.warn(
        f"collective spec is ':fused' but the wire kernel cannot serve pair "
        f"{pair_path!r} (scheme={pp.scheme}, down layout {pp.down.kind!r}: "
        f"{reason}); using the plain epilogue", stacklevel=3)


def _pair_local_forward(
    x: torch.Tensor,
    pp: PlannedPair,
    *,
    group,
    activation: Optional[str],
    policy: ExecutionPolicy,
    pair_path: Optional[str] = None,
) -> torch.Tensor:
    """One rank's pair forward.  ``x`` is replicated over the ranks; ``pp``
    holds this rank's shards (``reorder.shard_pair``).  The trailing
    collective is what ``policy.collective`` resolves to for
    ``pair_path``.  A ``:fused`` quantized spec has the down projection
    emit ring phase 1's payload itself (``kernels/dispatch.qmatmul_wire``)
    where ``wire_support`` allows, else the dense GEMM and the plain
    collective run, with a warning.  An ``:overlap`` quantized spec runs
    the down GEMM per row microbatch with the ring of one microbatch in
    flight across the next one's GEMM
    (``dist/overlap.pipelined_epilogue``): bit-equal either way."""
    y1 = column_step(x, pp, policy, activation)
    if pp.scheme == "exllama":
        # Algorithm 2: gather Y1 (l.2), then the local P2 chunk both
        # permutes and chunks it (l.3 + l.4)
        y1 = comm.all_gather_cols(y1, group).index_select(-1, pp.p2)

    from repro_torch.kernels import dispatch as kdispatch

    spec = policy.collective.resolve(pair_path)
    tp = comm.axis_size(group)
    use_wire = False
    if spec.fused:
        use_wire, reason = kdispatch.wire_support(pp.down, spec, tp)
        if not use_wire:
            _warn_unfusable(pair_path, pp, reason)
    if spec.overlap:
        from repro_torch.dist import overlap

        gemm_wire = (functools.partial(
            kdispatch.qmatmul_wire, ql=pp.down, policy=policy, spec=spec,
            tp=tp) if use_wire else None)
        return overlap.pipelined_epilogue(
            y1, group, spec, gemm=lambda y: qmatmul(y, pp.down, policy),
            gemm_wire=gemm_wire,
            loop=kdispatch.main_loop(pp.down, policy, y1.device))
    if use_wire:
        wp = kdispatch.qmatmul_wire(y1, pp.down, policy, spec=spec, tp=tp)
        return comm.apply_wire(wp, group, spec, policy)
    y2 = qmatmul(y1, pp.down, policy)
    return comm.apply(y2, group, spec, policy)


def pair_forward_tp(
    x: torch.Tensor,
    pp: PlannedPair,
    group,
    policy: Optional[ExecutionPolicy] = None,
    *,
    activation: Optional[str] = None,
    pair_path: Optional[str] = None,
) -> torch.Tensor:
    """Tensor-parallel forward on this rank of ``group``.

    ``x``: (..., K1), the same on every rank; ``pp``: this rank's shard of
    the plan.  Returns the closed output (..., N2), or, when the
    collective scatters its output (``psum_scatter``), this rank's shard
    of the last dim, as the reference's ``out_specs`` leave it.
    ``pair_path`` names the pair for a per-layer ``CollectivePlan``."""
    return _pair_local_forward(x, pp, group=group, activation=activation,
                               policy=resolve_policy(policy),
                               pair_path=pair_path)
