"""Runtime dequant-GEMM schemes on one device; port of
``repro/core/schemes.py`` (``ACTIVATIONS``, ``qmatmul``,
``pair_forward_reference``).  The TP forwards follow in a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

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


def pair_forward_reference(
    x: torch.Tensor,
    pp: PlannedPair,
    policy: Optional[ExecutionPolicy] = None,
    *,
    activation: Optional[str] = None,
) -> torch.Tensor:
    """Single-device forward of a planned pair."""
    policy = resolve_policy(policy)
    act = ACTIVATIONS[activation or "identity"]

    def mm(a, ql):
        return qmatmul(a, ql, policy)

    if pp.scheme == "naive-actorder":
        y1 = mm(x, pp.up)
        if pp.gate is not None:
            y1 = act(mm(x, pp.gate)) * y1
        elif activation:
            y1 = act(y1)
        return mm(y1, pp.down)

    # exllama and tp-aware gather X by P1 first
    xg = x.index_select(-1, pp.p1_up)
    y1 = mm(xg, pp.up)
    if pp.gate is not None:
        xgate = (xg if pp.p1_gate is None
                 else x.index_select(-1, pp.p1_gate))
        y1 = act(mm(xgate, pp.gate)) * y1
    elif activation:
        y1 = act(y1)
    if pp.scheme == "exllama":
        y1 = y1.index_select(-1, pp.p2)   # runtime P2 permute
    return mm(y1, pp.down)
