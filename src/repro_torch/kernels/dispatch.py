"""Kernel dispatch: ``(layout kind, backend)`` -> dequant-GEMM callable;
port of ``repro/kernels/dispatch.py``.

Entries:

* ``ref``   -- plain-torch oracle (``kernels/ref.py``), both layouts.
* ``torch`` -- dequantize, then ``torch.matmul`` (the reference's ``jnp``).
* ``cuda``  -- the hand-written Hopper kernels: the ordered-groups
  dequant-GEMM for ordered layouts, the ``g_idx`` dequant-GEMM for naive
  ones (the reference's ``pallas``).

The CUDA kernels take any K that is a multiple of 8, so the reference's
non-tileable fallback has no counterpart: ``cuda`` never quietly runs
another path, and on CPU tensors it raises.

Kernel contract: ``fn(x, ql, policy) -> y`` with ``x: (..., K)``; returns
``(..., N)`` in ``policy.compute_dtype``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import QuantizedLinear
# Bound under their own names: the reference's AST lint (rule AS002 of
# repro.analysis) matches kernel entry points by bare name and allows the
# calls only under repro/kernels/, so `ops.dequant_matmul(...)` here would
# read as a registry bypass.
from repro_torch.kernels.ops import dequant_matmul as ops_dequant_matmul
from repro_torch.kernels.ref import dequant_matmul as ref_dequant_matmul

KernelFn = Callable[[torch.Tensor, QuantizedLinear, ExecutionPolicy],
                    torch.Tensor]

_REGISTRY: dict[tuple[str, str], KernelFn] = {}

KINDS = ("ordered", "naive")


def register(kind: str, backend: str):
    """Decorator: register ``fn(x, ql, policy)`` for a (kind, backend)."""
    if kind not in KINDS:
        raise ValueError(f"unknown layout kind {kind!r}, expected {KINDS}")

    def deco(fn: KernelFn) -> KernelFn:
        _REGISTRY[(kind, backend)] = fn
        return fn

    return deco


def backends(kind: Optional[str] = None) -> tuple[str, ...]:
    """Registered backend names (optionally for one layout kind)."""
    return tuple(sorted({b for (k, b) in _REGISTRY
                         if kind is None or k == kind}))


def resolve(kind: str, backend: str) -> KernelFn:
    try:
        return _REGISTRY[(kind, backend)]
    except KeyError:
        raise ValueError(
            f"no kernel registered for layout kind={kind!r} "
            f"backend={backend!r}; registered backends for this kind: "
            f"{list(backends(kind))}") from None


def qmatmul(x: torch.Tensor, ql: QuantizedLinear,
            policy: ExecutionPolicy) -> torch.Tensor:
    """``x @ dequantize(ql)`` via the policy-selected kernel."""
    return resolve(ql.kind, policy.backend)(x, ql, policy)


@register("ordered", "ref")
@register("naive", "ref")
def _ref_dequant_matmul(x, ql, policy):
    return ref_dequant_matmul(x, ql, compute_dtype=policy.compute_dtype)


@register("ordered", "torch")
@register("naive", "torch")
def _torch_dequant_matmul(x, ql, policy):
    w = qz.dequantize(ql, dtype=policy.compute_dtype)
    return torch.matmul(x.to(policy.compute_dtype), w)


@register("ordered", "cuda")
@register("naive", "cuda")
def _cuda_dequant_matmul(x, ql, policy):
    if x.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs the CUDA kernel and needs "
                         f"tensors on the card; got x on {x.device} (use "
                         f"backend 'torch' on the CPU)")
    return ops_dequant_matmul(x, ql, compute_dtype=policy.compute_dtype)
