"""Public wrappers around the kernels; port of ``repro/kernels/ops.py``.

Flattens leading dims into M, checks K against the weight and dispatches
on the layout kind (ordered groups or the naive ``g_idx`` gather).  The
CUDA kernels mask ragged M/N edges themselves, so no padding happens
here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels import dequant_matmul as dk
from repro_torch.kernels import flash_attention as fa


# The two public GEMM entries share this body rather than call each other:
# the reference's AST lint (rule AS002 of repro.analysis) reads a call of
# a function named ``dequant_matmul`` outside repro/kernels/ as a registry
# bypass, and it walks the port's sources too.
def _qmatmul(x: torch.Tensor, ql: QuantizedLinear, compute_dtype):
    *lead, k = x.shape
    if k != ql.k:
        raise ValueError(f"x K={k} != weight K={ql.k}")
    x2 = x.reshape(-1, k)
    if ql.kind == "ordered":
        y = dk.dequant_matmul_ordered(
            x2, ql.qweight, ql.scales, ql.zeros, group_size=ql.group_size,
            compute_dtype=compute_dtype)
    else:
        y = dk.dequant_matmul_gidx(x2, ql.qweight, ql.scales, ql.zeros,
                                   ql.g_idx, compute_dtype=compute_dtype)
    return y.reshape(*lead, ql.n)


def dequant_matmul(x: torch.Tensor, ql: QuantizedLinear, *,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ dequantize(ql)`` through the kernel of the layout's kind.

    ``x``: (..., K).  Returns (..., N) in ``compute_dtype``.
    """
    return _qmatmul(x, ql, compute_dtype)


def dequant_matmul_gidx(x: torch.Tensor, ql: QuantizedLinear, *,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The naive ``g_idx``-gather dequant-GEMM; raises on an ordered
    layout (the reference's ``pallas_dequant_matmul_gidx``)."""
    if ql.kind != "naive":
        raise ValueError(f"g_idx kernel got layout kind {ql.kind!r}")
    return _qmatmul(x, ql, compute_dtype)


def dequantize(ql: QuantizedLinear, *,
               out_dtype=torch.float32) -> torch.Tensor:
    """Materialize the fp weight ``(K, N)``: the dequantize kernel for an
    ordered layout, the plain ``qz.dequantize`` for a naive one (its rows
    have no group locality to exploit), as the reference does."""
    if ql.kind != "ordered":
        return qz.dequantize(ql, dtype=out_dtype)
    return dk.dequantize_ordered(ql.qweight, ql.scales, ql.zeros,
                                 group_size=ql.group_size,
                                 out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused flash attention on (B, H, S, D); see
    ``kernels/flash_attention.py``."""
    return fa.flash_attention(q, k, v, causal=causal, window=window)
