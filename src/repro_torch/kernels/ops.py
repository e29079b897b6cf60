"""Public wrapper around the dequant-GEMM kernel; port of
``repro/kernels/ops.py::dequant_matmul``.

Flattens leading dims into M and checks K against the weight.  The CUDA
kernel masks ragged M/N edges itself, so no padding happens here.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels import dequant_matmul as dk


def dequant_matmul(x: torch.Tensor, ql: QuantizedLinear, *,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ dequantize(ql)`` through the ordered-groups kernel.

    ``x``: (..., K).  Returns (..., N) in ``compute_dtype``.  The naive
    g_idx layout has no kernel yet (K4 in ``ROADMAP.md``).
    """
    if ql.kind != "ordered":
        raise ValueError(f"the dequant-GEMM kernel needs the ordered layout, "
                         f"got {ql.kind!r} (the g_idx kernel is not ported)")
    *lead, k = x.shape
    if k != ql.k:
        raise ValueError(f"x K={k} != weight K={ql.k}")
    y = dk.dequant_matmul_ordered(
        x.reshape(-1, k), ql.qweight, ql.scales, ql.zeros,
        group_size=ql.group_size, compute_dtype=compute_dtype)
    return y.reshape(*lead, ql.n)
