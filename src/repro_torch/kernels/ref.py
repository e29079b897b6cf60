"""Plain-torch oracles for the kernels; port of ``repro/kernels/ref.py``.

``dequant_matmul_ordered``, ``dequant_matmul_gidx`` and
``dequant_matmul_wire_ordered`` are the kernels' plain versions, defined
once beside the kernels in ``kernels/dequant_matmul.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels.dequant_matmul import (  # noqa: F401
    dequant_matmul_gidx_torch as dequant_matmul_gidx,
    dequant_matmul_ordered_torch as dequant_matmul_ordered,
    dequant_matmul_wire_ordered_torch as dequant_matmul_wire_ordered)
from repro_torch.kernels.flash_attention import NEG_INF, attention_mask


def dequantize(ql: QuantizedLinear, dtype=torch.float32) -> torch.Tensor:
    return qz.dequantize(ql, dtype=dtype)


def dequant_matmul(x: torch.Tensor, ql: QuantizedLinear,
                   compute_dtype=torch.float32) -> torch.Tensor:
    w = qz.dequantize(ql, dtype=compute_dtype)
    return torch.matmul(x.to(compute_dtype), w)


def flash_attention(q, k, v, *, causal=True, window=None):
    """Oracle for ``kernels.flash_attention``: plain masked softmax
    attention, q/k/v (B, H, S|T, D) -> (B, H, S, D).  Scores in the
    inputs' dtype, then float32 divided by ``sqrt(D)``."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    sc = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32) / d ** 0.5
    mask = attention_mask(s, t, causal=causal, window=window,
                          device=q.device)
    w = torch.softmax(sc.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w,
                        v.to(torch.float32)).to(q.dtype)
