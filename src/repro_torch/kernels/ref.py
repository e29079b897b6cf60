"""Plain-torch oracles for the kernels; port of ``repro/kernels/ref.py``.

``dequant_matmul_ordered`` is the kernel's plain version, defined once
beside the kernel in ``kernels/dequant_matmul.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels.dequant_matmul import (  # noqa: F401
    dequant_matmul_ordered_torch as dequant_matmul_ordered)


def dequantize(ql: QuantizedLinear, dtype=torch.float32) -> torch.Tensor:
    return qz.dequantize(ql, dtype=dtype)


def dequant_matmul(x: torch.Tensor, ql: QuantizedLinear,
                   compute_dtype=torch.float32) -> torch.Tensor:
    w = qz.dequantize(ql, dtype=compute_dtype)
    return torch.matmul(x.to(compute_dtype), w)
