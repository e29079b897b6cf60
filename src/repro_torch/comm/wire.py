"""WirePayload, a pre-quantized TP epilogue payload; port of
``repro/comm/wire.py``.

The fused kernel (``kernels/dequant_matmul.dequant_matmul_wire_ordered``)
emits ring phase 1's quantized payload straight from the GEMM, so the
collective starts at the exchange.  ``wire_params`` is the one source of
the ring's geometry, used by the kernel's wrapper and by the collective
alike, so the flat kernel output chunks bit for bit into the ring's form:
a quant block divides the chunk, and for int4 so does a packed word, so
neither straddles a chunk boundary.

Lives in ``comm`` (not ``kernels``) so ``kernels/dispatch.py`` imports it
without a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.quantization import PACK, choose_group_size

__all__ = ["WirePayload", "wire_params"]


def wire_params(n: int, tp: int, bits: int,
                preferred_block: int) -> tuple[int, int, int]:
    """``(n_pad, chunk, block)`` of the two-phase quantized ring over a
    width-``n`` output: the zero-padded wire width (whole chunks per rank;
    whole 32-bit words per chunk for int4), the per-rank chunk, and the
    quant block used (the largest divisor of ``chunk`` at most
    ``preferred_block``)."""
    pad_to = tp * (PACK if bits == 4 else 1)
    n_pad = n + (-n) % pad_to
    chunk = n_pad // tp
    return n_pad, chunk, choose_group_size(chunk, preferred_block)


@dataclasses.dataclass
class WirePayload:
    """One rank's pre-quantized partial, ready for ring phase 1.

    ``payload`` is flat over the padded width: ``(..., n_pad)`` int8 for
    8-bit wires, ``(..., n_pad // 8)`` int32 words (the weights'
    ``pack_int4`` nibble layout) for 4-bit.  ``scales`` (and ``zeros``,
    int4 only) are ``(..., n_pad // block)`` float16."""

    payload: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    n: int                  # logical (un-padded) output width
    tp: int                 # ring size the payload was padded for
    bits: int               # 8 or 4
    block: int              # quant block used
    out_dtype: Any          # dtype the collective's result is cast back to

    @property
    def n_pad(self) -> int:
        w = self.payload.shape[-1]
        return w * PACK if self.bits == 4 else w
