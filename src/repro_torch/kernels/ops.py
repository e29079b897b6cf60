"""Public wrappers around the kernels; port of ``repro/kernels/ops.py``.

Flattens leading dims into M, checks K against the weight and dispatches
on the layout kind (ordered groups or the naive ``g_idx`` gather).  The
CUDA kernels mask ragged M/N edges themselves, and the wire kernel writes
the ring's zero padding past N itself, so no padding happens here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.kernels import dequant_matmul as dk
from repro_torch.kernels import flash_attention as fa


#: every kernel wrapper's launch counter, as (wrapper, attribute)
COUNTERS = ((dk.dequant_matmul_ordered, "launches"),
            (dk.dequant_matmul_ordered, "tensor_core_launches"),
            (dk.dequant_matmul_gidx, "launches"),
            (dk.dequantize_ordered, "launches"),
            (dk.dequant_matmul_wire_ordered, "launches"),
            (fa.flash_attention, "launches"))


def launch_counts() -> tuple[int, ...]:
    """The launch counters' values, in ``COUNTERS`` order."""
    return tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def add_launch_counts(counts) -> None:
    """Add ``counts`` (in ``COUNTERS`` order) to the launch counters.  A
    wrapper counts when the host runs it, so a CUDA graph counts once, at
    its capture; its owner adds the capture's counts at each replay, which
    launches those kernels again."""
    for (fn, attr), n in zip(COUNTERS, counts, strict=True):
        setattr(fn, attr, getattr(fn, attr) + n)


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


def dequant_matmul_wire(x: torch.Tensor, ql: QuantizedLinear, *, tp: int,
                        wire_bits: int, wire_block: int,
                        compute_dtype=torch.float32, plain: bool = False):
    """Fused GEMM + blockwise wire quantize (K3); ``plain`` runs its plain
    version instead, on any device.

    ``x``: (..., K).  Returns the flat wire tuple over the ring-padded
    width ``n_pad`` (``comm/wire.wire_params``): ``(payload, scales,
    zeros-or-None)`` of shapes ``(..., n_pad)`` int8 or ``(..., n_pad //
    8)`` int32 words, and ``(..., n_pad // block)`` float16, bit-identical
    to quantizing the zero-padded dense kernel output.  ``wire_block`` is
    the spec's preferred block; the block used is
    ``choose_group_size(n_pad // tp, wire_block)``, as the unfused
    collective picks it."""
    from repro_torch.comm.wire import wire_params

    if ql.kind != "ordered":
        raise ValueError(f"wire kernel needs the ordered layout, "
                         f"got {ql.kind!r}")
    *lead, k = x.shape
    if k != ql.k:
        raise ValueError(f"x K={k} != weight K={ql.k}")
    n_pad, _, bs = wire_params(ql.n, tp, wire_bits, wire_block)
    kernel = (dk.dequant_matmul_wire_ordered_torch if plain
              else dk.dequant_matmul_wire_ordered)
    p, s, z = kernel(x.reshape(-1, k), ql.qweight, ql.scales, ql.zeros,
                     group_size=ql.group_size, n_pad=n_pad, wire_block=bs,
                     wire_bits=wire_bits, compute_dtype=compute_dtype)
    return (p.reshape(*lead, p.shape[-1]), s.reshape(*lead, s.shape[-1]),
            None if z is None else z.reshape(*lead, z.shape[-1]))


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
