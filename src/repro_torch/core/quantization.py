"""Group-wise int4 RTN quantization with act-order; port of
``repro/core/quantization.py`` (the RTN path; GPTQ follows later).

Layout convention as in the reference: ``W`` is ``(K, N)`` with K the
reduction dim (``Y = X @ W``); groups run along K, 8 nibbles per 32-bit
word along K.

Packed words are held as **int32 bit views** of the reference's uint32:
torch on the CPU has no shifts for ``uint32``.  Nibble ``j`` of a word is
``(w >> 4j) & 0xF``, which is the same on the int32 view because the mask
drops the sign-extended bits.  ``torch.round`` and ``jnp.round`` both
round half to even, so codes are bit-equal to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

QMAX = 15  # int4: quantized values live in [0, 15]
PACK = 8   # 8 int4 values per 32-bit word along K


def choose_group_size(k: int, preferred: int = 128) -> int:
    """Largest divisor of ``k`` that is ``<= preferred``."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    g = min(preferred, k)
    while k % g != 0:
        g -= 1
    return g


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """A quantized ``(K, N)`` weight in deployment layout.

    ``kind``: ``"naive"`` keeps the original row order and needs ``g_idx``
    to gather metadata; ``"ordered"`` has rows sorted by group (row ``i``
    is in group ``i // group_size``) and the caller feeds ``X[:, P]``.
    """

    qweight: torch.Tensor               # (K // 8, N) int32 view of uint32
    scales: torch.Tensor                # (G, N) float32
    zeros: torch.Tensor                 # (G, N) float32 zero-points
    g_idx: Optional[torch.Tensor]       # (K,) int32, only for kind="naive"
    group_size: int
    kind: str

    @property
    def k(self) -> int:
        return self.qweight.shape[0] * PACK

    @property
    def n(self) -> int:
        return self.qweight.shape[1]


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack ``(K, N)`` ints in [0, 15] into ``(K//8, N)`` int32 words."""
    k, n = q.shape
    if k % PACK != 0:
        raise ValueError(f"K={k} must be a multiple of {PACK}")
    shifts = (torch.arange(PACK, device=q.device, dtype=torch.int64) * 4)
    words = (q.to(torch.int64).reshape(k // PACK, PACK, n)
             << shifts[None, :, None]).sum(dim=1)
    # uint32 value -> the int32 with the same bits
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_int4(qw: torch.Tensor) -> torch.Tensor:
    """Unpack ``(K//8, N)`` int32 words into ``(K, N)`` int32 in [0, 15]."""
    k8, n = qw.shape
    shifts = (torch.arange(PACK, device=qw.device, dtype=torch.int32) * 4)
    vals = (qw[:, None, :] >> shifts[None, :, None]) & 0xF
    return vals.reshape(k8 * PACK, n)


# ---------------------------------------------------------------------------
# group metadata and round-to-nearest codes
# ---------------------------------------------------------------------------

def _group_metadata(w_grouped: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric min/max scales+zeros for ``(G, gs, N)`` grouped weights."""
    wmax = torch.clamp(w_grouped.amax(dim=1), min=0.0)
    wmin = torch.clamp(w_grouped.amin(dim=1), max=0.0)
    scales = (wmax - wmin) / QMAX
    scales = torch.where(scales <= 0, torch.ones_like(scales), scales)
    zeros = torch.clamp(torch.round(-wmin / scales), 0, QMAX)
    return scales, zeros


def quantize_rtn(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """Round-to-nearest int4 codes for ``(K, N)`` w given group metadata."""
    k, n = w.shape
    wg = w.reshape(k // group_size, group_size, n)
    q = torch.round(wg / scales[:, None, :] + zeros[:, None, :])
    return torch.clamp(q, 0, QMAX).to(torch.int32).reshape(k, n)


@dataclasses.dataclass(frozen=True)
class QuantResult:
    """Both deployment layouts of one quantized weight, plus its perms."""

    naive: QuantizedLinear
    ordered: QuantizedLinear
    perm: torch.Tensor              # P (K,) int32, argsort(g_idx), stable
    g_idx: torch.Tensor             # (K,) unordered Eq.-3 group index array


def quantize(
    w: torch.Tensor,
    group_size: int = 128,
    act_order: bool = True,
    generator: Optional[torch.Generator] = None,
    proc_order: Optional[torch.Tensor] = None,
) -> QuantResult:
    """RTN-quantize ``W (K, N)`` and emit both deployment layouts.

    The processing order is ``proc_order`` when given (tests pass the
    reference's so codes compare bit for bit); else, with ``act_order``
    and a ``generator``, a ``randperm`` drawn from it (the reference draws
    ``jax.random.permutation``); else the identity.
    """
    k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    dev = w.device
    w = w.to(torch.float32)

    if proc_order is None:
        if act_order and generator is not None:
            proc_order = torch.randperm(k, generator=generator,
                                        device=generator.device)
        else:
            proc_order = torch.arange(k)
    proc_order = proc_order.to(device=dev, dtype=torch.int64)

    # Eq. 3: row proc_order[j] is processed at position j -> group j // gs
    inv = torch.empty(k, dtype=torch.int64, device=dev)
    inv[proc_order] = torch.arange(k, device=dev)
    g_idx = (inv // group_size).to(torch.int32)

    w_proc = w[proc_order]
    scales, zeros = _group_metadata(
        w_proc.reshape(k // group_size, group_size, n))
    q_proc = quantize_rtn(w_proc, scales, zeros, group_size)

    q_orig = torch.empty_like(q_proc)
    q_orig[proc_order] = q_proc
    naive = QuantizedLinear(qweight=pack_int4(q_orig), scales=scales,
                            zeros=zeros, g_idx=g_idx, group_size=group_size,
                            kind="naive")

    perm = torch.argsort(g_idx, stable=True).to(torch.int32)
    ordered = QuantizedLinear(qweight=pack_int4(q_orig[perm.long()]),
                              scales=scales, zeros=zeros, g_idx=None,
                              group_size=group_size, kind="ordered")
    return QuantResult(naive=naive, ordered=ordered, perm=perm, g_idx=g_idx)


# ---------------------------------------------------------------------------
# dequantization and the offline column fold
# ---------------------------------------------------------------------------

def dequantize(ql: QuantizedLinear, dtype=torch.float32) -> torch.Tensor:
    """Materialize the fp weight ``(K, N)`` in the linear's own row layout."""
    q = unpack_int4(ql.qweight).to(torch.float32)
    if ql.kind == "ordered":
        g_idx = torch.arange(ql.k, device=q.device) // ql.group_size
    else:
        g_idx = ql.g_idx.long()
    s = ql.scales.index_select(0, g_idx)
    z = ql.zeros.index_select(0, g_idx)
    return ((q - z) * s).to(dtype)


def permute_columns(ql: QuantizedLinear, p: torch.Tensor) -> QuantizedLinear:
    """Offline column permutation (the TP-aware fold, paper Algorithm 3);
    exact, because packing runs along K and metadata is per column."""
    p = p.long()
    return dataclasses.replace(
        ql, qweight=ql.qweight[:, p], scales=ql.scales[:, p],
        zeros=ql.zeros[:, p])
