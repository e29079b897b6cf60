"""Group-wise int4 quantization with act-order and GPTQ error
compensation (static groups); port of ``repro/core/quantization.py``.

Layout convention as in the reference: ``W`` is ``(K, N)`` with K the
reduction dim (``Y = X @ W``); groups run along K, 8 nibbles per 32-bit
word along K.

Packed words are held as **int32 bit views** of the reference's uint32:
torch on the CPU has no shifts for ``uint32``.  Nibble ``j`` of a word is
``(w >> 4j) & 0xF``, which is the same on the int32 view because the mask
drops the sign-extended bits.  ``torch.round`` and ``jnp.round`` both
round half to even, so RTN codes are bit-equal to the reference's.

GPTQ (``use_gptq``) quantizes the rows one at a time in processing order
and feeds each row's error forward through the upper Cholesky factor of
the inverse Hessian (``cholesky_hinv_upper``).  The reference updates the
whole matrix under a 0/1 mask at every row; ``_gptq_codes`` updates only
the rows below, which gives the same bits (the masked rows get ``w - 0``)
and moves K/2 times fewer bytes.  The updates are not blocked as in
Frantar et al.: blocking changes the order of the sums.  The factor
itself comes from ``torch.linalg`` and is within a few ulps of the
reference's, not bit-equal, so a GPTQ code may differ where a row sits on
a rounding edge.
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
        return self.qweight.shape[-2] * PACK

    @property
    def n(self) -> int:
        return self.qweight.shape[-1]


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


# ---------------------------------------------------------------------------
# GPTQ error compensation (static groups)
# ---------------------------------------------------------------------------

def _gptq_codes(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                group_size: int, hinv_u: torch.Tensor) -> torch.Tensor:
    """Sequential GPTQ quantization with error feedback.

    ``w`` is in processing order; ``hinv_u`` is the upper Cholesky factor
    of the inverse (permuted, damped) Hessian.  Row ``i`` is rounded with
    its group's metadata, and its error, divided by ``hinv_u[i, i]``, is
    fed to the rows below through row ``i`` of the factor.  Returns the
    int codes in processing order."""
    k, n = w.shape
    work = w.to(torch.float32).clone()
    codes = torch.empty((k, n), dtype=torch.int32, device=w.device)
    for i in range(k):
        g = i // group_size
        s, z = scales[g], zeros[g]
        row = work[i]
        q = torch.clamp(torch.round(row / s + z), 0, QMAX)
        err = (row - (q - z) * s) / hinv_u[i, i]
        if i + 1 < k:
            work[i + 1:] -= hinv_u[i, i + 1:, None] * err[None, :]
        codes[i] = q.to(torch.int32)
    return codes


def cholesky_hinv_upper(h: torch.Tensor, damp_frac: float = 0.01
                        ) -> torch.Tensor:
    """Upper-triangular U with ``H^-1 = U^T U`` (GPTQ's ``Hinv``), after
    damping the diagonal by ``damp_frac`` of its mean."""
    k = h.shape[0]
    damp = damp_frac * torch.mean(torch.diagonal(h)) + 1e-8
    h = h + damp * torch.eye(k, dtype=h.dtype, device=h.device)
    hinv = torch.linalg.inv(h)
    # lower L with hinv = L L^T; the GPTQ factor is U = L^T
    return torch.linalg.cholesky(hinv).T


def make_hessian(x_cal: torch.Tensor, damp: float = 0.0) -> torch.Tensor:
    """Calibration Hessian ``2 X^T X`` (GPTQ) from ``(B, K)`` activations."""
    x = x_cal.to(torch.float32)
    h = (2.0 * x.T) @ x
    if damp:
        h = h + damp * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    return h


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
    importance: Optional[torch.Tensor] = None,
    hessian: Optional[torch.Tensor] = None,
    use_gptq: bool = False,
    generator: Optional[torch.Generator] = None,
    proc_order: Optional[torch.Tensor] = None,
) -> QuantResult:
    """Quantize ``W (K, N)`` and emit both deployment layouts.

    The processing order, by the reference's precedence: ``proc_order``
    when given; else, with ``act_order``, descending ``importance``, then
    descending ``diag(hessian)``, then a ``randperm`` drawn from
    ``generator`` (the reference draws ``jax.random.permutation``), then
    the identity; without ``act_order`` the identity.  ``use_gptq`` runs
    the sequential error-feedback pass over ``hessian`` (the identity when
    None) instead of round-to-nearest.
    """
    k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    dev = w.device
    w = w.to(torch.float32)

    if proc_order is None:
        if not act_order:
            proc_order = torch.arange(k)
        elif importance is not None:
            proc_order = torch.argsort(-importance, stable=True)
        elif hessian is not None:
            proc_order = torch.argsort(-torch.diagonal(hessian), stable=True)
        elif generator is not None:
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
    if use_gptq:
        if hessian is None:
            hessian = torch.eye(k, dtype=torch.float32, device=dev)
        h = hessian.to(device=dev, dtype=torch.float32)
        hinv_u = cholesky_hinv_upper(h[proc_order][:, proc_order])
        q_proc = _gptq_codes(w_proc, scales, zeros, group_size, hinv_u)
    else:
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


def quant_error(ql: QuantizedLinear, w: torch.Tensor,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |W - dq(q(W))| against the original-layout W; an ordered
    linear needs its ``perm`` to put its rows back."""
    dq = dequantize(ql)
    if ql.kind == "ordered":
        if perm is None:
            raise ValueError("an ordered linear needs its perm")
        back = torch.empty_like(dq)
        back[perm.long()] = dq
        dq = back
    return torch.mean(torch.abs(w - dq))
