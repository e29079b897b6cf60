"""Paged KV pool: device-side layout, gather/scatter, quantized pages;
port of ``repro/cache/paged.py``.

The pool replaces the dense per-slot cache rows ``(..., B, cap, KV, D)``
with a shared page pool ``(..., N_pages, page_size, KV, D)`` plus a
host-managed per-slot page table ``(B, Pmax)`` of page indices
(``cache/manager.py``).  Decode scatters the new token into
``(table[b, pos // ps], pos % ps)`` and gathers a slot's logical cache
back by page index — memory scales with *live* tokens, not worst-case
sequence.

Quantized pages (``PageSpec.bits``) store uint8 codes, or int4 codes
nibble-packed into int32 words through ``core/quantization``'s
``pack_int4``/``unpack_int4`` (the reference's uint32 words, as the same
bits: torch has no shifts on ``uint32`` on the CPU), with an asymmetric
(scale, zero) pair per (token, head) row over head_dim.  The variant is
carried by the pool leaves' dtypes (uint8 -> int8, int32 -> int4, float
-> raw), as in the reference.

Two departures from the reference, both so that the step stays the dense
step's shape and a CUDA graph can hold it:

* ``scatter_token`` writes into the pool in place (the dense
  ``attention_decode`` does too; the reference returns a new pool, which
  its jitted step donates);
* ``gather`` returns exactly ``cap`` columns, the dense cache's capacity
  (the engine's ``max_seq``), not the reference's ``Pmax * page_size``:
  position j of slot b is read at ``(pages[b, j // ps], j % ps)``.  The
  attention then runs on the dense cache's shapes, so an fp pool gives
  the dense step's bits; torch's CPU kernels (and the card's, which are
  picked by shape) sum a masked tail of extra columns in another order.

Everything here is device ops on device tensors: no host read, no
host-built tensor.

Error model: dequantized values differ from the stored activations by at
most ``(max - min) / (2 * qmax)`` per (token, head) row; the fp pool is
bit-exact with the dense cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import pack_int4, unpack_int4

INT8_QMAX = 255
INT4_QMAX = 15


def pool_bits(pool: dict) -> Optional[int]:
    """Page payload width, recovered from the pool's own dtypes."""
    dt = pool["k"].dtype
    if dt == torch.uint8:
        return 8
    if dt == torch.int32:
        return 4
    return None


def init_pool(lead: tuple, n_pages: int, page_size: int, kv_heads: int,
              head_dim: int, *, dtype=torch.bfloat16,
              bits: Optional[int] = None, device=None) -> dict:
    """Zeroed page pool with leading (layer-stack) dims ``lead``."""
    body = (n_pages, page_size, kv_heads)
    if bits is None:
        shape = lead + body + (head_dim,)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if bits == 8:
        codes = lead + body + (head_dim,)
        code_dtype = torch.uint8
    elif bits == 4:
        if head_dim % 8:
            raise ValueError(
                f"int4 pages need head_dim % 8 == 0, got {head_dim}")
        codes = lead + body + (head_dim // 8,)
        code_dtype = torch.int32
    else:
        raise ValueError(f"kv bits must be None, 8 or 4, got {bits}")
    meta = lead + body
    pool = {}
    for name in ("k", "v"):
        pool[name] = torch.zeros(codes, dtype=code_dtype, device=device)
        pool[f"{name}_scale"] = torch.zeros(meta, dtype=torch.float32,
                                            device=device)
        pool[f"{name}_zero"] = torch.zeros(meta, dtype=torch.float32,
                                           device=device)
    return pool


def pool_page_bytes(pool: dict, n_pages: int) -> tuple[int, int]:
    """(actual, fp-equivalent) bytes per page, over all layer dims.

    ``fp-equivalent`` prices the same logical (token, head, head_dim)
    values at the dense cache's bf16 width — the baseline the stats
    endpoint reports quantized savings against.
    """
    actual = sum(leaf.numel() * leaf.element_size() for leaf in pool.values())
    fp = 0
    for name in ("k", "v"):
        leaf = pool[name]
        values = leaf.numel() * (8 if leaf.dtype == torch.int32 else 1)
        fp += values * 2
    return actual // n_pages, fp // n_pages


# ---------------------------------------------------------------------------
# quantized page codec — per (token, head) asymmetric min/max over head_dim
# ---------------------------------------------------------------------------

def _quantize_rows(x: torch.Tensor, qmax: int):
    """x: (..., D) -> (codes int32 in [0, qmax], scale, zero) per row."""
    x32 = x.to(torch.float32)
    wmin = x32.amin(dim=-1)
    wmax = x32.amax(dim=-1)
    scale = (wmax - wmin) / qmax
    # all-equal rows (e.g. zero-init) quantize through scale 1 exactly
    scale = torch.where(scale > 0, scale, 1.0)
    zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
    codes = torch.clamp(torch.round(x32 / scale[..., None] + zero[..., None]),
                        0, qmax).to(torch.int32)
    return codes, scale, zero


def _dequantize_rows(codes: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor) -> torch.Tensor:
    return (codes.to(torch.float32) - zero[..., None]) * scale[..., None]


def _pack_last(codes: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int codes along the last axis via ``pack_int4``
    (which packs along the first): (..., D) -> (..., D // 8) int32."""
    lead = codes.shape[:-1]
    d = codes.shape[-1]
    packed = pack_int4(codes.reshape(-1, d).T)          # (D // 8, X)
    return packed.T.reshape(*lead, d // 8)


def _unpack_last(packed: torch.Tensor) -> torch.Tensor:
    """(..., D // 8) int32 -> (..., D) int32 codes."""
    lead = packed.shape[:-1]
    d8 = packed.shape[-1]
    codes = unpack_int4(packed.reshape(-1, d8).T)       # (D, X)
    return codes.T.reshape(*lead, d8 * 8)


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------

def gather(pool: dict, pages: torch.Tensor,
           cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize each slot's first ``cap`` cache positions.

    pool: one layer's pool (no layer dims) — {"k","v": (N, ps, KV, D)}
    (+ scale/zero for quantized); pages: (B, Pmax) with ``Pmax * ps >=
    cap``.  Returns (k, v): (B, cap, KV, D), float32 for quantized pools,
    the pool's dtype for raw.  Unallocated table entries point at the
    scratch page (``manager.py``); the caller's position mask hides those
    columns (score -1e30 -> exp == 0.0 exactly).
    """
    bits = pool_bits(pool)
    ps = pool["k"].shape[1]
    j = torch.arange(cap, device=pages.device)
    pids = pages[:, j // ps]                     # (B, cap)
    offs = (j % ps)[None, :]

    def one(name):
        tile = pool[name][pids, offs]            # (B, cap, KV, [D])
        if bits is None:
            return tile
        codes = _unpack_last(tile) if bits == 4 else tile
        return _dequantize_rows(codes, pool[f"{name}_scale"][pids, offs],
                                pool[f"{name}_zero"][pids, offs])

    return one("k"), one("v")


def scatter_token(pool: dict, k: torch.Tensor, v: torch.Tensor,
                  pages: torch.Tensor, pos: torch.Tensor) -> dict:
    """Write one token per slot at its page-table position, in place.

    k/v: (B, KV, D); pages: (B, Pmax); pos: (B,) per-slot positions.
    Slots sharing a page write idempotently (identical prefixes produce
    identical K/V, see ``cache/prefix.py``), and idle lanes all write the
    scratch page, which no unmasked column reads, so duplicate (page,
    offset) targets are safe in any order.  Returns ``pool``.
    """
    bits = pool_bits(pool)
    ps = pool["k"].shape[1]
    pos = pos.long()
    pids = pages.gather(1, (pos // ps)[:, None])[:, 0]
    offs = pos % ps
    for name, val in (("k", k), ("v", v)):
        if bits is None:
            pool[name][pids, offs] = val.to(pool[name].dtype)
            continue
        qmax = INT4_QMAX if bits == 4 else INT8_QMAX
        codes, scale, zero = _quantize_rows(val, qmax)   # (B, KV[, D])
        pool[name][pids, offs] = (_pack_last(codes) if bits == 4
                                  else codes.to(torch.uint8))
        pool[f"{name}_scale"][pids, offs] = scale
        pool[f"{name}_zero"][pids, offs] = zero
    return pool
