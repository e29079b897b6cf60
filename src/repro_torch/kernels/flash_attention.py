"""Flash attention for Hopper and its plain version; port of
``repro/kernels/flash_attention.py``.

The kernel is CUDA C++ (``src/repro_torch/csrc/flash_attention.cu``; its
source note says what bounds it and how it is built up: both products on
the tensor cores, float32 split 3xTF32, K/V tiles double-buffered with
``cp.async``), compiled by ``kernels/build.py`` the first time a CUDA
tensor reaches the wrapper.

Layout as in the reference: q (B, H, S, D), k and v (B, H, T, D); GQA
callers repeat the KV heads before the call.  ``flash_attention`` runs
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel, counted in ``flash_attention.launches``, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: the reference's masked score (``NEG_INF``), not -inf
NEG_INF = -1e30
#: head dimensions the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH = build.Kernel("flash_attention", (
    ("flash_attention", (_P,) * 4 + (_I,) * 6 + (ctypes.c_float, _I, _P),
     _I),
    ("flash_attention_smem_bytes", (_I, _I), _I),
    ("flash_attention_error_string", (_I,), ctypes.c_char_p)))

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def attention_mask(s: int, t: int, *, causal: bool, window: Optional[int],
                   device=None) -> torch.Tensor:
    """(S, T) bool: key j is visible to query i."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    return mask


def flash_attention_torch(q, k, v, *, causal=True, window=None):
    """Plain version of the kernel's function: float32 scores times
    ``D ** -0.5``, masked with -1e30, softmax, times v; q's dtype out."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    sc = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * d ** -0.5
    mask = attention_mask(s, t, causal=causal, window=window,
                          device=q.device)
    w = torch.softmax(sc.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention: q (B, H, S, D), k/v (B, H, T, D) ->
    (B, H, S, D) in q's dtype, computed in float32.

    ``window`` keeps keys ``j > i - window``; ``causal`` keeps ``j <= i``.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    t = k.shape[2] if k.dim() == 4 else -1
    for name, x, shape in (("q", q, (b, h, s, d)), ("k", k, (b, h, t, d)),
                           ("v", v, (b, h, t, d))):
        if tuple(x.shape) != shape or x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} of shape {shape}, "
                             f"got {x.dtype} of shape {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if t == 0:              # no keys: l = 0 is guarded, the output is 0
        return torch.zeros_like(q)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = build.load(FLASH)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s,
            t, d, int(causal), -1 if window is None else int(window),
            d ** -0.5, KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cuda error {err} "
            f"({lib.flash_attention_error_string(err).decode()}) at "
            f"B={b} H={h} S={s} T={t} D={d}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
