"""Ordered-groups int4 dequant-GEMM: the Hopper kernel and its plain
version; port of ``repro/kernels/dequant_matmul.py::dequant_matmul_ordered``.

The kernel is CUDA C++ (``src/repro_torch/csrc/dequant_matmul_ordered.cu``;
its source note says what bounds it and how it is built up).  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface the first time a CUDA tensor reaches the wrapper, cached under
``build/`` at the repository root by the source's content hash, and
loaded with ``ctypes``.

``dequant_matmul_ordered`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from math import gcd
from pathlib import Path

import torch

from repro_torch.core import quantization as qz

PACK = qz.PACK
SOURCE = (Path(__file__).resolve().parents[1] / "csrc"
          / "dequant_matmul_ordered.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: largest K step the default tiling asks for (shared memory per stage
#: grows with it; see the kernel's stage layout)
TARGET_BLOCK_K = 256

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: what the last build printed: {"seconds", "ptxas", "path"}
build_info: dict = {}


def pick_block_k(k: int, group_size: int, target: int = TARGET_BLOCK_K) -> int:
    """K step: a multiple of lcm(group_size, 8) dividing K, close to target.

    Every quantized layout has such a step (K is a multiple of both 8 and
    the group size), so each step holds whole groups."""
    base = group_size * PACK // gcd(group_size, PACK)
    bk = base
    while bk * 2 <= min(k, target) and k % (bk * 2) == 0:
        bk *= 2
    if k % bk:
        raise ValueError(f"K={k} not tileable with group_size={group_size}")
    return bk


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernel cannot be "
                           "built")
    return path


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"dequant_matmul_ordered-{digest[:16]}.so"
    t0 = time.perf_counter()
    ptxas = "(cached build)"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        ptxas = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out))
    fn = lib.dequant_matmul_ordered
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dequant_matmul_partial_floats.argtypes = [ctypes.c_int] * 5
    lib.dequant_matmul_partial_floats.restype = ctypes.c_longlong
    lib.dequant_matmul_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.dequant_matmul_smem_bytes.restype = ctypes.c_int
    lib.dequant_matmul_error_string.argtypes = [ctypes.c_int]
    lib.dequant_matmul_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, ptxas=ptxas,
                      path=str(out))
    _lib = lib
    return lib


def dequant_matmul_ordered_torch(x, qweight, scales, zeros, *, group_size,
                                 compute_dtype=torch.float32):
    """Plain version: unpack, gather the metadata by ``arange(K) // gs``,
    dequantize, round both operands to ``compute_dtype``, ``matmul``."""
    k = qweight.shape[0] * PACK
    q = qz.unpack_int4(qweight).to(torch.float32)
    g_idx = torch.arange(k, device=q.device) // group_size
    s = scales.index_select(0, g_idx).to(torch.float32)
    z = zeros.index_select(0, g_idx).to(torch.float32)
    w = ((q - z) * s).to(compute_dtype)
    return torch.matmul(x.to(compute_dtype), w)


def _check_aligned(name: str, t: torch.Tensor):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary "
                         f"(data_ptr % 16 = {t.data_ptr() % 16})")


def dequant_matmul_ordered(
    x: torch.Tensor,            # (M, K)
    qweight: torch.Tensor,      # (K // 8, N) int32 words
    scales: torch.Tensor,       # (G, N) float32
    zeros: torch.Tensor,        # (G, N) float32
    *,
    group_size: int,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """``x @ ((unpack(qweight) - zeros[k//gs]) * scales[k//gs])`` in
    ``compute_dtype`` with float32 accumulation.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``dequant_matmul_ordered.launches``) or raise.
    """
    if x.device.type == "cpu":
        return dequant_matmul_ordered_torch(
            x, qweight, scales, zeros, group_size=group_size,
            compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if compute_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel computes in float32 or bfloat16, "
                         f"got {compute_dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    m, k = x.shape
    n = qweight.shape[1]
    if k % PACK or k % group_size:
        raise ValueError(f"K={k} must be a multiple of {PACK} and of "
                         f"group_size={group_size}")
    expect = {"qweight": ((k // PACK, n), torch.int32),
              "scales": ((k // group_size, n), torch.float32),
              "zeros": ((k // group_size, n), torch.float32)}
    for name, t in (("qweight", qweight), ("scales", scales),
                    ("zeros", zeros)):
        shape, dtype = expect[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_aligned(name, t)
    bk = pick_block_k(k, group_size)

    x = x.to(compute_dtype).contiguous()
    _check_aligned("x", x)
    y = torch.empty((m, n), dtype=compute_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = build()
    with torch.cuda.device(x.device):
        # the kernel splits K from the card's SM count; it says how much
        # float32 scratch that takes
        floats = lib.dequant_matmul_partial_floats(m, n, k, group_size, bk)
        if floats < 0:
            err = -floats
        else:
            partial = (torch.empty(floats, dtype=torch.float32,
                                   device=x.device) if floats else None)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.dequant_matmul_ordered(
                x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), y.data_ptr(),
                None if partial is None else partial.data_ptr(), floats, m,
                n, k, group_size, bk, _KERNEL_DTYPES[compute_dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"dequant_matmul_ordered kernel launch failed: cuda error {err} "
            f"({lib.dequant_matmul_error_string(err).decode()}) at "
            f"M={m} N={n} K={k} gs={group_size} bk={bk}")
    dequant_matmul_ordered.launches += 1
    return y


dequant_matmul_ordered.launches = 0
