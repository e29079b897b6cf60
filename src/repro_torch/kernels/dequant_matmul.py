"""Int4 dequant kernels for Hopper and their plain versions; port of
``repro/kernels/dequant_matmul.py``.

* ``dequant_matmul_ordered`` (K1): the ordered-groups dequant-GEMM,
  ``csrc/dequant_matmul_ordered.cu``: in float32 a decode loop on the
  tensor cores (the exact integer weight ``q - z`` times x in two TF32
  parts, each group's scale applied to that group's sum) and at
  ``M >= tensor_core_min_m()`` a large-M loop (3xTF32 ``mma.sync``); in
  bfloat16 a decode loop on the CUDA cores.
* ``dequant_matmul_gidx`` (K4): the naive act-order dequant-GEMM, each row
  gathering its group through ``g_idx``, ``csrc/dequant_matmul_gidx.cu``:
  one launch a call, the whole metadata table read once per column tile,
  the K split inside the block.
* ``dequantize_ordered`` (K5): the ordered-groups weight materializer,
  ``csrc/dequantize_ordered.cu``.
* ``dequant_matmul_wire_ordered`` (K3): K1's GEMM with ring phase 1's
  blockwise wire quantize fused into its epilogue,
  ``csrc/dequant_matmul_wire_ordered.cu`` (K1's main loops come from
  ``csrc/dequant_matmul_ordered.cuh``, so its sums are K1's bit for bit):
  one launch a call, the last block of each epilogue unit quantizing.

Each source note says what bounds the kernel and how it is built up.
``kernels/build.py`` compiles a source with ``nvcc`` for ``sm_90a`` the
first time a CUDA tensor reaches its wrapper and loads it with
``ctypes``.  Each wrapper runs its plain version (``*_torch``) only for
tensors on the CPU; for CUDA tensors it launches its kernel, counted in
``<wrapper>.launches``, or raises.
"""

from __future__ import annotations

import ctypes
from math import gcd

import torch
import torch.nn.functional as F

from repro_torch.comm import dispatch as comm
from repro_torch.core import quantization as qz
from repro_torch.kernels import build

PACK = qz.PACK
#: largest K step the default tiling asks for (shared memory per stage
#: grows with it; see the kernel's stage layout)
TARGET_BLOCK_K = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STR = ctypes.c_char_p
ORDERED = build.Kernel("dequant_matmul_ordered", (
    ("dequant_matmul_ordered", (_P,) * 6 + (_LL,) + (_I,) * 6 + (_P,), _I),
    ("dequant_matmul_partial_floats", (_I,) * 6, _LL),
    ("dequant_matmul_smem_bytes", (_I,) * 5, _I),
    ("dequant_matmul_tensor_cores", (_I,) * 3, _I),
    ("dequant_matmul_tensor_core_min_m", (), _I),
    ("dequant_matmul_takes_group", (_I,) * 3, _I),
    ("dequant_matmul_error_string", (_I,), _STR)))
GIDX = build.Kernel("dequant_matmul_gidx", (
    ("dequant_matmul_gidx", (_P,) * 6 + (_I,) * 6 + (_P,), _I),
    ("dequant_matmul_gidx_block_n", (_I,) * 4, _I),
    ("dequant_matmul_gidx_smem_bytes", (_I,) * 5, _I),
    ("dequant_matmul_gidx_smem_limit", (), _I),
    ("dequant_matmul_gidx_error_string", (_I,), _STR)))
DEQUANTIZE = build.Kernel("dequantize_ordered", (
    ("dequantize_ordered", (_P,) * 4 + (_I,) * 4 + (_P,), _I),
    ("dequantize_ordered_error_string", (_I,), _STR)))
WIRE = build.Kernel("dequant_matmul_wire_ordered", (
    ("dequant_matmul_wire_ordered",
     (_P,) * 8 + (_LL, _P, _LL) + (_I,) * 9 + (_P,), _I),
    ("dequant_matmul_wire_sizes", (_I,) * 9 + (_P,), _I),
    ("dequant_matmul_wire_error_string", (_I,), _STR)))
KERNELS = (ORDERED, GIDX, DEQUANTIZE, WIRE)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1       # cudaErrorInvalidValue


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


def _gather_dequant(qweight, scales, zeros, rows, dtype):
    """``(unpack(qweight) - zeros[rows]) * scales[rows]`` in float32,
    rounded to ``dtype``."""
    q = qz.unpack_int4(qweight).to(torch.float32)
    s = scales.index_select(0, rows).to(torch.float32)
    z = zeros.index_select(0, rows).to(torch.float32)
    return ((q - z) * s).to(dtype)


def _group_rows(qweight, group_size):
    k = qweight.shape[0] * PACK
    return torch.arange(k, device=qweight.device) // group_size


def dequant_matmul_ordered_torch(x, qweight, scales, zeros, *, group_size,
                                 compute_dtype=torch.float32):
    """Plain version: unpack, gather the metadata by ``arange(K) // gs``,
    dequantize, round both operands to ``compute_dtype``, ``matmul``."""
    w = _gather_dequant(qweight, scales, zeros,
                        _group_rows(qweight, group_size), compute_dtype)
    return torch.matmul(x.to(compute_dtype), w)


def dequant_matmul_gidx_torch(x, qweight, scales, zeros, g_idx, *,
                              compute_dtype=torch.float32):
    """Plain version (the twin of the reference's
    ``ref.dequant_matmul_gidx``): unpack, gather the metadata by
    ``g_idx``, dequantize, round both operands to ``compute_dtype``,
    ``matmul``."""
    w = _gather_dequant(qweight, scales, zeros, g_idx.long(), compute_dtype)
    return torch.matmul(x.to(compute_dtype), w)


def dequantize_ordered_torch(qweight, scales, zeros, *, group_size,
                             out_dtype=torch.float32):
    """Plain version: ``(unpack(qweight) - zeros[k//gs]) * scales[k//gs]``
    in float32, rounded to ``out_dtype``."""
    return _gather_dequant(qweight, scales, zeros,
                           _group_rows(qweight, group_size), out_dtype)


def quantize_wire(y: torch.Tensor, *, n_pad: int, wire_block: int,
                  wire_bits: int):
    """Ring phase 1's quantize of a dense ``(M, N)`` GEMM output: the
    float32 upcast, zero-padded to ``n_pad``, through the collective's own
    quantizers.  Returns ``(payload, scales, zeros-or-None)``: payload
    ``(M, n_pad)`` int8 or ``(M, n_pad // 8)`` int32 words, scales and
    zeros ``(M, n_pad // wire_block)`` float16."""
    y32 = y.to(torch.float32)
    if n_pad != y32.shape[-1]:
        y32 = F.pad(y32, (0, n_pad - y32.shape[-1]))
    if wire_bits == 8:
        q, s = comm._blockwise_quantize(y32, wire_block)
        return q, s, None
    q, s, z = comm._blockwise_quantize_int4(y32, wire_block)
    return comm._pack4_last(q), s, z


def dequant_matmul_wire_ordered_torch(x, qweight, scales, zeros, *,
                                      group_size, n_pad, wire_block,
                                      wire_bits, compute_dtype=torch.float32):
    """Plain version: the plain ordered dequant-GEMM, then
    ``quantize_wire``."""
    y = dequant_matmul_ordered_torch(x, qweight, scales, zeros,
                                     group_size=group_size,
                                     compute_dtype=compute_dtype)
    return quantize_wire(y, n_pad=n_pad, wire_block=wire_block,
                         wire_bits=wire_bits)


def _check_cuda(x: torch.Tensor, dtype, what: str):
    """Raise unless ``x`` is on the card and ``dtype`` is one the kernels
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel's {what} is float32 or bfloat16, "
                         f"got {dtype}")


def _check_aligned(name: str, t: torch.Tensor):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary "
                         f"(data_ptr % 16 = {t.data_ptr() % 16})")


def _check_operands(device, operands: dict):
    """``operands``: name -> (tensor, shape, dtype); each must match and
    be a contiguous, 16-byte aligned tensor on ``device``."""
    for name, (t, shape, dtype) in operands.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_aligned(name, t)


def _x_operand(x: torch.Tensor, qweight: torch.Tensor, compute_dtype):
    """(x in ``compute_dtype``, M, K, N) after checking x against the
    packed weight."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got shape {tuple(x.shape)}")
    m, k = x.shape
    if k % PACK:
        raise ValueError(f"K={k} must be a multiple of {PACK}")
    x = x.to(compute_dtype).contiguous()
    _check_aligned("x", x)
    return x, m, k, qweight.shape[1]


def _raise_on(err: int, lib, kernel: str, shape: str):
    if err != 0:
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cuda error {err} "
                           f"({msg}) at {shape}")


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
    (counted in ``dequant_matmul_ordered.launches``; those that take its
    large-M tensor-core loop, float32 at ``M >= tensor_core_min_m()`` with
    groups of at least 4 rows, also in
    ``dequant_matmul_ordered.tensor_core_launches``) or raise, also for a
    float32 call below that M whose group size the float32 decode loop
    does not take (it takes multiples of 4 rows, at least 8).
    """
    if x.device.type == "cpu":
        return dequant_matmul_ordered_torch(
            x, qweight, scales, zeros, group_size=group_size,
            compute_dtype=compute_dtype)
    _check_cuda(x, compute_dtype, "compute type")
    x, m, k, n = _x_operand(x, qweight, compute_dtype)
    if k % group_size:
        raise ValueError(f"K={k} must be a multiple of "
                         f"group_size={group_size}")
    g = k // group_size
    _check_operands(x.device, {
        "qweight": (qweight, (k // PACK, n), torch.int32),
        "scales": (scales, (g, n), torch.float32),
        "zeros": (zeros, (g, n), torch.float32)})
    bk = pick_block_k(k, group_size)
    y = torch.empty((m, n), dtype=compute_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = build.load(ORDERED)
    bf16 = _KERNEL_DTYPES[compute_dtype]
    _check_group(lib, m, group_size, bf16)
    with torch.cuda.device(x.device):
        # the kernel splits K from the card's SM count (never on its
        # tensor-core loop); it says how much float32 scratch that takes
        floats = lib.dequant_matmul_partial_floats(m, n, k, group_size, bk,
                                                   bf16)
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
                n, k, group_size, bk, bf16, stream)
    _raise_on(err, lib, "dequant_matmul", f"M={m} N={n} K={k} "
              f"gs={group_size} bk={bk}")
    dequant_matmul_ordered.launches += 1
    dequant_matmul_ordered.tensor_core_launches += \
        lib.dequant_matmul_tensor_cores(m, group_size, bf16)
    return y


dequant_matmul_ordered.launches = 0
dequant_matmul_ordered.tensor_core_launches = 0


def _check_group(lib, m: int, group_size: int, bf16: int):
    """Raise where a float32 call would take the decode loop with a group
    size it does not take."""
    if not lib.dequant_matmul_takes_group(m, group_size, bf16):
        raise ValueError(f"K1's float32 decode loop (M={m} < "
                         f"{lib.dequant_matmul_tensor_core_min_m()}) takes "
                         f"groups of a multiple of 4 rows, at least 8, got "
                         f"group_size={group_size}")


def tensor_core_min_m() -> int:
    """The smallest M whose float32 calls take K1's (and K3's)
    tensor-core loop; read from the kernel's source, so it builds K1."""
    return build.load(ORDERED).dequant_matmul_tensor_core_min_m()


def takes_tensor_cores(m: int, group_size: int, compute_dtype) -> bool:
    """Whether a call of K1 (or K3) with ``m`` rows takes the tensor-core
    loop, which sums each row in another order than the decode loop;
    asked of the kernel's source, so it builds K1."""
    return bool(build.load(ORDERED).dequant_matmul_tensor_cores(
        m, group_size, _KERNEL_DTYPES[compute_dtype]))


def dequant_matmul_gidx(
    x: torch.Tensor,            # (M, K)
    qweight: torch.Tensor,      # (K // 8, N) int32 words, original row order
    scales: torch.Tensor,       # (G, N) float32
    zeros: torch.Tensor,        # (G, N) float32
    g_idx: torch.Tensor,        # (K,) int32 group of each row, in [0, G)
    *,
    compute_dtype=torch.float32,
    block_n: int = 0,
) -> torch.Tensor:
    """``x @ ((unpack(qweight) - zeros[g_idx]) * scales[g_idx])`` in
    ``compute_dtype`` with float32 accumulation: the naive act-order
    layout, each row gathering its group's metadata.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``dequant_matmul_gidx.launches``; one launch a call) or
    raise, also when a block's shared memory (the whole ``(G, block_n)``
    table of its column tile and the ring) exceeds the card's.
    ``block_n``: the kernel's columns per block, 16 or 32, or 0 for the
    kernel's pick from N, G and the card; the result does not depend on
    it.  The kernel trusts ``g_idx`` to lie in ``[0, G)``, as the
    quantizer writes it.
    """
    if block_n not in (0, 16, 32):
        raise ValueError(f"block_n must be 0, 16 or 32, got {block_n}")
    if x.device.type == "cpu":
        return dequant_matmul_gidx_torch(x, qweight, scales, zeros, g_idx,
                                         compute_dtype=compute_dtype)
    _check_cuda(x, compute_dtype, "compute type")
    x, m, k, n = _x_operand(x, qweight, compute_dtype)
    g = scales.shape[0]
    _check_operands(x.device, {
        "qweight": (qweight, (k // PACK, n), torch.int32),
        "scales": (scales, (g, n), torch.float32),
        "zeros": (zeros, (g, n), torch.float32),
        "g_idx": (g_idx, (k,), torch.int32)})
    y = torch.empty((m, n), dtype=compute_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    lib = build.load(GIDX)
    bf16 = _KERNEL_DTYPES[compute_dtype]
    shape = f"M={m} N={n} K={k} G={g}"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dequant_matmul_gidx(
            x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), g_idx.data_ptr(), y.data_ptr(), m, n, k, g,
            bf16, block_n, stream)
        if err == _CUDA_ERROR_INVALID_VALUE:
            # the shape checks passed, so the block may not fit
            smem = lib.dequant_matmul_gidx_smem_bytes(m, n, g, block_n, bf16)
            limit = lib.dequant_matmul_gidx_smem_limit()
            if 0 <= limit < smem:
                raise ValueError(
                    f"dequant_matmul_gidx at {shape}: a block needs {smem} "
                    f"bytes of shared memory (the table of {g} groups, "
                    f"{g * 256} bytes, and the cp.async ring), above the "
                    f"card's {limit}")
    _raise_on(err, lib, "dequant_matmul_gidx", shape)
    dequant_matmul_gidx.launches += 1
    return y


dequant_matmul_gidx.launches = 0


def dequantize_ordered(
    qweight: torch.Tensor,      # (K // 8, N) int32 words
    scales: torch.Tensor,       # (G, N) float32
    zeros: torch.Tensor,        # (G, N) float32
    *,
    group_size: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """The ordered layout's weight ``(K, N)``:
    ``(unpack(qweight) - zeros[k//gs]) * scales[k//gs]`` in float32,
    rounded to ``out_dtype``; bit-equal to the plain version.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``dequantize_ordered.launches``) or raise.
    """
    if qweight.device.type == "cpu":
        return dequantize_ordered_torch(qweight, scales, zeros,
                                        group_size=group_size,
                                        out_dtype=out_dtype)
    _check_cuda(qweight, out_dtype, "output type")
    if qweight.dim() != 2:
        raise ValueError(f"qweight must be (K // 8, N), got shape "
                         f"{tuple(qweight.shape)}")
    k, n = qweight.shape[0] * PACK, qweight.shape[1]
    if k % group_size:
        raise ValueError(f"K={k} must be a multiple of "
                         f"group_size={group_size}")
    g = k // group_size
    _check_operands(qweight.device, {
        "qweight": (qweight, (k // PACK, n), torch.int32),
        "scales": (scales, (g, n), torch.float32),
        "zeros": (zeros, (g, n), torch.float32)})
    out = torch.empty((k, n), dtype=out_dtype, device=qweight.device)
    if k == 0 or n == 0:
        return out
    lib = build.load(DEQUANTIZE)
    with torch.cuda.device(qweight.device):
        stream = torch.cuda.current_stream(qweight.device).cuda_stream
        err = lib.dequantize_ordered(
            qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
            out.data_ptr(), n, k, group_size, _KERNEL_DTYPES[out_dtype],
            stream)
    _raise_on(err, lib, "dequantize_ordered", f"K={k} N={n} "
              f"gs={group_size}")
    dequantize_ordered.launches += 1
    return out


dequantize_ordered.launches = 0


def dequant_matmul_wire_ordered(
    x: torch.Tensor,            # (M, K)
    qweight: torch.Tensor,      # (K // 8, N) int32 words
    scales: torch.Tensor,       # (G, N) float32
    zeros: torch.Tensor,        # (G, N) float32
    *,
    group_size: int,
    n_pad: int,
    wire_block: int,
    wire_bits: int,
    compute_dtype=torch.float32,
):
    """K1's ``x @ W`` in ``compute_dtype`` with ring phase 1's blockwise
    quantize of the result fused in: ``(payload, scales, zeros-or-None)``
    as ``quantize_wire`` gives them, over the wire width ``n_pad >= N``
    (columns past N are exact zeros) with quant block ``wire_block`` (the
    block ``comm.wire.wire_params`` chose; it divides ``n_pad``).
    Bit-identical to ``quantize_wire`` of K1's output.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    one launch a call (counted in ``dequant_matmul_wire_ordered.launches``),
    or raise.  The kernel's counters live in a buffer kept per device and
    stream (``_wire_counters``), zeroed once when it is made; calls that
    may run at the same time must not share one.  A CUDA graph keeps the
    buffer of the stream it was captured on, so graphs captured on one
    stream (``torch.cuda.graph``'s shared capture stream, where none is
    named) must not be replayed concurrently with each other or with
    eager calls on that stream: capture each such graph on its own stream.
    The engine's captured decode step (``runtime/serve.py``) holds no K3
    call: it is captured at tp=1 only, and K3 runs at tp > 1, whose step
    stays eager.
    """
    if wire_bits not in (4, 8):
        raise ValueError(f"wire_bits must be 4 or 8, got {wire_bits}")
    if x.device.type == "cpu":
        return dequant_matmul_wire_ordered_torch(
            x, qweight, scales, zeros, group_size=group_size, n_pad=n_pad,
            wire_block=wire_block, wire_bits=wire_bits,
            compute_dtype=compute_dtype)
    _check_cuda(x, compute_dtype, "compute type")
    x, m, k, n = _x_operand(x, qweight, compute_dtype)
    if k % group_size:
        raise ValueError(f"K={k} must be a multiple of "
                         f"group_size={group_size}")
    if n_pad < n or wire_block <= 0 or n_pad % wire_block or (
            wire_bits == 4 and n_pad % PACK):
        raise ValueError(f"wire width n_pad={n_pad} must be >= N={n} and a "
                         f"multiple of wire_block={wire_block}"
                         + (f" and of {PACK}" if wire_bits == 4 else ""))
    g = k // group_size
    _check_operands(x.device, {
        "qweight": (qweight, (k // PACK, n), torch.int32),
        "scales": (scales, (g, n), torch.float32),
        "zeros": (zeros, (g, n), torch.float32)})
    bk = pick_block_k(k, group_size)
    dev = x.device
    if wire_bits == 8:
        payload = torch.empty((m, n_pad), dtype=torch.int8, device=dev)
    else:
        payload = torch.empty((m, n_pad // PACK), dtype=torch.int32,
                              device=dev)
    wscales = torch.empty((m, n_pad // wire_block), dtype=torch.float16,
                          device=dev)
    wzeros = torch.empty_like(wscales) if wire_bits == 4 else None
    if m == 0:
        return payload, wscales, wzeros
    _check_group(build.load(ORDERED), m, group_size,
                 _KERNEL_DTYPES[compute_dtype])
    lib = build.load(WIRE)
    shape = (m, n, k, group_size, bk, n_pad, wire_block, wire_bits,
             _KERNEL_DTYPES[compute_dtype])
    # the splits' partial tiles, a counter per row tile and epilogue unit
    # (0 before and after every call), and the launch's shared memory
    sizes = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
        err = lib.dequant_matmul_wire_sizes(*shape, sizes)
        if not err:
            floats, count, _ = sizes
            stream = torch.cuda.current_stream(dev)
            counters = _wire_counters(stream, count)
            scratch = torch.empty(floats, dtype=torch.float32, device=dev)
            err = lib.dequant_matmul_wire_ordered(
                x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), payload.data_ptr(), wscales.data_ptr(),
                None if wzeros is None else wzeros.data_ptr(),
                scratch.data_ptr(), floats, counters.data_ptr(),
                counters.numel(), *shape, stream.cuda_stream)
            if err:
                counters.zero_()
    _raise_on(err, lib, "dequant_matmul_wire", f"M={m} N={n} K={k} "
              f"gs={group_size} bk={bk} n_pad={n_pad} block={wire_block} "
              f"bits={wire_bits}")
    dequant_matmul_wire_ordered.launches += 1
    return payload, wscales, wzeros


dequant_matmul_wire_ordered.launches = 0

#: K3's counters: (device index, stream handle) -> [stream, int32
#: buffers]. Calls on one stream run one after another and each leaves its
#: counters at 0, so one buffer (the last) serves every call on its stream,
#: with no memset.  A buffer outgrown by a larger call is kept: a CUDA
#: graph captured earlier may still use it.
_wire_counter_buffers: dict = {}


def _wire_counters(stream, count: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``count`` counters for K3's calls
    on ``stream`` (the current stream), made (or grown) on first need.
    Not during a CUDA graph capture: a zero-fill captured there runs only
    when the graph is replayed, so the buffer must exist before (a call
    on the capturing stream first, as a warm-up)."""
    key = (stream.device_index, stream.cuda_stream)
    held = _wire_counter_buffers.setdefault(key, [stream])
    if len(held) == 1 or held[-1].numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "dequant_matmul_wire_ordered: no counters for this stream "
                "yet, and it is capturing a CUDA graph; call the kernel on "
                "the capturing stream once before the capture")
        held.append(torch.zeros(max(count, 1024), dtype=torch.int32,
                                device=stream.device))
    return held[-1]
