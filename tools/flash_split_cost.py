#!/usr/bin/env python3
"""Where the flash-attention kernel's time goes: K2 against copies of its
own source with one cost taken out, on one CUDA card.

    python3 tools/flash_split_cost.py      # from the repository root

Variants of ``src/repro_torch/csrc/flash_attention.cu``, made by text
substitution, built together and timed in turns at the full-width
forward's shape (B1 H32 S=T=2048 D128 causal, float32):

- ``kernel``: the source as it is;
- ``no_split``: the 3xTF32 split does no arithmetic (big = small = the
  float32 bits): the same mma count without the split's ALU work.  Its
  results are wrong; it is timed only;
- ``one_product``: float32 Q, K and V as single TF32 operands (one mma
  for QK^T, two for P.V, as for 16-bit inputs).  Wrong beyond the
  float32 tolerance; timed only;
- ``veltkamp``: big by Veltkamp's split in float32 arithmetic (multiply
  by 2^13 + 1; ties to even, not cvt.rna's ties away) and small = a - big
  unrounded.  Within the tolerance, but not the rounding the design
  prescribes.

Prints each variant's median ms over two alternating rounds, its max
error against the plain version, scaled_dot_product_attention's time,
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SPLIT = """  big = tf32(a);
  small = __float_as_uint(a - __uint_as_float(big & 0xffffe000u)) + 0x1000u;"""
KSPLIT = "  constexpr bool kSplit = sizeof(T) == 4;"
VARIANTS = {
    "kernel": [],
    "no_split": [(SPLIT, "  big = __float_as_uint(a);\n  small = big;")],
    "one_product": [(KSPLIT, "  constexpr bool kSplit = false;")],
    "veltkamp": [(SPLIT, "  const float p = __fmul_rn(a, 8193.0f);\n"
                         "  const float hi = __fsub_rn(p, __fsub_rn(p, a));\n"
                         "  big = __float_as_uint(hi);\n"
                         "  small = __float_as_uint(__fsub_rn(a, hi));")],
}


def _build() -> dict:
    source = fa.FLASH.source.read_text()
    out_dir = os.path.join(build.BUILD_DIR, "flash_split_cost")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source no longer "
                                   f"holds {old.strip()!r} once")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        fn = lib.flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _time(fn, reps: int = 20, batches: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_split_cost: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = _build()
    b, h, s, d = 1, 32, 2048, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               for _ in range(3))
    ref = fa.flash_attention_torch(q, k, v, causal=True)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b * h, s, s, d, 1, -1, d ** -0.5, 0, stream)
        if err:
            raise RuntimeError(f"launch failed: cuda error {err}")

    times = {name: [] for name in libs}
    for _ in range(2):                        # two rounds, in turns
        for name, fn in libs.items():
            times[name].append(_time(lambda fn=fn: launch(fn)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = _time(lambda: sdpa(q, k, v, is_causal=True))
    print(f"nvidia-smi: {smi}")
    limit = 1e-5 * ref.abs().max().item() + 1e-5
    for name, fn in libs.items():
        launch(fn)
        torch.cuda.synchronize()
        err = (o - ref).abs().max().item()
        print(f"{name}: {statistics.median(times[name]):.4f} ms (rounds "
              f"{', '.join(f'{t:.4f}' for t in times[name])}), max err "
              f"{err:.3g} ({'within' if err <= limit else 'outside'} the "
              f"float32 limit {limit:.3g})")
    print(f"scaled_dot_product_attention: {sdpa_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
