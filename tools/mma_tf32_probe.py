#!/usr/bin/env python3
"""Throughput and latency of ``mma.sync`` m16n8k8 TF32 on one CUDA card.

    python3 tools/mma_tf32_probe.py        # from the repository root

The flash-attention kernel (``src/repro_torch/csrc/flash_attention.cu``)
runs both of its products as these instructions, three for each float32
k-step (3xTF32).  The data sheet's dense TF32 rate is reached only by
``wgmma``; this probe measures what ``mma.sync`` reaches, which is the
ceiling of that kernel's design.  Each warp issues ``chains`` independent
accumulator chains for ``iters`` rounds on one block per SM (and four in
the last line); one chain on one warp a scheduler gives the latency.
Prints TFLOP/s and clocks per instruction per scheduler (at the SM clock
nvidia-smi reports) for each shape, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int kChains>
__global__ void probe(float* out, int iters) {
  float c[kChains][4] = {};
  const uint32_t t = threadIdx.x;
  const uint32_t a[4] = {t, t + 1, t + 2, t + 3}, b[2] = {3 * t, 5 * t};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int chains,
                   int iters) {
  if (chains == 1) probe<1><<<blocks, threads>>>(out, iters);
  else if (chains == 8) probe<8><<<blocks, threads>>>(out, iters);
  else return -1;
  return cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_probe: needs a CUDA card", file=sys.stderr)
        return 1
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "mma_tf32_probe.cu")
    lib_path = os.path.join(build.BUILD_DIR, "mma_tf32_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 256, device="cuda")
    print(f"nvidia-smi: {smi}")
    for blocks, threads, chains in ((sms, 128, 1), (sms, 128, 8),
                                    (sms, 256, 8), (4 * sms, 256, 8)):
        iters = 4000
        lib.run(out.data_ptr(), blocks, threads, chains, 10)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.run(out.data_ptr(), blocks, threads, chains, iters)
        stop.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"probe launch failed: cuda error {err}")
        ms = start.elapsed_time(stop)
        n = blocks * threads // 32 * chains * iters   # mma instructions
        clocks = ms * 1e-3 * mhz * 1e6 / (n / (4 * sms))
        print(f"{blocks} blocks x {threads} threads, {chains} chains a warp: "
              f"{ms:.3f} ms, {n * 2 * 16 * 8 * 8 / ms / 1e9:.1f} TFLOP/s, "
              f"{clocks:.2f} clocks per mma per scheduler at {mhz:.0f} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
