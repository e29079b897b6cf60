#!/usr/bin/env python3
"""Forms of K1's float32 decode loop, built side by side and timed on one
CUDA card.

    python3 tools/k1_decode_forms.py       # from the repository root

Builds copies of ``src/repro_torch/csrc/dequant_matmul_ordered.cuh`` with
one change each, made by text substitution (``kernel``: the source as it
is; ``stages128x3``: 128-k stages in a ring of 3 instead of 256-k stages
in a ring of 2; ``blocks5``: registers cut for 5 blocks a SM (96 a
thread) instead of 4; ``copies_only``: the stages' copies and barriers
with no products, the loop's floor from the bytes it moves), prints each
copy's registers and stack bytes (``cuobjdump -res-usage``), then times
each at qwen3-4b's up/gate (K 2560, N 9728, gs 128) and down (K 9728,
N 2560, gs 76) and mistral-large-123b's down projection (K 28672,
N 12288, gs 128) at M=4: ms a call in a CUDA-graph replay over weight
copies the 50 MB L2 cannot hold, and the GEMM's and the split-add's
device ms from ``torch.profiler``.  The forms other than ``kernel`` are
not checked (``copies_only`` computes nothing).  The last line is one
JSON object with the numbers and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from k1_threshold import _caller, _time, build_variants  # noqa: E402
from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SHAPES = (("qwen3-4b up/gate", 2560, 9728, 128),
          ("qwen3-4b down", 9728, 2560, 76),
          ("mistral-large-123b down", 28672, 12288, 128))
M = 4
VARIANTS = {
    "kernel": [],
    "stages128x3": [("constexpr int kDecRows = 32;",
                     "constexpr int kDecRows = 16;"),
                    ("constexpr int kDecStages = 2;",
                     "constexpr int kDecStages = 3;")],
    "blocks5": [("R4 == 1 && sizeof...(Epilogue) == 0 ? 4 : 3;",
                 "R4 == 1 && sizeof...(Epilogue) == 0 ? 5 : 3;")],
    "copies_only": [("      if (kc >= ke) break;\n",
                     "      if (kc >= ke || kc < ke) break;\n")],
}


def _device_ms(call, copies, reps: int) -> dict:
    """Device ms a call of the GEMM kernel and of the split-add pass, from
    torch.profiler over one replay of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            call(*copies[i % len(copies)])
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            key = ("gemm" if "decode_tc" in e.key else
                   "split_add" if "add_splits" in e.key else e.key[:40])
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_decode_forms: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    source = (build.CSRC / "dequant_matmul_ordered.cuh").read_text()
    headers = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the header no longer holds "
                                   f"{old.strip()!r} once")
            text = text.replace(old, new)
        headers[name] = text
    libs = build_variants(headers, "k1_decode_forms")
    out = {"nvidia_smi": smi, "resources": {}, "times": {}}
    for name in VARIANTS:
        lib = os.path.join(build.BUILD_DIR, "k1_decode_forms", name, "lib.so")
        res = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage",
                              lib], capture_output=True, text=True).stdout
        lines = res.splitlines()
        out["resources"][name] = [
            lines[i + 1].strip().split(" SHARED")[0]
            for i, text in enumerate(lines)
            if "decode_tc" in text and i + 1 < len(lines)]
        print(f"{name}: the decode loop's instances "
              + "; ".join(out["resources"][name]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, k, n, gs in SHAPES:
        ql = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen).ordered
        nbytes = ql.qweight.numel() * 4 + ql.scales.numel() * 8
        copies = [(ql.qweight.clone(), ql.scales.clone(), ql.zeros.clone())
                  for _ in range(max(2, int(150e6 // nbytes) + 1))]
        x = torch.randn(M, k, generator=gen, device="cuda")
        for name, lib in libs.items():
            call = _caller(lib, x, ql, gs)
            reps = 10 * len(copies)
            ms = _time(call, copies, reps)
            dev = _device_ms(call, copies, reps)
            out["times"][f"{shape} {name}"] = {"ms": ms, **dev}
            print(f"{shape} M={M} {name}: {ms:.4f} ms a call; device "
                  + ", ".join(f"{key} {v:.4f}" for key, v in dev.items())
                  + f"; {smi}", flush=True)
        del copies
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
