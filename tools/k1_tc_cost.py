#!/usr/bin/env python3
"""Where the time of K1's tensor-core loop goes, on one CUDA card.

    python3 tools/k1_tc_cost.py            # from the repository root

Variants of ``src/repro_torch/csrc/dequant_matmul_ordered.cuh``, made by
text substitution, built together and timed in turns (CUDA-graph replay,
two rounds in opposite orders) at the forward's M = 2048 with the
full-width qwen3-4b MLP shapes (up/gate: K 2560, N 9728, gs 128; down:
K 9728, N 2560, gs 76), float32:

- ``kernel``: the source as it is;
- ``no_split``: the 3xTF32 split does no arithmetic (big = small = the
  float32 bits): the same mma count without the split's ALU work.  Its
  results are wrong; it is timed only;
- ``trunc_split``: big is the float32 bits (the mma reads their top 19,
  which truncates) and small = v - trunc(v), also truncated by the mma:
  two instructions a value instead of cvt.rna's split;
- ``no_part``: every mma accumulates into the float32 sum directly, with
  no zeroed fragment per chunk of 16 k and no rounded add (the tensor
  cores' truncation then biases the sum);
- ``rows128``, ``rows160``: every launch takes blocks of 128 rows (4 m16
  tiles a warp), or of 160 (5), where the kernel picks the one that
  leaves each SM fewer rows (128 for up/gate, 160 for down at M 2048);
- ``stages3``: a 3-stage cp.async ring where the kernel has 4.

Prints each variant's median ms per shape, its max error against the
plain version beside the float32 limit, and the card's name and power
limit; the numbers also go to ``chiprun_out/k1_tc_cost.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from k1_threshold import SHAPES, _caller, _time, build_variants  # noqa: E402
from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dequant_matmul as dk  # noqa: E402

MTILES = "return rows_per_sm(5) < rows_per_sm(4) ? 5 : 4;"
SPLIT = """  big = tf32(v);
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u)) + 0x1000u;"""
VARIANTS = {
    "kernel": [],
    "no_split": [(SPLIT, "  big = __float_as_uint(v);\n  small = big;")],
    "trunc_split": [(SPLIT, "  big = __float_as_uint(v);\n  small = "
                            "__float_as_uint(v - __uint_as_float(big & "
                            "0xffffe000u));")],
    "no_part": [("mma(part[ni], as,", "mma(acc[mi][ni], as,"),
                ("mma(part[ni], ab, bsm", "mma(acc[mi][ni], ab, bsm"),
                ("mma(part[ni], ab, bb", "mma(acc[mi][ni], ab, bb"),
                ("acc[mi][ni][e] += part[ni][e];", ";")],
    "rows128": [(MTILES, "return 4;")],
    "rows160": [(MTILES, "return 5;")],
    "stages3": [("constexpr int kTcStages = 4;",
                 "constexpr int kTcStages = 3;")],
}
M = 2048


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_tc_cost: needs a CUDA card", file=sys.stderr)
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
    libs = build_variants(headers, "k1_tc_cost")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape, k, n, gs in SHAPES:
        ql = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen).ordered
        copies = [(ql.qweight.clone(), ql.scales.clone(), ql.zeros.clone())
                  for _ in range(4)]
        x = torch.randn(M, k, generator=gen, device="cuda")
        ref = dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=gs)
        limit = 1e-5 * ref.abs().max().item() + 1e-4
        calls = {v: _caller(lib, x, ql, gs) for v, lib in libs.items()}
        errs = {v: (call(*copies[0]) - ref).abs().max().item()
                for v, call in calls.items()}
        times = {v: [] for v in calls}
        order = list(calls)
        for v in order + order[::-1]:
            times[v].append(_time(calls[v], copies, reps=6))
        out[shape] = {v: {"ms": statistics.median(times[v]),
                          "max_abs_err": errs[v], "limit": limit}
                      for v in calls}
        for v in calls:
            r = out[shape][v]
            print(f"{shape:8s} {v:12s} {r['ms']:.4f} ms "
                  f"({r['ms'] / out[shape]['kernel']['ms']:.3f}x kernel); "
                  f"max err {r['max_abs_err']:.3g} (limit {limit:.3g})",
                  flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_tc_cost.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "m": M, "shapes": out}, f, indent=1)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
