#!/usr/bin/env python3
"""Where K1's tensor-core loop starts to pay, on one CUDA card.

    python3 tools/k1_threshold.py          # from the repository root

K1 (``src/repro_torch/csrc/dequant_matmul_ordered.cu``) has two float32
main loops: the decode loop (on the tensor cores), and for
calls at ``M >= kTcMinM`` (``dequant_matmul_ordered.cuh``) the large-M
tensor-core loop.
This builds two copies of the source with that constant changed by text
substitution, one that sends every float32 call to the decode loop and
one that sends every call above M = 4 to the tensor-core loop, checks
both against the plain version, and times them in turns (CUDA-graph
replay: decode, tensor cores, tensor cores, decode) at the full-width
qwen3-4b MLP shapes (up/gate: K 2560, N 9728, gs 128; down: K 9728,
N 2560, gs 76) over a sweep of M.

Prints, per M, both loops' ms at both shapes, the smallest M of the
sweep from which the tensor-core loop is faster at both shapes at every
larger M of the sweep, and the smallest from which it is faster per
qwen3-4b layer (2 x up/gate + down) at every larger M: the value
``kTcMinM`` holds (the float32 decode loop on the tensor cores wins at
the up/gate shape at every M of the sweep but 1536).  Then each M's
per-layer ms and the card's name and power limit.  The numbers also go
to ``chiprun_out/k1_threshold.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dequant_matmul as dk  # noqa: E402

SHAPES = (("up/gate", 2560, 9728, 128), ("down", 9728, 2560, 76))
SWEEP = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
#: kTcMinM of each copy: every float32 call on the decode loop, or every
#: call above M = 4 on the tensor-core loop
VARIANTS = {"decode": 1 << 30, "tensor_cores": 5}
CONSTANT = re.compile(r"constexpr int kTcMinM = \d+;")


def build_variants(headers: dict, out: str) -> dict:
    """Build K1's source once for each ``name -> header text`` under
    ``build/<out>/<name>/`` (one nvcc each, all started together) and load
    each library with K1's C signatures; print each one's ptxas
    registers and spills."""
    jobs = {}
    for name, header in headers.items():
        out_dir = os.path.join(build.BUILD_DIR, out, name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "dequant_matmul_ordered.cuh"),
                  "w") as f:
            f.write(header)
        src = os.path.join(out_dir, "dequant_matmul_ordered.cu")
        with open(src, "w") as f:
            f.write(dk.ORDERED.source.read_text())
        lib = os.path.join(out_dir, "lib.so")
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # the few lines after each tensor-core kernel's "Compiling entry"
        lines = log.splitlines()
        regs = [ln.split(":", 1)[-1].strip()
                for i, head in enumerate(lines)
                if "Compiling" in head and "dequant_matmul_tc_kernel" in head
                for ln in lines[i + 1:i + 4]
                if "spill" in ln or "registers" in ln]
        print(f"{name}: tensor-core kernel ptxas: {' / '.join(regs)}",
              flush=True)
        lib = ctypes.CDLL(path)
        for fname, argtypes, restype in dk.ORDERED.functions:
            fn = getattr(lib, fname)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        libs[name] = lib
    return libs


def _build() -> dict:
    header = (build.CSRC / "dequant_matmul_ordered.cuh").read_text()
    if len(CONSTANT.findall(header)) != 1:
        raise RuntimeError("the header no longer defines kTcMinM once")
    return build_variants(
        {name: CONSTANT.sub(f"constexpr int kTcMinM = {min_m};", header)
         for name, min_m in VARIANTS.items()}, "k1_threshold")


def _caller(lib, x, ql, gs):
    """A function computing K1 of ``x`` with library ``lib`` on one of the
    weight copies it is given."""
    m, k = x.shape
    n = ql.qweight.shape[1]
    bk = dk.pick_block_k(k, gs)
    floats = lib.dequant_matmul_partial_floats(m, n, k, gs, bk, 0)
    if floats < 0:
        raise RuntimeError(f"partial_floats: cuda error {-floats}")
    partial = torch.empty(max(floats, 1), device="cuda")
    y = torch.empty(m, n, device="cuda")

    def call(qw, s, z):
        err = lib.dequant_matmul_ordered(
            x.data_ptr(), qw.data_ptr(), s.data_ptr(), z.data_ptr(),
            y.data_ptr(), partial.data_ptr(), floats, m, n, k, gs, bk, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.dequant_matmul_error_string(err).decode())
        return y

    return call


def _time(fn, copies, reps: int, batches: int = 3) -> float:
    """Median over ``batches`` of the mean ms per call in a CUDA-graph
    replay of ``reps`` calls cycling through ``copies``."""
    fn(*copies[0])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(*copies[i % len(copies)])
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_threshold: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, k, n, gs in SHAPES:
        ql = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen).ordered
        # weight copies beyond the 50 MB L2
        copies = [(ql.qweight.clone(), ql.scales.clone(), ql.zeros.clone())
                  for _ in range(4)]
        for m in SWEEP:
            x = torch.randn(m, k, generator=gen, device="cuda")
            ref = dk.dequant_matmul_ordered_torch(
                x, ql.qweight, ql.scales, ql.zeros, group_size=gs)
            limit = 1e-5 * ref.abs().max().item() + 1e-4
            calls = {v: _caller(lib, x, ql, gs) for v, lib in libs.items()}
            row = {"shape": name, "m": m, "k": k, "n": n, "gs": gs}
            for v, call in calls.items():
                err = (call(*copies[0]) - ref).abs().max().item()
                if not err <= limit:
                    raise AssertionError(f"{v} at {row}: error {err} above "
                                         f"{limit}")
                row[f"{v}_max_abs_err"] = err
            reps = 16 if m <= 256 else 4
            times = {v: [] for v in calls}
            for v in ("decode", "tensor_cores", "tensor_cores", "decode"):
                times[v].append(_time(calls[v], copies, reps))
            for v, t in times.items():
                row[f"{v}_ms"] = statistics.median(t)
            rows.append(row)
            print(f"{name:8s} M={m:5d}: decode loop {row['decode_ms']:.4f} "
                  f"ms, tensor cores {row['tensor_cores_ms']:.4f} ms "
                  f"({row['decode_ms'] / row['tensor_cores_ms']:.2f}x); "
                  f"max err {row['decode_max_abs_err']:.3g} / "
                  f"{row['tensor_cores_max_abs_err']:.3g}", flush=True)
    faster = {m: all(r["tensor_cores_ms"] < r["decode_ms"]
                     for r in rows if r["m"] == m) for m in SWEEP}

    def layer(m, loop):
        """One qwen3-4b layer's ms: up and gate (the first shape), down."""
        up, down = (next(r[f"{loop}_ms"] for r in rows
                         if r["m"] == m and r["shape"] == name)
                    for name, *_ in SHAPES)
        return 2 * up + down

    faster_layer = {m: layer(m, "tensor_cores") < layer(m, "decode")
                    for m in SWEEP}
    threshold = layer_threshold = None
    for m in reversed(SWEEP):
        if not faster[m]:
            break
        threshold = m
    for m in reversed(SWEEP):
        if not faster_layer[m]:
            break
        layer_threshold = m
    print(f"smallest M of the sweep from which the tensor-core loop is "
          f"faster at both shapes: {threshold}; per layer (2 x up/gate + "
          f"down): {layer_threshold} (the source holds "
          f"{dk.tensor_core_min_m()})")
    for m in SWEEP:
        print(f"per layer M={m:5d}: decode loop {layer(m, 'decode'):.4f} ms, "
              f"tensor cores {layer(m, 'tensor_cores'):.4f} ms")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_threshold.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows, "threshold": threshold,
                   "layer_threshold": layer_threshold}, f, indent=1)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
