#!/usr/bin/env python3
"""K4's column tiles, and other forms of it, on one CUDA card.

    python3 tools/k4_forms.py [--source NAME=PATH ...]   # from the repo root

Builds K4 (``src/repro_torch/csrc/dequant_matmul_gidx.cu``) and each
``--source`` (a K4 source that exports the same C functions; built with
the same flags under ``build/k4_forms/NAME/``) and ``--timed-only``
source (the same, but its results may be wrong: a diagnostic that leaves
work out), all ``nvcc`` at once, prints each one's ptxas lines, then for
each form:

- checks it against the plain version, float32 and bfloat16, with
  ``chip_smoke.py``'s tolerance, at the full-width qwen3-4b MLP shapes
  (up/gate: K 2560, N 9728, gs 128; down: K 9728, N 2560, gs 76) at
  M 1, 4, 17 and 33, at G 304 (K 9728, gs 32) and at N 102, 130 and 200;
  for the repository's form with the kernel's pick of columns per block
  and with 16 and 32 forced (each that fits in shared memory), whose
  results must be bit-equal; the rows of an M = 4, 17 or 33 call must
  be bit-equal to the same rows run at M = 1;
- times it at M = 4, float32, up/gate and down (the repository's form
  also with each width forced), CUDA-graph replay over weight copies
  that the 50 MB L2 cannot hold, the forms in turns (A B B A), and the
  repository's form also on the ordered layout (``g_idx = k // gs``:
  the lookups of a packed row fall in one or two groups).

Prints each time beside the table bytes a launch reads (G x N x 8) and
the card's name and power limit; the numbers also go to
``chiprun_out/k4_forms.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
#: (M, K, N, gs) checked beyond the full-width shapes: G 304, ragged N
EDGES = ((4, 9728, 256, 32), (17, 9728, 200, 32), (5, 256, 102, 64),
         (33, 608, 200, 76), (4, 608, 130, 76), (1, 256, 130, 64))
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 0.0)}
#: columns per block: the kernel's pick, then each one forced
WIDTHS = (0, 16, 32)


def _build(sources: dict) -> dict:
    """name -> library, one nvcc each, all started together."""
    jobs = {}
    for name, src in sources.items():
        out_dir = os.path.join(build.BUILD_DIR, "k4_forms", name)
        os.makedirs(out_dir, exist_ok=True)
        lib = os.path.join(out_dir, "lib.so")
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"{name}: {ln.strip()}", flush=True)
        lib = ctypes.CDLL(path)
        for fname, argtypes, restype in dk.GIDX.functions:
            fn = getattr(lib, fname)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        libs[name] = lib
    return libs


def _caller(lib, x, n, groups, dtype, block_n):
    """A function computing K4 of ``x`` with ``lib`` on the weight copy it
    is given."""
    m, k = x.shape
    x = x.to(dtype).contiguous()
    y = torch.empty(m, n, dtype=dtype, device="cuda")
    bf16 = int(dtype == torch.bfloat16)

    def call(qw, s, z, g):
        err = lib.dequant_matmul_gidx(
            x.data_ptr(), qw.data_ptr(), s.data_ptr(), z.data_ptr(),
            g.data_ptr(), y.data_ptr(), m, n, k, groups, bf16, block_n,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                lib.dequant_matmul_gidx_error_string(err).decode())
        return y

    return call


def _time(fn, copies, reps: int, batches: int = 5) -> float:
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


def _widths(name: str, lib=None, m=4, n=0, groups=1, bf16=0) -> list:
    """The widths to run: the pick (0), and for the repository's form each
    forced width whose block fits in shared memory."""
    if name != "kernel":
        return [0]
    return [bn for bn in WIDTHS if bn == 0 or (
        lib.dequant_matmul_gidx_smem_bytes(m, n, groups, bn, bf16)
        <= lib.dequant_matmul_gidx_smem_limit())]


def _check(name, lib, gen) -> list:
    rows = []
    cases = [(m,) + s[1:] for s in SHAPES for m in (1, 4, 17, 33)]
    for m, k, n, gs in cases + list(EDGES):
        ql = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen).naive
        meta = (ql.qweight, ql.scales, ql.zeros, ql.g_idx)
        groups = ql.scales.shape[0]
        x = torch.randn(m, k, generator=gen, device="cuda")
        for dtype, (rtol, atol) in TOL.items():
            ref = dk.dequant_matmul_gidx_torch(x, *meta, compute_dtype=dtype)
            limit = rtol * ref.float().abs().max().item() + atol
            bf16 = int(dtype == torch.bfloat16)
            widths = _widths(name, lib, m, n, groups, bf16)
            outs = [_caller(lib, x, n, groups, dtype, bn)(*meta).clone()
                    for bn in widths]
            solo = torch.cat([_caller(lib, x[i:i + 1], n, groups, dtype,
                                      0)(*meta) for i in range(min(m, 4))])
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs().max().item()
            row = {"form": name, "m": m, "k": k, "n": n, "gs": gs,
                   "groups": groups, "dtype": str(dtype),
                   "block_n": lib.dequant_matmul_gidx_block_n(m, n, groups,
                                                              bf16),
                   "widths": widths,
                   "max_abs_err": err, "limit": limit,
                   "widths_bit_equal": all(torch.equal(outs[0], o)
                                           for o in outs[1:]),
                   "rows_equal_at_m1": bool(torch.equal(
                       outs[0][:min(m, 4)], solo))}
            rows.append(row)
            if not (err <= limit and row["widths_bit_equal"]
                    and row["rows_equal_at_m1"]):
                raise AssertionError(f"{name} fails: {row}")
    print(f"{name}: {len(rows)} cases within tolerance, bit-equal across "
          f"the widths that fit of {_widths(name, lib, 1, 8)} (0: the "
          f"kernel's pick), rows of M 4, 17 and 33 bit-equal to M 1",
          flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another K4 source exporting the same C functions")
    ap.add_argument("--timed-only", action="append", default=[],
                    metavar="NAME=PATH",
                    help="as --source, but its results may be wrong: it is "
                         "timed, not checked")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_forms: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sources = {"kernel": str(dk.GIDX.source)}
    sources.update(s.split("=", 1) for s in args.source + args.timed_only)
    unchecked = {s.split("=", 1)[0] for s in args.timed_only}
    libs = _build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"nvidia_smi": smi, "checks": [], "times": []}
    for name, lib in libs.items():
        if name not in unchecked:
            out["checks"] += _check(name, lib, gen)
    order = list(libs) + list(reversed(libs))
    for shape, k, n, gs in SHAPES:
        both = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"),
                           gs, generator=gen)
        ql = both.naive
        groups = ql.scales.shape[0]
        meta = [ql.qweight, ql.scales, ql.zeros, ql.g_idx]
        nbytes = sum(t.numel() * t.element_size() for t in meta)
        copies = [tuple(t.clone() for t in meta)
                  for _ in range(max(2, -(-150_000_000 // nbytes)))]
        o = both.ordered
        rows = (torch.arange(k, device="cuda") // gs).to(torch.int32)
        ordered = [tuple(t.clone() for t in (o.qweight, o.scales, o.zeros,
                                              rows)) for _ in copies]
        x = torch.randn(4, k, generator=gen, device="cuda")
        reps = 10 * len(copies)
        for bn in WIDTHS:
            names = [name for name in order
                     if bn in _widths(name, libs[name], 4, n, groups)]
            times = {name: [] for name in names}
            for name in names:
                times[name].append(_time(_caller(
                    libs[name], x, n, groups, torch.float32, bn), copies,
                    reps))
            ordered_ms = _time(_caller(libs["kernel"], x, n, groups,
                                       torch.float32, bn), ordered, reps)
            for name, t in times.items():
                row = {"form": name, "shape": shape, "k": k, "n": n,
                       "gs": gs, "block_n": bn or
                       libs[name].dequant_matmul_gidx_block_n(4, n, groups, 0),
                       "picked": bn == 0, "ms": statistics.median(t),
                       "ms_runs": t, "table_bytes": groups * n * 8}
                if name == "kernel":
                    row["ordered_layout_ms"] = ordered_ms
                out["times"].append(row)
                print(f"{shape:8s} {name:10s} block_n {row['block_n']:2d}"
                      f"{' (picked)' if bn == 0 else '         '}: "
                      f"{row['ms']:.4f} ms "
                      f"[{', '.join(f'{v:.4f}' for v in t)}]"
                      + (f", ordered layout {ordered_ms:.4f} ms"
                         if name == "kernel" else "")
                      + f"; table {row['table_bytes'] / 1e6:.2f} MB a "
                      f"launch", flush=True)
        del copies, ordered
    print(f"nvidia-smi: {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k4_forms.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
