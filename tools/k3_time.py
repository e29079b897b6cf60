#!/usr/bin/env python3
"""K3 (the fused dequant-GEMM + wire quantize) of one source tree, checked
and timed on one CUDA card at the tp=2 down shard of full-width qwen3-4b.

    python3 tools/k3_time.py [--root DIR]

``--root`` names the tree whose ``src/repro_torch`` is imported (default:
this repository); a second tree, such as the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists, is timed by a
second run of this script with ``--root`` pointing there.  Each run builds
that tree's K1 and K3 (its own ``kernels/build.py``, into its own
``build/``) and prints their ptxas lines.  Then, for each case of
``CASES`` (M and compute type: M 4 in float32 is the decode step, M 64
takes the decode loop's 16-row blocks, M 259 float32 the tensor-core
loop) and each wire (int8 blocks of 128, int4 blocks of 32), it checks K3
bit-equal to K1 followed by the collective's quantizer, counts the device
kernels one K3 call launches (torch.profiler) and times K3, K1 alone and
K1 followed by the plain quantizer (CUDA-graph replay over weight copies
that the 50 MB L2 cannot hold).  The timing and the kernel count are
chip_smoke.py's own (``_time``, ``_kernel_launches``).  Runs of two trees
in turns (A B B A) in one chip call compare them on one card.  The last
line is one JSON object with the numbers, the tree and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (K, N, gs) of one rank's down projection at tp=2, and the wires
SHAPE = (9728 // 2, 2560, 76)
TP = 2
WIRES = ((8, 128), (4, 32))
#: (M, compute type) of the timed calls
CASES = ((4, torch.float32), (64, torch.float32), (64, torch.bfloat16),
         (259, torch.float32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # the timed tree's package first: chip_smoke.py's own imports of
    # repro_torch then resolve into it
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    from chip_smoke import _kernel_launches, _time
    from repro_torch.comm.wire import wire_params
    from repro_torch.core import quantization as qz
    from repro_torch.kernels import build
    from repro_torch.kernels import dequant_matmul as dk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    tree = os.path.relpath(root, ROOT)
    build.compile_all(dk.ORDERED, dk.WIRE)
    for kern in (dk.ORDERED, dk.WIRE):
        for ln in build.info[kern.name]["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[{tree}] {kern.name}: {ln.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    k, n, gs = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    ql = qz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                     generator=gen).ordered
    meta = (ql.qweight, ql.scales, ql.zeros)
    wbytes = sum(t.numel() * t.element_size() for t in meta)
    copies = [tuple(t.clone() for t in meta)
              for _ in range(max(2, math.ceil(150e6 / wbytes)))]
    reps = 10 * len(copies)
    res = {"tree": tree, "nvidia_smi": smi, "cases": []}
    for m, dtype in CASES:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)

        def k1(qw, s, z, x=x, dtype=dtype):
            return dk.dequant_matmul_ordered(x, qw, s, z, group_size=gs,
                                             compute_dtype=dtype)

        k1_ms = _time(k1, copies, reps)
        for bits, blk in WIRES:
            n_pad, _, bs = wire_params(n, TP, bits, blk)
            kw = dict(group_size=gs, n_pad=n_pad, wire_block=bs,
                      wire_bits=bits, compute_dtype=dtype)
            wire = dict(n_pad=n_pad, wire_block=bs, wire_bits=bits)

            def k3(qw, s, z, x=x, kw=kw):
                return dk.dequant_matmul_wire_ordered(x, qw, s, z, **kw)

            def k1_quantizer(qw, s, z, wire=wire):
                return dk.quantize_wire(k1(qw, s, z), **wire)

            got, want = k3(*meta), k1_quantizer(*meta)
            torch.cuda.synchronize()
            if not all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want)):
                raise AssertionError(f"[{tree}] K3 int{bits} M={m} {dtype} "
                                     f"differs from K1 + the quantizer")
            kernels = _kernel_launches(lambda: k3(*meta))
            r = {"m": m, "dtype": str(dtype), "bits": bits, "block": bs,
                 "n_pad": n_pad, "bit_equal_to_k1": True,
                 "device_kernels_per_call": sum(kernels.values()),
                 "kernels": sorted(name[:80] for name in kernels),
                 "ms": _time(k3, copies, reps),
                 "k1_alone_ms": k1_ms,
                 "k1_plus_quantizer_ms": _time(k1_quantizer, copies, reps)}
            res["cases"].append(r)
            print(f"[{tree}] K3 int{bits} {str(dtype)[6:]} M={m} K={k} N={n} "
                  f"(tp=2 down shard): {r['ms']:.4f} ms in "
                  f"{r['device_kernels_per_call']} device kernel(s) a call; "
                  f"K1 + plain quantizer {r['k1_plus_quantizer_ms']:.4f}, "
                  f"K1 alone {k1_ms:.4f}; {smi}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
