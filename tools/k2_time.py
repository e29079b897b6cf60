#!/usr/bin/env python3
"""K2 (flash attention) of one source tree, its outputs digested and its
time taken on one CUDA card.

    python3 tools/k2_time.py [--root DIR]

``--root`` names the tree whose ``src/repro_torch`` is imported (default:
this repository); a second tree, such as the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists, is run by a
second run of this script with ``--root`` pointing there.  Each run builds
that tree's K2 (its own ``kernels/build.py``, into its own ``build/``),
then runs chip_smoke.py's check cases of K2 (``FLASH_SWEEP`` and
``FLASH_EDGES``, head dims 32, 64 and 128, then ``FLASH_EDGES_256`` where
the tree takes head dim 256), float32 and bfloat16, on inputs drawn from
seed 0 in one fixed order, and prints for each case the sha256 of the
output's bytes and its largest difference from the plain version, and
one sha256 over every output at head dims 32, 64 and 128: two trees
whose digests agree gave the same bits.  Then it times K2 at
qwen3-4b's forward shape (B1 H32 S2048 D128, causal) and, where the tree
takes it, at recurrentgemma-2b's (B1 H10 S2048 D256), with chip_smoke.py's
``_time`` (CUDA-graph replay over input copies).  Runs of two trees in
turns (A B B A) in one chip call compare them on one card.  The last line
is one JSON object with the digests, the numbers, the tree and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # the tree's package first: chip_smoke.py's own imports of repro_torch
    # then resolve into it
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    tree = os.path.relpath(root, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.compile_all(fa.FLASH)
    cases = [(b, h, s, s, d, causal, window)
             for b, h, s, d, causal, window in cs.FLASH_SWEEP] + cs.FLASH_EDGES
    if 256 in fa.HEAD_DIMS:
        cases += cs.FLASH_EDGES_256
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": tree, "nvidia_smi": smi, "cases": [], "ms": {}}
    whole = hashlib.sha256()
    for b, h, s, t, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, h, t, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            y = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_torch(q, k, v, causal=causal,
                                           window=window)
            raw = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            digest = hashlib.sha256(raw).hexdigest()
            if d <= 128:
                whole.update(raw)
            err = (y.float() - ref.float()).abs().max().item()
            res["cases"].append({"shape": [b, h, s, t, d], "causal": causal,
                                 "window": window, "dtype": str(dtype),
                                 "sha256": digest, "max_abs_err": err})
            print(f"[{tree}] K2 B{b} H{h} S{s} T{t} D{d} causal={causal} "
                  f"window={window} {str(dtype)[6:]}: sha256 {digest[:16]} "
                  f"max abs err {err:.3g}", flush=True)
    res["sha256_d32_64_128"] = whole.hexdigest()
    shapes = [cs.FLASH_FULL] + ([cs.FLASH_REC] if 256 in fa.HEAD_DIMS
                                else [])
    for bb, hh, ss, dd, causal, window in shapes:
        qkv = [tuple(torch.randn(bb, hh, ss, dd, generator=gen,
                                 device="cuda") for _ in range(3))
               for _ in range(2)]
        ms = cs._time(lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal, window=window), qkv, reps=6, batches=5)
        res["ms"][f"B{bb} H{hh} S{ss} D{dd}"] = ms
        print(f"[{tree}] K2 f32 B{bb} H{hh} S=T={ss} D{dd} causal: {ms:.4f} "
              f"ms; {smi}", flush=True)
    print(f"[{tree}] sha256 of every output at head dims 32, 64 and 128: "
          f"{res['sha256_d32_64_128']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
