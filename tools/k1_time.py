#!/usr/bin/env python3
"""K1 (the ordered dequant-GEMM) of one source tree, its outputs digested
and its time taken on one CUDA card.

    python3 tools/k1_time.py [--root DIR]

``--root`` names the tree whose ``src/repro_torch`` is imported (default:
this repository); a second tree, such as the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists, is run by a
second run of this script with ``--root`` pointing there.  Each run builds
that tree's K1 (its own ``kernels/build.py``, into its own ``build/``),
then runs chip_smoke.py's check cases of K1 (``k1_cases`` around the
tensor-core threshold 256, whatever the tree's own threshold, so that both
trees run the same cases) in float32 and bfloat16, on inputs drawn from
seed 0 in one fixed order, and prints one sha256 over every bfloat16
output (two trees whose digests agree gave the same bits) and the largest
float32 error against the plain version, absolute and as a share of the
check's limit (1e-5 * max|ref| + 1e-4).  Then it times K1 with
chip_smoke.py's ``_time`` (CUDA-graph replay over weight copies the 50 MB
L2 cannot hold; the split-add pass included) in float32: qwen3-4b's
up/gate and down at M 1, 4, 8, 16, 64 and 255, and at M=4 the MLP shapes
of mistral-large-123b, granite-3-8b, whisper-large-v3 and
llama-3.2-vision-90b and the qwen3-moe-235b-a22b expert's (also at M=8),
each beside its bytes bound, with one layer's sum (up, gate where gated,
down).  Runs of two trees in turns (A B B A) in one chip call compare
them on one card.  The last line is one JSON object with the digest, the
numbers, the tree and the card's name and power limit.
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
#: the large-M threshold the check cases are drawn around (the parent's)
CASES_THRESHOLD = 256
#: qwen3-4b's row counts timed: decode batches, an EP data rank's 8 rows,
#: and up to the large-M loop's threshold
QWEN_M = (1, 4, 8, 16, 64, 255)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # the tree's package first: chip_smoke.py's own imports of repro_torch
    # then resolve into it
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import dequant_matmul as dk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    tree = os.path.relpath(root, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.compile_all(dk.ORDERED)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"tree": tree, "nvidia_smi": smi, "ms": {}, "layers": {}}
    digest = hashlib.sha256()
    worst, worst_share = 0.0, 0.0
    cases = cs.k1_cases(CASES_THRESHOLD)
    for m, k, n, gs in cases:
        ql = cs._quantized(gen, k, n, gs).ordered
        x = torch.randn(m, k, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            y = dk.dequant_matmul_ordered(x, ql.qweight, ql.scales, ql.zeros,
                                          group_size=gs, compute_dtype=dtype)
            if dtype == torch.bfloat16:
                digest.update(y.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes())
                continue
            ref = dk.dequant_matmul_ordered_torch(
                x, ql.qweight, ql.scales, ql.zeros, group_size=gs)
            err = (y - ref).abs().max().item()
            worst = max(worst, err)
            worst_share = max(worst_share, err / (
                1e-5 * ref.abs().max().item() + 1e-4))
    res["bf16_sha256"] = digest.hexdigest()
    res["f32_max_abs_err"] = worst
    res["f32_err_share_of_limit"] = worst_share
    print(f"[{tree}] {len(cases)} K1 check cases: sha256 of every bfloat16 "
          f"output {res['bf16_sha256']}; float32 max abs err {worst:.3g}, "
          f"{worst_share:.3g} of the limit", flush=True)

    def timed(label, shape, m):
        _, k, n, gs = shape
        ql = cs._quantized(gen, k, n, gs).ordered
        meta = [ql.qweight, ql.scales, ql.zeros]
        wbytes = sum(t.numel() * t.element_size() for t in meta)
        copies = cs._copies(meta, wbytes)
        x = torch.randn(m, k, generator=gen, device="cuda")
        ms = cs._time(lambda qw, s, z: dk.dequant_matmul_ordered(
            x, qw, s, z, group_size=gs), copies, reps=10 * len(copies))
        bound, by = cs._bound(4 * (m * k + m * n) + wbytes, 2 * m * k * n)
        res["ms"][f"{label} M={m}"] = {"k": k, "n": n, "gs": gs, "ms": ms,
                                       "bound_ms": bound, "bound_by": by}
        print(f"[{tree}] K1 f32 {label} M={m} (K {k} N {n} gs {gs}): "
              f"{ms:.4f} ms, bound {bound:.4f} ({by})", flush=True)
        del copies
        return ms, bound

    def layer(name, shapes, m, gated=True):
        (up, up_b), (down, down_b) = (timed(label, shape, m)
                                      for label, shape in shapes)
        ms = (2 if gated else 1) * up + down
        bound = (2 if gated else 1) * up_b + down_b
        res["layers"][f"{name} M={m}"] = {"ms": ms, "bound_ms": bound}
        print(f"[{tree}] K1 f32 {name} per layer M={m}: {ms:.4f} ms, bound "
              f"{bound:.4f}; {smi}", flush=True)

    qwen = (("qwen3-4b up/gate", cs.UP), ("qwen3-4b down", cs.DOWN))
    for m in QWEN_M:
        layer("qwen3-4b", qwen, m)
    for arch in ("mistral-large-123b", "granite-3-8b", cs.WHISPER,
                 cs.VISION):
        cfg = get_config(arch)
        layer(arch, [(s[0], s) for s in cs.mlp_shapes(cfg)], 4,
              gated=cfg.mlp_gated)
    expert = [(s[0], s) for s in cs.MOE_SHAPES["qwen3-moe-235b-a22b"]]
    for m in (4, 8):
        layer("qwen3-moe-235b-a22b expert", expert, m)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
