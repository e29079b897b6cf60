#!/usr/bin/env python3
"""Which leaves make a smoke config's train-step gradient norm differ
between one CUDA card and the CPU.

    python3 tools/train_grad_gaps.py [ARCH ...]   # default: all ten

For each config, ``chip_smoke.py``'s smoke-step inputs (``quant.mode=
"none"``, float32 carry and stubs, its batch of the synthetic stream,
params from seed 0) and its ``_family_grads``: the train loss's gradient
on the card in float32 (twice: whether the two runs are bit-equal), on
the CPU in float32 and on the CPU in float64.  Per leaf: its share of
the float64 |grad|^2, and how far each float32 |grad|^2 lies from the
float64 one, as a share of the total; then the leaves with the largest
card-vs-CPU part, and each device's grad_norm gap to float64.  Prints the card's name and power limit, and
writes ``chiprun_out/train_grad_gaps.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (FAMILY_BATCH, FAMILY_SEQ, _family_grads,  # noqa: E402
                        _norm)
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.launch.train import stubs  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402

TOP = 5


def sq(t: torch.Tensor) -> float:
    return float(torch.sum(t * t))


def gaps(arch: str) -> dict:
    """chip_smoke.py's smoke-step gradients of ``arch``, leaf by leaf."""
    cfg = get_smoke_config(arch).with_quant(mode="none").with_(
        dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = next(data_lib.batches(data_lib.DataConfig(
        seq_len=FAMILY_SEQ, global_batch=FAMILY_BATCH,
        vocab_size=cfg.vocab_size), device="cpu"))
    batch.update(stubs(cfg, FAMILY_BATCH, "cpu"))
    _, card = _family_grads(model, params, batch, "cuda")
    _, again = _family_grads(model, params, batch, "cuda")
    _, cpu = _family_grads(model, params, batch, "cpu")
    _, f64 = _family_grads(build_model(cfg.with_(dtype="float64")), params,
                           batch, "cpu", torch.float64)
    f64 = {k: g for k, g in f64.items() if g is not None and g.numel()}
    total = sum(sq(g) for g in f64.values())
    leaves = [{"leaf": k, "share": sq(g) / total,
               "card_vs_cpu": (sq(card[k]) - sq(cpu[k])) / total,
               "card_vs_f64": (sq(card[k]) - sq(g)) / total,
               "cpu_vs_f64": (sq(cpu[k]) - sq(g)) / total}
              for k, g in f64.items()]
    leaves.sort(key=lambda r: -abs(r["card_vs_cpu"]))
    n64 = math.sqrt(total)
    return {"bit_equal_on_card": all(torch.equal(card[k], again[k])
                                     for k in f64),
            "grad_norm_vs_f64": {"card": (_norm(card) - n64) / n64,
                                 "cpu": (_norm(cpu) - n64) / n64},
            "top": leaves[:TOP]}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_grad_gaps: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    out = {"nvidia_smi": smi}
    for arch in sys.argv[1:] or ARCH_IDS:
        res = out[arch] = gaps(arch)
        g = res["grad_norm_vs_f64"]
        print(f"{arch}: grad_norm against float64: card {g['card']:+.3e}, "
              f"CPU {g['cpu']:+.3e}; two card runs bit-equal: "
              f"{res['bit_equal_on_card']}")
        for r in res["top"]:
            print(f"  {r['leaf']}: share {r['share']:.4f} of |grad|^2; "
                  f"|grad|^2 card-CPU {r['card_vs_cpu']:+.3e}, card-f64 "
                  f"{r['card_vs_f64']:+.3e}, CPU-f64 {r['cpu_vs_f64']:+.3e}"
                  " of the total")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_grad_gaps.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
