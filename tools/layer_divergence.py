#!/usr/bin/env python3
"""How far two runs of one full-width model drift apart, layer by layer,
on one CUDA card.

    python3 tools/layer_divergence.py [ARCH ...]

For each arch (default: qwen3-4b, granite-3-8b, starcoder2-3b and
mistral-large-123b at 4 layers), built from seed 0 on the card, runs the
full-sequence forward of 2 prompts x 12 tokens one layer at a time, each
run on its own carry:

* the tp-aware plan on backend=cuda against the same plan on
  backend=torch: one function, summed in another float32 order (the
  sum-order control);
* the naive-actorder plan (K4) against the tp-aware plan (K1).

Prints, for each pair, the carry's largest gap after each layer over its
max|.| (the last entry: the logits), then the carry's max|.| per layer,
and the card's name and power limit.  A model that amplifies rounding
over its depth shows the control's gap growing layer by layer; there a
check of two plans has to hold each layer on the same input
(``chip_smoke.py``'s ``layerwise``) rather than the free-running output.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.runtime.serve import Engine, make_engine  # noqa: E402

ARCHS = ("qwen3-4b", "granite-3-8b", "starcoder2-3b", "mistral-large-123b")


@torch.inference_mode()
def carry_trace(engine, tokens) -> list:
    """The carry leaving each layer (float32 copies), then the logits."""
    cfg, params = engine.model.cfg, engine.params
    x = cm.embed_tokens(cfg, params["embed"], tokens)
    out = []
    for lp in params["layers"]:
        x = engine.model.module.layer_forward(cfg, lp, x,
                                              engine.policy).to(x.dtype)
        out.append(x.float())
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return out + [cm.lm_head(cfg, params["embed"], x)]


def main() -> int:
    if not torch.cuda.is_available():
        print("layer_divergence: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in sys.argv[1:] or ARCHS:
        base = get_config(arch)
        if arch == "mistral-large-123b":
            base = base.with_(num_layers=4)
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, base.vocab_size, (2, 12))).cuda()
        runs = {}
        for scheme in ("tp-aware", "naive-actorder"):
            cfg = base.with_quant(mode="mlp", scheme=scheme, backend="cuda")
            engine = make_engine(cfg, 0, device="cuda", max_seq=32)
            runs[scheme, "cuda"] = carry_trace(engine, tokens)
            if scheme == "tp-aware":
                plain = Engine(model=engine.model, params=engine.params,
                               device=engine.device, max_seq=32,
                               policy=engine.policy.with_(backend="torch"))
                runs[scheme, "torch"] = carry_trace(plain, tokens)
                del plain
            del engine
            torch.cuda.empty_cache()
        ref = runs["tp-aware", "cuda"]
        for key, label in ((("tp-aware", "torch"), "sum-order control, "
                            "tp-aware cuda vs torch"),
                           (("naive-actorder", "cuda"),
                            "naive-actorder (K4) vs tp-aware (K1)")):
            gaps = [((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(runs[key], ref)]
            print(f"{arch} {base.num_layers}L, {label}: gap / max|.| per "
                  f"layer, then the logits: "
                  + " ".join(f"{g:.2e}" for g in gaps), flush=True)
        print(f"{arch}: carry max|.| per layer: "
              + " ".join(f"{t.abs().max().item():.3g}" for t in ref[:-1]),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
