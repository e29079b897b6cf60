#!/usr/bin/env python3
"""Host wall time of the port's full-width decode step on one CUDA card.

    python3 tools/decode_step_time.py [--rounds 5] [--steps 10] [--fold]

Builds the full-width qwen3-4b ``tp-aware`` engine from seed 0 on the
card, as ``chip_smoke.py``'s serve phase does (with ``--fold``, from the
plan with the attention V->O fold, prepared on the card from seed 0 and
served from memory, as phase 25 serves it from its files), and runs
4-slot decode steps at cache position 24 onwards (``Engine.decode``, as
the scheduler calls it: on the card, replays of the captured step).  Each
round times ``--steps`` steps with the host clock, ending in a
synchronize.  Prints each round's ms per step, their median, the card's
name and power limit.  Compare two trees only within one call, in turns.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import fold_layers  # noqa: E402
from repro_torch.plan import compiler  # noqa: E402
from repro_torch.runtime.serve import make_engine  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fold", action="store_true",
                    help="the plan with the attention V->O fold")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_step_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config("qwen3-4b").with_quant(mode="mlp", scheme="tp-aware",
                                           backend="auto",
                                           attn_tp_aware=args.fold)
    plan = (compiler.prepare(cfg, tp=1, seed=0, device="cuda")
            if args.fold else None)
    engine = make_engine(cfg, 0, device="cuda", max_seq=64, artifact=plan)
    del plan
    cache = engine.init_cache(4)
    tokens = torch.arange(4, device="cuda")
    pos = torch.full((4,), 24, device="cuda")

    def steps(n):
        for i in range(n):
            engine.decode(cache, tokens, pos + i)
        torch.cuda.synchronize()

    steps(3)                      # builds the kernels, captures, warms up
    rounds = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        steps(args.steps)
        rounds.append((time.perf_counter() - t0) * 1e3 / args.steps)
    print("decode step ms per round: "
          + ", ".join(f"{r:.2f}" for r in rounds))
    print(f"median {statistics.median(rounds):.2f} ms per step "
          f"({args.rounds} rounds of {args.steps} steps, 4 slots, full "
          f"width, tp-aware, {engine.policy.backend}; decode step: "
          f"{engine.decode_mode}; attn V->O fold: {fold_layers(engine)})")
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
