#!/usr/bin/env python3
"""The dense serve of one tree of the port on one CUDA card.

    python3 tools/serve_time.py [--root DIR]

Imports the port from ``DIR/src`` (default: this tree), builds the
full-width qwen3-4b ``tp-aware`` engine from seed 0 on the card and
serves ``chip_smoke.py``'s four requests (prompts of 4-31 tokens, 16 new
tokens, 4 slots, max_seq 49) three times through one ``Scheduler`` each,
with that tree's own ``chip_smoke.py`` helpers: the median step after
the first of each serve, and the ids (equal across the serves).  Then
the serve CLI at ``--tp 2 --collective quant-int8:fused`` from ``DIR``
(two rank processes; the CLI's tokens/s).
Prints one JSON line and the card's name and power limit.  To compare two
trees, unpack the other under ``build/`` (``git archive``) and run the
trees in turns in one call (parent, change, change, parent); a tree's
first run builds its kernels, so compare its later runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the tree whose port is served (default: this one)")
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        print("serve_time: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import chip_smoke as cs        # puts DIR/src first on the path

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.QWEN.with_quant(mode="mlp", scheme="tp-aware", backend="auto")
    engine = cs.make_engine(cfg, 0, device="cuda", max_seq=49)
    medians, ids = [], None
    for _ in range(3):
        sched = cs.Scheduler(engine, max_batch=4, prompt_budget=32,
                             scfg=cs.SamplingConfig(temperature=0.8,
                                                    top_k=40), seed=0)
        cs._submit_requests(sched, cfg)
        done, _, step_ms = cs._run_steps(sched)
        medians.append(cs.statistics.median(step_ms[1:]))
        out = {k: r.output for k, r in sorted(done.items())}
        if ids is not None and out != ids:
            raise AssertionError("a serve's ids differ from the first's")
        ids = out
    del engine
    torch.cuda.empty_cache()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tp", "2",
         "--collective", cs.TP_SERVE, "--requests", "4", "--max-new",
         "16"], cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    if cli.returncode:
        raise RuntimeError(f"serve CLI at tp=2 failed: {cli.stderr[-2000:]}")
    m = re.search(r"(\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s\)", cli.stdout)
    smi = cs.phase_device()
    print(json.dumps({"root": root, "tp1_steady_ms": medians,
                      "tp1_first_ids": {k: v[:4] for k, v in ids.items()},
                      "tp2_seconds": float(m.group(2)),
                      "tp2_tokens_per_s": float(m.group(3))}))
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
