"""Serving entry point of the port; port of ``repro/launch/serve.py``
(the one-shot, in-memory lifecycle).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        [--smoke] [--scheme tp-aware] [--backend auto|cuda|torch|ref] \
        [--tp 2 --collective quant-int8:fused] \
        [--requests 8 --max-new 16 --prompt-budget 32 --max-batch 4 \
         --temperature 0.8 --seed 0] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
exits with an error naming the missing card.  ``--tp N`` spawns N rank
processes (``launch/mesh.py``): each builds its slices of the plan from
the same seed and runs the same scheduler, so all emit the same tokens;
rank 0 prints the banner, which names the transport, and the results.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm.spec import parse_collective
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.reorder import SCHEMES
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import make_engine


def _build_cfg(args):
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return cfg.with_quant(mode="mlp", scheme=args.scheme,
                          backend=args.backend, collective=args.collective)


def _collective(value: str) -> str:
    try:
        parse_collective(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


def _serve(args, device, group=None, transport="1 device"):
    """Build the engine (this rank's slices under TP), serve the seeded
    requests, and return what rank 0 prints."""
    cfg = _build_cfg(args)
    max_seq = args.prompt_budget + args.max_new + 1
    engine = make_engine(cfg, args.seed, device=device, max_seq=max_seq,
                         group=group)
    policy = engine.policy
    sched = Scheduler(engine, max_batch=args.max_batch,
                      prompt_budget=args.prompt_budget,
                      scfg=SamplingConfig(temperature=args.temperature,
                                          top_k=40),
                      seed=args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt_budget))
        sched.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))
    done = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done.values())
    lines = [f"req {rid}: prompt {len(r.prompt):3d} -> {r.output[:8]}..."
             for rid, r in sorted(done.items())]
    lines.append(
        f"\n{len(done)} requests, {total_new} tokens in {dt:.1f}s "
        f"({total_new / dt:.1f} tok/s) [scheme={policy.scheme} "
        f"backend={policy.backend} collective="
        f"{policy.collective.shorthand()} mesh={policy.mesh.shorthand()} "
        f"({transport}) "
        f"device={device} in-memory plan]")
    lines.append(f"decode step: {engine.decode_mode}")
    return {rid: r.output for rid, r in done.items()}, lines


def _serve_rank(ctx, args):
    """One TP rank of ``--tp N``."""
    return _serve(args, ctx.device, ctx.group, ctx.transport)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheme", default="tp-aware", choices=SCHEMES)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch", "ref"],
                    help="dequant-GEMM kernel (cuda: the hand-written "
                         "kernels, for ordered layouts and for "
                         "naive-actorder's g_idx layout; auto: cuda for "
                         "ordered layouts on the card, else torch)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-budget", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks, one process each")
    ap.add_argument("--collective", default="psum", type=_collective,
                    help="row-TP epilogue: psum, psum_scatter, cast[:dtype], "
                         "quant-int8[:block][:fused], "
                         "quant-int4[:block][:fused], none, or a "
                         "'per-layer:<glob>=<spec>,...' plan")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    if args.tp > 1:
        outputs, lines = mesh.run(_serve_rank, args.tp, args,
                                  device_type=device.type)[0]
    else:
        outputs, lines = _serve(args, device)
    print("\n".join(lines))
    return outputs


if __name__ == "__main__":
    main()
