#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root, one H100

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
  2. build: nvcc of the dequant-GEMM kernel for sm_90a, ptxas registers
     and shared memory
  3. kernel check: the CUDA kernel against its plain torch version at the
     reference's test shapes, the gs=76 shape and the full-width qwen3-4b
     MLP shapes, float32 and bfloat16
  4. kernel timing: full-width M=4 launches against the bytes bound, the
     plain version and, as context, torch.matmul on the pre-dequantized
     weight
  5. serve: full-width qwen3-4b (36 layers) built by the port's
     ``make_engine`` on the card from seed 0, four requests through the
     ``Scheduler``; every decode step must launch the kernel 108 times
  6. trace: device time of a few full-width decode steps by kernel
     (torch.profiler) against their wall time: the device's busy share
  7. backend cross-check: greedy decode with backend=cuda and
     backend=torch on the same params

then the per-kernel JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke.json``.  Any failure raises, so the script exits
non-zero and prints no result line; so does a machine without a card.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.kernels import dequant_matmul as dk  # noqa: E402
from repro_torch.runtime.sampling import SamplingConfig  # noqa: E402
from repro_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from repro_torch.runtime.serve import Engine, make_engine  # noqa: E402

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores (the kernel's float32 policy uses plain FMA)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: full-width qwen3-4b MLP GEMMs: (name, K, N, group size); the down
#: projection's gs is choose_group_size(9728 / 16, 128) = 76
UP = ("up/gate", 2560, 9728, 128)
DOWN = ("down", 9728, 2560, 76)
SWEEP = [(8, 128, 128, 32), (16, 256, 384, 64), (128, 512, 256, 128),
         (1, 256, 128, 64), (4, 1024, 128, 128), (4, 608, 128, 76),
         # ragged edges: N not a multiple of 4 (4-byte copies), M past a tile
         (5, 256, 102, 64), (33, 608, 200, 76)]
#: tolerance of the kernel against its plain version, relative to
#: max|ref|: float32 sums in another order (plus 1e-4 absolute), or one
#: bf16 ulp of the output
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 0.0)}
LAUNCHES_PER_STEP = 36 * 3


def line(phase: str, text: str):
    print(f"[{phase}] {text}", flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    line("device", f"nvidia-smi: {smi} | torch {torch.__version__} cuda "
                   f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> dict:
    lib = dk.build()
    info = dk.build_info
    ptxas = [s.strip() for s in info["ptxas"].splitlines()
             if "registers" in s or "smem" in s]
    # dynamic shared memory per block at the main path's shapes (f32, M<=4)
    smem = {name: lib.dequant_matmul_smem_bytes(4, gs, dk.pick_block_k(k, gs),
                                                0)
            for name, k, _, gs in (UP, DOWN)}
    line("build", f"{info['seconds']:.1f}s -> "
                  f"{os.path.relpath(info['path'], ROOT)}; dynamic smem per "
                  f"block {smem}; ptxas: "
                  f"{' || '.join(ptxas) or info['ptxas'].strip()}")
    return {"seconds": info["seconds"], "ptxas": ptxas, "smem_bytes": smem}


def _weights(gen, k, n, gs):
    w = torch.randn(k, n, generator=gen, device="cuda")
    return qz.quantize(w, gs, generator=gen).ordered


def phase_check(gen) -> tuple[float, list]:
    """Returns the largest float32 error at the main path's shapes (M=4,
    full width) and every case's record."""
    shapes = SWEEP + [(m, k, n, gs) for _, k, n, gs in (UP, DOWN)
                      for m in (1, 4, 32)]
    rows, worst, main = [], {}, 0.0
    for m, k, n, gs in shapes:
        ql = _weights(gen, k, n, gs)
        x = torch.randn(m, k, generator=gen, device="cuda")
        for dtype, (rtol, atol) in TOL.items():
            y = dk.dequant_matmul_ordered(
                x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
                compute_dtype=dtype)
            ref = dk.dequant_matmul_ordered_torch(
                x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
                compute_dtype=dtype)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            limit = rtol * ref.float().abs().max().item() + atol
            rows.append({"m": m, "k": k, "n": n, "gs": gs,
                         "dtype": str(dtype), "max_abs_err": err,
                         "limit": limit})
            if not (y.shape == ref.shape and math.isfinite(err)
                    and err <= limit):
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: {rows[-1]}")
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
            if dtype == torch.float32 and m == 4 and k >= 2560:
                main = max(main, err)
    line("check", f"{len(rows)} cases ({len(SWEEP)} sweep + 6 full-width "
                  f"shapes x "
                  f"f32/bf16) within tolerance; max err / max|ref|: f32 "
                  f"{worst[torch.float32]:.3g}, bf16 "
                  f"{worst[torch.bfloat16]:.3g}; f32 max_abs_err at the "
                  f"main path's shapes {main:.3g}; tol f32 "
                  f"1e-5*max|ref|+1e-4, bf16 1e-2*max|ref|")
    return main, rows


def _time(fn, args_list, reps: int, batches: int = 5,
          graph: bool = True) -> float:
    """Median over ``batches`` of the mean ms per call, cycling through
    ``args_list`` (distinct weight copies, so the 50 MB L2 holds none).

    With ``graph`` the ``reps`` calls are captured once as a CUDA graph and
    replayed: device time of back-to-back launches, without the host's
    launch overhead.  Without it, the calls are issued from Python."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()

    def run():
        for i in range(reps):
            fn(*args_list[i % len(args_list)])

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def phase_timing(gen) -> dict:
    m = 4
    res = {}
    for name, k, n, gs in (UP, DOWN):
        ql = _weights(gen, k, n, gs)
        wbytes = (ql.qweight.numel() + ql.scales.numel()
                  + ql.zeros.numel()) * 4
        copies = max(2, math.ceil(150e6 / wbytes))
        quants = [(ql.qweight.clone(), ql.scales.clone(), ql.zeros.clone())
                  for _ in range(copies)]
        x = torch.randn(m, k, generator=gen, device="cuda")

        def kernel(qw, s, z):
            return dk.dequant_matmul_ordered(x, qw, s, z, group_size=gs)

        def plain(qw, s, z):
            return dk.dequant_matmul_ordered_torch(x, qw, s, z,
                                                   group_size=gs)

        w_deq = [qz.dequantize(ql) for _ in range(2)]
        ms = _time(kernel, quants, reps=10 * copies)
        eager_ms = _time(kernel, quants, reps=10 * copies, graph=False)
        plain_ms = _time(plain, quants[:2], reps=10)
        mm_ms = _time(lambda w: torch.matmul(x, w), [(w,) for w in w_deq],
                      reps=20)
        nbytes = 4 * (m * k + m * n) + wbytes
        bound_bytes = nbytes / PEAK_BYTES * 1e3
        bound_ops = 2 * m * k * n / PEAK_F32 * 1e3
        res[name] = {"m": m, "k": k, "n": n, "gs": gs, "ms": ms,
                     "eager_ms": eager_ms,
                     "plain_ms": plain_ms, "matmul_dequantized_ms": mm_ms,
                     "bytes": nbytes, "bound_ms": max(bound_bytes, bound_ops),
                     "bound_by": ("bytes" if bound_bytes >= bound_ops
                                  else "operations"),
                     "weight_copies": copies}
        del quants, w_deq
    u, d = res[UP[0]], res[DOWN[0]]
    line("timing", "f32 M=4, CUDA-graph replay: up/gate {:.4f} ms (bound "
         "{:.4f}, plain {:.4f}, matmul on dequantized weight {:.4f} "
         "[context], eager call {:.4f}); down {:.4f} ms (bound {:.4f}, "
         "plain {:.4f}, matmul {:.4f} [context], eager call {:.4f})".format(
             u["ms"], u["bound_ms"], u["plain_ms"],
             u["matmul_dequantized_ms"], u["eager_ms"], d["ms"],
             d["bound_ms"], d["plain_ms"], d["matmul_dequantized_ms"],
             d["eager_ms"]))
    return res


def phase_serve(cfg):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, 0, device="cuda", max_seq=32 + 16 + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.policy.backend != "cuda":
        raise AssertionError(f"auto policy picked {engine.policy.backend!r}")
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    rng = np.random.default_rng(0)
    for i in range(4):
        plen = int(rng.integers(4, 32))
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=16))
    dk.dequant_matmul_ordered.launches = 0
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dk.dequant_matmul_ordered.launches
    steps = sched.steps
    tokens = sum(len(r.output) for r in done.values())
    if sorted(done) != [0, 1, 2, 3] or any(
            len(r.output) != 16 or not all(0 <= t < cfg.vocab_size
                                           for t in r.output)
            for r in done.values()):
        raise AssertionError(f"requests incomplete: "
                             f"{ {k: r.output for k, r in done.items()} }")
    if launches != LAUNCHES_PER_STEP * steps:
        raise AssertionError(f"kernel launches {launches} != "
                             f"{LAUNCHES_PER_STEP} x {steps} decode steps")
    peak = torch.cuda.max_memory_allocated()
    out = {"init_s": init_s, "run_s": dt, "tokens": tokens,
           "tokens_per_s": tokens / dt, "decode_steps": steps,
           "launches": launches, "ms_per_step": dt / steps * 1e3,
           "peak_bytes": peak,
           "first_ids": {k: r.output[:4] for k, r in sorted(done.items())}}
    line("serve", f"qwen3-4b 36L d2560 ff9728 vocab151936 on cuda: 4 "
                  f"requests, {tokens} tokens in {dt:.2f}s "
                  f"({tokens / dt:.1f} tok/s, {out['ms_per_step']:.1f} "
                  f"ms/step), {steps} decode steps, kernel launches "
                  f"{launches} = 108 x {steps}, init {init_s:.1f}s, "
                  f"max_memory_allocated {peak / 2**30:.2f} GiB, first ids "
                  f"{out['first_ids']}")
    return engine, out


def _greedy_trace(engine, tokens, plen, n):
    cache = engine.init_cache(tokens.shape[0])
    logits, cache = engine.prefill(tokens, cache, plen)
    trace, ids = [logits], [logits.argmax(-1)]
    pos = int(plen.max())
    for i in range(n - 1):
        logits, cache = engine.decode(cache, ids[-1], pos + i)
        trace.append(logits)
        ids.append(logits.argmax(-1))
    return torch.stack(ids, 1), torch.stack(trace, 1)


def phase_trace(engine) -> dict:
    """Device time of full-width decode steps (4 slots, cache half full)
    by kernel, from ``torch.profiler``, against the same steps' wall
    time measured without the profiler: the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    cache = engine.init_cache(4)
    tokens = torch.arange(4, device="cuda")
    pos = torch.full((4,), 24, device="cuda")
    steps = 3

    def run():
        for i in range(steps):
            engine.decode(cache, tokens, pos + i)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}      # kernels only: host ops also report device time
    events = 0        # device kernels and copies launched
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / steps)
            events += e.count
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
           "busy_share": device_ms / wall_ms,
           "device_events_per_step": events / steps,
           "top_kernels_ms_per_step": dict(top)}
    line("trace", f"decode step {wall_ms:.1f} ms wall (no profiler), "
                  f"{device_ms:.2f} ms of kernels -> device busy "
                  f"{100 * device_ms / wall_ms:.1f}%; "
                  f"{events / steps:.0f} device kernels/copies per step; "
                  f"top kernels ms/step: "
                  + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top))
    return out


def phase_crosscheck(engine, cfg):
    other = Engine(model=engine.model, params=engine.params,
                   device=engine.device, max_seq=engine.max_seq,
                   policy=engine.policy.with_(backend="torch"))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))).cuda()
    plen = torch.tensor([12, 9], device="cuda")
    ids_c, lg_c = _greedy_trace(engine, toks, plen, 8)
    ids_t, lg_t = _greedy_trace(other, toks, plen, 8)
    gap = (lg_c - lg_t).abs().max().item()
    scale = lg_t.abs().max().item()
    agree = bool(torch.equal(ids_c, ids_t))
    text = (f"greedy 2 prompts x 8 tokens, cuda vs torch backend: max logit "
            f"gap {gap:.3g} (max|logit| {scale:.3g}), ids agree: {agree}")
    out = {"max_logit_gap": gap, "max_logit": scale, "ids_agree": agree,
           "ids_cuda": ids_c.tolist(), "ids_torch": ids_t.tolist()}
    if not agree:
        row, step = (ids_c != ids_t).nonzero()[0].tolist()
        top2 = lg_t[row, step].topk(2).values
        margin = (top2[0] - top2[1]).item()
        text += f"; first divergence row {row} step {step}, top-2 margin " \
                f"{margin:.3g}"
        out.update(divergent_step=step, top2_margin=margin)
        if margin > gap:
            raise AssertionError(f"backends disagree beyond a near tie: "
                                 f"{text}")
    if not gap <= 5e-2 * scale:
        raise AssertionError(f"backend logit gap too large: {text}")
    line("crosscheck", text)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_device()
    build = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, checks = phase_check(gen)
    timing = phase_timing(gen)
    cfg = get_config("qwen3-4b").with_quant(mode="mlp", scheme="tp-aware",
                                            backend="auto")
    engine, serve = phase_serve(cfg)
    trace = phase_trace(engine)
    cross = phase_crosscheck(engine, cfg)

    u, d = timing[UP[0]], timing[DOWN[0]]
    # one layer's three launches at M=4: up, gate (same shape) and down
    kernel = {
        "name": "dequant_matmul_ordered", "route": "cuda",
        "source": "src/repro_torch/csrc/dequant_matmul_ordered.cu",
        "replaces": "src/repro/kernels/dequant_matmul.py:104",
        "launches": serve["launches"], "max_abs_err": worst,
        "ms": 2 * u["ms"] + d["ms"],
        "plain_ms": 2 * u["plain_ms"] + d["plain_ms"],
        "bound_ms": 2 * u["bound_ms"] + d["bound_ms"],
        "bound_by": "bytes" if u["bound_by"] == d["bound_by"] == "bytes"
        else "operations",
        "library_ms": None,
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build": build, "check": checks,
                   "timing": timing, "serve": serve, "trace": trace,
                   "crosscheck": cross,
                   "kernel": kernel,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": [kernel]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
