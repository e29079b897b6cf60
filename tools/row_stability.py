#!/usr/bin/env python3
"""Which library ops of the decode step give a row other bits when the
batch around it changes, on one CUDA card.

    python3 tools/row_stability.py

At qwen3-4b's full-width decode shapes (and the MoE routers'), each op
runs on the first M rows of one random input for M in ``MS``; a row is
stable when every M gives it the bits of the same row computed alone
(M=1).  The ops: the head, the attention projections and the MoE
routers (float32 ``torch.matmul``), the RMS norm over d_model (bf16
and float32 in; its bf16 output hides the reduction's order) and over a
head, decode attention at two cache lengths (the per-head form with
repeated KV heads, ``models/common._sdpa``, and the grouped form the
decode step runs, ``_sdpa_decode``), and the router's softmax.  Each op
runs twice: as called, and through ``models/common.row_stable``, which
runs row counts up to ``ROW_STABLE_MAX`` in blocks of exactly
``row_block()`` rows (``ROW_BLOCK`` here).  Then times (CUDA events,
medians of 50 calls) at M 1, 4, 8 and 16 of the head, plain and through
``row_stable`` at blocks of 4, 8 and 16 rows, and of decode attention at
T 49 and 1024 (the old form against the grouped one through
``row_stable``); the decode step of full-width qwen3-4b op by op, 4 rows
against row 0 alone (``step_ops``: the first op whose row 0 differs);
the captured decode step of full-width qwen3-4b at batches 1, 4, 8 and
16, plain (no ``row_stable``) and at blocks of 4, 8 and 16 rows
(``Engine.row_block``; ``step_times``: CUDA events over replays, medians
of ``ROUNDS`` rounds); and the card's name and power limit.  Writes
``chiprun_out/row_stability.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

MS = (1, 2, 3, 4, 8, 16)
BLOCKS = (4, 8, 16)
#: batches of ``step_times``, and its rounds of ``STEPS`` replays each
BATCHES = (1, 4, 8, 16)
ROUNDS, STEPS = 7, 10


def ops(gen) -> dict:
    """name -> (fn of row-aligned inputs, its inputs at MS[-1] rows)."""
    cfg = get_config("qwen3-4b")
    d, hd = cfg.d_model, cfg.head_dim
    m = MS[-1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    head = rnd(d, cfg.vocab_size) * d ** -0.5
    w = {"wq": rnd(d, 32 * hd), "wk": rnd(d, 8 * hd), "wo": rnd(32 * hd, d)}
    routers = {"router qwen3-moe": rnd(4096, 128),
               "router arctic": rnd(7168, 128)}
    out = {"head 2560x151936": (lambda x: x @ head, (rnd(m, d),))}
    for k, wk in w.items():
        out[f"{k} {tuple(wk.shape)}"] = (lambda x, wk=wk: x @ wk,
                                         (rnd(m, wk.shape[0]),))
    for k, wr in routers.items():
        out[k] = (lambda x, wr=wr: x @ wr, (rnd(m, wr.shape[0]),))
    for dt in (torch.bfloat16, torch.float32):
        out[f"rms norm d=2560 ({str(dt)[6:]} in)"] = (
            lambda x: cm._norm(cfg, {"scale": torch.ones(d, device="cuda")},
                               x), (rnd(m, 1, d).to(dt),))
    out["head norm 128"] = (
        lambda x: cm.rms_head_norm(x, torch.ones(hd, device="cuda"),
                                   cfg.norm_eps), (rnd(m, 1, 32, hd),))
    for t in (49, 1024):
        args = (rnd(m, 1, 32, hd), rnd(m, t, 8, hd).bfloat16(),
                rnd(m, t, 8, hd).bfloat16(),
                torch.ones(m, 1, t, dtype=torch.bool, device="cuda"))
        out[f"sdpa T={t}"] = (cm._sdpa, args)
        out[f"sdpa_decode T={t}"] = (cm._sdpa_decode, args)
    out["softmax 128"] = (lambda x: torch.softmax(x, dim=-1), (rnd(m, 128),))
    return out


def unstable_rows(fn, xs) -> dict:
    """M -> rows whose bits differ from the row computed alone."""
    solo = [fn(*(x[r:r + 1] for x in xs)) for r in range(xs[0].shape[0])]
    bad = {}
    for m in MS:
        y = fn(*(x[:m] for x in xs))
        rows = [r for r in range(m) if not torch.equal(y[r:r + 1], solo[r])]
        if rows:
            bad[m] = rows
    return bad


def timed(fn, xs, reps: int = 50) -> float:
    fn(*xs)
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*xs)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


#: the decode step's functions recorded op by op by ``step_ops``: (module,
#: name), looked up at call time by their callers
STEP_OPS = (("cm", "embed_tokens"), ("cm", "apply_norm"), ("cm", "matmul"),
            ("cm", "rms_head_norm"), ("cm", "rope"), ("cm", "_sdpa_decode"),
            ("schemes", "qmatmul"), ("schemes", "column_step"),
            ("cm", "lm_head"))


@torch.inference_mode()
def step_ops(b: int = 4) -> dict:
    """qwen3-4b at full width from seed 0: one eager decode step of ``b``
    rows and the same step of row 0 alone, every call of ``STEP_OPS``
    recorded; the first call whose row 0 differs between the two (its
    inputs' row 0 equal or not), and how many calls differ."""
    from repro_torch.core import schemes
    from repro_torch.runtime.serve import make_engine

    mods = {"cm": cm, "schemes": schemes}
    cfg = get_config("qwen3-4b").with_quant(mode="mlp", backend="auto")
    engine = make_engine(cfg, 0, device="cuda", max_seq=49)
    tokens = torch.arange(b, device="cuda") * 7 + 3
    pos = torch.full((b,), 5, device="cuda")

    def run(rows: int) -> list:
        calls = []
        real = {}
        for mod, name in STEP_OPS:
            fn = getattr(mods[mod], name)
            real[mod, name] = fn

            def rec(*a, _fn=fn, _name=name, **kw):
                y = _fn(*a, **kw)
                first = next((t for t in a if torch.is_tensor(t)), None)
                calls.append((_name, y[:1].clone(),
                              None if first is None else first[:1].clone()))
                return y

            setattr(mods[mod], name, rec)
        try:
            cache = engine.init_cache(rows)
            engine.decode_eager(cache, tokens[:rows], pos[:rows])
        finally:
            for (mod, name), fn in real.items():
                setattr(mods[mod], name, fn)
        return calls

    many, one = run(b), run(1)
    differ = [i for i, (x, y) in enumerate(zip(many, one))
              if not torch.equal(x[1], y[1])]
    out = {"calls": len(many), "differing_calls": len(differ)}
    if differ:
        i = differ[0]
        out.update(first=many[i][0], index=i,
                   inputs_equal=many[i][2] is not None and bool(
                       torch.equal(many[i][2], one[i][2])),
                   first_names=sorted({many[j][0] for j in differ}))
    return out


@torch.inference_mode()
def step_times() -> dict:
    """qwen3-4b at full width from seed 0, tp-aware: ms per captured
    decode step (``Engine.decode``'s replays, as the scheduler steps) at
    each batch of ``BATCHES``, plain and at each block of ``BLOCKS``, the
    variants in turns within each round; medians over ``ROUNDS``."""
    from repro_torch.runtime.serve import make_engine

    cfg = get_config("qwen3-4b").with_quant(mode="mlp", backend="auto")
    engine = make_engine(cfg, 0, device="cuda", max_seq=64)
    top = cm.ROW_STABLE_MAX
    variants = (None,) + BLOCKS
    out = {}
    try:
        for b in BATCHES:
            cache = engine.init_cache(b)
            tokens = torch.arange(b, device="cuda") * 7 + 3
            pos = torch.full((b,), 24, device="cuda")
            graphs = {}
            for blk in variants:          # one capture per variant
                # None: no row_stable blocks, every op as called
                cm.ROW_STABLE_MAX = 0 if blk is None else top
                engine.row_block = blk or cm.ROW_BLOCK
                engine.graphs.clear()
                for _ in range(3):
                    engine.decode(cache, tokens, pos)
                graphs[blk] = engine.graphs.pop(b)
            ms = {blk: [] for blk in variants}
            for _ in range(ROUNDS):
                for blk in variants:
                    engine.graphs[b] = graphs[blk]
                    a = torch.cuda.Event(enable_timing=True)
                    z = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(STEPS):
                        engine.decode(cache, tokens, pos)
                    z.record()
                    z.synchronize()
                    ms[blk].append(a.elapsed_time(z) / STEPS)
            for blk in variants:
                name = "plain" if blk is None else f"row_stable({blk})"
                out[f"step {name} B={b}"] = statistics.median(ms[blk])
            engine.graphs.clear()
            del graphs, cache
    finally:
        cm.ROW_STABLE_MAX = top
    return out


@torch.inference_mode()
def main() -> int:
    if not torch.cuda.is_available():
        print("row_stability: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"row_block": cm.ROW_BLOCK, "plain": {}, "row_stable": {},
              "ms": {}}
    table = ops(gen)
    for name, (fn, xs) in table.items():
        result["plain"][name] = unstable_rows(fn, xs)
        result["row_stable"][name] = unstable_rows(
            lambda *t, fn=fn: cm.row_stable(fn, *t), xs)
        print(f"{name}: plain unstable {result['plain'][name] or 'none'}; "
              f"row_stable unstable {result['row_stable'][name] or 'none'}",
              flush=True)
    fn, xs = table["head 2560x151936"]
    for m in (1, 4, 8, 16):
        rows = tuple(x[:m] for x in xs)
        result["ms"][f"head plain M={m}"] = timed(fn, rows)
        for blk in BLOCKS:
            with cm.row_blocks(blk):
                result["ms"][f"head row_stable({blk}) M={m}"] = timed(
                    lambda *t: cm.row_stable(fn, *t), rows)
    for t in (49, 1024):
        rows = tuple(x[:4] for x in table[f"sdpa T={t}"][1])
        result["ms"][f"sdpa T={t} M=4"] = timed(cm._sdpa, rows)
        for blk in BLOCKS:
            with cm.row_blocks(blk):
                result["ms"][f"sdpa_decode row_stable({blk}) T={t} M=4"] = \
                    timed(lambda *a: cm.row_stable(cm._sdpa_decode, *a),
                          rows)
    for k, v in result["ms"].items():
        print(f"{k}: {v:.4f} ms")
    result["step"] = step_ops()
    print(f"decode step, 4 rows against row 0 alone: {result['step']}")
    torch.cuda.empty_cache()
    result["step_ms"] = step_times()
    for k, v in result["step_ms"].items():
        print(f"{k}: {v:.4f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result["nvidia_smi"] = smi
    print(f"nvidia-smi: {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "row_stability.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
