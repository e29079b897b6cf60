"""Training entry point; port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --steps 100 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 8 --batch 2 --seq 128          # full width, on the card

The dense model (``quant.mode="none"``, float32 params, the config's
carry dtype) from ``--seed``, AdamW with the reference's schedule
(warmup ``steps // 20``), the synthetic stream (or ``--data``, a uint16
token file); the audio and vision families get zero bf16 frames /
patches, as the reference feeds them.  It prints the reference's
``step ... loss ... gnorm ... lr ... (s/step)`` lines, then the steps'
times and the memory: the param count, the state's reckoned bytes (16
a param: params, gradients, AdamW's float32 ``m`` and ``v``) and, on
the card, ``torch.cuda.max_memory_allocated``; and the launches of the
port's counted kernels, none on this path.  ``--ckpt PREFIX``
saves the params as ``PREFIX_stepNNNNNNNN.npz`` in the reference's
layout (layers stacked), which ``repro.train.checkpoint`` reads.

Runs on the CUDA card unless ``--device cpu``; without a card it exits
with an error naming the missing card.  ``--tp`` above 1 exits 1: the
port trains at tp=1 only.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint, data as data_lib, optimizer as opt
from repro_torch.train import trainstep

#: the ROADMAP line that records what training at tp > 1 needs
TP_ROADMAP = ("ROADMAP.md queue 1, item 11: training at tp > 1, autograd "
              "through the port's rank-process collectives")

#: bytes of train state a param: float32 params, gradients, m and v
STATE_BYTES_PER_PARAM = 16


def stubs(cfg, batch: int, device) -> dict:
    """The audio and vision families' zero bf16 frames / patches."""
    if cfg.family == "audio":
        return {"frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)}
    if cfg.family == "vlm":
        return {"patches": torch.zeros(
            (batch, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)}
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size (the port trains at 1 only)")
    ap.add_argument("--data", default=None, help="token file (uint16)")
    ap.add_argument("--ckpt", default=None, help="checkpoint path prefix")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise SystemExit(f"error: --tp {args.tp}: the port trains at tp=1 "
                         f"only ({TP_ROADMAP})")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).with_quant(mode="none")
    model = build_model(cfg)
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 1))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = trainstep.init_train_state(model, args.seed, device=device)
    step_fn = trainstep.make_train_step(model, ocfg)
    dcfg = data_lib.DataConfig(seq_len=args.seq, global_batch=args.batch,
                               vocab_size=cfg.vocab_size, seed=args.seed,
                               path=args.data)
    batches = data_lib.batches(dcfg, device=device)

    times, data_times = [], []
    t0 = time.time()
    for i in range(args.steps):
        t_step = time.perf_counter()
        batch = next(batches)
        batch.update(stubs(cfg, args.batch, device))
        data_times.append(time.perf_counter() - t_step)
        state, metrics = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t_step)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {i:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)

    rest = slice(1, None) if len(times) > 1 else slice(None)
    steady = statistics.median(times[rest])
    print(f"steps: first {times[0]:.4f} s, median of the rest {steady:.4f} "
          f"s/step ({statistics.median(data_times[rest]):.4f} s of it the "
          f"batch), {args.batch * args.seq / steady:.1f} tokens/s "
          f"(batch {args.batch} x seq {args.seq}) on {device}")
    n = sum(t.numel() for t in checkpoint.flatten_keys(
        state["params"]).values())
    peak = (f"{torch.cuda.max_memory_allocated(device)} B "
            f"max_memory_allocated ({torch.cuda.max_memory_reserved(device)} "
            f"B reserved)" if cuda else "peak not measured on cpu")
    print(f"memory: param_count {cfg.param_count()} ({n} param elements), "
          f"{STATE_BYTES_PER_PARAM * cfg.param_count()} B of train state "
          f"reckoned at {STATE_BYTES_PER_PARAM} B a param, {peak}")
    print(f"kernel launches: {sum(ops.launch_counts())} (the port's counted "
          f"CUDA kernels; the dense model's path runs none)")

    if args.ckpt:
        params = checkpoint.map_tensors(state["params"],
                                        lambda _, t: t.detach().cpu())
        path = checkpoint.save(args.ckpt, interop.to_reference_layout(params),
                               step=int(metrics["step"]))
        print("saved", path)


if __name__ == "__main__":
    main()
