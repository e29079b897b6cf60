"""AdamW with a cosine schedule and global-norm clipping; port of
``repro/train/optimizer.py``.

The state is a plain tree ``{"m", "v", "step"}``: ``m`` and ``v`` are
float32 trees shaped like the params (and split as they are,
``state_specs``), ``step`` an int32 scalar.  The arithmetic is the
reference's, in its order and in float32: the bias corrections
``1 - b ** step``, weight decay on every leaf.

What differs is the idiom.  ``apply_updates`` updates each leaf's
``p``, ``m`` and ``v`` in place, and applies the clip scale to a leaf's
gradient inside that leaf's update: XLA fuses the reference's
clip-as-a-tree-map into the update, but eager torch would allocate a
second gradient tree (17.6 GB for qwen3-4b at full width).  A leaf with
no gradient (``grad is None``) is updated as with a zero gradient, which
is what JAX's grad gives it; a zero-size leaf passes through.  Nothing
is read back to the host: the schedule's scalars stay tensors on the
params' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.train.checkpoint import flatten_keys, map_tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr`` (float32,
    on ``step``'s device)."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(params: Any) -> dict:
    """Zero ``m`` and ``v`` (float32, on each param's device), step 0."""
    some = next(iter(flatten_keys(params).values()))
    return {"m": map_tensors(params, lambda _, p: torch.zeros_like(
                p, dtype=torch.float32)),
            "v": map_tensors(params, lambda _, p: torch.zeros_like(
                p, dtype=torch.float32)),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def state_specs(param_specs: Any) -> dict:
    """The state's TP specs: ``m`` and ``v`` split as the params, ``step``
    replicated (None)."""
    return {"m": param_specs, "v": param_specs, "step": None}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32; leaves that
    are None (no gradient) count as zeros."""
    leaves = [t for t in flatten_keys(tree).values() if t is not None]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: dict) -> tuple[Any, dict, torch.Tensor]:
    """One AdamW step, in place: each leaf of ``params``, ``state["m"]``
    and ``state["v"]`` is updated where it lies, and ``state["step"]``
    advances.  ``grads`` is a tree like ``params`` (a leaf may be None);
    with clipping, its float32 leaves are scaled in place.  Returns
    ``(params, state, norm)``: the same two objects, and the gradients'
    ``global_norm`` before the clip (the train step's ``grad_norm``)."""
    step = state["step"] + 1
    b1, b2 = cfg.betas
    gn = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    flat_g = flatten_keys(grads)
    flat_m = flatten_keys(state["m"])
    flat_v = flatten_keys(state["v"])
    for key, p in flatten_keys(params).items():
        if p.numel() == 0:
            continue
        m, v = flat_m[key], flat_v[key]
        g = flat_g.get(key)
        if g is None:
            g = torch.zeros_like(m)
        else:
            g = g.to(torch.float32)
            if scale is not None:
                g.mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        step_dir = (m / bc1).div_(denom)
        del denom
        p32 = p.to(torch.float32)           # p itself when float32
        step_dir.add_(p32 * cfg.weight_decay)
        p32.sub_(step_dir.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
    state["step"] = step
    return params, state, gn
