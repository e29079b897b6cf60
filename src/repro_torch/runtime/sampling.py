"""Token sampling: greedy / temperature / top-k / top-p; port of
``repro/runtime/sampling.py``.

Randomness comes from ``torch.Generator``s, one per row in
``sample_slots``, so a request's draws do not depend on which other
requests share the batch.  A draw is the argmax of the masked logits plus
Gumbel noise (what ``jax.random.categorical`` computes); torch's and
JAX's generators give different bits, so sampled tokens match the
reference only in distribution.  Greedy rows consume no randomness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0       # 0 -> greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None  # nucleus mass (None/1.0 -> no-op)


def _masked_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Shared mask pipeline: scale -> top-k -> top-p.  All params are
    per-row vectors (B,); ``top_k == 0`` / ``top_p == 1.0`` disable their
    mask; ``temperature <= 0`` rows are scaled by 1."""
    _, v = logits.shape
    t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / t[:, None]

    srt = torch.sort(scaled, dim=-1).values                # ascending
    k = top_k.clamp(0, v)
    # kth-largest per row; k == 0 rows are not masked, any index will do
    kth = srt.gather(-1, (v - k).clamp(0, v - 1)[:, None])
    neg_inf = torch.tensor(-float("inf"), device=logits.device)
    scaled = torch.where((k > 0)[:, None] & (scaled < kth), neg_inf, scaled)

    # top-p: keep every token whose preceding cumulative mass (descending
    # order) is < top_p; the top-1 token always survives
    probs = torch.softmax(scaled, dim=-1)
    srt_p = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(srt_p, dim=-1)
    keep = (cum - srt_p) < top_p[:, None]
    thr = torch.where(keep, srt_p,
                      torch.tensor(float("inf"), device=logits.device)
                      ).amin(dim=-1)
    return torch.where(probs < thr[:, None], neg_inf, scaled)


def _param_vectors(b: int, cfg: SamplingConfig, device):
    temperature = torch.full((b,), cfg.temperature, dtype=torch.float32,
                             device=device)
    top_p = torch.full((b,), 1.0 if cfg.top_p is None else cfg.top_p,
                       dtype=torch.float32, device=device)
    top_k = torch.full((b,), 0 if cfg.top_k is None else cfg.top_k,
                       dtype=torch.int64, device=device)
    return temperature, top_p, top_k


def _gumbel_argmax(row: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    # u in [tiny, 1), as the reference's jax.random.gumbel draws it: at
    # u = 0 the noise would be -inf, and that token could never be drawn
    u = torch.rand(row.shape, generator=gen, device=row.device).clamp_min(
        torch.finfo(torch.float32).tiny)
    return torch.argmax(row - torch.log(-torch.log(u)))


def sample(gen: Optional[torch.Generator], logits: torch.Tensor,
           cfg: SamplingConfig) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,); one generator, rows drawn in
    order.  Greedy when ``cfg.temperature <= 0``."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    masked = _masked_logits(logits, *_param_vectors(logits.shape[0], cfg,
                                                    logits.device))
    return torch.stack([_gumbel_argmax(row, gen) for row in masked])


def sample_slots(gens: Sequence[Optional[torch.Generator]],
                 logits: torch.Tensor, temperature: torch.Tensor,
                 top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling for the continuous decode loop.

    ``gens[i]`` is row i's generator, or None for a row that must not
    draw (its result is the argmax); rows with ``temperature <= 0`` are
    greedy and draw nothing either.
    """
    out = torch.argmax(logits, dim=-1)
    draw = [i for i, (g, t) in enumerate(zip(gens, temperature.tolist()))
            if g is not None and t > 0.0]
    if draw:
        masked = _masked_logits(logits, temperature, top_p, top_k)
        for i in draw:
            out[i] = _gumbel_argmax(masked[i], gens[i])
    return out
