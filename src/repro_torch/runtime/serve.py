"""Serving engine: prefill and decode steps over a registry model; port of
``repro/runtime/serve.py`` (``Engine``, ``make_engine`` without an
artifact).

Prefill replays the prompt through the decode step, exactly as the
reference does, so prompt and generation share one numeric path.
``prefill_logits`` is the full-sequence forward (the reference's
``prefill_logits``), whose attention ``attn_backend`` picks.  Batching
across requests is the scheduler's job (``runtime/scheduler.py``).

Under tensor parallelism every rank runs its own ``Engine`` over its
slices of the params with the ranks' process group (``group``); the
logits are gathered whole on every rank, so every rank samples the same
tokens from identically seeded generators.  The policy's ``mesh`` names
the TP degree the plan was made for, and it must be the group's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.comm import dispatch as comm
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.topology import MeshPlan
from repro_torch.models.registry import Model, build_model
from repro_torch.runtime import sampling


@dataclasses.dataclass
class Engine:
    model: Model
    params: Any
    device: torch.device
    max_seq: int = 2048
    window: Optional[int] = None
    # The deployment plan every quantized GEMM runs under; None derives
    # it from the model config for ``device`` and the group's TP degree.
    policy: Optional[ExecutionPolicy] = None
    # Attention of the full-sequence forward (``prefill_logits``): "xla"
    # (einsum) or "flash" (the kernel); the reference's
    # ``ParallelContext.attn_backend``.  Decode never uses it.
    attn_backend: str = "xla"
    # The process group of the TP ranks (``launch/mesh.py``); None runs on
    # one device.  ``params`` are then this rank's slices.
    group: Any = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.policy is None:
            self.policy = ExecutionPolicy.from_config(
                self.model.cfg, device=self.device).with_(
                    mesh=MeshPlan(tp=self.tp))
        check_mesh(self.policy, self.tp)

    @property
    def tp(self) -> int:
        return comm.axis_size(self.group)

    def init_cache(self, batch: int):
        return self.model.init_cache(batch, self.max_seq, window=self.window,
                                     device=self.device, tp=self.tp)

    @torch.inference_mode()
    def prefill_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """The full-sequence forward: tokens (B, S) -> logits (B, S, V)
        (the reference's ``prefill_logits``)."""
        return self.model.forward(self.params, {"tokens": tokens},
                                  self.policy, window=self.window,
                                  attn_backend=self.attn_backend,
                                  group=self.group)

    @torch.inference_mode()
    def decode(self, cache, tokens: torch.Tensor, pos):
        """One decode step: tokens (B,), pos int or (B,) -> (logits, cache)."""
        return self.model.decode_step(self.params, cache, tokens, pos,
                                      self.policy, window=self.window,
                                      group=self.group)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache, prompt_len: torch.Tensor):
        """Replay right-padded prompts (B, S) through the decode step;
        returns (logits at each row's last prompt token (B, V), cache)."""
        b, s = tokens.shape
        last = torch.zeros((b, self.model.cfg.vocab_size),
                           dtype=torch.float32, device=self.device)
        for t in range(s):
            logits, cache = self.decode(cache, tokens[:, t], t)
            keep = (prompt_len == t + 1)[:, None]
            last = torch.where(keep, logits, last)
        return last, cache

    @torch.inference_mode()
    def generate(self, gen: Optional[torch.Generator], tokens: torch.Tensor,
                 prompt_len, *, max_new_tokens: int = 32,
                 scfg: sampling.SamplingConfig = sampling.SamplingConfig()):
        """Batched generation; returns (B, max_new_tokens) token ids.
        ``gen`` draws the samples (unused when greedy)."""
        tokens = tokens.to(self.device)
        prompt_len = torch.as_tensor(prompt_len, device=self.device)
        cache = self.init_cache(tokens.shape[0])
        logits, cache = self.prefill(tokens, cache, prompt_len)
        pos = int(prompt_len.max())
        tok = sampling.sample(gen, logits, scfg)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.decode(cache, tok, pos + i)
            tok = sampling.sample(gen, logits, scfg)
            out.append(tok)
        return torch.stack(out, dim=1)


def check_mesh(policy: ExecutionPolicy, tp: int) -> None:
    """Raise unless ``policy.mesh`` plans the ``tp`` ranks that run it."""
    if policy.mesh.tp != tp:
        raise ValueError(
            f"policy mesh {policy.mesh.shorthand()} plans tp="
            f"{policy.mesh.tp}, but {tp} rank(s) run it")


def make_engine(cfg, seed: int = 0, *, device: DeviceLike = None,
                max_seq: int = 2048, window=None,
                policy: Optional[ExecutionPolicy] = None,
                group=None) -> Engine:
    """Build an engine whose params ``Model.init`` makes from ``seed``;
    with the TP ranks' ``group``, this rank's slices of them.  Runs on the
    CUDA card unless ``device`` says otherwise.  A ``policy`` whose mesh
    does not match the group raises before any weight is made."""
    dev = resolve_device(device)
    tp = comm.axis_size(group)
    if policy is not None:
        check_mesh(policy, tp)
    model = build_model(cfg)
    params = model.init(seed, device=dev, tp=tp,
                        rank=comm.axis_index(group))
    return Engine(model=model, params=params, device=dev, max_seq=max_seq,
                  window=window, policy=policy, group=group)
