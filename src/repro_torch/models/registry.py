"""Model registry (the dense, MoE, audio, vision and recurrent families);
port of ``repro/models/registry.py``.

The recurrent families (``hybrid``: recurrentgemma, ``ssm``: rwkv6) keep
a fixed-size decode state per slot: they have no paged cache, and their
decode step accepts a page table and ignores it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import DeviceLike, new_generator, resolve_device
from repro_torch.models import (moe, rglru, rwkv6, transformer,
                                vision_llama, whisper)

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "hybrid": rglru,
                   "ssm": rwkv6, "audio": whisper, "vlm": vision_llama}


def layer_stacks() -> dict:
    """Every family's stacked layer prefixes (``LAYER_STACKS``: dotted
    path -> leading dims stacked there in the reference's tree), as one
    map.  Families may share a prefix (``super``: the vision model's and
    recurrentgemma's superblocks) if they stack the same number of dims
    there; a prefix stacked at two depths raises, as one map could not
    convert both trees."""
    out: dict = {}
    for mod in _FAMILY_MODULES.values():
        for path, depth in getattr(mod, "LAYER_STACKS", {}).items():
            if out.setdefault(path, depth) != depth:
                raise ValueError(
                    f"layer stack {path!r} is {out[path]} dims deep in one "
                    f"family and {depth} in {mod.__name__}")
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    """Bound (cfg, family module) pair with the uniform interface."""

    cfg: ModelConfig
    module: Any

    def init(self, seed: int = 0, *, device: DeviceLike = None,
             tp: int = 1, rank: int = 0, ep: int = 1,
             ep_rank: int = 0) -> Any:
        """Raw init from ``seed``, then, for quantized configs, the plan
        compiler (RTN quantize + layout), one layer (and one MoE expert)
        at a time; with ``tp > 1`` only rank ``rank``'s slices of each
        piece are kept (every rank draws the same whole weights from
        ``seed``), and with ``ep > 1`` (``supports_experts``) only data
        rank ``ep_rank``'s ``1 / ep`` of each layer's experts, as
        ``keep_experts`` cuts them.  Runs on the CUDA card unless
        ``device`` says otherwise."""
        from repro_torch.plan import compiler

        dev = resolve_device(device)
        gen = new_generator(seed, dev)
        plan_gen = compiler.plan_generator(seed, dev)
        quantized = self.cfg.quant.mode == "mlp"

        def stage(key, node):
            if quantized and key not in ("embed", "final_norm"):
                node = compiler.compile_params(self.cfg, node,
                                               generator=plan_gen)
            if tp > 1:
                specs = self.module.piece_specs(self.cfg, key, node, tp)
                node = compiler.stage_shard(node, specs, tp, rank)
            return node

        kw = {} if ep == 1 else {"ep": ep, "ep_rank": ep_rank}
        return self.module.init_params(self.cfg, gen, stage=stage, **kw)

    def init_raw(self, seed: int = 0, *, device: DeviceLike = None) -> Any:
        """The raw fp params (no quantization): the compiler's input."""
        return self.module.init_params(
            self.cfg, new_generator(seed, resolve_device(device)))

    def param_specs(self, params, tp: int):
        """Per leaf, the dim split over ``tp`` ranks (None: replicated)."""
        return self.module.param_specs(self.cfg, params, tp)

    @property
    def supports_attn_vo(self) -> bool:
        """The family's attention consumes V->O folds from ``aux``."""
        return bool(getattr(self.module, "SUPPORTS_ATTN_VO", False))

    @property
    def attn_vo_path(self) -> Optional[str]:
        """Where the family's folds sit in the aux tree's ``attn_plans``."""
        return getattr(self.module, "ATTN_VO_PATH", None)

    @property
    def attn_vo_waived(self) -> dict:
        """Folds the plan compiler makes for this family that its runtime
        does not consume, with the reason (``ATTN_VO_WAIVED``): an
        artifact may carry them, and the engine leaves them unused."""
        return dict(getattr(self.module, "ATTN_VO_WAIVED", {}))

    @property
    def has_cross(self) -> bool:
        """The decoder attends to a source that prefill writes into the
        cache (whisper's encoder states, the vision patches):
        ``prefill_cross`` runs before the prompt replay."""
        return hasattr(self.module, "prefill_cross")

    def prefill_cross(self, params, batch: dict, cache,
                      policy: ExecutionPolicy, *, attn_backend="xla",
                      group=None) -> None:
        """Fill ``cache``'s cross K/V from ``batch`` (its ``"frames"`` or
        ``"patches"``) in place."""
        need = "frames" if self.cfg.family == "audio" else "patches"
        if need not in batch:
            raise ValueError(f"family {self.cfg.family!r} needs "
                             f"batch[{need!r}] beside the tokens")
        self.module.prefill_cross(self.cfg, params, batch, cache, policy,
                                  attn_backend=attn_backend, group=group)

    def make_batch(self, gen: torch.Generator, batch: int, seq_len: int,
                   *, dtype=torch.bfloat16) -> dict:
        """A random batch on ``gen.device``: ``"tokens"`` (B, S) and, for
        the audio and vision families, the stubs' ``"frames"`` (B,
        encoder_seq, d) or ``"patches"`` (B, vision_tokens, d) in
        ``dtype``, the reference's ``make_batch`` shapes."""
        cfg, dev = self.cfg, gen.device
        out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                       generator=gen, device=dev)}
        if cfg.family == "audio":
            out["frames"] = torch.randn(
                (batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                device=dev).to(dtype)
        if cfg.family == "vlm":
            out["patches"] = torch.randn(
                (batch, cfg.vision_tokens, cfg.d_model), generator=gen,
                device=dev).to(dtype)
        return out

    @property
    def supports_experts(self) -> bool:
        """The family's layers hold MoE experts, which a data group can
        spread over its processes (expert parallelism, ``ep_group``)."""
        return hasattr(self.module, "keep_experts")

    def keep_experts(self, params, ep: int, ep_rank: int):
        """``params`` with data rank ``ep_rank``'s ``1 / ep`` of each
        layer's experts only."""
        return self.module.keep_experts(self.cfg, params, ep, ep_rank)

    def expert_bytes(self, params) -> int:
        return self.module.expert_bytes(params)

    @staticmethod
    def _ep(ep_group) -> dict:
        return {} if ep_group is None else {"ep_group": ep_group}

    def _aux(self, aux) -> dict:
        if aux is None:
            return {}
        if not self.supports_attn_vo:
            raise ValueError(f"family {self.cfg.family!r} has no V->O fold "
                             f"integration; it cannot serve aux plans")
        return {"aux": aux}

    def forward(self, params, batch, policy: ExecutionPolicy, *,
                window=None, attn_backend="xla", group=None, aux=None,
                ep_group=None):
        """``aux``: an artifact's aux plans (attention V->O folds), for
        families that declare ``SUPPORTS_ATTN_VO``; ``ep_group``: the data
        ranks the experts are spread over (``supports_experts``)."""
        return self.module.forward(self.cfg, params, batch, policy,
                                   window=window, attn_backend=attn_backend,
                                   group=group, **self._aux(aux),
                                   **self._ep(ep_group))

    def init_cache(self, batch: int, seq_len: int, *, window=None,
                   dtype=torch.bfloat16, device: DeviceLike = None,
                   tp: int = 1):
        return self.module.init_cache(self.cfg, batch, seq_len, window=window,
                                      dtype=dtype,
                                      device=resolve_device(device), tp=tp)

    def init_paged_cache(self, n_pages: int, page_size: int, *,
                         bits=None, dtype=torch.bfloat16,
                         device: DeviceLike = None, tp: int = 1,
                         batch: Optional[int] = None):
        """A page pool in place of ``init_cache``'s dense rows, for the
        families whose KV grows with the sequence; ``batch``: the slots
        of the dense cross K/V beside it (the audio and vision
        families)."""
        if not self.supports_paged:
            raise ValueError(
                f"family {self.cfg.family!r} has no paged cache (its decode "
                "state is fixed-size per slot)")
        kw = {} if batch is None else {"batch": batch}
        return self.module.init_paged_cache(
            self.cfg, n_pages, page_size, bits=bits, dtype=dtype,
            device=resolve_device(device), tp=tp, **kw)

    @property
    def supports_paged(self) -> bool:
        return hasattr(self.module, "init_paged_cache")

    def decode_step(self, params, cache, tokens, pos,
                    policy: ExecutionPolicy, *, window=None, group=None,
                    pages=None, kv_len=None, aux=None, ep_group=None):
        return self.module.decode_step(self.cfg, params, cache, tokens, pos,
                                       policy, window=window, group=group,
                                       pages=pages, kv_len=kv_len,
                                       **self._aux(aux),
                                       **self._ep(ep_group))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown family {cfg.family!r}; known: "
                       f"{sorted(_FAMILY_MODULES)}")
    return Model(cfg=cfg, module=_FAMILY_MODULES[cfg.family])
