"""Dense decoder-only transformer (pre-norm GQA attention + optionally
quantized MLP); port of ``repro/models/transformer.py``.

Layers are a list of per-layer dicts driven by a Python loop (the
reference stacks them and runs ``lax.scan``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import common as cm


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                compile_layer: Optional[Callable[[dict], dict]] = None):
    """Random params on ``gen.device``.  ``compile_layer`` (the plan
    compiler) is applied to each layer as soon as it exists, so only one
    layer's raw MLP weights are alive at a time."""
    dev = gen.device
    embed = cm.embed_params(cfg, gen)
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"ln1": cm.norm_params(cfg, dev),
                 "attn": cm.attention_params(cfg, gen),
                 "ln2": cm.norm_params(cfg, dev),
                 "mlp": cm.mlp_params(cfg, gen)}
        layers.append(compile_layer(layer) if compile_layer else layer)
    return {"embed": embed, "layers": layers,
            "final_norm": cm.norm_params(cfg, dev)}


def _mlp_residual(cfg, lp, x, h, policy):
    """``x + h`` then the MLP block's residual, cast back to x's dtype
    (the reference's scan carry keeps its dtype; bf16 + f32 promotes to
    f32 in both frameworks)."""
    y = x + h
    y = y + cm.mlp_forward(cfg, lp["mlp"], cm.apply_norm(cfg, lp["ln2"], y),
                           policy)
    return y.to(x.dtype)


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla") -> torch.Tensor:
    """Train/prefill forward: batch={"tokens": (B, S)} -> logits.
    ``attn_backend``: ``"xla"`` (einsum) or ``"flash"`` (the kernel)."""
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"])
    for lp in params["layers"]:
        h = cm.attention_forward(cfg, lp["attn"],
                                 cm.apply_norm(cfg, lp["ln1"], x),
                                 window=window, causal=cfg.causal,
                                 attn_backend=attn_backend)
        x = _mlp_residual(cfg, lp, x, h, policy)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None) -> dict:
    return cm.init_kv_cache(cfg, cfg.num_layers, batch, seq_len,
                            window=window, dtype=dtype, device=device)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None):
    """One-token decode. tokens: (B,), pos: int or (B,) -> (logits (B, V),
    cache); the cache is updated in place."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None])
    for i, lp in enumerate(params["layers"]):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = cm.attention_decode(cfg, lp["attn"],
                                   cm.apply_norm(cfg, lp["ln1"], x),
                                   layer_cache, pos, window=window)
        x = _mlp_residual(cfg, lp, x, h, policy)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x)[:, 0], cache
