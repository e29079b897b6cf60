"""Offline plan compiler, in-memory stages; port of
``repro/plan/compiler.py`` (``stage_quantize``, ``stage_layout``,
``compile_params``, ``_pair_group_sizes``).

The stages walk a raw param tree and replace every MLP weight dict
(``{"w_up", "w_down"[, "w_gate"]}``) first by a scheme-agnostic
``PairBundle``, then by a ``PlannedPair`` in the deployment scheme.
``Model.init`` runs them one layer at a time, so the raw f32 MLP weights
of all layers never sit in memory together.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import reorder
from repro_torch.core.quantization import choose_group_size
from repro_torch.core.reorder import PairBundle
from repro_torch.device import new_generator

#: seed part separating the quantization stream from the init stream
PLAN_RNG_STREAM = 0x504C414E  # "PLAN"


def _is_mlp_dict(node: Any) -> bool:
    return isinstance(node, dict) and "w_up" in node and "w_down" in node


def _walk(node: Any, fn, match) -> Any:
    """Rebuild ``node`` with ``fn`` applied to every sub-node ``match``
    accepts (dicts and lists are walked)."""
    if match(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _walk(v, fn, match) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, fn, match) for v in node]
    return node


def _pair_group_sizes(cfg: ModelConfig, w_up, w_down) -> tuple[int, int]:
    """Deployment group sizes of one pair: the down projection's group
    must tile the K shard of up to ``tp_groups`` ranks."""
    d = w_up.shape[-2]
    ff = w_down.shape[-2]
    ff_shard = (ff // cfg.quant.tp_groups if ff % cfg.quant.tp_groups == 0
                else ff)
    return (choose_group_size(d, cfg.quant.group_size),
            choose_group_size(ff_shard, cfg.quant.group_size))


def stage_quantize(cfg: ModelConfig, params: Any,
                   generator: torch.Generator) -> Any:
    """Raw fp MLP dicts -> ``PairBundle``s."""
    def quantize_one(node: dict) -> PairBundle:
        gs_up, gs_down = _pair_group_sizes(cfg, node["w_up"], node["w_down"])
        return reorder.quantize_pair(
            node["w_up"], node["w_down"], w_gate=node.get("w_gate"),
            group_size_up=gs_up, group_size_down=gs_down,
            act_order=cfg.quant.act_order, generator=generator)

    return _walk(params, quantize_one, _is_mlp_dict)


def stage_layout(params: Any, scheme: str) -> Any:
    """``PairBundle``s -> ``PlannedPair``s in ``scheme``."""
    return _walk(params, lambda b: reorder.layout_pair(b, scheme),
                 lambda n: isinstance(n, PairBundle))


def compile_params(cfg: ModelConfig, raw_params: Any, *,
                   generator: Optional[torch.Generator] = None,
                   scheme: Optional[str] = None) -> Any:
    """Raw fp params -> planned params (quantize, then lay out).

    ``generator`` draws the act-order processing orders (default: seed 0
    on the CPU); ``scheme`` defaults to ``cfg.quant.scheme``."""
    gen = generator if generator is not None else new_generator(0)
    bundles = stage_quantize(cfg, raw_params, gen)
    return stage_layout(bundles, scheme or cfg.quant.scheme)
