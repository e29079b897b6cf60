"""Dense decoder-only transformer (pre-norm GQA attention + optionally
quantized MLP); port of ``repro/models/transformer.py``.

Layers are a list of per-layer dicts driven by a Python loop (the
reference stacks them and runs ``lax.scan``).  ``group`` is the process
group of the TP ranks (None: one device); under TP ``params`` are this
rank's slices (``param_specs``) and the cache holds this rank's KV heads.

``aux``: an artifact's aux plans; the attention V->O folds at
``ATTN_VO_PATH`` (stacked over the layers, as the artifact holds them,
or a per-layer list, as the engine keeps them) run each layer's V and
output projection (``models/common.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import common as cm
from repro_torch.train.checkpoint import map_tensors

#: the pair path of every layer's MLP (the key a per-layer
#: ``CollectivePlan`` resolves), as the reference's layer body passes it
MLP_PATH = "layers.mlp"

#: this family consumes attention V->O folds (the registry forwards
#: ``aux`` only to modules that say so)
SUPPORTS_ATTN_VO = True

#: the dotted path ``stage_fold_attention`` records this family's
#: attention dicts under (the key into the aux tree's ``attn_plans``)
ATTN_VO_PATH = "layers.attn"


#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout)
LAYER_STACKS = {"layers": 1}


def layer_folds(aux, path: str, dims: tuple) -> list:
    """The V->O folds at ``path`` of the aux tree's ``attn_plans`` as
    nested per-layer lists of shape ``dims`` (``(L,)``, or ``(ns, nself)``
    for a two-level stack), None at every layer without one: a fold
    stacked over the layers (as the artifact holds it) is split into
    per-layer views; a list is taken as it is."""
    def nones(dims):
        return [None if len(dims) == 1 else nones(dims[1:])
                for _ in range(dims[0])]

    def split(vo, dims):
        if isinstance(vo, list):
            out = vo
        else:
            out = [map_tensors(vo, lambda _, t, i=i: t[i])
                   for i in range(vo.up.qweight.shape[0])]
        if len(out) != dims[0]:
            raise ValueError(f"the V->O fold at {path} has {len(out)} "
                             f"layers, the model {dims[0]}")
        return out if len(dims) == 1 else [split(v, dims[1:]) for v in out]

    vo = ((aux or {}).get("attn_plans") or {}).get(path)
    return nones(dims) if vo is None else split(vo, dims)


def _layer_vo(aux, num_layers: int) -> list:
    """One V->O fold (or None) for each of the ``num_layers`` layers."""
    return layer_folds(aux, ATTN_VO_PATH, (num_layers,))


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None):
    """Random params on ``gen.device``.  ``stage(key, node)`` (the plan
    compiler: quantize and lay out each layer, then keep one rank's
    slices) is applied to the embedding, each layer and the final norm as
    soon as each exists, so only one layer's raw or unsharded weights are
    alive at a time."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    embed = stage("embed", cm.embed_params(cfg, gen))
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(stage("layers", {
            "ln1": cm.norm_params(cfg, dev),
            "attn": cm.attention_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "mlp": cm.mlp_params(cfg, gen)}))
    return {"embed": embed, "layers": layers,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int):
    """TP specs of one top-level piece (``"embed"``, one of ``"layers"``,
    ``"final_norm"``): per leaf the dim split over the ranks, or None."""
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key == "layers":
        return {"ln1": cm.norm_specs(node["ln1"]),
                "attn": cm.attention_specs(cfg, node["attn"], tp),
                "ln2": cm.norm_specs(node["ln2"]),
                "mlp": cm.mlp_specs(node["mlp"])}
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split."""
    return {"embed": piece_specs(cfg, "embed", params["embed"], tp),
            "layers": [piece_specs(cfg, "layers", lp, tp)
                       for lp in params["layers"]],
            "final_norm": piece_specs(cfg, "final_norm",
                                      params["final_norm"], tp)}


def _mlp_residual(cfg, lp, x, h, policy, group, path=MLP_PATH):
    """``x + h`` then the MLP block's residual (bf16 + f32 promotes to f32
    in both frameworks; the caller casts back to the carry's dtype, as
    the reference's scan does).  ``path``: the MLP's pair path."""
    y = x + h
    return y + cm.mlp_forward(cfg, lp["mlp"],
                              cm.apply_norm(cfg, lp["ln2"], y), policy,
                              group=group, path=path)


def layer_forward(cfg: ModelConfig, lp, x, policy: ExecutionPolicy, *,
                  window=None, attn_backend="xla", group=None, vo=None,
                  path=MLP_PATH):
    """One layer of the forward (the reference's scan body, ``_layer``):
    attention (through the V->O fold ``vo`` when given), then the MLP
    block (pair path ``path``), each on the pre-normed residual; the
    result before its cast to the carry's dtype."""
    h = cm.attention_forward(cfg, lp["attn"], cm.apply_norm(cfg, lp["ln1"], x),
                             window=window, causal=cfg.causal,
                             attn_backend=attn_backend, group=group, vo=vo,
                             policy=policy)
    return _mlp_residual(cfg, lp, x, h, policy, group, path)


def layer_decode(cfg: ModelConfig, lp, x, layer_cache, pos,
                 policy: ExecutionPolicy, *, window=None, group=None,
                 pages=None, kv_len=None, vo=None, path=MLP_PATH):
    """One layer of the decode step: attention over ``layer_cache`` (this
    layer's dense rows or page pool, written in place), then the MLP
    block (pair path ``path``); the result before its cast to the
    carry's dtype."""
    h, _ = cm.attention_decode(cfg, lp["attn"],
                               cm.apply_norm(cfg, lp["ln1"], x), layer_cache,
                               pos, window=window, group=group, pages=pages,
                               kv_len=kv_len, vo=vo, policy=policy)
    return _mlp_residual(cfg, lp, x, h, policy, group, path)


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            aux=None) -> torch.Tensor:
    """Train/prefill forward: batch={"tokens": (B, S)} -> logits.
    ``attn_backend``: ``"xla"`` (einsum) or ``"flash"`` (the kernel)."""
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"], group=group)
    vos = _layer_vo(aux, len(params["layers"]))
    for lp, vo in zip(params["layers"], vos):
        x = layer_forward(cfg, lp, x, policy, window=window,
                          attn_backend=attn_backend, group=group,
                          vo=vo).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None, tp: int = 1) -> dict:
    return cm.init_kv_cache(cfg, cfg.num_layers, batch, seq_len,
                            window=window, dtype=dtype, device=device, tp=tp)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     bits=None, dtype=torch.bfloat16, device=None,
                     tp: int = 1) -> dict:
    """The page pool for all layers, ``n_pages`` pages."""
    return cm.init_paged_kv_cache(cfg, cfg.num_layers, n_pages, page_size,
                                  bits=bits, dtype=dtype, device=device,
                                  tp=tp)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None, group=None,
                pages=None, kv_len=None, aux=None):
    """One-token decode. tokens: (B,), pos: int or (B,) -> (logits (B, V),
    cache); the cache is updated in place.  With ``pages`` (B, Pmax) the
    cache is the page pool, sliced per layer as the dense cache is, and
    ``kv_len`` the positions attention reads (``attention_decode``)."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    vos = _layer_vo(aux, len(params["layers"]))
    for i, (lp, vo) in enumerate(zip(params["layers"], vos)):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = layer_decode(cfg, lp, x, layer_cache, pos, policy,
                         window=window, group=group, pages=pages,
                         kv_len=kv_len, vo=vo).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
