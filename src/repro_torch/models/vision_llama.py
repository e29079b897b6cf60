"""Llama-3.2-Vision backbone, a decoder with gated cross-attention image
layers every ``cross_attn_every`` layers; port of
``repro/models/vision_llama.py``.

The ViT/SigLIP vision encoder and its projector are a stub, as in the
reference: ``batch["patches"]`` carries precomputed patch embeddings
(B, vision_tokens, d_model).

Structure: ``n_super = L / cross_attn_every`` superblocks, each
``cross_attn_every - 1`` self layers (``transformer.layer_forward`` and
``layer_decode``) followed by one cross layer whose attention and MLP
residuals are gated by ``tanh(gate_attn)`` and ``tanh(gate_mlp)``.  The
params hold ``super`` as a list of ``{"self": [layers], "cross": layer}``;
the reference stacks ``super`` along one leading dim and ``super.self``
along two, ``(n_super, n_self)`` (``LAYER_STACKS``).  The cache is
``{"self": {"k", "v": (n_super, n_self, B, C, KV, D)} (or a page pool
with those leading dims), "cross_k", "cross_v": (n_super, B,
vision_tokens, KV, D)}``, the cross K/V written once at prefill by
``precompute_cross`` in place.

The gates start at 0, as the reference's: tanh(0) = 0, so with freshly
drawn params the cross layers add nothing (tests set them nonzero).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

#: this family consumes attention V->O folds for its self layers (the
#: registry forwards ``aux`` only to modules that say so)
SUPPORTS_ATTN_VO = True

#: the dotted path ``stage_fold_attention`` records the (n_super,
#: n_self) self-attention folds under
ATTN_VO_PATH = "super.self.attn"

#: folds the plan compiler produces but this runtime does not consume,
#: with the reason (the reference's)
ATTN_VO_WAIVED = {
    "super.cross.xattn": (
        "cross-attention K/V is precomputed from raw wv at prefill "
        "(precompute_cross); a folded V would disagree with the cached "
        "values"),
}

#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout)
LAYER_STACKS = {"super": 1, "super.self": 2}

#: the pair paths of the self layers' and the cross layers' MLPs
SELF_MLP_PATH = "super.self.mlp"
CROSS_MLP_PATH = "super.cross.mlp"

#: the ``init_params`` stage keys of a self layer and a cross layer
SELF_KEY = "super.self"
CROSS_KEY = "super.cross"


def _n_super(cfg: ModelConfig) -> tuple[int, int]:
    """(superblocks, self layers in each)."""
    if cfg.num_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.arch_id}: {cfg.num_layers} layers are not "
                         f"whole superblocks of {cfg.cross_attn_every}")
    return cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _self_vo(aux, cfg: ModelConfig) -> list:
    """The (n_super, n_self) nested lists of V->O folds (or None)."""
    return tfm.layer_folds(aux, ATTN_VO_PATH, _n_super(cfg))


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None):
    """Random params on ``gen.device``; the gates start at 0.
    ``stage(key, node)`` (the plan compiler) is applied to the embedding,
    each self layer (``SELF_KEY``), each cross layer (``CROSS_KEY``) and
    the final norm as soon as each exists, so one layer's raw weights are
    alive at a time."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    ns, nself = _n_super(cfg)
    embed = stage("embed", cm.embed_params(cfg, gen))
    sup = []
    for _ in range(ns):
        selfs = [stage(SELF_KEY, {"ln1": cm.norm_params(cfg, dev),
                                  "attn": cm.attention_params(cfg, gen),
                                  "ln2": cm.norm_params(cfg, dev),
                                  "mlp": cm.mlp_params(cfg, gen)})
                 for _ in range(nself)]
        cross = stage(CROSS_KEY, {
            "ln1": cm.norm_params(cfg, dev),
            "xattn": cm.attention_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "mlp": cm.mlp_params(cfg, gen),
            "gate_attn": torch.zeros((), device=dev),
            "gate_mlp": torch.zeros((), device=dev)})
        sup.append({"self": selfs, "cross": cross})
    return {"embed": embed, "super": sup,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int):
    """TP specs of one piece: ``"embed"``, a self layer (``SELF_KEY``), a
    cross layer (``CROSS_KEY``; its gates replicated) or the final
    norm."""
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key in (SELF_KEY, CROSS_KEY):
        cm.require_whole_kv(cfg, tp)
        return {k: (cm.attention_specs(cfg, v, tp) if k in ("attn", "xattn")
                    else cm.mlp_specs(v) if k == "mlp"
                    else None if k.startswith("gate_")
                    else cm.norm_specs(v)) for k, v in node.items()}
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split."""
    return {"embed": piece_specs(cfg, "embed", params["embed"], tp),
            "super": [{"self": [piece_specs(cfg, SELF_KEY, lp, tp)
                                for lp in sp["self"]],
                       "cross": piece_specs(cfg, CROSS_KEY, sp["cross"], tp)}
                      for sp in params["super"]],
            "final_norm": piece_specs(cfg, "final_norm",
                                      params["final_norm"], tp)}


def cross_layer_forward(cfg: ModelConfig, cp, x, patches,
                        policy: ExecutionPolicy, *, group=None):
    """The gated cross layer of the forward (the reference's
    ``_cross_layer_fwd``): cross-attention over ``patches``, then the
    MLP, each on the pre-normed residual and scaled by the tanh of its
    gate; the result before its cast to the carry's dtype."""
    h = cm.attention_forward(cfg, cp["xattn"],
                             cm.apply_norm(cfg, cp["ln1"], x), kv_x=patches,
                             group=group, policy=policy)
    y = x + torch.tanh(cp["gate_attn"]) * h
    h = cm.mlp_forward(cfg, cp["mlp"], cm.apply_norm(cfg, cp["ln2"], y),
                       policy, group=group, path=CROSS_MLP_PATH)
    return y + torch.tanh(cp["gate_mlp"]) * h


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            aux=None) -> torch.Tensor:
    """batch: {"tokens": (B, S), "patches": (B, vision_tokens, d)} ->
    logits.  ``attn_backend`` picks the self layers' attention;
    cross-attention stays on the einsum path."""
    patches = batch["patches"]
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"], group=group)
    for sp, vos in zip(params["super"], _self_vo(aux, cfg)):
        for lp, vo in zip(sp["self"], vos):
            x = tfm.layer_forward(cfg, lp, x, policy, window=window,
                                  attn_backend=attn_backend, group=group,
                                  vo=vo, path=SELF_MLP_PATH).to(x.dtype)
        x = cross_layer_forward(cfg, sp["cross"], x, patches, policy,
                                group=group).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)


def _cross_cache(cfg: ModelConfig, batch: int, dtype, device, tp: int):
    kvp, _, _ = cm.head_grid(cfg)
    shape = (_n_super(cfg)[0], batch, cfg.vision_tokens, kvp // tp,
             cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None, tp: int = 1) -> dict:
    """The self layers' rows with ``(n_super, n_self)`` leading dims and
    every superblock's cross K/V (this rank's KV heads)."""
    ns, nself = _n_super(cfg)
    kvp, _, _ = cm.head_grid(cfg)
    cap = min(seq_len, window) if window else seq_len
    shape = (ns, nself, batch, cap, kvp // tp, cfg.head_dim)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)},
            **_cross_cache(cfg, batch, dtype, device, tp)}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     batch: int, bits=None, dtype=torch.bfloat16,
                     device=None, tp: int = 1) -> dict:
    """A page pool with ``(n_super, n_self)`` leading dims for the self
    layers; the cross K/V stay dense (the vision prefix is fixed per
    slot)."""
    from repro_torch.cache import paged as paged_pool

    kvp, _, _ = cm.head_grid(cfg)
    return {"self": paged_pool.init_pool(_n_super(cfg), n_pages, page_size,
                                         kvp // tp, cfg.head_dim,
                                         dtype=dtype, bits=bits,
                                         device=device),
            **_cross_cache(cfg, batch, dtype, device, tp)}


def precompute_cross(cfg: ModelConfig, params, patches: torch.Tensor,
                     cache) -> tuple[torch.Tensor, torch.Tensor]:
    """Write every superblock's cross K and V of ``patches`` (B,
    vision_tokens, d) into ``cache["cross_k"]`` and ``cache["cross_v"]``
    in place, cast to the cache's dtype; returns the two.  Under TP
    ``wk``/``wv`` hold this rank's heads, as the cache does (no
    collective)."""
    b, t, _ = patches.shape
    hd = cfg.head_dim
    for s, sp in enumerate(params["super"]):
        xa = sp["cross"]["xattn"]
        kvh = xa["wk"].shape[-1] // hd
        cache["cross_k"][s].copy_(cm.matmul(patches, xa["wk"]).reshape(
            b, t, kvh, hd))
        cache["cross_v"][s].copy_(cm.matmul(patches, xa["wv"]).reshape(
            b, t, kvh, hd))
    return cache["cross_k"], cache["cross_v"]


def prefill_cross(cfg: ModelConfig, params, batch: dict, cache,
                  policy: ExecutionPolicy, *, attn_backend="xla",
                  group=None) -> None:
    """The prefill's cross-attention part (the reference engine's vlm
    branch): ``precompute_cross`` of ``batch["patches"]`` into the
    cache."""
    del policy, attn_backend, group
    precompute_cross(cfg, params, batch["patches"], cache)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None, group=None,
                pages=None, kv_len=None, aux=None):
    """One-token decode: tokens (B,), pos int or (B,) -> (logits (B, V),
    cache); the self layers' cache is written in place.  With ``pages``
    the ``"self"`` entry is the page pool (``kv_len`` as in
    ``attention_decode``)."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    for s, (sp, vos) in enumerate(zip(params["super"], _self_vo(aux, cfg))):
        for j, (lp, vo) in enumerate(zip(sp["self"], vos)):
            layer_cache = {name: leaf[s, j]
                           for name, leaf in cache["self"].items()}
            x = tfm.layer_decode(cfg, lp, x, layer_cache, pos, policy,
                                 window=window, group=group, pages=pages,
                                 kv_len=kv_len, vo=vo,
                                 path=SELF_MLP_PATH).to(x.dtype)
        cp = sp["cross"]
        h = cm.cross_attention_decode(cfg, cp["xattn"],
                                      cm.apply_norm(cfg, cp["ln1"], x),
                                      cache["cross_k"][s],
                                      cache["cross_v"][s], group=group)
        y = x + torch.tanh(cp["gate_attn"]) * h
        h = cm.mlp_forward(cfg, cp["mlp"], cm.apply_norm(cfg, cp["ln2"], y),
                           policy, group=group, path=CROSS_MLP_PATH)
        x = (y + torch.tanh(cp["gate_mlp"]) * h).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
