"""Offline plan compiler; port of ``repro/plan/compiler.py``
(``stage_quantize``, ``stage_layout``, ``stage_fold_attention``,
``compile_params``, ``_pair_group_sizes``, ``shard_params``,
``stage_shard``, ``compile_plan``, ``prepare``).

The stages walk a raw param tree and replace every MLP weight dict
(``{"w_up", "w_down"[, "w_gate"]}``) first by a scheme-agnostic
``PairBundle``, then by a ``PlannedPair`` in the deployment scheme.
With ``cfg.quant.attn_tp_aware``, ``stage_fold_attention`` plans every
attention's V->O pair with the head-block-constrained fold
(``core/attention_fold.py``) into the artifact's aux tree, stacked over
the layers as the reference's aux holds them.  ``autotune=True`` runs
the collective tuner (``plan/tuner.py``) over the planned pairs and
folds and writes its per-layer ``CollectivePlan`` into the policy.
``stage_shard`` then keeps one TP rank's slices, as the model's
``param_specs`` name them; the aux tree stays whole (each rank takes its
heads of it at load, ``runtime/serve.py``).  ``Model.init`` runs the
quantize and layout stages one layer (and one MoE expert) at a time, so
neither the raw f32 MLP weights nor the unsharded plan of all layers
ever sit in memory together.  ``compile_plan`` takes that plan, folds
attention from its (unquantized) attention weights, shards it for every
rank and freezes the result as a ``DeploymentArtifact``; ``prepare``
does so from a seed, and its rank ``r`` is ``Model.init(seed, tp=tp,
rank=r)`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention_fold, reorder
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import choose_group_size
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PairBundle, PlannedPair
from repro_torch.device import (DeviceLike, derive_seed, new_generator,
                                resolve_device)
from repro_torch.dist.topology import MeshPlan
from repro_torch.train.checkpoint import flatten_keys, map_tensors

#: seed part separating the quantization stream from the init stream
PLAN_RNG_STREAM = 0x504C414E  # "PLAN"

#: seed part of the attention fold's stream, disjoint from the MLP
#: quantize stage's (the reference offsets its fold_in counter by it)
ATTN_FOLD_STREAM = 0x41545400


def plan_generator(seed: int, device=None) -> torch.Generator:
    """The generator of the act-order processing orders for ``seed``:
    with the init generator ``new_generator(seed)``, the definition of
    "the same seed" that makes ``prepare`` equal ``Model.init``."""
    return new_generator(derive_seed(seed, PLAN_RNG_STREAM), device)


def fold_generator(seed: int, device=None) -> torch.Generator:
    """The generator of the attention folds' importance and V orders."""
    return new_generator(
        derive_seed(seed, PLAN_RNG_STREAM, ATTN_FOLD_STREAM), device)


def tune_generator(seed: int, device=None) -> torch.Generator:
    """The generator of the collective tuner's calibration rows."""
    from repro_torch.plan.tuner import TUNE_RNG_STREAM

    return new_generator(
        derive_seed(seed, PLAN_RNG_STREAM, TUNE_RNG_STREAM), device)


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
    on the CPU); ``scheme`` defaults to ``cfg.quant.scheme``.  The MLP
    dict of a layer stack of length 0 (recurrentgemma below 3 layers)
    becomes a ``PlannedPair`` of ``(0, ...)`` leaves with a pair's
    shapes."""
    gen = generator if generator is not None else new_generator(0)
    scheme = scheme or cfg.quant.scheme

    def empty_stack(node: dict):
        # a layer stack of length 0 ((0, ...) leaves, which keep a layer's
        # shapes): a pair of ones of those shapes planned with a generator
        # of its own, stacked 0 deep
        one = {k: torch.ones(t.shape[1:], dtype=t.dtype, device=t.device)
               for k, t in node.items()}
        plan = compile_params(cfg, one, generator=new_generator(
            0, node["w_up"].device), scheme=scheme)
        return map_tensors(plan, lambda _, t: t.new_empty(
            (0,) + tuple(t.shape)))

    raw_params = _walk(raw_params, empty_stack,
                       lambda n: _is_mlp_dict(n) and n["w_up"].dim() > 2
                       and n["w_up"].shape[0] == 0)
    bundles = stage_quantize(cfg, raw_params, gen)
    return stage_layout(bundles, scheme)


# ---------------------------------------------------------------------------
# the attention V->O fold
# ---------------------------------------------------------------------------

def _is_attn_dict(node: Any) -> bool:
    return isinstance(node, dict) and "wv" in node and "wo" in node


def stage_fold_attention(cfg: ModelConfig, params: Any,
                         generator: torch.Generator) -> Optional[dict]:
    """The head-block-constrained V->O folds of every attention dict
    (``{"wv", "wo", ...}``, unquantized in a raw tree and in a plan), when
    ``cfg.quant.attn_tp_aware`` is set (else None): ``{dotted path:
    PlannedPair}``, the layers' pairs stacked along the leading dims of
    their layer stacks (``{"layers.attn": pair of (L, ...) leaves}``;
    the vision model's ``super.self.attn`` over ``(n_super, n_self)``),
    the reference's aux tree.  The paths come in the tree's walk order
    (whisper: ``enc_layers.attn``, ``dec_layers.attn``,
    ``dec_layers.xattn``), and the folds path by path, layer by layer;
    each draws its row importance and V's processing order from
    ``generator``, over the padded head grid."""
    from repro_torch import interop
    from repro_torch.models.common import head_grid

    if not cfg.quant.attn_tp_aware:
        return None
    kvp, _, hp = head_grid(cfg)
    hd = cfg.head_dim
    gs = choose_group_size(hd, cfg.quant.group_size)

    def collect(node, path: tuple) -> dict:
        """{dotted path: the attention dict, or nested lists of them}"""
        if _is_attn_dict(node):
            return {".".join(path): node}
        found: dict = {}
        if isinstance(node, dict):
            for k, v in node.items():
                found.update(collect(v, path + (k,)))
        elif isinstance(node, list) and node:
            items = [collect(v, path) for v in node]
            found = {key: [it[key] for it in items] for key in items[0]}
        return found

    def fold(node):
        if isinstance(node, list):
            return interop.stack_layers([fold(v) for v in node])
        return attention_fold.plan_attention_vo(
            node["wv"], node["wo"], n_heads=hp, n_kv_heads=kvp,
            head_dim=hd, group_size=gs, generator=generator)

    return {key: fold(node)
            for key, node in collect(params, ()).items()} or None


# ---------------------------------------------------------------------------
# TP pre-shard
# ---------------------------------------------------------------------------

def _slice_leaf(t: torch.Tensor, dim: Optional[int], tp: int, rank: int,
                key: str) -> torch.Tensor:
    """Rank ``rank``'s 1/tp slice of ``t`` along ``dim``; the whole leaf
    when ``dim`` is None (replicated) or ``tp`` is 1.

    The reference keeps a leaf whose dim does not divide ``tp`` whole in
    an artifact (recorded null), for its loader to put back together.  A
    port rank runs on its own slices, and the TP forward sums every
    sharded leaf's partials over the ranks, so such a leaf raises here,
    and ``DeploymentArtifact.validate`` refuses one in an artifact."""
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"leaf {key!r}: dim {dim} of size {t.shape[dim]} "
                         f"does not split over tp={tp} ranks")
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def stage_shard(node: Any, specs: Any, tp: int, rank: int, *,
                leaf_shards: Optional[dict] = None, key: str = "") -> Any:
    """Rank ``rank``'s slices of the planned (sub)tree ``node``.

    ``specs`` mirrors ``node`` (the model's ``param_specs``): at each
    tensor leaf the dim sharded over the TP ranks, or None.  A sharded
    dim that does not divide ``tp`` raises; ``leaf_shards`` (when given)
    records the dim each leaf was sliced along, or None, under its
    ``||``-joined key path.  ``PlannedPair`` leaves slice exactly as
    ``core/reorder.shard_pair`` does."""
    def sub(n, sp, k):
        return stage_shard(n, sp, tp, rank, leaf_shards=leaf_shards,
                           key=f"{key}||{k}" if key else str(k))

    if node is None:
        return None
    if torch.is_tensor(node):
        if leaf_shards is not None:
            leaf_shards[key] = specs
        return _slice_leaf(node, specs, tp, rank, key)
    if isinstance(node, dict):
        return {k: sub(v, specs[k], k) for k, v in node.items()}
    if isinstance(node, list):
        return [sub(v, sp, i) for i, (v, sp) in enumerate(zip(node, specs))]
    if isinstance(node, (PlannedPair, QuantizedLinear)):
        return dataclasses.replace(node, **{
            f.name: sub(getattr(node, f.name), getattr(specs, f.name), f.name)
            for f in dataclasses.fields(node)
            if f.name not in ("group_size", "kind", "scheme")})
    raise TypeError(f"cannot shard a {type(node).__name__} at {key!r}")


def shard_params(cfg: ModelConfig, params: Any,
                 tp: int) -> tuple[list, dict]:
    """Pre-split a planned tree into ``tp`` per-rank trees, driven by the
    model's ``param_specs``.  Returns ``(rank_trees, {leaf key: sliced dim
    | None})``."""
    from repro_torch.models.registry import build_model

    specs = build_model(cfg).param_specs(params, tp)
    leaf_shards: dict = {}
    trees = [stage_shard(params, specs, tp, r,
                         leaf_shards=leaf_shards if r == 0 else None)
             for r in range(tp)]
    return trees, leaf_shards


# ---------------------------------------------------------------------------
# the whole offline compile
# ---------------------------------------------------------------------------

def pair_meta(params: Any) -> list:
    """The manifest's record of every MLP pair of a plan (unsharded), as
    the reference writes it: one entry per pair path, the layer list and
    an MoE layer's experts (``(E, ...)`` leaves) counted as its stack
    (``[L, E]``)."""
    meta = []

    def walk(node, path, stacked):
        if isinstance(node, PlannedPair):
            meta.append({
                "path": ".".join(path),
                "stacked": stacked + list(node.up.qweight.shape[:-2]),
                "k1": node.k1, "n1": node.n1, "n2": node.n2,
                "gate": node.gate is not None,
                "group_size_up": node.up.group_size,
                "group_size_down": node.down.group_size,
                "scheme": node.scheme})
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), stacked)
        elif isinstance(node, list) and node:
            walk(node[0], path, stacked + [len(node)])

    walk(params, (), [])
    return meta


def compile_plan(cfg: ModelConfig, params: Any, *, tp: int,
                 policy: ExecutionPolicy,
                 seed: Optional[int] = None,
                 extra_manifest: Optional[dict] = None,
                 autotune: bool = False,
                 tune_budget: Optional[float] = None,
                 tune_overlap: bool = False):
    """A plan (``Model.init``'s unsharded tree, in ``policy``'s scheme)
    -> ``DeploymentArtifact``: fold attention (``cfg.quant.attn_tp_aware``),
    tune the collectives (``autotune``: max relative error
    ``tune_budget``, the tuner's default when None; ``tune_overlap``
    marks the quantized pair choices ``:overlap``), then pre-shard for
    ``tp`` ranks, and freeze with the manifest.  ``policy`` is recorded
    (with the tuned plan); the fold and tuner streams come from ``seed``
    (0 when None) on the params' device, and ``seed`` is also recorded
    as provenance."""
    from repro_torch.plan import tuner
    from repro_torch.plan.artifact import DeploymentArtifact

    dev = next(iter(flatten_keys(params).values())).device
    base = 0 if seed is None else seed
    meta = pair_meta(params)
    attn_plans = stage_fold_attention(cfg, params, fold_generator(base, dev))
    report = ()
    if autotune:
        kw = {} if tune_budget is None else {"budget": tune_budget}
        kw["overlap"] = tune_overlap
        policy, report = tuner.autotune_collectives(
            cfg, params, meta, policy, tp, attn_plans=attn_plans,
            generator=tune_generator(base, dev), **kw)
    trees, leaf_shards = shard_params(cfg, params, tp)
    return DeploymentArtifact.from_state(
        cfg=cfg, policy=policy, tp=tp, rank_params=trees,
        leaf_shards=leaf_shards, pair_meta=meta, seed=seed,
        extra=extra_manifest, tuner_report=report,
        aux=None if attn_plans is None else {"attn_plans": attn_plans})


def prepare(cfg: ModelConfig, *, tp: int, seed: int = 0,
            policy: Optional[ExecutionPolicy] = None,
            extra_manifest: Optional[dict] = None,
            device: DeviceLike = None,
            autotune: bool = False,
            tune_budget: Optional[float] = None,
            tune_overlap: bool = False):
    """Seed -> artifact, on ``device`` (default: the CUDA card).  The plan
    is ``Model.init``'s (one layer, and one MoE expert, of raw weights
    alive at a time), so rank ``r`` of the result equals
    ``Model.init(seed, tp=tp, rank=r)`` on the same device bit for bit.
    ``policy`` defaults to the config's for ``device`` and ``tp`` ranks;
    ``autotune``, ``tune_budget`` and ``tune_overlap`` as in
    ``compile_plan``."""
    from repro_torch.models.registry import build_model

    dev = resolve_device(device)
    if policy is None:
        policy = ExecutionPolicy.from_config(cfg, device=dev).with_(
            mesh=MeshPlan(tp=tp))
    params = build_model(cfg.with_quant(scheme=policy.scheme)).init(
        seed, device=dev)
    return compile_plan(cfg, params, tp=tp, policy=policy, seed=seed,
                        extra_manifest=extra_manifest, autotune=autotune,
                        tune_budget=tune_budget, tune_overlap=tune_overlap)
