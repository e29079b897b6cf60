"""Mixture-of-Experts decoder (qwen3-moe, arctic); port of
``repro/models/moe.py``.

The dense skeleton of ``models/transformer.py`` (a list of per-layer
dicts) with an MoE block in place of the MLP:
``{"ln1", "attn", "ln2", "moe": {"router", "experts"[, "dense_mlp"]}}``.
``"experts"`` is one ``PlannedPair`` whose leaves keep a leading ``E``
dim (what the reference's ``(L, E, ...)`` stack leaves per layer, and
what the artifact holds); expert ``e`` runs on the view ``leaf[e]``.
In a dense config (``quant.mode == "none"``, what training runs) it is
the raw weights' dict of ``(E, d, ff)`` / ``(E, ff, d)`` leaves, which
run as one batched product per GEMM over the experts (the reference's
``vmap`` of the dense MLP).

Token-choice top-k routing with capacity (``_capacity``, ``dispatch``):
a float32 router and softmax, ``topk`` with the gates renormalised, each
(token, slot)'s place within its expert by a cumsum over the flat
``T * k`` order, slots past the capacity dropped (``keep``), the kept
tokens written into an ``(E, cap, d)`` buffer; every expert runs its
pair over its ``cap`` rows, one dequant-GEMM launch per expert GEMM, as
the reference's ``vmap`` runs every expert; the combine gathers the
``T * k`` slots, weights them by their gates and adds slot 0, 1, ... of
each token to a zero in that order.  Every shape is fixed and nothing is
read back to the host, so the decode step can be captured in a CUDA
graph, and no add depends on an atomic's order.

Parallelism (the reference's ``moe_forward_ep``), as the engine's groups
name it:

* ``group`` (the TP ranks): each rank holds its slice of every expert's
  inner dim, runs the expert GEMMs with no per-pair epilogue and closes
  one collective per layer over the stacked ``(E, cap, d)`` partials,
  the spec ``policy.collective`` resolves at ``EXPERTS_PATH`` (``none``
  and scattering strategies fall back to ``psum``: the combine needs
  every rank's whole output; a ``:fused`` spec runs the plain ring after
  the GEMM, whose bits the wire kernel's payload equals);
* ``ep_group`` (the data ranks, expert parallelism): each process holds
  ``E / D`` experts (``keep_experts``); its tokens are dispatched with
  the capacity of its own rows, travel to the experts' owners by an
  all-to-all over the group (``(E, cap, d)`` -> ``(E/D, D*cap, d)``)
  and back.

On one device the experts run under the compute dtype of
``DEFAULT_POLICY`` and the deployment's kernel backend, as the
reference's single-device path runs them under ``REPLICATED``.
``moe_forward(return_aux=True)`` also gives the Switch-style
load-balance loss ``E * sum_e f_e * P_e`` of the layer's tokens (the
train loss does not add it, as the reference's does not).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.comm import dispatch as comm
from repro_torch.comm.spec import CollectiveSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.core import schemes
from repro_torch.core.policy import DEFAULT_POLICY, ExecutionPolicy
from repro_torch.core.reorder import PlannedPair
from repro_torch.models import common as cm
from repro_torch.train.checkpoint import flatten_keys, map_tensors

#: dotted pair paths, as the plan compiler's manifest entries name them
#: (the keys a per-layer ``CollectivePlan`` resolves these epilogues by)
EXPERTS_PATH = "layers.moe.experts"
DENSE_MLP_PATH = "layers.moe.dense_mlp"

#: the key ``init_params`` stages each expert's raw weights under
EXPERT_KEY = "experts"

#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout); the
#: experts' ``E`` dim stays a dim of their leaves
LAYER_STACKS = {"layers": 1}


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts)
    return max(4, min(tokens, c))


# ---------------------------------------------------------------------------
# params and specs
# ---------------------------------------------------------------------------

def _expert_range(cfg: ModelConfig, ep: int, ep_rank: int) -> range:
    """Data rank ``ep_rank``'s experts of ``ep``: a contiguous ``E / ep``."""
    e = cfg.num_experts
    if e % ep:
        raise ValueError(f"{cfg.arch_id}: {e} experts do not split over "
                         f"{ep} data ranks")
    return range(ep_rank * (e // ep), (ep_rank + 1) * (e // ep))


def _init_experts(cfg: ModelConfig, gen: torch.Generator, stage,
                  mine: range):
    """The layer's experts ``mine`` as one tree of ``(len(mine), ...)``
    leaves: each expert's raw weights are drawn and staged (quantized and
    laid out, then sliced for this TP rank) before the next is drawn, so
    one expert's raw weights are alive at a time.  Every expert is drawn
    and staged, in order, so the kept ones are the whole init's."""
    stacked, leaves = None, None
    for e in range(cfg.num_experts):
        one = stage(EXPERT_KEY, cm.mlp_params(cfg, gen, d_ff=cfg.moe_dff))
        if e not in mine:
            continue
        if stacked is None:
            stacked = map_tensors(one, lambda _, t: t.new_empty(
                (len(mine),) + tuple(t.shape)))
            leaves = flatten_keys(stacked)
        for key, t in flatten_keys(one).items():
            leaves[key][e - mine.start].copy_(t)
    return stacked


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None,
                ep: int = 1, ep_rank: int = 0):
    """Random params on ``gen.device``.  ``stage(key, node)`` (the plan
    compiler) is applied to the embedding, to each expert's raw weights
    as they are drawn (``EXPERT_KEY``), to the rest of each layer and to
    the final norm, so one layer's other raw weights, or one expert's,
    are alive at a time.  The draws (and the plan's) run in the order of
    the reference's tree: attention, router, experts 0..E-1, dense MLP.
    With ``ep > 1`` only data rank ``ep_rank``'s experts are kept
    (``keep_experts``'s cut, without the whole stack ever made)."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    mine = _expert_range(cfg, ep, ep_rank)
    embed = stage("embed", cm.embed_params(cfg, gen))
    layers = []
    for _ in range(cfg.num_layers):
        layer = {"ln1": cm.norm_params(cfg, dev),
                 "attn": cm.attention_params(cfg, gen),
                 "ln2": cm.norm_params(cfg, dev)}
        router = cm.dense_init(gen, (cfg.d_model, cfg.num_experts))
        experts = _init_experts(cfg, gen, stage, mine)
        moe = {"router": router}
        if cfg.dense_residual:
            moe["dense_mlp"] = cm.mlp_params(cfg, gen, d_ff=cfg.d_ff)
        layer = stage("layers", dict(layer, moe=moe))
        block = layer["moe"]
        layer["moe"] = {"router": block["router"], "experts": experts}
        if cfg.dense_residual:
            layer["moe"]["dense_mlp"] = block["dense_mlp"]
        layers.append(layer)
    return {"embed": embed, "layers": layers,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int):
    """TP specs of one piece: ``"embed"``, one of ``"layers"`` (with or
    without its experts), one expert's pair (``EXPERT_KEY``), or
    ``"final_norm"``.  The experts keep their leading ``E`` dim whole and
    split their inner dims as one pair's do."""
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key == EXPERT_KEY:
        return cm.mlp_specs(node)
    if key == "layers":
        moe = node["moe"]
        specs = {"router": None}
        if "experts" in moe:
            specs["experts"] = cm.mlp_specs(moe["experts"], lead=1)
        if "dense_mlp" in moe:
            specs["dense_mlp"] = cm.mlp_specs(moe["dense_mlp"])
        return {"ln1": cm.norm_specs(node["ln1"]),
                "attn": cm.attention_specs(cfg, node["attn"], tp),
                "ln2": cm.norm_specs(node["ln2"]),
                "moe": {k: specs[k] for k in moe}}
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split."""
    return {"embed": piece_specs(cfg, "embed", params["embed"], tp),
            "layers": [piece_specs(cfg, "layers", lp, tp)
                       for lp in params["layers"]],
            "final_norm": piece_specs(cfg, "final_norm",
                                      params["final_norm"], tp)}


def keep_experts(cfg: ModelConfig, params, ep: int, ep_rank: int):
    """``params`` with only data rank ``ep_rank``'s ``E / ep`` experts of
    each layer (contiguous copies; the others are dropped)."""
    mine = _expert_range(cfg, ep, ep_rank)
    layers = []
    for lp in params["layers"]:
        kept = map_tensors(lp["moe"]["experts"],
                           lambda _, t: t[mine.start:mine.stop].clone())
        layers.append(dict(lp, moe=dict(lp["moe"], experts=kept)))
    return dict(params, layers=layers)


def expert_bytes(params) -> int:
    """Bytes of every layer's expert leaves."""
    return sum(t.nbytes for lp in params["layers"]
               for t in flatten_keys(lp["moe"]["experts"]).values())


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def load_balance_loss(cfg: ModelConfig, probs: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Switch-style ``E * sum_e f_e * P_e``: ``f_e`` the share of the
    ``T * k`` slots routed to expert ``e``, ``P_e`` its mean probability."""
    e = cfg.num_experts
    frac = torch.nn.functional.one_hot(idx, e).to(torch.float32).mean(
        dim=(0, 1))
    return e * torch.sum(frac * probs.mean(dim=0))


def dispatch(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
             cap: int):
    """Token-choice top-k dispatch of the tokens ``xt`` (T, d): the
    ``(E, cap, d)`` buffer of each expert's tokens (zero rows past its
    count), the routing ``(idx (T, k), gate (T, k), pos (T*k,),
    keep (T*k,))`` the combine reads (the reference's ``_dispatch_local``),
    and the router's probabilities (T, E) the load-balance loss reads."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    scores = cm.matmul(xt.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(scores, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    flat_e = idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=xt.device)).to(
        torch.int32)
    pos = (onehot.cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    flat_tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    # dropped slots go to a spare row past the capacity, cut off after
    buf = xt.new_zeros((e, cap + 1, d))
    buf[flat_e, torch.where(keep, pos, cap)] = xt[flat_tok]
    return buf[:, :cap], (idx, gate, pos, keep), probs


def combine(out: torch.Tensor, routing, dtype) -> torch.Tensor:
    """The experts' outputs ``out`` (E, cap, d) back to the tokens: each
    (token, slot)'s row weighted by its gate (0 when dropped), the
    ``k`` slots of a token added to a zero in slot order."""
    idx, gate, pos, keep = routing
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    slots = out[flat_e, torch.where(keep, pos, 0)]
    w = (gate.reshape(-1) * keep).to(dtype)[:, None]
    slots = (slots.to(dtype) * w).reshape(t, k, -1)
    y = torch.zeros_like(slots[:, 0])
    for j in range(k):
        y = y + slots[:, j]
    return y


def expert_views(experts: PlannedPair) -> list:
    """Expert ``e``'s pair as views ``leaf[e]`` of the stacked leaves,
    made once for each stacked pair and kept on it (every MoE layer of
    every eager step asks for them)."""
    views = experts.__dict__.get("_expert_views")
    if views is None:
        n = experts.up.qweight.shape[0]
        views = [map_tensors(experts, lambda _, t, e=e: t[e])
                 for e in range(n)]
        # a cache beside the frozen dataclass's fields, not one of them
        object.__setattr__(experts, "_expert_views", views)
    return views


def experts_forward(cfg: ModelConfig, experts, xs, policy, *,
                    group=None) -> torch.Tensor:
    """``xs`` (E_local, C, d) through this process's experts, one pair
    each, every GEMM one kernel launch: (E_local, C, d).  With the TP
    ``group``, one collective closes the stacked partials.  Raw experts
    (a dense config's dict of stacked weights) run one batched product
    per GEMM (one device only: ``moe_forward`` refuses a group)."""
    if not isinstance(experts, PlannedPair):
        return cm.mlp_forward(cfg, experts, xs, policy)
    views = expert_views(experts)
    act = cfg.activation
    if group is None:
        return torch.stack([pp.forward(xs[e], policy, activation=act)
                            for e, pp in enumerate(views)])
    # each expert's column step (its P1 gather, up and the gated
    # product) over its rows: (E, C, N1 / tp)
    y1 = torch.stack([schemes.column_step(xs[e], pp, policy, act)
                      for e, pp in enumerate(views)])
    if views[0].scheme == "exllama":
        # Algorithm 2 per expert: gather Y1, keep the local P2 chunk
        y1 = comm.all_gather_cols(y1, group)
        y1 = torch.stack([y1[e].index_select(-1, pp.p2)
                          for e, pp in enumerate(views)])
    y = torch.stack([schemes.qmatmul(y1[e], pp.down, policy)
                     for e, pp in enumerate(views)])
    spec = policy.collective.resolve(EXPERTS_PATH)
    if spec.name == "none" or comm.scatters_output(spec):
        spec = CollectiveSpec(name="psum")
    return comm.apply(y, group, spec, policy)


def moe_forward(cfg: ModelConfig, p, x, policy: ExecutionPolicy, *,
                group=None, ep_group=None, return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d): the MoE block (and arctic's dense
    residual MLP beside it); with ``return_aux``, ``(y, aux)``, ``aux``
    the load-balance loss of these tokens."""
    if (group is not None or ep_group is not None) and not isinstance(
            p["experts"], PlannedPair):
        raise ValueError(
            "the raw (quant.mode='none') experts run on one device only "
            "(ROADMAP.md queue 1, item 11)")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    buf, routing, probs = dispatch(cfg, xt, p["router"],
                                   _capacity(cfg, b * s))
    if group is None and ep_group is None:
        out = experts_forward(cfg, p["experts"], buf, policy.with_(
            compute_dtype=DEFAULT_POLICY.compute_dtype))
    else:
        # (E, cap, d) -> (E/D, D*cap, d): tokens travel to their experts
        buf = comm.all_to_all(buf, ep_group, split_axis=0, concat_axis=1)
        out = experts_forward(cfg, p["experts"], buf, policy, group=group)
        # (E/D, D*cap, d) -> (E, cap, d): results travel home
        out = comm.all_to_all(out, ep_group, split_axis=1, concat_axis=0)
    y = combine(out.to(x.dtype), routing, x.dtype).reshape(b, s, d)
    if cfg.dense_residual:
        y = y + cm.mlp_forward(cfg, p["dense_mlp"], x, policy, group=group,
                               path=DENSE_MLP_PATH)
    if return_aux:
        return y, load_balance_loss(cfg, probs, routing[0])
    return y


# ---------------------------------------------------------------------------
# full model: the dense skeleton with MoE blocks as the MLP
# ---------------------------------------------------------------------------

def _moe_residual(cfg, lp, x, h, policy, group, ep_group):
    """``x + h`` then the MoE block's residual, before the cast to the
    carry's dtype (as ``transformer._mlp_residual``)."""
    y = x + h
    return y + moe_forward(cfg, lp["moe"], cm.apply_norm(cfg, lp["ln2"], y),
                           policy, group=group, ep_group=ep_group)


def layer_forward(cfg: ModelConfig, lp, x, policy: ExecutionPolicy, *,
                  window=None, attn_backend="xla", group=None,
                  ep_group=None, vo=None):
    """One layer of the forward (the reference's scan body), before the
    cast to the carry's dtype.  ``vo``: this family consumes no attention
    V->O fold (the reference's MoE attention takes none); None only."""
    if vo is not None:
        raise ValueError("the MoE family consumes no attention V->O fold")
    h = cm.attention_forward(cfg, lp["attn"], cm.apply_norm(cfg, lp["ln1"], x),
                             window=window, causal=cfg.causal,
                             attn_backend=attn_backend, group=group,
                             policy=policy)
    return _moe_residual(cfg, lp, x, h, policy, group, ep_group)


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            ep_group=None) -> torch.Tensor:
    """Train/prefill forward: batch={"tokens": (B, S)} -> logits."""
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"], group=group)
    for lp in params["layers"]:
        x = layer_forward(cfg, lp, x, policy, window=window,
                          attn_backend=attn_backend, group=group,
                          ep_group=ep_group).to(x.dtype)
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
                pages=None, kv_len=None, ep_group=None):
    """One-token decode, as ``transformer.decode_step``: tokens (B,), pos
    int or (B,) -> (logits (B, V), cache updated in place)."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    for i, lp in enumerate(params["layers"]):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        h, _ = cm.attention_decode(cfg, lp["attn"],
                                   cm.apply_norm(cfg, lp["ln1"], x),
                                   layer_cache, pos, window=window,
                                   group=group, pages=pages, kv_len=kv_len,
                                   policy=policy)
        x = _moe_residual(cfg, lp, x, h, policy, group, ep_group).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
