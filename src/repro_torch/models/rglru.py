"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks
and local (sliding-window) attention blocks at 2:1, each followed by a
GeGLU MLP; port of ``repro/models/rglru.py``.

Superblocks of (recurrent, recurrent, local attention), then
``num_layers % 3`` extra recurrent layers (26 -> 8 superblocks + 2).
The RG-LRU recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``
runs one step per decode token, and in the forward one token at a time
over the sequence (the reference's associative scan computes the same
recurrence in another sum order).  The recurrence, the depthwise causal
conv and the float32 projections are library ops, as the reference
computes them outside any kernel; the MLP pairs are the quantized pairs
(``MLP_PATHS``).  Local attention is ``cm.attention_forward`` and
``cm.attention_decode`` with ``window=cfg.local_window`` over a ring of
``min(max_seq, local_window)`` rows.  With ``attn_backend="flash"`` the
forward's local attention (10 heads of 256 over one KV head, MQA, at full
width) runs the flash kernel at head dim 256 with
``window=cfg.local_window``, as the reference's flash path does: one
launch per superblock.

Layers are lists of per-layer dicts (``super``: one dict of ``rec1``,
``rec2``, ``attn`` per superblock; ``extra``: the remaining recurrent
layers, or None when there are none), as ``LAYER_STACKS`` stacks them in
the reference.  With fewer than 3 layers there is no superblock; the
reference then holds a stack of length 0, and so does the port: a dict
of ``(0, ...)`` leaves in place of the list (``interop``), which every
loop here skips, and which keeps the pair sites' shapes for the
artifact's manifest.

The decode state of a slot is fixed-size: per recurrent layer the conv
history ``(B, conv_width - 1, W)`` and the LRU state ``(B, W)``, both
float32 as the reference's step writes them, and per superblock the
local attention's K/V ring in the cache dtype; every leaf is written in
place, so a captured step keeps its addresses.  Every library product
of a decode step runs through ``cm.row_stable``.

Under tensor parallelism (``group``) a recurrent block runs on the
rank's ``W / tp`` LRU channels (the reference's split: ``w_x``,
``w_gate`` and ``conv_w`` by columns, ``lam`` by its one dim): the conv
is depthwise and the recurrence elementwise, so they need no
collective; ``w_rgate`` and ``w_igate`` are split by rows, so the
rank's products are partial sums of the whole gates, which a
reduce-scatter sums, leaving the rank its channels; ``w_out``'s partial
sums close with a float32 all-reduce.  The per-rank state is conv
``(n, B, CW - 1, W / tp)`` and LRU ``(n, B, W / tp)``.  The local
attention (one KV head at full width) splits ``wk`` and ``wv`` by
columns, cutting the head: each rank gathers K's and V's columns and
its ring holds the whole head (``cm.kv_heads_per_rank``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.comm import dispatch as comm
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import new_generator
from repro_torch.models import common as cm
from repro_torch.train.checkpoint import map_tensors

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)

#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout)
LAYER_STACKS = {"super": 1, "extra": 1}

#: the pair paths of the MLPs, as the reference's layer bodies pass them
REC1_PATH, REC2_PATH = "super.rec1.mlp", "super.rec2.mlp"
ATTN_MLP_PATH, EXTRA_PATH = "super.attn.mlp", "extra.mlp"
MLP_PATHS = (REC1_PATH, REC2_PATH, ATTN_MLP_PATH, EXTRA_PATH)


def _n_super(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.num_layers // 3, cfg.num_layers % 3


def blocks(node) -> list:
    """The layers of a stack: the list, or none for a stack of length 0
    (a dict of ``(0, ...)`` leaves) or a missing one (None)."""
    return node if isinstance(node, list) else []


# ---------------------------------------------------------------------------
# the RG-LRU temporal block
# ---------------------------------------------------------------------------

def rec_block_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_x": cm.dense_init(gen, (d, w)),
        "w_gate": cm.dense_init(gen, (d, w)),
        "w_out": cm.dense_init(gen, (w, d)),
        "w_rgate": cm.dense_init(gen, (w, w)),
        "w_igate": cm.dense_init(gen, (w, w)),
        "lam": torch.linspace(0.9, 5.0, w, device=gen.device),
        "conv_w": cm.dense_init(gen, (cfg.conv_width, w), 0.5),
    }


def _causal_conv(h, conv_w, state=None):
    """Depthwise causal conv along the sequence.  h: (B, S, W), conv_w:
    (CW, W); ``state``: (B, CW-1, W), the previous inputs (decode).
    Returns (out, the new state)."""
    cw = conv_w.shape[0]
    if state is None:
        state = h.new_zeros((h.shape[0], cw - 1, h.shape[2]))
    dt = torch.promote_types(state.dtype, h.dtype)
    hist = torch.cat([state.to(dt), h.to(dt)], dim=1)   # (B, S+CW-1, W)
    out = torch.zeros_like(h)
    for i in range(cw):
        out = out + hist[:, i:i + h.shape[1]] * conv_w[cw - 1 - i]
    return out, hist[:, -(cw - 1):]


def _rg_lru(h, r_gate, i_gate, lam, state=None):
    """h: (B, S, W) -> (out, last state).  ``a_t = exp(-c softplus(lam)
    r_t)``; one step when S == 1 (decode), else the S steps in order."""
    r = torch.sigmoid(r_gate)
    i = torch.sigmoid(i_gate)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-_C * softplus * r)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-6)) * (i * h)
    if h.shape[1] == 1:
        s0 = state if state is not None else torch.zeros_like(h[:, 0])
        s1 = a[:, 0] * s0 + gated[:, 0]
        return s1[:, None], s1
    cur, outs = state, []
    for t in range(h.shape[1]):
        cur = gated[:, t] if cur is None else a[:, t] * cur + gated[:, t]
        outs.append(cur)
    return torch.stack(outs, dim=1), cur


def rec_block_forward(cfg: ModelConfig, p, x, state=None, group=None):
    """x: (B, S, d); ``state``: {"conv": (B, CW-1, W), "lru": (B, W)} or
    None.  Returns (y float32, the new state).  Under TP (``group``) W is
    the rank's ``W / tp`` channels: the gates' partial sums are
    reduce-scattered to them, and y closes with an all-reduce."""
    xb = cm.matmul(x, p["w_x"])
    gate = F.gelu(cm.matmul(x, p["w_gate"]), approximate="tanh")
    xb, new_conv = _causal_conv(xb, p["conv_w"],
                                None if state is None else state["conv"])
    r_gate = cm.matmul(xb, p["w_rgate"])
    i_gate = cm.matmul(xb, p["w_igate"])
    if group is not None:
        # (B, S, 2, W) partial sums -> the whole gates' (B, S, 2, W / tp)
        r_gate, i_gate = comm.raw_psum_scatter(
            torch.stack([r_gate, i_gate], dim=-2), group).unbind(-2)
    h, new_lru = _rg_lru(xb.float(), r_gate.float(), i_gate.float(),
                         p["lam"], None if state is None else state["lru"])
    h = h.to(x.dtype) * gate
    return (comm.raw_psum(cm.matmul(h, p["w_out"]), group),
            {"conv": new_conv, "lru": new_lru})


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _rec_layer_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln1": cm.norm_params(cfg, dev),
            "rec": rec_block_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "mlp": cm.mlp_params(cfg, gen)}


def _super_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"rec1": _rec_layer_params(cfg, gen),
            "rec2": _rec_layer_params(cfg, gen),
            "attn": {"ln1": cm.norm_params(cfg, dev),
                     "attn": cm.attention_params(cfg, gen),
                     "ln2": cm.norm_params(cfg, dev),
                     "mlp": cm.mlp_params(cfg, gen)}}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None):
    """Random params on ``gen.device``.  ``stage(key, node)`` (the plan
    compiler) is applied to the embedding, each superblock (``"super"``),
    each extra layer (``"extra"``) and the final norm as soon as each
    exists, so one superblock's raw weights are alive at a time.  With no
    superblock, ``super`` is a stack of length 0 whose shapes are those
    of a superblock drawn from a generator of its own."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    ns, nx = _n_super(cfg)
    embed = stage("embed", cm.embed_params(cfg, gen))
    sup = [stage("super", _super_params(cfg, gen)) for _ in range(ns)]
    extra = ([stage("extra", _rec_layer_params(cfg, gen)) for _ in range(nx)]
             if nx else None)
    if not ns:
        sup = stage("super", map_tensors(
            _super_params(cfg, new_generator(0, dev)),
            lambda _, t: t.new_empty((0,) + tuple(t.shape))))
    return {"embed": embed, "super": sup, "extra": extra,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def _lead(specs: dict, lead: int) -> dict:
    return {k: None if v is None else v + lead for k, v in specs.items()}


def _rec_layer_specs(node, lead: int) -> dict:
    rec = {"w_x": 1, "w_gate": 1, "w_out": 0, "w_rgate": 0, "w_igate": 0,
           "lam": 0, "conv_w": 1}
    return {"ln1": cm.norm_specs(node["ln1"]),
            "rec": _lead({k: rec.get(k) for k in node["rec"]}, lead),
            "ln2": cm.norm_specs(node["ln2"]),
            "mlp": cm.mlp_specs(node["mlp"], lead)}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int, lead: int = 0):
    """The reference's TP split of one piece (``"embed"``, a superblock
    ``"super"``, an ``"extra"`` layer, ``"final_norm"``): ``w_x`` and
    ``w_gate`` by columns, ``w_out``, ``w_rgate`` and ``w_igate`` by rows,
    attention (``wk`` and ``wv`` by columns within the one KV head) and
    the MLP pairs as in every family; each dim after ``lead`` stacked
    dims."""
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key == "super":
        at = node["attn"]
        return {"rec1": _rec_layer_specs(node["rec1"], lead),
                "rec2": _rec_layer_specs(node["rec2"], lead),
                "attn": {"ln1": cm.norm_specs(at["ln1"]),
                         "attn": _lead(cm.attention_specs(cfg, at["attn"],
                                                          tp), lead),
                         "ln2": cm.norm_specs(at["ln2"]),
                         "mlp": cm.mlp_specs(at["mlp"], lead)}}
    if key == "extra":
        return _rec_layer_specs(node, lead)
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split (a stack of
    length 0 split one dim further, past its stacked dim)."""
    sup = params["super"]
    return {"embed": piece_specs(cfg, "embed", params["embed"], tp),
            "super": ([piece_specs(cfg, "super", sp, tp) for sp in sup]
                      if isinstance(sup, list)
                      else piece_specs(cfg, "super", sup, tp, lead=1)),
            "extra": (None if params["extra"] is None else
                      [piece_specs(cfg, "extra", lp, tp)
                       for lp in params["extra"]]),
            "final_norm": piece_specs(cfg, "final_norm",
                                      params["final_norm"], tp)}


def rec_layer_forward(cfg: ModelConfig, lp, x, policy: ExecutionPolicy,
                      path: str, *, state=None, group=None):
    """One recurrent layer: the rec block, then the MLP (pair path
    ``path``), each on the pre-normed residual.  Returns (the result, not
    cast, and the block's new state)."""
    h, ns = rec_block_forward(cfg, lp["rec"], cm.apply_norm(cfg, lp["ln1"], x),
                              state, group=group)
    y = x + h
    return y + cm.mlp_forward(cfg, lp["mlp"], cm.apply_norm(cfg, lp["ln2"], y),
                              policy, group=group, path=path), ns


def _attn_mlp(cfg, ap, y, h, policy, group):
    y = y + h
    return y + cm.mlp_forward(cfg, ap["mlp"], cm.apply_norm(cfg, ap["ln2"], y),
                              policy, group=group, path=ATTN_MLP_PATH)


def super_forward(cfg: ModelConfig, sp, x, policy: ExecutionPolicy, *,
                  attn_backend="xla", group=None) -> torch.Tensor:
    """One superblock of the forward: rec1, rec2 (on rec1's uncast
    result, as the reference's body), the local attention and its MLP;
    the result before its cast to the carry's dtype."""
    y, _ = rec_layer_forward(cfg, sp["rec1"], x, policy, REC1_PATH,
                             group=group)
    y, _ = rec_layer_forward(cfg, sp["rec2"], y, policy, REC2_PATH,
                             group=group)
    ap = sp["attn"]
    h = cm.attention_forward(cfg, ap["attn"], cm.apply_norm(cfg, ap["ln1"], y),
                             window=cfg.local_window,
                             attn_backend=attn_backend, group=group,
                             policy=policy)
    return _attn_mlp(cfg, ap, y, h, policy, group)


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            aux=None) -> torch.Tensor:
    """batch={"tokens": (B, S)} -> logits (B, S, V).  The local attention
    takes ``cfg.local_window`` (``window`` is unused); ``attn_backend``
    picks its kernel."""
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"], group=group)
    for sp in blocks(params["super"]):
        x = super_forward(cfg, sp, x, policy, attn_backend=attn_backend,
                          group=group).to(x.dtype)
    for lp in blocks(params["extra"]):
        x = rec_layer_forward(cfg, lp, x, policy, EXTRA_PATH,
                              group=group)[0].to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)


def _rec_state(cfg: ModelConfig, n: int, batch: int, device,
               tp: int) -> dict:
    w = cfg.lru_width // tp
    return {"conv": torch.zeros((n, batch, cfg.conv_width - 1, w),
                                dtype=torch.float32, device=device),
            "lru": torch.zeros((n, batch, w), dtype=torch.float32,
                               device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None, tp: int = 1) -> dict:
    """The fixed-size decode state of ``batch`` slots: each recurrent
    layer's conv history and LRU state (this rank's ``W / tp`` channels),
    each superblock's local K/V ring of ``min(seq_len, local_window)``
    rows in ``dtype`` (the whole KV head on every rank)."""
    ns, nx = _n_super(cfg)
    return {"rec1": _rec_state(cfg, ns, batch, device, tp),
            "rec2": _rec_state(cfg, ns, batch, device, tp),
            "attn": cm.init_kv_cache(cfg, ns, batch, seq_len,
                                     window=cfg.local_window, dtype=dtype,
                                     device=device, tp=tp),
            "extra": _rec_state(cfg, nx, batch, device, tp) if nx else None}


def _layer_state(cache: dict, i: int) -> dict:
    return {"conv": cache["conv"][i], "lru": cache["lru"][i]}


def _write_state(cache: dict, i: int, new: dict) -> None:
    cache["conv"][i].copy_(new["conv"])
    cache["lru"][i].copy_(new["lru"])


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None, group=None,
                pages=None, kv_len=None, aux=None):
    """One-token decode: tokens (B,), pos int or (B,) -> (logits (B, V),
    cache), every state leaf written in place.  ``pages`` and ``kv_len``
    are accepted and unused: the recurrent state has no sequence and the
    local K/V ring is fixed-size per slot, with nothing to page."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    for i, sp in enumerate(blocks(params["super"])):
        y, n1 = rec_layer_forward(cfg, sp["rec1"], x, policy, REC1_PATH,
                                  state=_layer_state(cache["rec1"], i),
                                  group=group)
        _write_state(cache["rec1"], i, n1)
        y, n2 = rec_layer_forward(cfg, sp["rec2"], y, policy, REC2_PATH,
                                  state=_layer_state(cache["rec2"], i),
                                  group=group)
        _write_state(cache["rec2"], i, n2)
        ap = sp["attn"]
        ring = {name: leaf[i] for name, leaf in cache["attn"].items()}
        h, _ = cm.attention_decode(cfg, ap["attn"],
                                   cm.apply_norm(cfg, ap["ln1"], y), ring,
                                   pos, window=cfg.local_window, group=group,
                                   policy=policy)
        x = _attn_mlp(cfg, ap, y, h, policy, group).to(x.dtype)
    for i, lp in enumerate(blocks(params["extra"])):
        y, ns = rec_layer_forward(cfg, lp, x, policy, EXTRA_PATH,
                                  state=_layer_state(cache["extra"], i),
                                  group=group)
        _write_state(cache["extra"], i, ns)
        x = y.to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
