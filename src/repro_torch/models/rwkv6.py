"""RWKV-6 "Finch" (arXiv:2404.05892), attention-free with data-dependent
decay; port of ``repro/models/rwkv6.py``.

Each layer is a time-mix (a multi-head linear recurrence with a
per-channel data-dependent decay ``w_t`` and a bonus ``u``) and a
channel-mix.  Time-mix state per head: ``S`` (dk, dv), ``S_t = diag(w_t)
S_{t-1} + k_t v_t^T``, ``out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``,
stepped one token at a time over the sequence in the forward and once
per decode step.  The token shift is the paper's data-dependent ddlerp
with rank-32 adapters, and the decay LoRA gives ``w_t = exp(-exp(w0 +
tanh(x W_a) W_b))``.  The channel-mix is an r-gated squared-ReLU FFN
whose K->V projection pair is the quantized MLP pair (``MLP_PATH``); the
recurrence, the ddlerp, the group norm and the float32 projections are
library ops, as the reference computes them outside any kernel.

Layers are a list of per-layer dicts driven by a Python loop (the
reference stacks them, ``LAYER_STACKS``).  The decode state of a slot is
fixed-size: ``{"tm_shift": (L, B, d), "wkv": (L, B, H, dk, dv),
"cm_shift": (L, B, d)}``, written **in place** (``copy_``) by every step,
so a captured step keeps its addresses.  Its dtypes are those the
reference's step writes: the time-mix shift is the layer's normed input
(the carry's dtype), the channel-mix shift is float32 (its input follows
a float32 residual), and ``wkv`` is float32; so no stored row is rounded.

Every library product and row reduction of a decode step (the
projections, the ddlerp's LoRA product, the wkv readout, the group norm,
the head) runs through ``cm.row_stable``, so a row's bits do not depend
on its company in the batch.

Under tensor parallelism (``group``) each rank owns the heads of its
column block of ``w_r``, ``w_k``, ``w_v`` and ``w_g`` (the reference's
split): it slices the replicated decay, bonus and group-norm scale to
those columns, steps its heads' recurrence on its own (a head's state
never leaves its rank) and closes ``w_o``'s partial sums with a float32
all-reduce; the channel-mix pair runs the paper's schemes.  Its wkv
state is ``(L, B, H / tp, dk, dv)``: whole heads.  The reference's
``cache_specs`` places the state split over dk instead (40 heads do not
split 16 ways); that places state on devices and does not change the
function.  A ``tp`` that does not divide the heads raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.comm import dispatch as comm
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import common as cm

LORA_RANK = 32
MIX_NAMES = ("r", "k", "v", "g", "w")  # ddlerp targets

#: the pair path of every layer's channel-mix K->V pair
MLP_PATH = "layers.cm.pair"

#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout)
LAYER_STACKS = {"layers": 1}


def check_heads(cfg: ModelConfig, tp: int) -> None:
    """Raise unless the time-mix heads split whole over ``tp`` ranks: a
    rank's column block would otherwise cut a head, whose state and
    group norm span all its channels."""
    h = cfg.d_model // cfg.rwkv_head_dim
    if h % tp:
        raise ValueError(f"{cfg.arch_id}: {h} time-mix heads do not split "
                         f"over tp={tp} ranks")


def _shifted(prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The token shift: ``prev`` (B, d) then ``x``'s rows but its last,
    in the two's promoted dtype (as the reference's concatenate)."""
    dt = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


# ---------------------------------------------------------------------------
# time-mix
# ---------------------------------------------------------------------------

def time_mix_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, dev, n = cfg.d_model, gen.device, len(MIX_NAMES)
    return {
        "mu_x": torch.full((d,), 0.5, device=dev),
        "mu": torch.full((n, d), 0.5, device=dev),
        "maa_w1": cm.dense_init(gen, (d, n * LORA_RANK)),
        "maa_w2": cm.dense_init(gen, (n, LORA_RANK, d)),
        "w_r": cm.dense_init(gen, (d, d)),
        "w_k": cm.dense_init(gen, (d, d)),
        "w_v": cm.dense_init(gen, (d, d)),
        "w_g": cm.dense_init(gen, (d, d)),
        "w_o": cm.dense_init(gen, (d, d)),
        "decay_base": torch.linspace(-6.0, -1.0, d, device=dev),
        "decay_w1": cm.dense_init(gen, (d, LORA_RANK)),
        "decay_w2": cm.dense_init(gen, (LORA_RANK, d)),
        "bonus_u": torch.linspace(-0.5, 0.5, d, device=dev),
        "ln_scale": torch.ones(d, device=dev),
    }


def _ddlerp(p, x, xx) -> dict:
    """Data-dependent token-shift interpolation: the five mixed inputs.
    The reference's ``mu_x`` is weakly typed (``jnp.full`` of a Python
    float), so its interpolation stays in the activations' dtype (bf16
    in a bf16 model); ``mu``, added to the float32 LoRA delta first,
    widens the mixes to float32."""
    base = x + (xx - x) * p["mu_x"].to(x.dtype)
    lora = torch.tanh(cm.matmul(base, p["maa_w1"]))
    lead = lora.shape[:-1]
    lora = lora.reshape(-1, len(MIX_NAMES), LORA_RANK)
    delta = cm.row_stable(
        lambda t: torch.einsum("mnr,nrd->mnd", t, p["maa_w2"]), lora)
    delta = delta.reshape(*lead, len(MIX_NAMES), -1)
    return {name: x + (xx - x) * (p["mu"][i] + delta[..., i, :])
            for i, name in enumerate(MIX_NAMES)}


def _wkv_step(s, rkvwu):
    """One recurrence step of every head of every row.  s: (B, H, dk,
    dv); r, k, w: (B, H, dk); v: (B, H, dv); u: (H, dk).  Returns (the
    new state, the readout (B, H, dv))."""
    r, k, v, w, u = rkvwu
    kv = k[..., :, None] * v[..., None, :]
    out = cm.row_stable(lambda rr, ss: torch.einsum("bhk,bhkv->bhv", rr, ss),
                        r, s + u[:, :, None] * kv)
    return w[..., None] * s + kv, out


def _group_norm(o: torch.Tensor) -> torch.Tensor:
    """Per-head normalization of (M, H, hd) rows (the reference's mean and
    ``jnp.var``)."""
    mu = o.mean(dim=-1, keepdim=True)
    var = torch.square(o - mu).mean(dim=-1, keepdim=True)
    return (o - mu) * torch.rsqrt(var + 1e-5)


def time_mix_forward(cfg: ModelConfig, p, x, state=None, group=None):
    """x: (B, S, d); ``state``: {"shift": (B, d), "wkv": (B, H, dk, dv)}
    or None (zeros).  Returns (y (B, S, d) float32, the new state); the
    wkv recurrence steps the S tokens in order.  Under TP (``group``)
    the rank's heads only (H / tp, its columns of r, k, v, g), and y
    closes with an all-reduce of ``w_o``'s rows."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    dl = p["w_r"].shape[-1]                 # this rank's columns
    h = dl // hd
    lo = comm.axis_index(group) * dl
    cols = slice(lo, lo + dl)
    prev = state["shift"] if state is not None else x.new_zeros((b, d))
    xx = _shifted(prev, x)
    m = _ddlerp(p, x, xx)

    r = cm.matmul(m["r"], p["w_r"]).reshape(b, s, h, hd)
    k = cm.matmul(m["k"], p["w_k"]).reshape(b, s, h, hd)
    v = cm.matmul(m["v"], p["w_v"]).reshape(b, s, h, hd)
    g = F.silu(cm.matmul(m["g"], p["w_g"]))
    decay = p["decay_base"][cols] + cm.matmul(
        torch.tanh(cm.matmul(m["w"], p["decay_w1"])), p["decay_w2"][:, cols])
    w = torch.exp(-torch.exp(decay.float())).reshape(b, s, h, hd)
    u = p["bonus_u"][cols].reshape(h, hd).float()

    cur = (state["wkv"] if state is not None
           else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=x.device))
    outs = []
    for t in range(s):
        cur, o = _wkv_step(cur, (r[:, t].float(), k[:, t].float(),
                                 v[:, t].float(), w[:, t], u))
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(b * s, h, hd)
    out = cm.row_stable(_group_norm, out).reshape(b, s, dl) * \
        p["ln_scale"][cols]
    out = out.to(x.dtype) * g
    return (comm.raw_psum(cm.matmul(out, p["w_o"]), group),
            {"shift": x[:, -1], "wkv": cur})


# ---------------------------------------------------------------------------
# channel-mix
# ---------------------------------------------------------------------------

def channel_mix_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, dev = cfg.d_model, gen.device
    return {
        "mu_k": torch.full((d,), 0.5, device=dev),
        "mu_r": torch.full((d,), 0.5, device=dev),
        "w_r": cm.dense_init(gen, (d, d)),
        "pair": cm.mlp_params(cfg, gen, d_ff=cfg.d_ff),
    }


def channel_mix_forward(cfg: ModelConfig, p, x, policy: ExecutionPolicy,
                        state=None, group=None):
    """x: (B, S, d); ``state``: the previous token's row (B, d) or None.
    The K->V pair (up, squared ReLU, down) is the quantized MLP pair at
    ``MLP_PATH``.  Returns (y, the new state)."""
    b, _, d = x.shape
    prev = state if state is not None else x.new_zeros((b, d))
    xx = _shifted(prev, x)
    # weakly typed in the reference (``jnp.full``): in the input's dtype
    xk = x + (xx - x) * p["mu_k"].to(x.dtype)
    xr = x + (xx - x) * p["mu_r"].to(x.dtype)
    rgate = torch.sigmoid(cm.matmul(xr, p["w_r"]))
    v = cm.mlp_forward(cfg, p["pair"], xk, policy, activation="relu2",
                       group=group, path=MLP_PATH)
    return rgate * v, x[:, -1]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _layer_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln1": cm.norm_params(cfg, dev),
            "tm": time_mix_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "cm": channel_mix_params(cfg, gen)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None):
    """Random params on ``gen.device``.  ``stage(key, node)`` (the plan
    compiler) is applied to the embedding, each layer and the final norm
    as soon as each exists, so one layer's raw weights are alive at a
    time."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    embed = stage("embed", cm.embed_params(cfg, gen))
    layers = [stage("layers", _layer_params(cfg, gen))
              for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int):
    """The reference's TP split of one piece (``"embed"``, one of
    ``"layers"``, ``"final_norm"``): the time-mix's r, k, v, g by columns
    and its output by rows, the channel-mix pair as every MLP pair; a
    ``tp`` that does not divide the time-mix heads raises."""
    check_heads(cfg, tp)
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key == "layers":
        tm = {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0}
        return {"ln1": cm.norm_specs(node["ln1"]),
                "tm": {k: tm.get(k) for k in node["tm"]},
                "ln2": cm.norm_specs(node["ln2"]),
                "cm": {k: (cm.mlp_specs(v) if k == "pair" else None)
                       for k, v in node["cm"].items()}}
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split."""
    return {"embed": piece_specs(cfg, "embed", params["embed"], tp),
            "layers": [piece_specs(cfg, "layers", lp, tp)
                       for lp in params["layers"]],
            "final_norm": piece_specs(cfg, "final_norm",
                                      params["final_norm"], tp)}


def layer_forward(cfg: ModelConfig, lp, x, policy: ExecutionPolicy, *,
                  state=None, group=None):
    """One layer: the time-mix, then the channel-mix, each on the
    pre-normed residual.  ``state``: {"shift", "wkv", "cm"} of this layer
    or None.  Returns (the result before its cast to the carry's dtype,
    the time-mix state, the channel-mix state)."""
    tm_state = None if state is None else {"shift": state["shift"],
                                           "wkv": state["wkv"]}
    h, tm = time_mix_forward(cfg, lp["tm"], cm.apply_norm(cfg, lp["ln1"], x),
                             tm_state, group=group)
    y = x + h
    h, cs = channel_mix_forward(cfg, lp["cm"],
                                cm.apply_norm(cfg, lp["ln2"], y), policy,
                                None if state is None else state["cm"],
                                group=group)
    return y + h, tm, cs


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            aux=None) -> torch.Tensor:
    """batch={"tokens": (B, S)} -> logits (B, S, V).  The family has no
    attention; ``window`` and ``attn_backend`` are accepted and unused."""
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"], group=group)
    for lp in params["layers"]:
        x = layer_forward(cfg, lp, x, policy, group=group)[0].to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None, tp: int = 1) -> dict:
    """The fixed-size decode state of ``batch`` slots (``seq_len`` and
    ``window`` unused: there is no KV sequence); ``wkv`` of this rank's
    ``H / tp`` heads."""
    check_heads(cfg, tp)
    d, hd, n = cfg.d_model, cfg.rwkv_head_dim, cfg.num_layers
    # the layer's normed input: the carry's dtype
    shift = torch.promote_types(dtype, torch.bfloat16 if cfg.dtype ==
                                "bfloat16" else torch.float32)
    return {
        "tm_shift": torch.zeros((n, batch, d), dtype=shift, device=device),
        "wkv": torch.zeros((n, batch, d // hd // tp, hd, hd),
                           dtype=torch.float32, device=device),
        "cm_shift": torch.zeros((n, batch, d), dtype=torch.float32,
                                device=device),
    }


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None, group=None,
                pages=None, kv_len=None, aux=None):
    """One-token decode: tokens (B,) -> (logits (B, V), cache), the state
    written in place.  ``pos``, ``pages`` and ``kv_len`` are accepted and
    unused: the whole state is fixed-size per slot, with nothing to page
    or mask."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    for i, lp in enumerate(params["layers"]):
        y, tm, cs = layer_forward(
            cfg, lp, x, policy, group=group,
            state={"shift": cache["tm_shift"][i], "wkv": cache["wkv"][i],
                   "cm": cache["cm_shift"][i]})
        cache["tm_shift"][i].copy_(tm["shift"])
        cache["wkv"][i].copy_(tm["wkv"])
        cache["cm_shift"][i].copy_(cs)
        x = y.to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
