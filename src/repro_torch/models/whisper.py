"""Whisper-large-v3 backbone, an encoder-decoder; port of
``repro/models/whisper.py``.

The mel-spectrogram and conv front end is a stub, as in the reference:
``batch["frames"]`` carries precomputed frame embeddings (B, enc_seq, d).
Sinusoidal positions, LayerNorm, ungated GELU MLPs (the quantized pairs).

Layers are lists of per-layer dicts (``enc_layers``, ``dec_layers``)
driven by Python loops; the reference stacks each along a leading dim
(``LAYER_STACKS``).  The decoder's cache is ``{"self": the dense KV rows
(or a page pool), "cross_k", "cross_v": (L, B, enc_seq, KV, D)}``: the
cross K/V of every decoder layer, written once at prefill by
``precompute_cross`` **in place** (a captured decode step keeps their
addresses) and read by every step.

Dtypes follow the reference's: the frames and the decoder's carry are
bf16; after a layer's self-attention the residual is float32, so the
cross K/V are widened to float32 for the step's cross-attention, as the
reference's ``xk.astype(x.dtype)`` widens them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.models import common as cm
from repro_torch.models.transformer import layer_folds

#: this family consumes attention V->O folds for its decoder
#: self-attention (the registry forwards ``aux`` only to modules that
#: say so)
SUPPORTS_ATTN_VO = True

#: the dotted path ``stage_fold_attention`` records the decoder
#: self-attention folds under
ATTN_VO_PATH = "dec_layers.attn"

#: folds the plan compiler produces but this runtime does not consume,
#: with the reason (the reference's)
ATTN_VO_WAIVED = {
    "dec_layers.xattn": (
        "cross-attention K/V is precomputed from raw wv at prefill "
        "(precompute_cross); a folded V would disagree with the cached "
        "values"),
    "enc_layers.attn": (
        "encoder runs once at prefill through GSPMD; the fold targets "
        "the per-token decode path"),
}

#: the stacked layer prefixes of the reference's tree and how many
#: leading dims each stacks (``interop``, the artifact's layout)
LAYER_STACKS = {"enc_layers": 1, "dec_layers": 1}

#: the pair paths of the encoder's and the decoder's MLPs
ENC_MLP_PATH = "enc_layers.mlp"
DEC_MLP_PATH = "dec_layers.mlp"


def _dec_vo(aux, num_layers: int) -> list:
    """One V->O fold (or None) for each decoder layer."""
    return layer_folds(aux, ATTN_VO_PATH, (num_layers,))


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    """The (seq, d) float32 sinusoid table, computed as the reference
    computes it: ``pos / 10000 ** (2 * dim / d)``, sines then cosines.
    The power is taken in float64 and rounded once: the reference's
    correctly rounded float32 power (float32 ``pow`` misses some by an
    ulp, which moves the angles of far positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    expo = 2 * dim / d
    ang = pos / (10000.0 ** expo.to(torch.float64)).to(torch.float32)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln1": cm.norm_params(cfg, dev),
            "attn": cm.attention_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "mlp": cm.mlp_params(cfg, gen)}


def _dec_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln1": cm.norm_params(cfg, dev),
            "attn": cm.attention_params(cfg, gen),
            "lnx": cm.norm_params(cfg, dev),
            "xattn": cm.attention_params(cfg, gen),
            "ln2": cm.norm_params(cfg, dev),
            "mlp": cm.mlp_params(cfg, gen)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                stage: Optional[Callable[[str, object], object]] = None):
    """Random params on ``gen.device``.  ``stage(key, node)`` (the plan
    compiler) is applied to the embedding, each encoder layer
    (``"enc_layers"``), the encoder's norm, each decoder layer
    (``"dec_layers"``) and the final norm as soon as each exists, so one
    layer's raw weights are alive at a time."""
    dev = gen.device
    stage = stage or (lambda key, node: node)
    embed = stage("embed", cm.embed_params(cfg, gen))
    enc = [stage("enc_layers", _enc_layer(cfg, gen))
           for _ in range(cfg.encoder_layers)]
    enc_norm = stage("enc_norm", cm.norm_params(cfg, dev))
    dec = [stage("dec_layers", _dec_layer(cfg, gen))
           for _ in range(cfg.num_layers)]
    return {"embed": embed, "enc_layers": enc, "enc_norm": enc_norm,
            "dec_layers": dec,
            "final_norm": stage("final_norm", cm.norm_params(cfg, dev))}


def piece_specs(cfg: ModelConfig, key: str, node, tp: int):
    """TP specs of one piece (``"embed"``, one of ``"enc_layers"`` or
    ``"dec_layers"``, a norm): per leaf the dim split over the ranks."""
    if key == "embed":
        return cm.embed_specs(cfg, tp)
    if key in LAYER_STACKS:
        cm.require_whole_kv(cfg, tp)
        return {k: (cm.attention_specs(cfg, v, tp) if k in ("attn", "xattn")
                    else cm.mlp_specs(v) if k == "mlp"
                    else cm.norm_specs(v)) for k, v in node.items()}
    return cm.norm_specs(node)


def param_specs(cfg: ModelConfig, params, tp: int):
    """The reference's ``param_specs``: every leaf's TP split."""
    return {k: ([piece_specs(cfg, k, lp, tp) for lp in v]
                if isinstance(v, list) else piece_specs(cfg, k, v, tp))
            for k, v in params.items()}


def enc_layer_forward(cfg: ModelConfig, lp, x, policy: ExecutionPolicy, *,
                      attn_backend="xla", group=None) -> torch.Tensor:
    """One encoder layer (the reference's encoder scan body): bidirectional
    self-attention, then the MLP, each on the pre-normed residual; the
    result before its cast to the carry's dtype."""
    h = cm.attention_forward(cfg, lp["attn"], cm.apply_norm(cfg, lp["ln1"], x),
                             causal=False, attn_backend=attn_backend,
                             group=group, policy=policy)
    y = x + h
    return y + cm.mlp_forward(cfg, lp["mlp"], cm.apply_norm(cfg, lp["ln2"], y),
                              policy, group=group, path=ENC_MLP_PATH)


def encode(cfg: ModelConfig, params, frames: torch.Tensor,
           policy: ExecutionPolicy, *, attn_backend="xla",
           group=None) -> torch.Tensor:
    """frames (B, enc_seq, d), the stub's embeddings -> the encoder's
    states (B, enc_seq, d) in the frames' dtype."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for lp in params["enc_layers"]:
        x = enc_layer_forward(cfg, lp, x, policy, attn_backend=attn_backend,
                              group=group).to(x.dtype)
    return cm.apply_norm(cfg, params["enc_norm"], x)


def dec_layer_forward(cfg: ModelConfig, lp, x, enc, policy: ExecutionPolicy,
                      *, attn_backend="xla", group=None,
                      vo=None) -> torch.Tensor:
    """One decoder layer of the forward (the reference's ``_dec_layer``):
    causal self-attention (through the V->O fold ``vo`` when given),
    cross-attention over the encoder states ``enc``, then the MLP, each
    on the pre-normed residual; the result before its cast to the
    carry's dtype."""
    h = cm.attention_forward(cfg, lp["attn"], cm.apply_norm(cfg, lp["ln1"], x),
                             attn_backend=attn_backend, group=group, vo=vo,
                             policy=policy)
    y = x + h
    y = y + cm.attention_forward(cfg, lp["xattn"],
                                 cm.apply_norm(cfg, lp["lnx"], y), kv_x=enc,
                                 group=group, policy=policy)
    return y + cm.mlp_forward(cfg, lp["mlp"], cm.apply_norm(cfg, lp["ln2"], y),
                              policy, group=group, path=DEC_MLP_PATH)


def forward(cfg: ModelConfig, params, batch: dict, policy: ExecutionPolicy,
            *, window=None, attn_backend="xla", group=None,
            aux=None) -> torch.Tensor:
    """batch: {"tokens": (B, S), "frames": (B, enc_seq, d)} -> logits.
    The decoder's self-attention is causal and windowless, as the
    reference's; ``attn_backend`` picks its kernel and the encoder's
    (cross-attention stays on the einsum path)."""
    enc = encode(cfg, params, batch["frames"], policy,
                 attn_backend=attn_backend, group=group)
    return decoder_forward(cfg, params, batch["tokens"], enc, policy,
                           attn_backend=attn_backend, group=group, aux=aux)


def decoder_forward(cfg: ModelConfig, params, tok: torch.Tensor,
                    enc: torch.Tensor, policy: ExecutionPolicy, *,
                    attn_backend="xla", group=None,
                    aux=None) -> torch.Tensor:
    """The decoder half of ``forward``: tokens (B, S) over the encoder
    states ``enc`` (B, enc_seq, d) -> logits (B, S, V)."""
    x = cm.embed_tokens(cfg, params["embed"], tok, group=group)
    x = x + _sinusoid(tok.shape[1], cfg.d_model, x.device).to(x.dtype)
    vos = _dec_vo(aux, len(params["dec_layers"]))
    for lp, vo in zip(params["dec_layers"], vos):
        x = dec_layer_forward(cfg, lp, x, enc, policy,
                              attn_backend=attn_backend, group=group,
                              vo=vo).to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)


def _cross_cache(cfg: ModelConfig, batch: int, dtype, device, tp: int):
    kvp, _, _ = cm.head_grid(cfg)
    shape = (cfg.num_layers, batch, cfg.encoder_seq, kvp // tp, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, window=None,
               dtype=torch.bfloat16, device=None, tp: int = 1) -> dict:
    """The decoder's self-attention rows and every layer's cross K/V (this
    rank's KV heads)."""
    return {"self": cm.init_kv_cache(cfg, cfg.num_layers, batch, seq_len,
                                     window=window, dtype=dtype,
                                     device=device, tp=tp),
            **_cross_cache(cfg, batch, dtype, device, tp)}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     batch: int, bits=None, dtype=torch.bfloat16,
                     device=None, tp: int = 1) -> dict:
    """A page pool for the decoder's self-attention; the cross K/V stay
    dense (a fixed ``enc_seq`` per slot, written once at prefill)."""
    return {"self": cm.init_paged_kv_cache(cfg, cfg.num_layers, n_pages,
                                           page_size, bits=bits, dtype=dtype,
                                           device=device, tp=tp),
            **_cross_cache(cfg, batch, dtype, device, tp)}


def precompute_cross(cfg: ModelConfig, params, enc: torch.Tensor,
                     cache) -> tuple[torch.Tensor, torch.Tensor]:
    """Write every decoder layer's cross K and V of the encoder states
    ``enc`` (B, enc_seq, d) into ``cache["cross_k"]`` and
    ``cache["cross_v"]`` in place, cast to the cache's dtype; returns the
    two.  Under TP ``wk``/``wv`` hold this rank's heads, as the cache
    does (no collective)."""
    b, t, _ = enc.shape
    hd = cfg.head_dim
    for i, lp in enumerate(params["dec_layers"]):
        xa = lp["xattn"]
        kvh = xa["wk"].shape[-1] // hd
        cache["cross_k"][i].copy_(cm.matmul(enc, xa["wk"]).reshape(
            b, t, kvh, hd))
        cache["cross_v"][i].copy_(cm.matmul(enc, xa["wv"]).reshape(
            b, t, kvh, hd))
    return cache["cross_k"], cache["cross_v"]


def prefill_cross(cfg: ModelConfig, params, batch: dict, cache,
                  policy: ExecutionPolicy, *, attn_backend="xla",
                  group=None) -> None:
    """The prefill's cross-attention part (the reference engine's audio
    branch): encode ``batch["frames"]``, then ``precompute_cross`` into
    the cache."""
    enc = encode(cfg, params, batch["frames"], policy,
                 attn_backend=attn_backend, group=group)
    precompute_cross(cfg, params, enc, cache)


def _positions(cfg: ModelConfig, pos, x: torch.Tensor) -> torch.Tensor:
    """The position embedding of ``pos`` (an int, or a (B,) tensor of
    per-slot positions), clamped at ``max_target_positions - 1`` and
    gathered on the device (no read to the host), in ``x``'s dtype,
    shaped to add to x (B, 1, d).  Both forms give the same bits."""
    table = _sinusoid(cfg.max_target_positions or 448, cfg.d_model,
                      x.device)
    last = table.shape[0] - 1
    if torch.is_tensor(pos) and pos.dim() == 1:
        emb = table[pos.clamp(max=last)][:, None]
    else:
        emb = table[min(int(pos), last)][None, None]
    return emb.to(x.dtype)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                policy: ExecutionPolicy, *, window=None, group=None,
                pages=None, kv_len=None, aux=None):
    """One-token decode: tokens (B,), pos int or (B,) -> (logits (B, V),
    cache); the self-attention cache is written in place.  With ``pages``
    the ``"self"`` entry is the page pool (``kv_len`` as in
    ``attention_decode``)."""
    x = cm.embed_tokens(cfg, params["embed"], tokens[:, None], group=group)
    x = x + _positions(cfg, pos, x)
    vos = _dec_vo(aux, len(params["dec_layers"]))
    for i, (lp, vo) in enumerate(zip(params["dec_layers"], vos)):
        layer_cache = {name: leaf[i] for name, leaf in cache["self"].items()}
        h, _ = cm.attention_decode(cfg, lp["attn"],
                                   cm.apply_norm(cfg, lp["ln1"], x),
                                   layer_cache, pos, window=window,
                                   group=group, pages=pages, kv_len=kv_len,
                                   vo=vo, policy=policy)
        y = x + h
        y = y + cm.cross_attention_decode(
            cfg, lp["xattn"], cm.apply_norm(cfg, lp["lnx"], y),
            cache["cross_k"][i], cache["cross_v"][i], group=group)
        y = y + cm.mlp_forward(cfg, lp["mlp"],
                               cm.apply_norm(cfg, lp["ln2"], y), policy,
                               group=group, path=DEC_MLP_PATH)
        x = y.to(x.dtype)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return cm.lm_head(cfg, params["embed"], x, group=group)[:, 0], cache
