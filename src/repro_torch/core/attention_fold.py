"""Head-block-constrained TP-aware fold of attention's V -> out_proj pair;
port of ``repro/core/attention_fold.py``.

Attention output channel ``(h, j)`` (query head ``h``, channel ``j``) comes
from V channel ``(h // g, j)`` of KV head ``h // g`` (GQA group ``g``), and
attention mixes tokens, never channels.  So a per-KV-head permutation of
the channels commutes with attention, and an act-order permutation of
W_o's rows folds into W_v's columns when it is the same for the query
heads of one KV group and stays inside each head's ``head_dim`` block.
Under head-sharded TP the blocks never cross ranks, so, as in the paper's
MLP fold, no all-gather is needed between V and out_proj.

The reference draws the row importance and V's processing order from a
``jax.random`` key.  The port takes both explicitly (tests pass the
reference's, so the leaves compare bit for bit), else draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantization as qz
from repro_torch.core.reorder import PlannedPair
from repro_torch.device import new_generator


def constrained_row_order(importance_o: torch.Tensor, *, n_heads: int,
                          n_kv_heads: int, head_dim: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-constrained descending-importance order of W_o's rows.

    ``importance_o``: (n_heads * head_dim,).  Returns (proc_order (K2,),
    pi (n_kv_heads, head_dim)) with ``proc_order[h*hd + j] = h*hd +
    pi[h // g, j]``: each KV head's channels sorted by the mean importance
    of its query heads (a stable sort, as ``jnp.argsort``)."""
    g = n_heads // n_kv_heads
    imp = importance_o.reshape(n_kv_heads, g, head_dim)
    imp_kv = torch.mean(imp, dim=1)
    pi = torch.argsort(-imp_kv, dim=1, stable=True).to(torch.int32)
    dev = importance_o.device
    base = (torch.arange(n_heads, dtype=torch.int32, device=dev)
            * head_dim)[:, None]
    pi_per_q = pi[torch.arange(n_heads, device=dev) // g]
    return (base + pi_per_q).reshape(-1), pi


def plan_attention_vo(
    w_v: torch.Tensor,              # (d_model, n_kv_heads * head_dim)
    w_o: torch.Tensor,              # (n_heads * head_dim, d_model)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    group_size: int = 128,
    importance_o: Optional[torch.Tensor] = None,
    proc_order_v: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PlannedPair:
    """The tp-aware plan of the V -> out_proj pair.

    ``up`` is V quantized in ``proc_order_v`` (else an order drawn from
    ``generator``, else the identity) with its columns folded by the
    per-KV-head order ``pi``; ``down`` is W_o quantized in the
    block-constrained order of ``importance_o`` (else importance drawn
    uniform from ``generator``, or from seed 0 without one), its rows
    sorted by group; ``p2`` holds that row order.  Attention runs between
    the two GEMMs (``attention_vo_reference``, ``models/common.py``)."""
    k2 = n_heads * head_dim
    if w_o.shape[0] != k2:
        raise ValueError(f"w_o rows {w_o.shape[0]} != H*hd {k2}")
    if head_dim % group_size and group_size % head_dim:
        raise ValueError(
            f"group_size {group_size} must tile head_dim {head_dim} so "
            "quant groups never cross foldable blocks")

    if importance_o is None:
        gen = (generator if generator is not None
               else new_generator(0, w_o.device))
        importance_o = torch.rand(k2, generator=gen, device=gen.device)
    proc_order, pi = constrained_row_order(
        importance_o.to(w_o.device), n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim=head_dim)

    gs_o = qz.choose_group_size(min(head_dim, k2), group_size)
    gs_v = qz.choose_group_size(w_v.shape[0], group_size)
    q_o = qz.quantize(w_o, gs_o, act_order=True, proc_order=proc_order)
    q_v = qz.quantize(w_v, gs_v, act_order=True, generator=generator,
                      proc_order=proc_order_v)

    # the fold: V's columns permuted by pi inside each KV-head block, so
    # the attention output lands aligned with W_o's sorted rows
    kv_fold = (torch.arange(n_kv_heads, dtype=torch.int32,
                            device=pi.device)[:, None] * head_dim
               + pi).reshape(-1)
    return PlannedPair(up=qz.permute_columns(q_v.ordered, kv_fold),
                       gate=None, down=q_o.ordered, p1_up=q_v.perm,
                       p1_gate=None, p2=q_o.perm, scheme="tp-aware")


def shard_attention_vo(pp: PlannedPair, tp: int, *, n_heads: int,
                       n_kv_heads: int, head_dim: int) -> list[PlannedPair]:
    """Split one layer's fold into ``tp`` per-rank folds by heads, as the
    attention's own specs split ``wv`` (columns) and ``wo`` (rows): rank
    ``r`` keeps V's columns of its KV heads and O's rows of its query
    heads, which are contiguous in the ordered layout (W_o's rows sort
    within head blocks, and O's groups never cross heads).  ``p1_up``
    stays whole, ``p2`` splits into local chunks.  Every slice is a
    contiguous copy."""
    if n_heads % tp or n_kv_heads % tp:
        raise ValueError(f"{n_heads} query and {n_kv_heads} KV heads do "
                         f"not split over tp={tp} ranks")
    cols = n_kv_heads // tp * head_dim
    rows = n_heads // tp * head_dim
    gs = pp.down.group_size
    if rows % qz.PACK or rows % gs:
        raise ValueError(f"a rank's {rows} O rows are not whole packed "
                         f"words and groups of {gs}")

    def own(t):
        return t.clone(memory_format=torch.contiguous_format)

    out = []
    for r in range(tp):
        c = slice(r * cols, (r + 1) * cols)
        up = dataclasses.replace(
            pp.up, qweight=own(pp.up.qweight[:, c]),
            scales=own(pp.up.scales[:, c]), zeros=own(pp.up.zeros[:, c]))
        k = slice(r * rows // qz.PACK, (r + 1) * rows // qz.PACK)
        g = slice(r * rows // gs, (r + 1) * rows // gs)
        down = dataclasses.replace(
            pp.down, qweight=own(pp.down.qweight[k]),
            scales=own(pp.down.scales[g]), zeros=own(pp.down.zeros[g]))
        out.append(dataclasses.replace(
            pp, up=up, down=down, p1_up=own(pp.p1_up),
            p2=own(pp.p2[r * rows:(r + 1) * rows])))
    return out


def attention_vo_reference(x, q_heads, attn_weights, pp: PlannedPair, *,
                           n_heads: int, n_kv_heads: int, head_dim: int,
                           policy=None) -> torch.Tensor:
    """X -> V -> attention mix -> out_proj through the folded plan.

    ``attn_weights``: (B, H, S, T) softmaxed scores (V's channel order
    cannot change them); ``q_heads`` is unused, as in the reference.
    ``policy`` picks the kernel and dtypes of the two quantized GEMMs."""
    from repro_torch.core import schemes
    from repro_torch.core.policy import resolve_policy

    policy = resolve_policy(policy)
    g = n_heads // n_kv_heads
    xin = x.index_select(-1, pp.p1_up) if pp.p1_up is not None else x
    v = schemes.qmatmul(xin, pp.up, policy)
    b, t, _ = v.shape
    v = v.reshape(b, t, n_kv_heads, head_dim)
    out = torch.einsum("bhst,bthd->bshd",
                       attn_weights.to(policy.compute_dtype),
                       v.repeat_interleave(g, dim=2))
    out = out.reshape(b, -1, n_heads * head_dim)
    return schemes.qmatmul(out, pp.down, policy)
