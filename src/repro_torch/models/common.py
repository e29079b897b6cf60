"""Shared model substrate; port of ``repro/models/common.py``.

Params are plain dicts of tensors, one dict per layer (the reference
stacks layers along a leading L dim for ``lax.scan``).  Where the
reference passes a ``ParallelContext``, the port passes the
``ExecutionPolicy`` and the process group of the TP ranks (``group``;
None runs on one device).

Tensor parallelism follows the reference's sharding (``*_specs``, which
name the dim of each leaf that is split over the ranks) with GSPMD's
implicit collectives written out: attention runs this rank's heads and
closes its row-sharded output projection with a float32 all-reduce; the
vocab-sharded embedding closes with an all-reduce and the column-sharded
``lm_head`` with an all-gather of the logits (when the padded vocab does
not divide the ranks, the embedding is split by ``d_model`` columns and
closes with an all-gather, the head by rows and closes with an
all-reduce of the logits); the MLP pair runs the paper's schemes
(``core/schemes.pair_forward_tp``).

Dtypes follow what JAX reaches: activations enter a layer in bf16
(``cfg.dtype``), every product with an f32 weight promotes to f32, and
the layer's output is cast back to the carry dtype.  Torch's ``matmul``
does not promote mixed dtypes (JAX does), so ``promoted`` makes those
casts explicit.  Elementwise ops promote the same way in both.

With an attention V->O fold (``vo``, a ``PlannedPair`` from
``core/attention_fold.py``; the artifact's aux plans), V and the output
projection run as quantized GEMMs through ``schemes.qmatmul`` (the
kernel ``policy.backend`` names) instead of ``wv`` and ``wo``, cast to
the input's dtype as the reference casts them.  The folded V channels
land in the cache permuted within head blocks, which attention commutes
with and ``vo.down``'s sorted rows expect.  Under TP ``vo`` holds this
rank's heads, and the output projection closes by the float32
all-reduce that closes ``wo``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.comm import dispatch as comm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import schemes
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PlannedPair


def promoted(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Cast tensors to their common dtype, as JAX promotes ``a @ b``."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


#: row counts up to ``ROW_STABLE_MAX`` (decode batches) run ``row_stable``
#: ops in blocks of exactly ``row_block()`` rows: ``ROW_BLOCK`` unless a
#: caller sets another (``row_blocks``; an engine steps in blocks of its
#: scheduler's ``max_batch``, so a full batch runs each op once, unpadded)
ROW_BLOCK = 4
ROW_STABLE_MAX = 64
_ROW_BLOCK = contextvars.ContextVar("row_block", default=ROW_BLOCK)


def row_block() -> int:
    """The block ``row_stable`` runs its rows in here."""
    return _ROW_BLOCK.get()


@contextlib.contextmanager
def row_blocks(n: int):
    """Run ``row_stable`` ops in blocks of ``n`` rows within the block."""
    token = _ROW_BLOCK.set(int(n))
    try:
        yield
    finally:
        _ROW_BLOCK.reset(token)


def row_stable(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` for a ``fn`` that maps each row (dim 0) of its inputs
    on its own, with each row's bits independent of how many rows come
    with it.

    A library GEMM picks its kernel, and so its sum order, by the row
    count (a strided-batched one by its batch count), so a request's
    logits would depend on its company in the batch.  Up to
    ``ROW_STABLE_MAX`` rows ``fn`` runs on blocks of exactly
    ``row_block()`` rows (the last one zero-padded): one shape, hence one
    kernel, whatever the batch.  Longer inputs (a full forward) run as
    one call."""
    blk = row_block()
    m = xs[0].shape[0]
    if m == 0 or m == blk or m > ROW_STABLE_MAX:
        return fn(*xs)
    outs = []
    for i in range(0, m, blk):
        n = min(blk, m - i)
        part = [x[i:i + n] if n == blk else torch.cat(
            [x[i:i + n], x.new_zeros((blk - n,) + x.shape[1:])])
            for x in xs]
        outs.append(fn(*part)[:n])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion (bf16 @ f32 -> f32), with
    rows that do not depend on how many come along (``row_stable``)."""
    a, b = promoted(a, b)
    if b.dim() != 2:
        return a @ b
    lead = a.shape[:-1]
    y = row_stable(lambda t: t @ b, a.reshape(-1, a.shape[-1]))
    return y.reshape(*lead, b.shape[-1])


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return w.to(dtype)


def norm_params(cfg: ModelConfig, device) -> dict:
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMS norm or LayerNorm over the last dim, its reduction run on
    row-stable blocks (``row_stable``: the reduction's split of a row
    follows the row count)."""
    lead = x.shape[:-1]
    return row_stable(lambda t: _norm(cfg, p, t),
                      x.reshape(-1, x.shape[-1])).reshape(*lead, -1)


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = torch.square(x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """Per-head RMS norm (qwen3 qk_norm); x: (..., D), scale: (D,)."""
    x32 = x.to(torch.float32)
    ms = torch.square(x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding; x: (B, S, H, D), positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    # the power in float64, rounded once: the reference's correctly
    # rounded float32 frequencies (float32 ``pow`` misses some by an ulp,
    # which moves the angles of far positions)
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = (theta ** expo.to(torch.float64)).to(torch.float32)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = (pos[:, None] * freqs[None, :])[None, :, None, :]
    else:
        ang = (pos[..., None] * freqs)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def head_grid(cfg: ModelConfig) -> tuple[int, int, int]:
    """(kv_pad, g_pad, h_pad): the deployed (KV, group) head grid, padded
    so ``h_pad % attn_tp_pad == 0`` when ``cfg.attn_tp_pad`` is set."""
    kv, h = cfg.n_kv_heads, cfg.n_heads
    g = h // kv
    tp = cfg.attn_tp_pad
    if not tp or h % tp == 0:
        return kv, g, h
    best = None
    for gp in range(g, g + tp + 1):
        for kvp in range(kv, kv + tp + 1):
            if (kvp * gp) % tp == 0:
                if best is None or kvp * gp < best[0] * best[1]:
                    best = (kvp, gp)
                break
    kvp, gp = best
    return kvp, gp, kvp * gp


def _pad_heads(w: torch.Tensor, d: int, n_real: int, n_pad: int,
               hd: int) -> torch.Tensor:
    """Zero-pad a (d, n_real*hd) projection to (d, n_pad*hd) head-wise."""
    if n_real == n_pad:
        return w
    w = w.reshape(d, n_real, hd)
    w = torch.nn.functional.pad(w, (0, 0, 0, n_pad - n_real))
    return w.reshape(d, n_pad * hd)


def attention_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kvp, gp, hp = head_grid(cfg)
    g = h // kv
    wq = dense_init(gen, (d, kv, g, hd)).reshape(d, h * hd)
    wo = dense_init(gen, (kv, g, hd, d)).reshape(h * hd, d)
    if (kvp, gp) != (kv, g):
        pad = torch.nn.functional.pad
        wq = pad(wq.reshape(d, kv, g, hd),
                 (0, 0, 0, gp - g, 0, kvp - kv)).reshape(d, hp * hd)
        wo = pad(wo.reshape(kv, g, hd, d),
                 (0, 0, 0, 0, 0, gp - g, 0, kvp - kv)).reshape(hp * hd, d)
    p = {
        "wq": wq,
        "wk": _pad_heads(dense_init(gen, (d, kv * hd)), d, kv, kvp, hd),
        "wv": _pad_heads(dense_init(gen, (d, kv * hd)), d, kv, kvp, hd),
        "wo": wo,
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=gen.device)
        p["k_norm"] = torch.ones(hd, device=gen.device)
    return p


def _sdpa(q, k, v, mask):
    """Scaled-dot-product attention in flat-head form.

    q: (B, S, H, D); k/v: (B, T, KV, D); mask broadcastable to (B, S, T).
    GQA KV heads are repeated to H (``jnp.repeat`` == ``repeat_interleave``).
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    q_dtype = q.dtype
    q, k = promoted(q, k)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / (d ** 0.5)
    scores = scores.to(torch.float32)
    if mask is not None:
        # a Python scalar, not a host-built tensor: no copy from host
        # memory, so the decode step can be captured in a CUDA graph
        scores = torch.where(mask[:, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q_dtype)
    w, v = promoted(w, v)
    return torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, h * d)


def _sdpa_decode(q, k, v, mask):
    """Decode attention, one query per row, each query head against its
    KV head's group (the GQA repeat written as a grouped product, no
    repeated KV heads): q (B, 1, H, D); k/v (B, T, KV, D); mask (B, 1, T)
    -> (B, 1, H * D).  Rows are independent (``row_stable`` pads them)."""
    b, _, h, d = q.shape
    kvh = k.shape[2]
    q_dtype = q.dtype
    qg, k = promoted(q.reshape(b, kvh, h // kvh, d), k)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) / (d ** 0.5)
    scores = torch.where(mask[:, :, None], scores.to(torch.float32), -1e30)
    w = torch.softmax(scores, dim=-1).to(q_dtype)
    w, v = promoted(w, v)
    return torch.einsum("bkgt,btkd->bkgd", w, v).reshape(b, 1, h * d)


def _flash_sdpa(q, k, v, *, causal: bool, window):
    """Fused flash-attention path (the CUDA kernel, ``kernels/ops``).

    q: (B, S, H, D); k/v: (B, T, KV, D).  The KV heads are repeated to the
    full head grid (``jnp.repeat`` == ``repeat_interleave``) and the
    kernel runs on (B, H, S, D); returns (B, S, H * D).  A head dim the
    kernel lacks (``HEAD_DIMS``) raises, on the CPU too (whose plain
    version would take it).
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        # on every device, so a forward never takes another path quietly
        raise ValueError(f"attn_backend='flash': the flash kernel takes "
                         f"head dims {HEAD_DIMS}, not {hd}")
    g = h // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    # a folded V is in the input's dtype; widening it to q's is exact, as
    # the reference's kernel promotes it in its products
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1).to(q.dtype)
    vt = vt.contiguous()
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2).reshape(b, s, h * hd)


ATTN_BACKENDS = ("xla", "flash")

#: Q-chunk size of long causal self-attention on the einsum path: the
#: (Q_CHUNK, T) score tile is the only temp that grows with S x T
Q_CHUNK = 2048
Q_CHUNK_MIN_SEQ = 8192


def _local_heads(cfg: ModelConfig, p) -> tuple[int, int]:
    """(query heads, KV heads) this rank holds: the whole padded grid on
    one device, its ``1/tp`` under TP."""
    hd = cfg.head_dim
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd


def _vo_project_v(vo: PlannedPair, src, policy) -> torch.Tensor:
    """V through a V->O fold: gather the input by P1, run the folded
    quantized up GEMM, cast to the input's dtype.  The output channels
    are permuted within each KV-head block, which ``vo.down``'s sorted
    rows expect."""
    xin = src.index_select(-1, vo.p1_up) if vo.p1_up is not None else src
    return schemes.qmatmul(xin, vo.up, policy).to(src.dtype)


def _out_proj(p, out, group, vo: Optional[PlannedPair] = None,
              policy=None, dtype=None):
    """The output projection; under TP ``wo`` (or ``vo.down``) holds this
    rank's rows, so the product is a partial sum closed by a float32
    all-reduce.  Through a fold the result is cast to ``dtype``."""
    if vo is not None:
        return comm.raw_psum(schemes.qmatmul(out, vo.down, policy),
                             group).to(dtype)
    return comm.raw_psum(matmul(out, p["wo"]), group)


def attention_forward(cfg: ModelConfig, p, x, *, positions=None,
                      window=None, causal=True, attn_backend="xla",
                      group=None, vo: Optional[PlannedPair] = None,
                      policy: Optional[ExecutionPolicy] = None,
                      kv_x: Optional[torch.Tensor] = None):
    """Full-sequence attention (prefill, an encoder, cross-attention).

    ``attn_backend`` as in the reference's ``ParallelContext``: ``"xla"``
    is the einsum path (under the reference's name), ``"flash"`` the flash
    kernel.  On the einsum path long causal self-attention (S >=
    ``Q_CHUNK_MIN_SEQ``, S a multiple of ``Q_CHUNK``) runs one Q chunk at
    a time: each chunk's softmax rows see the whole key range, so the
    result is the unchunked one, while the score tensor shrinks from
    (S, T) to (Q_CHUNK, T) (the reference's ``chunk_scan=False`` form).
    ``vo``: a V->O fold, whose GEMMs run under ``policy``.

    ``kv_x`` (B, T, d): the source sequence of cross-attention, which K
    and V are projected from.  Cross-attention takes no RoPE and no mask,
    and never the flash kernel or the Q chunks, as in the reference."""
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attn_backend {attn_backend!r}, expected "
                         f"one of {ATTN_BACKENDS}")
    cross = kv_x is not None
    src = kv_x if cross else x
    b, s, _ = x.shape
    t = src.shape[1]
    hd = cfg.head_dim
    h, kvh = _local_heads(cfg, p)
    q = matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = matmul(src, p["wk"]).reshape(b, t, kvh, hd)
    v = (_vo_project_v(vo, src, policy) if vo is not None
         else matmul(src, p["wv"])).reshape(b, t, kvh, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope and not cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if attn_backend == "flash" and not cross:
        return _out_proj(p, _flash_sdpa(q, k, v, causal=causal,
                                        window=window), group, vo, policy,
                         x.dtype)
    causal = causal and not cross

    def mask_rows(i0: int, rows: int):
        """The causal (and window) mask of query rows i0 .. i0 + rows."""
        if not causal:
            return None
        i = torch.arange(i0, i0 + rows, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        m = j <= i
        if window is not None:
            m = m & (j > i - window)
        return m.expand(b, rows, s)

    if causal and s >= Q_CHUNK_MIN_SEQ and s % Q_CHUNK == 0:
        out = torch.cat([_sdpa(q[:, i0:i0 + Q_CHUNK], k, v,
                               mask_rows(i0, Q_CHUNK))
                         for i0 in range(0, s, Q_CHUNK)], dim=1)
    else:
        out = _sdpa(q, k, v, mask_rows(0, s))
    return _out_proj(p, out, group, vo, policy, x.dtype)


def attention_decode(cfg: ModelConfig, p, x, cache, pos, *, window=None,
                     group=None, pages=None, kv_len=None,
                     vo: Optional[PlannedPair] = None,
                     policy: Optional[ExecutionPolicy] = None):
    """One-token decode over a dense KV cache or a page pool.

    x: (B, 1, d); cache: {"k", "v": (B, C, KV, D)}; pos: an int (all rows
    in lockstep) or a (B,) tensor of per-slot positions.  The new token's
    K/V are written **in place** into ``cache`` (the reference returns a
    new cache; updating in place keeps one copy on the card, and is the
    counterpart of the reference's ``donate_argnums``).  Returns
    (out, cache).

    ``pages``: (B, Pmax) per-slot page table; ``cache`` is then one
    layer's page pool {"k","v": (N_pages, page_size, KV, D)} (plus
    scale/zero leaves for quantized pages; ``cache/paged.py``).  The token
    scatters into ``(pages[b, pos // ps], pos % ps)``, then the first
    ``kv_len`` positions (the dense cache's capacity, the engine's
    ``max_seq``; required with ``pages``) are gathered back and masked
    ``j <= pos``: an fp pool gives the dense step's bits.  A paged step
    takes per-slot positions and no window, as the reference's does.

    The per-slot path builds nothing on the host and never reads a
    position back, so a CUDA graph can hold it (``Engine.decode``); the
    lockstep path bakes ``int(pos)`` into the step and is run eagerly.
    Both give the same bits for the same positions.

    ``vo``: a V->O fold, whose GEMMs run under ``policy``; the folded V
    channels are what the cache holds.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    h, kvh = _local_heads(cfg, p)
    per_slot = torch.is_tensor(pos) and pos.dim() == 1

    q = matmul(x, p["wq"]).reshape(b, 1, h, hd)
    k = matmul(x, p["wk"]).reshape(b, 1, kvh, hd)
    v = (_vo_project_v(vo, x, policy) if vo is not None
         else matmul(x, p["wv"])).reshape(b, 1, kvh, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        # (B, 1) on both paths: rope broadcasts them alike, so a lockstep
        # step gives the bits of the same step on per-slot positions
        posv = (pos[:, None] if per_slot
                else torch.full((b, 1), int(pos), device=x.device))
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)

    if pages is not None:
        from repro_torch.cache import paged as paged_pool

        if window is not None:
            raise ValueError("paged decode does not take a ring-buffer "
                             "window (windowed caches are fixed-size per "
                             "slot and stay dense)")
        if not per_slot:
            raise ValueError("paged decode requires per-slot (B,) "
                             "positions (the page table is per slot)")
        if kv_len is None:
            raise ValueError("paged decode requires kv_len (the dense "
                             "capacity the gather returns)")
        paged_pool.scatter_token(cache, k[:, 0], v[:, 0], pages, pos)
        cap = kv_len
        kk, vv = paged_pool.gather(cache, pages, cap)   # (B, cap, KV, D)
        valid = torch.arange(cap, device=x.device)[None, :] <= pos[:, None]
        mask = valid[:, None, :].expand(b, 1, cap)
        out = row_stable(_sdpa_decode, q, kk.to(x.dtype), vv.to(x.dtype),
                         mask)
        return _out_proj(p, out, group, vo, policy, x.dtype), cache

    ck, cv = cache["k"], cache["v"]
    cap = ck.shape[1]
    slot = pos % cap if window is not None else pos
    if per_slot:
        rows = torch.arange(b, device=x.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
    else:
        ck[:, int(slot)] = k[:, 0].to(ck.dtype)
        cv[:, int(slot)] = v[:, 0].to(cv.dtype)

    j = torch.arange(cap, device=x.device)[None, :]
    pb = (pos[:, None] if per_slot
          else torch.full((1, 1), int(pos), device=x.device))
    valid = j <= pb
    if window is not None:
        # ring buffer: once pos >= cap every slot holds a live position
        valid = valid | (pb >= cap)
    mask = valid[:, None, :].expand(b, 1, cap)
    out = row_stable(_sdpa_decode, q, ck.to(x.dtype), cv.to(x.dtype), mask)
    return _out_proj(p, out, group, vo, policy, x.dtype), cache


def cross_attention_decode(cfg: ModelConfig, p, x, k, v, *, group=None):
    """One query a row against precomputed cross K/V (the audio and vision
    families' decode): x (B, 1, d) the normed residual; k/v (B, T, KV, D),
    this rank's KV heads, cast to ``x``'s dtype as the reference casts
    them; no mask (every source position is valid).  Under TP ``wo`` holds
    this rank's rows and the product closes with the all-reduce that
    closes self-attention.  Returns (B, 1, d)."""
    b = x.shape[0]
    h, _ = _local_heads(cfg, p)
    q = matmul(x, p["wq"]).reshape(b, 1, h, cfg.head_dim)
    # a fill on the card, not a host tensor: a CUDA graph can hold it
    mask = torch.ones((b, 1, k.shape[1]), dtype=torch.bool, device=x.device)
    out = row_stable(_sdpa_decode, q, k.to(x.dtype), v.to(x.dtype), mask)
    return _out_proj(p, out, group)


def init_kv_cache(cfg: ModelConfig, num_layers: int, batch: int,
                  seq_len: int, *, window=None, dtype=torch.bfloat16,
                  device=None, tp: int = 1) -> dict:
    """Layer-stacked dense cache of this rank's KV heads:
    {"k", "v": (L, B, C, KVp / tp, D)}."""
    cap = min(seq_len, window) if window else seq_len
    kvp, _, _ = head_grid(cfg)
    shape = (num_layers, batch, cap, kvp // tp, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_layers: int, n_pages: int,
                        page_size: int, *, bits=None, dtype=torch.bfloat16,
                        device=None, tp: int = 1) -> dict:
    """Layer-stacked page pool of this rank's KV heads, replacing
    ``init_kv_cache``'s dense rows: leaves (L, N_pages, page_size,
    KVp / tp, D) — see ``cache/paged.py``."""
    from repro_torch.cache import paged as paged_pool

    kvp, _, _ = head_grid(cfg)
    return paged_pool.init_pool((num_layers,), n_pages, page_size, kvp // tp,
                                cfg.head_dim, dtype=dtype, bits=bits,
                                device=device)


# ---------------------------------------------------------------------------
# MLP (the paper's subject)
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig, gen: torch.Generator, *,
               d_ff: Optional[int] = None) -> dict:
    """One layer's raw fp MLP weights (the plan compiler quantizes them);
    ``d_ff`` (default ``cfg.d_ff``): an MoE expert's width."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, (d, ff)), "w_down": dense_init(gen, (ff, d))}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (d, ff))
    return p


def mlp_forward(cfg: ModelConfig, p, x, policy: ExecutionPolicy, *,
                activation=None, group=None, path="layers.mlp"):
    """Apply an MLP block: a quantized ``PlannedPair`` or raw weights.

    Under TP the pair runs ``pair_forward_tp`` on this rank's shard, with
    the collective ``policy.collective`` resolves for ``path``.  A
    scattering collective (``psum_scatter``) leaves each rank its shard
    of the output; as the reference's replicated residual stream does
    under GSPMD, the shards are then all-gathered."""
    act = activation or cfg.activation
    if isinstance(p, PlannedPair):
        lead = x.shape[:-1]
        y = p.forward(x.reshape(-1, x.shape[-1]), policy, group,
                      activation=act, pair_path=path)
        if group is not None and comm.scatters_output(
                policy.collective.resolve(path)):
            y = comm.all_gather_cols(y, group)
        return y.reshape(*lead, -1).to(x.dtype)
    a = schemes.ACTIVATIONS[act]
    h = matmul(x, p["w_up"])
    h = a(matmul(x, p["w_gate"])) * h if "w_gate" in p else a(h)
    return comm.raw_psum(matmul(h, p["w_down"]), group)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    v, vp = cfg.vocab_size, cfg.padded_vocab()
    emb = dense_init(gen, (v, cfg.d_model), 1.0)
    head = dense_init(gen, (cfg.d_model, v))
    if vp != v:
        emb = torch.nn.functional.pad(emb, (0, 0, 0, vp - v))
        head = torch.nn.functional.pad(head, (0, vp - v))
    return {"embedding": emb, "lm_head": head}


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor, *,
                 group=None) -> torch.Tensor:
    """Look the tokens up.  Under TP the table is split by vocab rows: each
    rank looks up the tokens it holds, zeros elsewhere, and an all-reduce
    adds the exact rows; or, where the vocab does not divide the ranks,
    by ``d_model`` columns: each rank looks up its columns and an
    all-gather joins them."""
    emb = p["embedding"]
    if emb.shape[1] != cfg.d_model:                 # d_model columns split
        x = comm.all_gather_cols(emb[tokens], group)
    elif emb.shape[0] != cfg.padded_vocab():        # vocab rows split
        rows = emb.shape[0]
        local = tokens - comm.axis_index(group) * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], emb[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=emb.dtype, device=emb.device))
        x = comm.raw_psum(x, group)
    else:
        x = emb[tokens]
    return x.to(torch.bfloat16) if cfg.dtype == "bfloat16" else x


def lm_head(cfg: ModelConfig, p, x: torch.Tensor, *,
            group=None) -> torch.Tensor:
    """Logits over the padded vocab.  Under TP the head is split by vocab
    columns and the logit shards are all-gathered; or, where the vocab
    does not divide the ranks, by ``d_model`` rows: each rank multiplies
    its slice of ``x`` and an all-reduce sums the whole logits."""
    head = p["lm_head"].to(torch.float32)
    x = x.to(torch.float32)
    if head.shape[0] != cfg.d_model:                # d_model rows split
        rows = head.shape[0]
        r = comm.axis_index(group)
        logits = comm.raw_psum(matmul(x[..., r * rows:(r + 1) * rows],
                                      head), group)
    else:
        logits = comm.all_gather_cols(matmul(x, head), group)
    v, vp = cfg.vocab_size, cfg.padded_vocab()
    if vp != v:
        # padded vocab columns: exp(-1e30) == 0, softmax stays exact
        logits[..., v:] += -1e30
    return logits


# ---------------------------------------------------------------------------
# TP sharding: per leaf, the dim split over the ranks (None: replicated)
# ---------------------------------------------------------------------------

def norm_specs(p: dict) -> dict:
    return {k: None for k in p}


def attention_specs(cfg: ModelConfig, p: dict, tp: int) -> dict:
    """Q/K/V split by columns (whole heads), the output projection by
    rows; the qk norms replicated."""
    kvp, _, hp = head_grid(cfg)
    if hp % tp or kvp % tp:
        raise ValueError(f"{cfg.arch_id}: {hp} query and {kvp} KV heads "
                         f"do not split over tp={tp} ranks")
    spec = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    return {k: spec.get(k) for k in p}


def embed_specs(cfg: ModelConfig, tp: int) -> dict:
    """The reference's ``embed_specs``: split by vocab when the padded
    vocab divides the ranks, else by ``d_model`` (embedding columns,
    ``lm_head`` rows), which closes the head with an all-reduce of the
    whole logits."""
    if cfg.padded_vocab() % tp == 0:
        return {"embedding": 0, "lm_head": 1}
    return {"embedding": 1, "lm_head": 0}


def _pair_specs(pp: PlannedPair, lead: int = 0) -> PlannedPair:
    """Column-TP up/gate (dim 1), row-TP down (dim 0; the naive layout's
    metadata replicated, its ``g_idx`` split), ``p1`` replicated, ``p2``
    split: the slices ``reorder.shard_pair`` takes; each dim after
    ``lead`` stacking dims."""
    def col(ql):
        return QuantizedLinear(qweight=lead + 1, scales=lead + 1,
                               zeros=lead + 1, g_idx=None,
                               group_size=ql.group_size, kind=ql.kind)

    def row(ql):
        naive = ql.kind == "naive"
        return QuantizedLinear(qweight=lead, scales=None if naive else lead,
                               zeros=None if naive else lead,
                               g_idx=lead if naive else None,
                               group_size=ql.group_size, kind=ql.kind)

    return PlannedPair(up=col(pp.up),
                       gate=col(pp.gate) if pp.gate is not None else None,
                       down=row(pp.down), p1_up=None, p1_gate=None, p2=lead,
                       scheme=pp.scheme)


def mlp_specs(p, lead: int = 0) -> object:
    """TP specs of one MLP (a pair or raw weights), or, with ``lead``
    stacking dims kept whole (an MoE layer's experts, ``(E, ...)``), of
    a stack of them: the reference's ``mlp_specs(..., lead=)``."""
    if isinstance(p, PlannedPair):
        return _pair_specs(p, lead)
    return {k: lead + (0 if k == "w_down" else 1) for k in p}
