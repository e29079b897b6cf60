"""Collective dispatch: ``CollectiveSpec.name`` -> TP epilogue strategy;
port of ``repro/comm/dispatch.py`` on ``torch.distributed``.

Where the reference names a mesh axis inside ``shard_map``, the port
takes the process group of the tensor-parallel ranks (``None`` means one
rank: every strategy is then the identity).  This module is the only
place of the port that calls ``torch.distributed`` collectives.

Strategy contract (``y`` is this rank's full-width partial sum of the
row-TP output):

* ``apply(y, group, spec, policy) -> y`` runs the collective; the result
  has the input's dtype;
* ``apply_wire(wp, group, spec, policy)`` starts the quantized rings from
  a kernel-emitted ``WirePayload``;
* ``bytes_on_wire(shape, tp, spec)`` is the per-rank wire bytes under the
  ring model;
* ``scatters_output``: the result is this rank's shard of the last dim.

Strategies: ``psum`` (f32 all-reduce), ``psum_scatter`` (reduce-scatter),
``cast`` (all-reduce in a narrow wire dtype), ``quant-int8`` and
``quant-int4`` (the two-phase blockwise-quantized ring: quantize chunks,
``all_to_all``, dequantize and sum ranks 0..tp-1 in order in float32,
requantize the owned chunk, ``all_gather``), and ``none``.

The quantized ring runs in two halves: ``ring_start`` quantizes and posts
phase 1's all-to-alls without waiting (a ``PendingRing``),
``ring_finish`` waits for them and runs the rest.  Their ``apply`` calls
the two back to back; an ``:overlap`` spec changes nothing here, and the
down projection's epilogue (``dist/overlap.py``) holds one microbatch's
started ring across the next microbatch's GEMM.  The arithmetic is the
same either way.

Transport: on the CPU and under NCCL a tensor goes to the collective as
it is.  Under gloo with tensors on the card (several ranks sharing one
card, ``launch/mesh.py``), each payload is copied to host memory before
the gloo call and back after it, and gloo only carries it: the
all-reduce and the reduce-scatter become an all-gather and an
all-to-all whose results the card adds in rank order, so no arithmetic
moves to the host.

``all_to_all`` is the reference's tiled all-to-all over any group (the
MoE token shuffle over the data ranks), built on ``_all_to_all``.

``wire_bytes`` counts what each collective of this module hands to the
wire under the ring model, whatever carries it (the reference reads the same bytes out of
the compiled HLO): an all-reduce of B bytes over tp ranks moves
2 B (tp-1)/tp, an all-to-all or reduce-scatter of B bytes B (tp-1)/tp,
an all-gather of a B-byte shard B (tp-1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.comm.spec import CollectiveSpec
from repro_torch.core.quantization import (PACK, choose_group_size,
                                           pack_int4, unpack_int4)

_REGISTRY: dict[str, "CollectiveStrategy"] = {}


class WireBytes:
    """Bytes handed to the wire by this process's collective calls."""

    def __init__(self):
        self.total = 0.0

    def reset(self):
        self.total = 0.0

    def add(self, nbytes: float):
        self.total += nbytes


wire_bytes = WireBytes()


class CollectiveStrategy:
    """One named way to close a row-TP layer."""

    scatters_output: bool = False

    def apply(self, y: torch.Tensor, group, spec: CollectiveSpec,
              policy) -> torch.Tensor:
        raise NotImplementedError

    def apply_wire(self, wp, group, spec: CollectiveSpec, policy):
        raise NotImplementedError(
            f"collective {spec.name!r} does not accept a pre-quantized "
            f"wire payload")

    def bytes_on_wire(self, shape: tuple, tp: int,
                      spec: CollectiveSpec) -> float:
        raise NotImplementedError


def register(name: str):
    """Decorator: register a ``CollectiveStrategy`` subclass under
    ``name``."""
    def deco(cls):
        _REGISTRY[name] = cls()
        return cls

    return deco


def strategies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(name: str) -> CollectiveStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"no collective strategy registered for {name!r}; "
            f"registered strategies: {list(strategies())}") from None


def apply(y: torch.Tensor, group, spec: CollectiveSpec, policy=None):
    """Close a row-TP layer: run ``spec`` on this rank's partial sums."""
    return resolve(spec.name).apply(y, group, spec, policy)


def apply_wire(wp, group, spec: CollectiveSpec, policy=None):
    """Close a row-TP layer from a kernel-emitted ``WirePayload``: ring
    phase 1's quantize already ran in the GEMM, so the ring starts at the
    exchange."""
    return resolve(spec.name).apply_wire(wp, group, spec, policy)


def scatters_output(spec: CollectiveSpec) -> bool:
    return resolve(spec.name).scatters_output


def bytes_on_wire(spec: CollectiveSpec, shape, tp: int) -> float:
    return resolve(spec.name).bytes_on_wire(tuple(shape), int(tp), spec)


# ---------------------------------------------------------------------------
# transport: the only torch.distributed calls of the port
# ---------------------------------------------------------------------------

# torch renamed these two; the card's torch may have only the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def axis_size(group) -> int:
    """Ranks in ``group`` (1 for ``None``, a single rank)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank in ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _via_host(t: torch.Tensor, group) -> bool:
    """True when gloo serves a tensor that lives on the card (several ranks
    sharing one card): the payload then crosses through host memory, and
    gloo only carries it; every sum is done on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the collective takes it: contiguous, and in host memory
    when it crosses through the host."""
    if _via_host(t, group):
        return t.to("cpu").contiguous()
    return t.contiguous()


def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device)


def _gather_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new dim 0 in rank order."""
    tp = axis_size(group)
    buf = _to_wire(t, group).reshape(1, -1)
    out = buf.new_empty((tp, buf.shape[1]))
    _ALL_GATHER(out, buf, group=group)
    return _from_wire(out.reshape(tp, *t.shape), t)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``t``.  Through the host, an all-gather
    carries the ranks' tensors and the card adds them in rank order;
    the byte count stays the all-reduce's."""
    tp = axis_size(group)
    wire_bytes.add(2 * _nbytes(t) * (tp - 1) / tp)
    if _via_host(t, group):
        return _sum_ranks(_gather_ranks(t, group))
    buf = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf


def _all_to_all_post(t: torch.Tensor, group) -> tuple:
    """Post ``_all_to_all`` of ``t`` without waiting: (its work, the send
    and the receive buffer, both on the wire's side)."""
    tp = axis_size(group)
    wire_bytes.add(_nbytes(t) * (tp - 1) / tp)
    buf = _to_wire(t, group)
    out = torch.empty_like(buf)
    return dist.all_to_all_single(out, buf, group=group,
                                  async_op=True), buf, out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 (of size tp) split across ranks: rank j receives every rank's
    slice j, stacked in rank order (the reference's tiled ``all_to_all``
    with split and concat axis 0)."""
    work, _, out = _all_to_all_post(t, group)
    work.wait()
    return _from_wire(out, t)


def _all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last dim in rank order."""
    tp = axis_size(group)
    wire_bytes.add(_nbytes(t) * (tp - 1))
    return _gather_ranks(t, group).movedim(0, -2).reshape(
        *t.shape[:-1], tp * t.shape[-1])


def _reduce_scatter_last(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``t``, of which this rank keeps its tiled
    shard of the last dim.  Through the host, an all-to-all carries the
    shards and the card adds them in rank order (the same bytes)."""
    tp = axis_size(group)
    n = t.shape[-1]
    if n % tp:
        raise ValueError(f"psum_scatter needs the last dim {n} to divide "
                         f"tp={tp}")
    chunks = t.reshape(*t.shape[:-1], tp, n // tp).movedim(-2, 0)
    if _via_host(t, group):
        return _sum_ranks(_all_to_all(chunks, group))
    wire_bytes.add(_nbytes(t) * (tp - 1) / tp)
    buf = chunks.contiguous()                   # rank chunks along dim 0
    out = buf.new_empty((1, buf[0].numel()))
    _REDUCE_SCATTER(out, buf.reshape(tp, -1), group=group)
    return out.reshape(buf.shape[1:])


# ---------------------------------------------------------------------------
# raw-primitive facade (scheme and model code call these, never
# torch.distributed)
# ---------------------------------------------------------------------------

def raw_psum(y: torch.Tensor, group) -> torch.Tensor:
    """Full-precision all-reduce outside the strategy registry (the
    attention output projection, the vocab-sharded embedding, the
    ``d_model``-split head's logits)."""
    return y if axis_size(group) == 1 else _all_reduce(y, group)


def raw_psum_scatter(y: torch.Tensor, group) -> torch.Tensor:
    """Full-precision reduce-scatter outside the strategy registry: the
    sum over ranks of ``y``, of which this rank keeps its tiled shard of
    the last dim (recurrentgemma's row-split gate products)."""
    return y if axis_size(group) == 1 else _reduce_scatter_last(y, group)


def all_gather_cols(y: torch.Tensor, group) -> torch.Tensor:
    """Gather last-dim shards into the full tensor (the exllama scheme's
    Algorithm-2 gather, the column-sharded logits)."""
    return y if axis_size(group) == 1 else _all_gather_last(y, group)


def all_to_all(x: torch.Tensor, group, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` (the MoE token shuffle over
    the data ranks): ``x`` is cut into ``D`` equal parts along
    ``split_axis``, part ``j`` goes to rank ``j``, and the parts received
    are joined along ``concat_axis`` in rank order."""
    d = axis_size(group)
    if d == 1:
        return x
    n = x.shape[split_axis]
    if n % d:
        raise ValueError(f"dim {split_axis} of size {n} does not split "
                         f"over {d} ranks")
    parts = x.unflatten(split_axis, (d, n // d)).movedim(split_axis, 0)
    got = _all_to_all(parts.contiguous(), group)
    got = got.movedim(0, concat_axis)
    return got.flatten(concat_axis, concat_axis + 1)


# ---------------------------------------------------------------------------
# quantizers of the compressed rings
# ---------------------------------------------------------------------------

def _full_bytes(shape, dtype) -> float:
    return math.prod(shape) * dtype.itemsize


def _wire_dtype(spec: CollectiveSpec):
    return spec.wire_dtype if spec.wire_dtype is not None else torch.float32


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor filled on ``like``'s device (no host
    copy, so a CUDA graph can capture it): dividing by it is an IEEE
    division on the card too (a Python-scalar divisor makes torch
    multiply by its reciprocal there)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _blockwise_quantize(v: torch.Tensor, bs: int):
    """Symmetric int8 quantization over size-``bs`` blocks of the last dim:
    ``(q int8 of v's shape, scales float16 (..., n // bs))``."""
    vb = v.reshape(*v.shape[:-1], v.shape[-1] // bs, bs)
    s = vb.abs().amax(dim=-1) / _const(vb, 127.0)
    s = torch.clamp(s, min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(vb / s[..., None]), -127, 127).to(torch.int8)
    return q.reshape(v.shape), s.to(torch.float16)


def _blockwise_dequantize(q: torch.Tensor, s: torch.Tensor,
                          bs: int) -> torch.Tensor:
    qb = q.reshape(*q.shape[:-1], q.shape[-1] // bs, bs).to(torch.float32)
    return (qb * s.to(torch.float32)[..., None]).reshape(q.shape)


def _pack4_last(q: torch.Tensor) -> torch.Tensor:
    """Pack ints in [0, 15] along the last dim in the weights'
    ``pack_int4`` layout (8 nibbles per int32 word):
    (..., n) -> (..., n // 8)."""
    moved = q.movedim(-1, 0)
    packed = pack_int4(moved.reshape(moved.shape[0], -1))
    return packed.reshape(moved.shape[0] // PACK,
                          *moved.shape[1:]).movedim(0, -1)


def _unpack4_last(qp: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack4_last``: (..., n // 8) -> (..., n) int32."""
    moved = qp.movedim(-1, 0)
    vals = unpack_int4(moved.reshape(moved.shape[0], -1))
    return vals.reshape(moved.shape[0] * PACK,
                        *moved.shape[1:]).movedim(0, -1)


def _blockwise_quantize_int4(v: torch.Tensor, bs: int):
    """Asymmetric int4 over size-``bs`` blocks of the last dim (the weight
    quantizer's min/max form): ``(q int32 in [0, 15] of v's shape, scales
    float16, zeros float16)``."""
    vb = v.reshape(*v.shape[:-1], v.shape[-1] // bs, bs)
    vmax = torch.clamp(vb.amax(dim=-1), min=0.0)
    vmin = torch.clamp(vb.amin(dim=-1), max=0.0)
    s = (vmax - vmin) / _const(vb, 15.0)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    z = torch.clamp(torch.round(-vmin / s), 0, 15)
    q = torch.clamp(torch.round(vb / s[..., None] + z[..., None]), 0, 15)
    return (q.to(torch.int32).reshape(v.shape), s.to(torch.float16),
            z.to(torch.float16))


def _blockwise_dequantize_int4(q: torch.Tensor, s: torch.Tensor,
                               z: torch.Tensor, bs: int) -> torch.Tensor:
    qb = q.reshape(*q.shape[:-1], q.shape[-1] // bs, bs).to(torch.float32)
    s32 = s.to(torch.float32)[..., None]
    z32 = z.to(torch.float32)[..., None]
    return ((qb - z32) * s32).reshape(q.shape)


def _sum_ranks(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ... + parts[tp-1]``, in that order."""
    red = parts[0]
    for i in range(1, parts.shape[0]):
        red = red + parts[i]
    return red


def _chunked(y: torch.Tensor, tp: int, pad_to: int, bs_pref: int):
    """``y`` in float32, zero-padded to a multiple of ``pad_to``, as
    ``(tp, ..., chunk)`` chunks, with the quant block."""
    n = y.shape[-1]
    y32 = y.to(torch.float32)
    pad = (-n) % pad_to
    if pad:
        y32 = F.pad(y32, (0, pad))
    chunk = (n + pad) // tp
    bs = choose_group_size(chunk, bs_pref)
    return y32.reshape(*y32.shape[:-1], tp, chunk).movedim(-2, 0), bs


def _wire_chunks(t: torch.Tensor, tp: int) -> torch.Tensor:
    """A flat (..., w) wire tensor as (tp, ..., w // tp) chunks."""
    return t.reshape(*t.shape[:-1], tp,
                     t.shape[-1] // tp).movedim(-2, 0).contiguous()


def _check_wire(wp, group, spec, bits):
    tp = axis_size(group)
    if tp == 1 or tp != wp.tp or wp.bits != bits:
        raise ValueError(f"wire payload (tp={wp.tp}, bits={wp.bits}) does "
                         f"not fit a {tp}-rank {spec.name} ring")
    return tp


def _unpad(out: torch.Tensor, n: int) -> torch.Tensor:
    return out[..., :n] if out.shape[-1] != n else out


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

@register("psum")
class _Psum(CollectiveStrategy):
    """Full-precision all-reduce."""

    def apply(self, y, group, spec, policy):
        return raw_psum(y, group)

    def bytes_on_wire(self, shape, tp, spec):
        return _full_bytes(shape, _wire_dtype(spec)) * 2 * (tp - 1) / tp


@register("psum_scatter")
class _PsumScatter(CollectiveStrategy):
    """Reduce-scatter along the output dim: each rank keeps its shard (half
    the wire bytes of an all-reduce)."""

    scatters_output = True

    def apply(self, y, group, spec, policy):
        return raw_psum_scatter(y, group)

    def bytes_on_wire(self, shape, tp, spec):
        return _full_bytes(shape, _wire_dtype(spec)) * (tp - 1) / tp


@register("cast")
class _Cast(CollectiveStrategy):
    """All-reduce in the wire dtype (default bf16), cast back to the
    input's dtype."""

    def apply(self, y, group, spec, policy):
        if axis_size(group) == 1:
            return y
        return _all_reduce(y.to(spec.wire_dtype), group).to(y.dtype)

    def bytes_on_wire(self, shape, tp, spec):
        return _full_bytes(shape, spec.wire_dtype) * 2 * (tp - 1) / tp


@register("none")
class _NoCollective(CollectiveStrategy):
    """No collective: this rank's partial sums."""

    def apply(self, y, group, spec, policy):
        return y

    def bytes_on_wire(self, shape, tp, spec):
        return 0.0


@dataclasses.dataclass
class PendingRing:
    """A quantized ring whose phase 1 (one all-to-all per payload part) is
    posted and not yet waited for (``ring_start``; ``ring_finish`` closes
    it)."""

    strategy: "_QuantRing"
    group: Any
    works: tuple            # the posted all-to-alls
    sends: tuple            # their buffers, held until they complete
    recvs: tuple
    device: torch.device    # where the payload was made and is summed
    bs: int
    n: int                  # logical output width (before padding)
    out_dtype: Any

    def in_flight(self) -> bool:
        """True while a part of phase 1 has not completed."""
        return not all(w.is_completed() for w in self.works)

    def wait(self) -> None:
        """Block until phase 1 has landed (a no-op once it has)."""
        for w in self.works:
            w.wait()


class _QuantRing(CollectiveStrategy):
    """The two-phase quantized ring.  A width that does not tile
    ``tp * pack`` is zero-padded on the wire and sliced after."""

    bits: int
    pack: int               # elements of one wire word

    def _quantize(self, v: torch.Tensor, bs: int) -> tuple:
        raise NotImplementedError

    def _dequantize(self, parts: tuple, bs: int) -> torch.Tensor:
        raise NotImplementedError

    def _post(self, parts, group, *, bs, n, out_dtype, device):
        posted = [_all_to_all_post(t, group) for t in parts]
        return PendingRing(self, group, *map(tuple, zip(*posted)),
                           device=device, bs=bs, n=n, out_dtype=out_dtype)

    def start(self, y, group, spec) -> PendingRing:
        """Quantize this rank's partial ``y`` and post phase 1."""
        yc, bs = _chunked(y, axis_size(group), axis_size(group) * self.pack,
                          spec.block_size)
        return self._post(self._quantize(yc, bs), group, bs=bs,
                          n=y.shape[-1], out_dtype=y.dtype, device=y.device)

    def start_wire(self, wp, group, spec) -> PendingRing:
        """Post phase 1 of a kernel-emitted ``WirePayload``."""
        tp = _check_wire(wp, group, spec, self.bits)
        parts = (wp.payload, wp.scales) + (
            (wp.zeros,) if self.bits == 4 else ())
        return self._post(tuple(_wire_chunks(t, tp) for t in parts), group,
                          bs=wp.block, n=wp.n, out_dtype=wp.out_dtype,
                          device=wp.payload.device)

    def finish(self, pend: PendingRing) -> torch.Tensor:
        """Wait for phase 1, dequantize and sum the ranks' chunks in rank
        order, requantize the owned chunk, all-gather and dequantize."""
        pend.wait()
        got = tuple(b.to(pend.device) for b in pend.recvs)
        red = _sum_ranks(self._dequantize(got, pend.bs))
        gathered = tuple(_all_gather_last(t, pend.group)
                         for t in self._quantize(red, pend.bs))
        out = self._dequantize(gathered, pend.bs)
        return _unpad(out, pend.n).to(pend.out_dtype)

    def apply(self, y, group, spec, policy):
        if axis_size(group) == 1:
            return y
        return self.finish(self.start(y, group, spec))

    def apply_wire(self, wp, group, spec, policy):
        return self.finish(self.start_wire(wp, group, spec))


def _quant_ring(spec: CollectiveSpec) -> _QuantRing:
    strategy = resolve(spec.name)
    if not isinstance(strategy, _QuantRing):
        raise ValueError(f"{spec.name!r} is not a quantized ring")
    return strategy


def ring_start(y: torch.Tensor, group, spec: CollectiveSpec) -> PendingRing:
    """Quantize ``y`` and post the ring's phase 1 (``spec`` names
    ``quant-int8`` or ``quant-int4``)."""
    return _quant_ring(spec).start(y, group, spec)


def ring_start_wire(wp, group, spec: CollectiveSpec) -> PendingRing:
    """Post the ring's phase 1 of a kernel-emitted ``WirePayload``."""
    return _quant_ring(spec).start_wire(wp, group, spec)


def ring_finish(pend: PendingRing) -> torch.Tensor:
    """Close a started ring; the result is ``apply``'s."""
    return pend.strategy.finish(pend)


@register("quant-int8")
class _QuantInt8(_QuantRing):
    """Blockwise-int8 two-phase ring: int8 payloads plus float16 scales on
    both phases."""

    bits, pack = 8, 1

    def _quantize(self, v, bs):
        return _blockwise_quantize(v, bs)

    def _dequantize(self, parts, bs):
        return _blockwise_dequantize(*parts, bs)

    def bytes_on_wire(self, shape, tp, spec):
        if tp <= 1:
            return 0.0
        n_pad = shape[-1] + (-shape[-1]) % tp
        n_elts = math.prod(shape[:-1]) * n_pad
        bs = choose_group_size(n_pad // tp, spec.block_size)
        payload = n_elts * 1 + (n_elts / bs) * 2   # int8 + f16 scales
        return 2 * payload * (tp - 1) / tp


@register("quant-int4")
class _QuantInt4(_QuantRing):
    """Blockwise-int4 two-phase ring: the payload nibble-packed as the
    weights are, plus a float16 (scale, zero) pair per block."""

    bits, pack = 4, PACK

    def _quantize(self, v, bs):
        q, s, z = _blockwise_quantize_int4(v, bs)
        return _pack4_last(q), s, z

    def _dequantize(self, parts, bs):
        qp, s, z = parts
        return _blockwise_dequantize_int4(_unpack4_last(qp), s, z, bs)

    def bytes_on_wire(self, shape, tp, spec):
        if tp <= 1:
            return 0.0
        n = shape[-1]
        n_pad = n + (-n) % (tp * PACK)
        n_elts = math.prod(shape[:-1]) * n_pad
        bs = choose_group_size(n_pad // tp, spec.block_size)
        payload = n_elts * 0.5 + (n_elts / bs) * 4  # nibbles + f16 s, z
        return 2 * payload * (tp - 1) / tp
