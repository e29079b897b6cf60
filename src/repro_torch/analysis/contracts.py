"""Contract lint: the collective strategies and the model families
against the dtype and shape contracts the serving stack relies on; port
of ``repro/analysis/contracts.py``.

The reference traces everything under ``jax.eval_shape`` and spends no
FLOPs.  Torch has no tracer over process groups, so the port runs the
programs, at sizes where that costs next to nothing:

* CT002: at TP=1 (one process, no group) every spec's strategy returns
  its ``(8, 256)`` partial sum unchanged (shape, dtype and values), in a
  float32 and a bfloat16 stream, and its analytic ``bytes_on_wire`` is
  exactly 0.
* CT001: at each TP degree above 1, one ``launch/mesh.py`` run of that
  many rank processes applies every spec to a ``(8, 256)`` partial sum
  of each stream dtype (a few KB on the wire a call: the cost is the
  ranks' start-up); each rank's result must have the stream's dtype and
  the contracted shape (the whole width, or for a scattering strategy
  the rank's ``256 / tp`` columns).  The ranks are CPU processes under
  gloo on the CPU, and on the card the ranks sharing it over gloo, as
  the serve path's tp=2 runs.
* CT003: per registered family with a paged cache, the dense and paged
  caches, built on the ``meta`` device (shapes and dtypes, no memory),
  end in the family's ``(kv_heads, head_dim)`` and hold one payload
  dtype.
* CT004: per registered family, the smoke config's model (its plan
  compiled from seed 0 on the device) runs a forward of a ``(2, 16)``
  batch and one decode step; both emit float32 logits of the batch's
  shape.

With ``specs=None`` the collective checks sweep every registered
strategy plus the ``:overlap`` quant variants; ``serve verify`` passes
the specs an artifact's plan resolves instead.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.device import DeviceLike, resolve_device

#: the residual-stream dtypes the collective contract must preserve
STREAM_DTYPES = ("float32", "bfloat16")

#: (rows, cols) of the partial sum the collectives close; cols divides
#: by every TP degree up to 8 (and tp * 8 for packed int4)
PROBE_SHAPE = (8, 256)

#: seconds a TP degree's probe ranks may take, start-up included
PROBE_TIMEOUT = 300.0


def _default_specs() -> list:
    from repro_torch.comm import dispatch as comm_dispatch
    from repro_torch.comm.spec import CollectiveSpec

    out = [CollectiveSpec.parse(n) for n in comm_dispatch.strategies()]
    out += [CollectiveSpec.parse("quant-int8:32:overlap"),
            CollectiveSpec.parse("quant-int4:32:overlap")]
    return out


def _partial(dtype: str, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(PROBE_SHAPE, generator=gen, device=device).to(
        getattr(torch, dtype))


def _apply(spec, y: torch.Tensor, group) -> torch.Tensor:
    from repro_torch.comm import dispatch as comm_dispatch
    from repro_torch.core.policy import ExecutionPolicy

    return comm_dispatch.apply(y, group, spec,
                               ExecutionPolicy(collective=spec))


def _probe_rank(ctx, shorts: list) -> list:
    """Inside each rank of a ``mesh.run``: every spec of ``shorts`` on a
    partial sum of each stream dtype; ``(short, dtype, shape, dtype name,
    error)`` per pair, the error a string where the call raised."""
    from repro_torch.comm.spec import CollectiveSpec

    out = []
    for short in shorts:
        spec = CollectiveSpec.parse(short)
        for dtype in STREAM_DTYPES:
            try:
                o = _apply(spec, _partial(dtype, ctx.device, ctx.rank),
                           ctx.group)
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                out.append((short, dtype, tuple(o.shape),
                            str(o.dtype).removeprefix("torch."), None))
            except Exception as e:  # noqa: BLE001 -- reported as a finding
                out.append((short, dtype, None, None,
                            f"{type(e).__name__}: {e}"))
    return out


def _lint_tp1(spec, device) -> list[Finding]:
    """CT002 for one spec."""
    short = spec.shorthand()
    out = []
    b1 = spec.bytes_on_wire(PROBE_SHAPE, 1)
    if b1 != 0.0:
        out.append(Finding(
            "CT002",
            f"bytes_on_wire at tp=1 is {b1}, not 0 — a single-rank "
            f"deployment would be billed for wire traffic",
            location=short, detail={"bytes": b1}))
    for dtype in STREAM_DTYPES:
        loc = f"{short}[{dtype}]"
        y = _partial(dtype, device, 0)
        try:
            o = _apply(spec, y, None)
        except Exception as e:  # noqa: BLE001 -- reported as a finding
            out.append(Finding("CT002", f"apply failed at tp=1: {e}",
                               location=loc))
            continue
        if (tuple(o.shape), o.dtype) != (PROBE_SHAPE, y.dtype):
            out.append(Finding(
                "CT002",
                f"tp=1 is not the identity: {dtype}{PROBE_SHAPE} -> "
                f"{str(o.dtype).removeprefix('torch.')}{tuple(o.shape)}",
                location=loc))
        elif not torch.equal(o, y):
            out.append(Finding(
                "CT002",
                f"tp=1 is not the identity: the values change (max "
                f"difference {(o.float() - y.float()).abs().max().item()})",
                location=loc))
    return out


def _lint_tp(specs, tp: int, device) -> list[Finding]:
    """CT001 for every spec at one TP degree, from one run of ``tp``
    rank processes."""
    from repro_torch.comm import dispatch as comm_dispatch
    from repro_torch.launch import mesh

    shorts = [s.shorthand() for s in specs]
    try:
        ranks = mesh.run(_probe_rank, tp, shorts, device_type=device.type,
                         timeout=PROBE_TIMEOUT)
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        return [Finding("CT001", f"the probe ranks failed: {e}",
                        location=f"@tp={tp}")]
    out, seen = [], set()
    scatters = {s.shorthand(): comm_dispatch.scatters_output(s)
                for s in specs}
    for results in ranks:
        for short, dtype, shape, got, err in results:
            loc = f"{short}[{dtype}]@tp={tp}"
            want = (PROBE_SHAPE[0], PROBE_SHAPE[1] // tp) if scatters[
                short] else PROBE_SHAPE
            if err is not None:
                found = [Finding("CT001", f"apply failed: {err}",
                                 location=loc)]
            else:
                found = []
                if got != dtype:
                    found.append(Finding(
                        "CT001",
                        f"collective returns {got}, not the residual "
                        f"stream's {dtype} — a wire dtype leaks into the "
                        f"caller", location=loc,
                        detail={"got": got, "want": dtype}))
                if shape != want:
                    found.append(Finding(
                        "CT001",
                        f"collective returns shape {shape} on a rank, "
                        f"contract says {want}", location=loc,
                        detail={"got": list(shape), "want": list(want)}))
            for f in found:
                if (f.location, f.message) not in seen:
                    seen.add((f.location, f.message))
                    out.append(f)
    return out


def lint_collectives(specs: Optional[Sequence] = None,
                     tps: Iterable[int] = (1, 2),
                     device: DeviceLike = None) -> list[Finding]:
    """CT002 at tp=1 and CT001 at every ``tp > 1`` of ``tps``, over every
    spec (shorthands or specs) and stream dtype, on ``device`` (default:
    the card)."""
    from repro_torch.comm.spec import CollectiveSpec

    dev = resolve_device(device)
    specs = (_default_specs() if specs is None
             else [CollectiveSpec.parse(s) for s in specs])
    out: list[Finding] = []
    tps = sorted(set(tps))
    if 1 in tps:
        for spec in specs:
            out += _lint_tp1(spec, dev)
    for tp in tps:
        if tp > 1:
            out += _lint_tp(specs, tp, dev)
    return out


# ---------------------------------------------------------------------------
# model-family contracts
# ---------------------------------------------------------------------------

def _family_smoke_cfgs() -> dict:
    """One smoke config per registered family (first matching arch)."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config

    seen = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        seen.setdefault(cfg.family, cfg)
    return seen


def _kv_geometry_leaves(tree, kvh: int, hd: int) -> list:
    """(key, leaf, ends in (kv_heads, head_dim)) of the floating payload
    leaves (ndim >= 4) of a cache tree."""
    from repro_torch.train.checkpoint import flatten_keys

    return [(key, t, tuple(t.shape[-2:]) == (kvh, hd))
            for key, t in sorted(flatten_keys(tree).items())
            if t.dim() >= 4 and t.dtype.is_floating_point]


def _lint_paged(model, cfg, batch: int, seq: int, loc: str
                ) -> list[Finding]:
    """CT003 for one family: the dense and paged caches on ``meta``."""
    from repro_torch.models import common as cm

    kvh, _, _ = cm.head_grid(cfg)
    hd = cfg.head_dim
    try:
        dense = model.init_cache(batch, seq, device="meta")
        paged = model.init_paged_cache(
            8, 8, device="meta", batch=batch if model.has_cross else None)
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        return [Finding("CT003", f"cache construction failed: {e}",
                        location=loc)]
    out = []
    dense_kv = _kv_geometry_leaves(dense, kvh, hd)
    paged_kv = _kv_geometry_leaves(paged, kvh, hd)
    for which, leaves in (("dense", dense_kv), ("paged", paged_kv)):
        for name, leaf, ok in leaves:
            if not ok:
                out.append(Finding(
                    "CT003",
                    f"{which} cache leaf {name} has trailing dims "
                    f"{tuple(leaf.shape[-2:])}, family geometry is "
                    f"({kvh}, {hd})", location=loc))
    d_dtypes = {str(leaf.dtype) for _, leaf, _ in dense_kv}
    p_dtypes = {str(leaf.dtype) for _, leaf, _ in paged_kv}
    if d_dtypes != p_dtypes:
        out.append(Finding(
            "CT003",
            f"dense cache payload dtypes {sorted(d_dtypes)} != paged "
            f"{sorted(p_dtypes)}", location=loc))
    return out


@torch.inference_mode()
def _lint_logits(model, cfg, batch: int, seq: int, dev, loc: str
                 ) -> list[Finding]:
    """CT004 for one family: a forward and one decode step."""
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.device import new_generator

    policy = ExecutionPolicy.from_config(cfg, device=dev)
    try:
        params = model.init(0, device=dev)
        inputs = model.make_batch(new_generator(0, dev), batch, seq)
        logits = model.forward(params, inputs, policy)
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        return [Finding("CT004", f"forward failed: {e}", location=loc)]
    out = []
    if logits.dtype != torch.float32:
        out.append(Finding(
            "CT004", f"forward logits are {logits.dtype}, not float32",
            location=loc, detail={"got": str(logits.dtype)}))
    if tuple(logits.shape) != (batch, seq, cfg.vocab_size):
        out.append(Finding(
            "CT004", f"forward logits shape {tuple(logits.shape)} != "
            f"{(batch, seq, cfg.vocab_size)}", location=loc))
    try:
        cache = model.init_cache(batch, seq, device=dev)
        dec, _ = model.decode_step(params, cache, inputs["tokens"][:, 0], 0,
                                   policy)
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        return out + [Finding("CT004", f"decode_step failed: {e}",
                              location=loc)]
    if dec.dtype != torch.float32:
        out.append(Finding(
            "CT004", f"decode logits are {dec.dtype}, not float32",
            location=loc, detail={"got": str(dec.dtype)}))
    if tuple(dec.shape) != (batch, cfg.vocab_size):
        out.append(Finding(
            "CT004", f"decode logits shape {tuple(dec.shape)} != "
            f"{(batch, cfg.vocab_size)}", location=loc))
    return out


def lint_families(batch: int = 2, seq: int = 16,
                  device: DeviceLike = None) -> list[Finding]:
    """CT003 + CT004 over every registered model family at smoke size, on
    ``device`` (default: the card)."""
    from repro_torch.models.registry import build_model

    dev = resolve_device(device)
    out: list[Finding] = []
    for family, cfg in sorted(_family_smoke_cfgs().items()):
        model = build_model(cfg)
        loc = f"{family}/{cfg.arch_id}"
        out += _lint_logits(model, cfg, batch, seq, dev, loc)
        if model.supports_paged:
            out += _lint_paged(model, cfg, batch, seq, loc)
    return out


def run(specs: Optional[Sequence] = None, tps: Iterable[int] = (1, 2),
        device: DeviceLike = None) -> list[Finding]:
    """Entry point the CLI calls: collective + family contracts."""
    return (lint_collectives(specs=specs, tps=tps, device=device)
            + lint_families(device=device))
