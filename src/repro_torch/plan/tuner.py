"""Collective autotuner: a per-layer ``CollectivePlan`` chosen offline;
port of ``repro/plan/tuner.py``.

For every pair site the compiler planned (``pair_meta``), and every V->O
attention fold, ``autotune_collectives`` scores each registered
full-output collective with

* its analytic wire bytes per token (``CollectiveSpec.bytes_on_wire``),
* a measured activation error: the site's layer-0 pair is split into
  per-rank shards (``reorder.shard_pair``), calibration rows run through
  each rank's local forward (``pair_forward_reference`` gives a rank's
  partial sums), and the wire is simulated with ``comm/dispatch.py``'s
  own blockwise quantizers (``simulate_wire``), so no ranks are needed,

then picks the cheapest collective whose relative error stays within
``budget``, and marks a quantized choice ``:fused`` where the wire
kernel can serve the site's down GEMM (``kernels.dispatch.wire_support``),
and, with ``overlap=True``, a quantized pair choice ``:overlap`` (the
ring pipelined against the down GEMM, ``dist/overlap.py``: the same
numerics and wire bytes, so the scores carry over).
The report records every candidate's score, the choice and why a site
may or may not be fused; the artifact's manifest keeps it as
``collective_tuner``.

The fold sites (``kind: "attn_vo"``) are probed as the reference probes
them and join the plan under their path, never fused.  The port closes
attention's output projection by a float32 all-reduce
(``models/common.py``), as the reference closes it through GSPMD, so
their entry is recorded and not applied.

The reference draws each site's calibration rows with ``jax.random``;
the port draws them from a ``torch.Generator``, or takes them by site
path (tests pass the reference's).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.comm import dispatch as comm_dispatch
from repro_torch.comm.spec import CollectivePlan, CollectiveSpec
from repro_torch.core import reorder, schemes
from repro_torch.core.quantization import choose_group_size
from repro_torch.device import new_generator
from repro_torch.train.checkpoint import map_tensors

#: default max relative activation error a tuned collective may introduce
DEFAULT_BUDGET = 0.05

#: seed part separating the tuner's calibration stream from the quantize
#: and attention-fold streams
TUNE_RNG_STREAM = 0x54554E45  # "TUNE"


def candidate_specs() -> tuple[CollectiveSpec, ...]:
    """Every registered full-output collective (``none`` and scattering
    strategies change the epilogue's output and are not candidates)."""
    out = []
    for name in comm_dispatch.strategies():
        spec = CollectiveSpec.parse(name)
        if name == "none" or comm_dispatch.scatters_output(spec):
            continue
        out.append(spec)
    return tuple(out)


def simulate_wire(partials, spec: CollectiveSpec) -> torch.Tensor:
    """``partials`` (the ``tp`` ranks' float32 partial sums, (m, n) each)
    closed as ``comm.dispatch`` closes them: phase 1 rounds each rank's
    contribution once, phase 2 the re-quantized reduction once, with the
    strategies' own blockwise quantizers."""
    tp = len(partials)
    if spec.name in ("psum", "psum_scatter", "none") or tp == 1:
        return sum(partials[1:], partials[0])
    n = partials[0].shape[-1]
    if spec.name == "cast":
        # the all-reduce accumulates in the wire dtype on the wire
        acc = partials[0].to(spec.wire_dtype)
        for p in partials[1:]:
            acc = (acc + p.to(spec.wire_dtype)).to(spec.wire_dtype)
        return acc.to(partials[0].dtype)
    pad_to = tp * (8 if spec.bits == 4 else 1)
    bs = choose_group_size((n + (-n) % pad_to) // tp, spec.block_size)
    if spec.name == "quant-int8":
        def roundtrip(v):
            q, s = comm_dispatch._blockwise_quantize(v, bs)
            return comm_dispatch._blockwise_dequantize(q, s, bs)
    elif spec.name == "quant-int4":
        def roundtrip(v):
            q, s, z = comm_dispatch._blockwise_quantize_int4(v, bs)
            return comm_dispatch._blockwise_dequantize_int4(q, s, z, bs)
    else:
        raise ValueError(f"no wire simulation for collective {spec.name!r}")

    pad = (-n) % bs
    padded = [F.pad(p, (0, pad)) if pad else p for p in partials]
    red = roundtrip(padded[0])
    for p in padded[1:]:
        red = red + roundtrip(p)                  # phase 1, per rank
    out = roundtrip(red)                          # phase 2, re-quantized
    return out[..., :n] if pad else out


def _layer0(node):
    """Layer 0 of (nested) per-layer lists, or of a pair stacked over one
    or more layer dims."""
    while isinstance(node, list):
        node = node[0]
    while node.up.qweight.dim() > 2:
        node = map_tensors(node, lambda _, t: t[0])
    return node


def _site_pair(params, path: str):
    """The layer-0 ``PlannedPair`` at a dotted ``pair_meta`` path."""
    node = params
    for part in path.split("."):
        node = node[0][part] if isinstance(node, list) else node[part]
    return _layer0(node)


def _probe_site(pp, tp: int, x: torch.Tensor, candidates,
                activation: Optional[str]) -> dict:
    """Score every candidate on one pair site over the calibration rows
    ``x`` (calib_batch, K1); returns {shorthand: score}."""
    from repro_torch.kernels import dispatch as kdispatch

    shards = reorder.shard_pair(pp, tp)
    partials = [schemes.pair_forward_reference(
        x, s, activation=activation).to(torch.float32) for s in shards]
    exact = sum(partials[1:], partials[0])
    scale = float(torch.max(torch.abs(exact)))
    scores = {}
    for spec in candidates:
        sim = simulate_wire(partials, spec)
        err = float(torch.max(torch.abs(sim - exact))) / max(scale, 1e-30)
        fusable, why = kdispatch.wire_support(shards[0].down, spec, tp)
        scores[spec.shorthand()] = {
            "spec": spec,
            "rel_err": err,
            "bytes_per_token": spec.bytes_on_wire((1, pp.n2), tp),
            "fusable": fusable,
            "fuse_reason": why,
        }
    return scores


def autotune_collectives(cfg, params: Any, pair_meta, policy, tp: int, *,
                         attn_plans: Optional[dict] = None,
                         budget: float = DEFAULT_BUDGET,
                         calib_batch: int = 8,
                         candidates=None,
                         overlap: bool = False,
                         generator: Optional[torch.Generator] = None,
                         calib_rows: Optional[dict] = None):
    """Choose a per-layer ``CollectivePlan`` for a planned tree.

    ``params``: the planned (unsharded) tree; ``pair_meta``: the
    manifest's ``pairs``; ``attn_plans``: ``{path: PlannedPair}`` of the
    attention folds (stacked over layers or a per-layer list).  Each
    site's calibration rows are ``calib_rows[path]`` when given, else
    ``calib_batch`` standard-normal rows drawn from ``generator``.
    ``overlap`` marks quantized pair choices ``:overlap``, never an
    ``attn_vo`` site (its epilogue is the all-reduce that closes
    attention).  Returns ``(policy with the tuned plan, report)``."""
    if not tp:
        raise ValueError("autotune_collectives needs a target TP degree")
    tp = int(tp)
    default = CollectiveSpec(name="psum")
    if candidates is None:
        candidates = candidate_specs()
    if generator is None:
        generator = new_generator(TUNE_RNG_STREAM)

    sites = [(meta["path"], "pair",
              lambda meta=meta: _site_pair(params, meta["path"]),
              cfg.activation) for meta in pair_meta]
    sites += [(path, "attn_vo", lambda plans=plans: _layer0(plans), None)
              for path, plans in sorted((attn_plans or {}).items())]

    entries, report = [], []
    for path, kind, get_pair, activation in sites:
        if tp == 1:
            chosen, scores, status = default, {}, "tp=1 (no collective)"
        else:
            pp = get_pair()
            dev = pp.up.qweight.device
            if calib_rows is not None and path in calib_rows:
                x = calib_rows[path].to(device=dev, dtype=torch.float32)
            else:
                x = torch.randn((calib_batch, pp.k1), generator=generator,
                                device=generator.device).to(dev)
            try:
                scores = _probe_site(pp, tp, x, candidates, activation)
                status = "tuned"
            except ValueError as e:   # non-divisible / group-misaligned
                scores, status = {}, f"untunable: {e}"
            ok = [v for v in scores.values() if v["rel_err"] <= budget]
            chosen = (min(ok, key=lambda v: v["bytes_per_token"])["spec"]
                      if ok else default)
            if kind == "pair":
                win = scores.get(chosen.shorthand())
                if win is not None and win.get("fusable"):
                    chosen = chosen.with_(fused=True)
                    scores[chosen.shorthand()] = {**win, "spec": chosen}
                if overlap and chosen.name in ("quant-int8", "quant-int4"):
                    chosen = chosen.with_(overlap=True)
        entries.append((path, chosen))
        if tp == 1:
            elig = {"fusable": False, "reason": status}
        elif kind != "pair":
            elig = {"fusable": False,
                    "reason": "attn_vo epilogue closes through GSPMD"}
        else:
            base = scores.get(chosen.shorthand()) or scores.get(
                chosen.with_(fused=False, overlap=False).shorthand())
            elig = ({"fusable": base["fusable"],
                     "reason": base["fuse_reason"]}
                    if base is not None
                    else {"fusable": False, "reason": status})
        report.append({
            "path": path, "kind": kind, "tp": tp, "budget": budget,
            "status": status, "chosen": chosen.shorthand(),
            "fused": chosen.fused, "overlap": chosen.overlap,
            "eligibility": elig,
            "candidates": {
                short: {"rel_err": v["rel_err"],
                        "bytes_per_token": v["bytes_per_token"]}
                for short, v in scores.items()},
        })

    plan = CollectivePlan(entries=tuple(entries), default=default)
    return policy.with_(collective=plan), report
