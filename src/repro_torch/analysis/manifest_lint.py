"""Manifest lint: offline audit of a ``DeploymentArtifact`` directory;
port of ``repro/analysis/manifest_lint.py`` (its MF rules).

Everything here reads ``manifest.json`` and the ``rank_NN.npz`` /
``aux.npz`` files (``plan/artifact.py``, ``train/checkpoint.py``), in
either package's writing; no process group, no model, no kernel.  The
invariants are the ones a served deployment would otherwise find at
forward time, or never:

* MF001: every ``collective_plan`` entry glob resolves at least one real
  pair or fold site; an unreachable glob is a typo'd plan.
* MF002: no entry is fully shadowed by earlier entries (matches sites,
  wins none).
* MF003: every ``:fused``/``:overlap`` mark is backed by recorded tuner
  eligibility provenance, and every ``:fused`` pair site by
  ``kernels.dispatch.wire_support`` re-derived from the rank-0 shard on
  disk.
* MF004: the manifest's ``leaf_shards`` map and the ``rank_NN.npz``
  files agree: all TP files present, identical key sets, consistent
  per-rank shapes, no stray rank files beyond the TP degree.
* MF005: every aux attention V->O fold is either consumed by the
  family's attention runtime (``SUPPORTS_ATTN_VO`` and ``ATTN_VO_PATH``)
  or explicitly waived (``ATTN_VO_WAIVED``, an ``info`` finding).
* MF006: the policy's collective shorthand round-trips through
  ``parse_collective`` and agrees with the structural
  ``collective_plan`` echo.

The reference's BN001 (the committed benchmark snapshots) comes with the
port's benchmark (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Optional

from repro_torch.analysis.findings import Finding


def _site_paths(manifest: dict, aux: Optional[dict]) -> list[str]:
    """Every dotted path the plan can resolve: planned MLP pairs plus
    aux attention V->O fold sites."""
    paths = [m["path"] for m in manifest.get("pairs", ())]
    for path in sorted((aux or {}).get("attn_plans", {})):
        if path not in paths:
            paths.append(path)
    return paths


def _parse_plan(manifest: dict, location: str):
    """(parsed collective, findings) from the manifest's policy field."""
    from repro_torch.comm.spec import parse_collective

    short = manifest.get("policy", {}).get("collective", "psum")
    try:
        coll = parse_collective(short)
    except ValueError as e:
        return None, [Finding(
            "MF006", f"policy collective {short!r} does not parse: {e}",
            location=location)]
    out = []
    if coll.shorthand() != short:
        out.append(Finding(
            "MF006",
            f"collective shorthand does not round-trip: {short!r} "
            f"re-serializes as {coll.shorthand()!r}",
            location=location))
    return coll, out


def lint_manifest_dict(manifest: dict, aux: Optional[dict] = None, *,
                       location: str = "manifest") -> list[Finding]:
    """Pure-dict checks (MF001/MF002/MF003-provenance/MF006), no disk."""
    from repro_torch.comm.spec import (CollectivePlan, _match,
                                       parse_collective)

    coll, out = _parse_plan(manifest, location)
    sites = _site_paths(manifest, aux)

    # MF006: the structural echo must agree with the shorthand
    echo = manifest.get("collective_plan")
    if echo is not None:
        if not isinstance(coll, CollectivePlan):
            out.append(Finding(
                "MF006",
                "manifest carries a collective_plan echo but the policy "
                "collective is a bare spec",
                location=location))
        else:
            want = {"entries": [[pat, spec.shorthand()]
                                for pat, spec in coll.entries],
                    "default": coll.default.shorthand()}
            if echo != want:
                out.append(Finding(
                    "MF006",
                    "collective_plan echo disagrees with the policy "
                    "collective shorthand",
                    location=location,
                    detail={"echo": echo, "policy": want}))

    # MF001 / MF002: glob reachability over the real site list
    if isinstance(coll, CollectivePlan) and sites:
        winners: set[int] = set()
        for site in sites:
            for i, (pat, _) in enumerate(coll.entries):
                if _match(site, pat):
                    winners.add(i)
                    break
        for i, (pat, spec) in enumerate(coll.entries):
            if not any(_match(s, pat) for s in sites):
                out.append(Finding(
                    "MF001",
                    f"plan entry {pat!r} ({spec.shorthand()}) matches no "
                    f"pair or fold site — unreachable",
                    location=location, detail={"sites": sites}))
            elif i not in winners:
                out.append(Finding(
                    "MF002",
                    f"plan entry {pat!r} ({spec.shorthand()}) is fully "
                    f"shadowed by earlier entries — it never resolves",
                    location=location))

    # MF003 (provenance half): every fused/overlap mark needs a tuner
    # eligibility record that says the kernel can serve it
    report = {e.get("path"): e
              for e in manifest.get("collective_tuner", ())}
    for pat, short in (echo or {}).get("entries", ()):
        try:
            spec = parse_collective(short)
        except ValueError:
            continue   # already reported by the round-trip check
        if not (getattr(spec, "fused", False)
                or getattr(spec, "overlap", False)):
            continue
        entry = report.get(pat)
        if entry is None:
            out.append(Finding(
                "MF003",
                f"site {pat!r} is marked {short!r} but the manifest has "
                f"no tuner record for it — unprovenanced eligibility",
                location=location))
            continue
        elig = entry.get("eligibility")
        if spec.fused:
            if not elig:
                out.append(Finding(
                    "MF003",
                    f"site {pat!r} is marked ':fused' but its tuner "
                    f"record carries no eligibility provenance",
                    location=location))
            elif not elig.get("fusable"):
                out.append(Finding(
                    "MF003",
                    f"site {pat!r} is marked ':fused' but the recorded "
                    f"eligibility says it is not "
                    f"({elig.get('reason', 'no reason recorded')})",
                    location=location, detail=elig))
    return out


# ---------------------------------------------------------------------------
# on-disk checks
# ---------------------------------------------------------------------------

def _rank_files(dirpath: str, tp: int):
    have = sorted(globlib.glob(os.path.join(dirpath, "rank_*.npz")))
    want = [os.path.join(dirpath, f"rank_{r:02d}.npz") for r in range(tp)]
    return have, want


def _lint_rank_shards(dirpath: str, manifest: dict) -> list[Finding]:
    """MF004: leaf_shards against what is on disk."""
    from repro_torch.train import checkpoint

    out: list[Finding] = []
    tp = int(manifest["tp"])
    shards = manifest.get("leaf_shards", {})
    have, want = _rank_files(dirpath, tp)
    for path in want:
        if path not in have:
            out.append(Finding(
                "MF004",
                f"missing rank shard {os.path.basename(path)} "
                f"(manifest tp={tp})", location=dirpath))
    for path in have:
        if path not in want:
            out.append(Finding(
                "MF004",
                f"stray rank shard {os.path.basename(path)} beyond the "
                f"manifest's tp={tp} — a stale or foreign file",
                location=dirpath))
    # each file's leaf shapes from its schema: an 8 GB artifact is
    # audited without reading its arrays
    shapes = {r: checkpoint.leaf_shapes(path)
              for r, path in enumerate(want) if path in have}
    if not shapes:
        return out
    want_keys = set(shards)
    for r, flat in sorted(shapes.items()):
        keys = set(flat)
        if want_keys and keys != want_keys:
            missing = sorted(want_keys - keys)[:5]
            extra = sorted(keys - want_keys)[:5]
            out.append(Finding(
                "MF004",
                f"rank_{r:02d}.npz keys disagree with the manifest's "
                f"leaf_shards map (missing {missing}, extra {extra})",
                location=dirpath))
    ranks = sorted(shapes)
    base = shapes[ranks[0]]
    for r in ranks[1:]:
        for key in sorted(set(base) & set(shapes[r])):
            if base[key] != shapes[r][key]:
                out.append(Finding(
                    "MF004",
                    f"leaf {key!r} has shape {shapes[r][key]} on rank {r} "
                    f"but {base[key]} on rank {ranks[0]} — uneven shards",
                    location=dirpath))
    return out


def _leaf_index(tree, path: str, stacked):
    """The layer-0 node at a dotted path of a (possibly stacked) tree."""
    from repro_torch.train import checkpoint

    node = tree
    for part in path.split("."):
        node = node[part]
    lead = len(stacked or ())
    if lead:
        node = checkpoint.map_tensors(node, lambda _, t: t[(0,) * lead])
    return node


def _lint_fused_on_disk(dirpath: str, manifest: dict) -> list[Finding]:
    """MF003 (disk half): re-derive wire eligibility from rank 0."""
    from repro_torch.comm.spec import parse_collective
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.train import checkpoint

    out: list[Finding] = []
    marked = []
    for pat, short in manifest.get("collective_plan", {}).get(
            "entries", ()):
        try:
            spec = parse_collective(short)
        except ValueError:
            continue
        if getattr(spec, "fused", False):
            marked.append((pat, spec))
    if not marked:
        return out
    rank0 = os.path.join(dirpath, "rank_00.npz")
    if not os.path.exists(rank0):
        return out       # MF004 already reports the missing file
    tree = checkpoint.load(rank0)
    meta = {m["path"]: m for m in manifest.get("pairs", ())}
    tp = int(manifest["tp"])
    for pat, spec in marked:
        m = meta.get(pat)
        if m is None:
            continue     # a fold or unknown site: the provenance half
        try:
            pair = _leaf_index(tree, pat, m.get("stacked"))
            ok, why = kdispatch.wire_support(pair.down, spec, tp)
        except Exception as e:  # noqa: BLE001 -- reported as a finding
            out.append(Finding(
                "MF003",
                f"could not re-derive wire eligibility for {pat!r}: {e}",
                location=dirpath))
            continue
        if not ok:
            out.append(Finding(
                "MF003",
                f"site {pat!r} is marked ':fused' but the rank-0 shard "
                f"on disk cannot take the wire epilogue: {why}",
                location=dirpath))
    return out


def _lint_fold_coverage(manifest: dict, aux: Optional[dict], *,
                        location: str) -> list[Finding]:
    """MF005: every shipped V->O fold is consumed or explicitly waived."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model

    out: list[Finding] = []
    plans = (aux or {}).get("attn_plans") or {}
    if not plans:
        return out
    try:
        model = build_model(get_smoke_config(manifest["arch_id"]))
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        out.append(Finding(
            "MF005",
            f"cannot resolve the family of arch "
            f"{manifest.get('arch_id')!r}: {e}", location=location))
        return out
    family = model.cfg.family
    consumed = model.attn_vo_path if model.supports_attn_vo else None
    waived = model.attn_vo_waived
    for path in sorted(plans):
        if path == consumed:
            continue
        if path in waived:
            out.append(Finding(
                "MF005",
                f"fold {path!r} is waived by the {family} runtime: "
                f"{waived[path]}", location=location, severity="info"))
        else:
            out.append(Finding(
                "MF005",
                f"artifact ships a V->O fold at {path!r} the {family} "
                f"attention runtime neither consumes nor waives — dead "
                f"aux weight shipped as if live",
                location=location,
                detail={"consumed": consumed,
                        "waived": sorted(waived)}))
    return out


def lint_artifact(dirpath: str) -> list[Finding]:
    """Full offline audit of one artifact directory (MF001-MF006)."""
    from repro_torch.plan.artifact import AUX, DeploymentArtifact
    from repro_torch.train import checkpoint

    try:
        manifest = DeploymentArtifact.load_manifest(dirpath)
    except Exception as e:  # noqa: BLE001 -- reported as a finding
        return [Finding("MF004", f"unloadable artifact: {e}",
                        location=dirpath)]
    aux_path = os.path.join(dirpath, AUX)
    aux = checkpoint.load(aux_path) if os.path.exists(aux_path) else None
    out = lint_manifest_dict(manifest, aux, location=dirpath)
    out += _lint_rank_shards(dirpath, manifest)
    out += _lint_fused_on_disk(dirpath, manifest)
    out += _lint_fold_coverage(manifest, aux, location=dirpath)
    return out


def run(artifact: Optional[str] = None) -> list[Finding]:
    """Entry point the CLI and ``serve verify`` call: the artifact audit
    (none without an artifact)."""
    return lint_artifact(artifact) if artifact else []
