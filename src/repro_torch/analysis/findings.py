"""Findings and the rule catalog, the analysis package's shared
vocabulary; port of ``repro/analysis/findings.py``.

Every linter of ``repro_torch.analysis`` (``ast_lint``, ``contracts``,
``manifest_lint``) reports a ``Finding``: a rule ID from ``RULES``, a
severity, a location and a free-form ``detail``.  A linter cannot emit an
ID the catalog lacks (``Finding`` refuses it), and the JSON report has
the reference's shape, so the two packages' reports compare key for key.

Severities:

* ``error``: an invariant the deployment plan promises is violated; the
  CLI exits 1;
* ``warn``: suspicious but not provably wrong;
* ``info``: a recorded, intentional waiver (an attention fold a family
  declares it does not consume).

The catalog holds the reference's CT, AS and MF rules with their IDs and
severities, each invariant stated in the port's terms.  Not in it:

* HL001-HL004 read XLA's compiled HLO, which the port does not have.
  What stands in (ROADMAP.md queue 1, item 12): for HL001, ``comm.
  wire_bytes`` held equal to ``bytes_on_wire`` (``tests/test_torch_tp.py``);
  for HL003, ``chip_smoke.py`` phase 27's ring windows, each holding a
  down GEMM on the card; for HL002, CT001 on the ranks; HL004 has no
  counterpart (a CUDA graph keeps its buffers' addresses).
* BN001 checks the benchmark's snapshots and comes with the port's
  benchmark (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One catalog entry: the invariant a linter enforces."""

    id: str
    layer: str          # contracts | ast | manifest
    severity: str       # default severity findings of this rule carry
    invariant: str      # one-line statement of what must hold
    caught: str         # which bug class this rule would have caught


#: the rule catalog; ``Finding`` refuses IDs that are not in it
RULES: dict[str, Rule] = {r.id: r for r in [
    # ---- contracts.py (the strategies and families on real ranks) -------
    Rule("CT001", "contracts", "error",
         "every collective strategy returns the residual stream's dtype "
         "and the contracted shape on the ranks of every TP degree "
         "(torch.distributed rank processes)",
         "a 'cast' strategy leaking its bf16 wire dtype into the f32 "
         "residual stream (compounding rounding per layer)"),
    Rule("CT002", "contracts", "error",
         "at TP=1 every collective spec is the identity and its analytic "
         "bytes_on_wire is exactly zero",
         "single-rank deployments paying a quantize/dequantize round "
         "trip (or wire bytes) for a collective that moves nothing"),
    Rule("CT003", "contracts", "error",
         "paged and dense KV caches of a family agree on per-token "
         "geometry (kv-heads, head_dim) and payload dtype",
         "a paged pool allocated with the wrong head grid decoding "
         "garbage only once a sequence crosses its first page boundary"),
    Rule("CT004", "contracts", "error",
         "every registered model family's forward and decode step emit "
         "float32 logits of the batch's shape from its smoke config",
         "low-bit accumulation dtypes escaping through the lm_head and "
         "silently degrading sampling entropy"),
    # ---- ast_lint.py (source-tree checks) ---------------------------------
    Rule("AS001", "ast", "error",
         "no raw torch.distributed collective (all_reduce, all_gather, "
         "reduce_scatter, all_to_all, broadcast, send/recv and their "
         "variants) outside comm/ and dist/",
         "call sites bypassing the comm registry so per-layer plans, "
         "wire accounting, and the dtype contract silently don't apply"),
    Rule("AS002", "ast", "error",
         "no kernel entry point (kernels.ops and kernels.dequant_matmul "
         "launchers of K1, K3, K4, K5) is called outside kernels/; the "
         "rest of the package goes through kernels/dispatch.py",
         "a call pinned to one kernel skipping the registry's choice by "
         "the policy's backend and the layout's kind"),
    Rule("AS003", "ast", "error",
         "every dataclass in a spec module (core/policy.py, comm/spec.py"
         ", cache/spec.py, dist/topology.py) is frozen",
         "a spec mutated after it keys a captured step or an engine's "
         "plan: stale captures and plans keyed on the old value"),
    Rule("AS004", "ast", "error",
         "no mutable default argument (list/dict/set literals) in the "
         "package",
         "a shared default accumulating state across calls (classic "
         "aliasing bug; none shipped, the rule keeps it that way)"),
    # ---- manifest_lint.py (offline artifact audit) ------------------------
    Rule("MF001", "manifest", "error",
         "every CollectivePlan entry glob matches at least one site the "
         "artifact actually planned (pairs + attention folds)",
         "a tuned plan entry orphaned by a rename resolving every site "
         "to the default psum while the manifest still advertises "
         "quantized epilogues"),
    Rule("MF002", "manifest", "error",
         "no CollectivePlan entry is shadowed (every entry is the first "
         "match for at least one planned site)",
         "an earlier catch-all glob silently overriding a later, more "
         "specific per-layer choice"),
    Rule("MF003", "manifest", "error",
         "every ':fused'/':overlap' mark is backed by recorded "
         "eligibility provenance AND by kernels.dispatch.wire_support "
         "re-derived from the rank-0 shard on disk",
         "a plan marked ':fused' whose serve-time wire_support check "
         "fails: the down projection falls back to the dense epilogue "
         "while the banner reports the fused one"),
    Rule("MF004", "manifest", "error",
         "the manifest's leaf_shards map matches the rank_NN.npz files "
         "on disk: tp files present, every key in every rank, no "
         "unlisted keys, shard shapes consistent across ranks",
         "a hand-pruned artifact directory serving a rank tree that "
         "silently reassembles the wrong global tensor"),
    Rule("MF005", "manifest", "error",
         "every aux attention V->O fold is either consumed by the "
         "family's runtime (ATTN_VO_PATH) or explicitly waived "
         "(ATTN_VO_WAIVED, reported as info)",
         "whisper's decoder folds riding every artifact as dead weight "
         "while the runtime recomputed the unfolded projections"),
    Rule("MF006", "manifest", "error",
         "the manifest's collective shorthand parses and round-trips, "
         "and the structural collective_plan echo agrees with it",
         "a manifest edited by hand serving a different plan than the "
         "one its provenance block displays"),
]}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter result, machine-readable.

    ``location`` is layer-appropriate: ``file:line`` for AST findings, a
    spec shorthand (with its dtype and TP degree) for contract findings,
    the artifact directory for manifest findings.
    """

    rule: str
    message: str
    location: str = ""
    severity: Optional[str] = None      # None -> the rule's default
    detail: Any = None

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(
                f"finding uses unregistered rule id {self.rule!r}; "
                f"catalog: {sorted(RULES)}")
        sev = self.severity or RULES[self.rule].severity
        if sev not in SEVERITIES:
            raise ValueError(f"unknown severity {sev!r}")
        object.__setattr__(self, "severity", sev)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "layer": RULES[self.rule].layer,
            "location": self.location,
            "message": self.message,
            "detail": self.detail,
        }

    def __str__(self) -> str:
        loc = f" {self.location}" if self.location else ""
        return f"[{self.rule}/{self.severity}]{loc}: {self.message}"


def summarize(findings) -> dict:
    """The CLI's JSON report: catalog + findings + exit-worthy counts."""
    findings = list(findings)
    return {
        "findings": [f.to_json() for f in findings],
        "counts": {sev: sum(1 for f in findings if f.severity == sev)
                   for sev in SEVERITIES},
        "rules_checked": sorted(RULES),
    }


def to_json_text(findings) -> str:
    return json.dumps(summarize(findings), indent=1, sort_keys=True)


def has_errors(findings) -> bool:
    return any(f.severity == "error" for f in findings)
