"""repro_torch.analysis: static and contract verification of the port's
deployment invariants; port of ``repro/analysis``.

Three linters, one CLI (``python -m repro_torch.analysis``), findings
with the reference's rule IDs and JSON shape (``findings.RULES``):

* ``ast_lint``: source hygiene over ``src/repro_torch``: raw
  ``torch.distributed`` collectives outside ``comm/`` and ``dist/``,
  kernel launches bypassing ``kernels/dispatch.py``, unfrozen spec
  dataclasses, mutable defaults (AS rules).
* ``contracts``: every collective strategy at TP=1 in process and at
  each TP degree on rank processes, every model family's logits and
  cache geometry at smoke size (CT rules).
* ``manifest_lint``: offline audit of a prepared artifact directory:
  plan-glob reachability, fused/overlap eligibility re-derived from the
  shards on disk, rank files, fold coverage (MF rules).

The reference's ``hlo_lint`` reads XLA's compiled HLO, which the port
has not; ``findings`` says what stands in for each HL rule.
"""

from repro_torch.analysis.findings import (Finding, Rule, RULES, has_errors,
                                           summarize, to_json_text)

__all__ = ["Finding", "Rule", "RULES", "has_errors", "summarize",
           "to_json_text"]
