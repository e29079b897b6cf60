"""CLI: ``python -m repro_torch.analysis``, the port's verification
suite; port of ``python -m repro.analysis``.

    python -m repro_torch.analysis --ast                   # source hygiene
    python -m repro_torch.analysis --all --tp 2            # AST + contracts
    python -m repro_torch.analysis --artifact DIR          # offline audit
    python -m repro_torch.analysis --all --device cpu --json out.json

It prints one count line per linter, every finding, then the total, and
exits 1 when any finding is an ``error`` (``warn`` and ``info`` never
gate), 0 otherwise.  The contracts run on the CUDA card unless
``--device cpu`` is given; without a card they exit naming it.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="deployment-invariant linters of the port (the "
                    "reference's --hlo reads XLA's compiled HLO, which the "
                    "port has not, and --bench the benchmark snapshots, "
                    "which come with the port's benchmark: ROADMAP.md "
                    "queue 1, item 12)")
    ap.add_argument("--ast", action="store_true",
                    help="AS rules: source hygiene over src/repro_torch")
    ap.add_argument("--contracts", action="store_true",
                    help="CT rules: the collectives at TP=1 and on rank "
                         "processes at each --tp, the families' logits and "
                         "cache geometry")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="MF rules: offline audit of a prepared "
                         "DeploymentArtifact directory")
    ap.add_argument("--all", action="store_true",
                    help="--ast and --contracts (add --artifact for the "
                         "manifest audit)")
    ap.add_argument("--tp", type=int, nargs="*", default=(2,),
                    help="TP degrees of the contracts' rank runs")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the findings summary as JSON")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the contracts run (default: the CUDA card)")
    args = ap.parse_args(argv)

    run_ast = args.ast or args.all
    run_contracts = args.contracts or args.all
    if not (run_ast or run_contracts or args.artifact):
        ap.error("pick at least one of --ast/--contracts/--artifact "
                 "(or --all)")

    from repro_torch.analysis.findings import (has_errors, summarize,
                                               to_json_text)

    findings = []
    if run_ast:
        from repro_torch.analysis import ast_lint
        found = ast_lint.run()
        findings += found
        print(f"ast_lint: {len(found)} finding(s)")
    if run_contracts:
        from repro_torch.analysis import contracts
        from repro_torch.device import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"error: {e}") from None
        found = contracts.run(tps=(1, *args.tp), device=device)
        findings += found
        print(f"contracts: {len(found)} finding(s)")
    if args.artifact:
        from repro_torch.analysis import manifest_lint
        found = manifest_lint.run(artifact=args.artifact)
        findings += found
        print(f"manifest_lint: {len(found)} finding(s)")

    for f in findings:
        print(f"  {f}")
    summary = summarize(findings)
    print(f"{len(findings)} finding(s), "
          f"{summary['counts'].get('error', 0)} error(s)")
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(to_json_text(findings))
        print(f"wrote {args.json}")
    return 1 if has_errors(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
