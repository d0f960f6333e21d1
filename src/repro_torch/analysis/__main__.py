"""``python -m repro_torch.analysis`` — the static-analysis CI gate.

Counterpart of ``python -m repro.analysis``. Exit status 0 iff the
widthcheck matrix has no findings, every registered op carries analysis
metadata, and the lint pass is clean. Declared skips (e.g. "callers scale
operands" contracts) are reported but do not fail the gate — they are
auditable, reasoned exclusions, not silent gaps. The reference's
``jax_enable_x64`` switch has no counterpart: each case declares its bus.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="SIMDive aten-graph width/overflow verifier + repo lint")
    ap.add_argument("--gate", action="store_true",
                    help="CI mode: nonzero exit on any finding/gap")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    ap.add_argument("--op", action="append", default=None,
                    help="restrict to this registered op (repeatable)")
    ap.add_argument("--diff", default=None, metavar="REF",
                    help="analyze only ops whose datapath sources changed "
                         "vs this git ref (shared-source changes widen to "
                         "the full matrix; lint always runs repo-wide)")
    ap.add_argument("--width", action="append", type=int, default=None,
                    help="restrict to this lane width (repeatable)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    ap.add_argument("--out", default=None,
                    help="also write the report to this path")
    args = ap.parse_args(argv)

    from . import render_text, run_lint, run_matrix, to_json

    ops = args.op
    skip_matrix = False
    if args.diff is not None:
        if args.op:
            ap.error("--diff and --op are mutually exclusive: the diff "
                     "decides the op set")
        from repro_torch.kernels import registry

        from .diff import changed_paths, ops_for_paths
        diff_ops = ops_for_paths(
            changed_paths(args.diff),
            [impl.name for impl in registry.all_ops()])
        if diff_ops is None:
            print(f"# --diff {args.diff}: shared datapath sources changed "
                  "-> full matrix")
        elif not diff_ops:
            print(f"# --diff {args.diff}: no datapath sources changed "
                  "-> matrix skipped (lint still runs)")
            skip_matrix = True
        else:
            print(f"# --diff {args.diff}: analyzing {', '.join(diff_ops)}")
            ops = list(diff_ops)

    from .widthcheck import MatrixResult
    result = MatrixResult() if skip_matrix \
        else run_matrix(ops=ops, widths=args.width)
    lint_findings = [] if args.no_lint else run_lint()

    text = (json.dumps(to_json(result, lint_findings), indent=2, sort_keys=True)
            if args.json else render_text(result, lint_findings))
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text if text.endswith("\n") else text + "\n")

    bad = bool(result.findings) or bool(result.gaps) or bool(lint_findings)
    if args.gate and bad:
        print("GATE: FAIL", file=sys.stderr)
        return 1
    if args.gate:
        print("GATE: PASS", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
