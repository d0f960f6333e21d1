"""Static verification of the port's SIMDive integer datapath.

Counterpart of ``repro.analysis``:

* :mod:`repro_torch.analysis.widthcheck` — aten-graph abstract interpreter
  proving overflow / shift-range / lane-isolation / signedness safety of
  every registered op at every supported width, against each case's bus.
* :mod:`repro_torch.analysis.lint` — repo-specific AST rules (timing
  harness, hardcoded block shapes, unguarded ``torch.uint64``, swallowed
  exceptions).
* :mod:`repro_torch.analysis.diff` — which ops a git diff touches.

CLI: ``python -m repro_torch.analysis [--gate] [--json] [--op NAME]
[--width W] [--diff REF] [--no-lint] [--out PATH]``.
"""
from .domain import AbsVal, ArgSpec, Finding, TraceCase, from_concrete, top
from .lint import run_lint
from .widthcheck import (MatrixResult, check_case, render_text, run_matrix,
                         to_json, verdict_for)

__all__ = [
    "AbsVal", "ArgSpec", "Finding", "TraceCase", "from_concrete", "top",
    "run_lint", "MatrixResult", "check_case", "render_text", "run_matrix",
    "to_json", "verdict_for",
]
