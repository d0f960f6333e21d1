"""repro_torch.metrics — error, operand and timing metrics.

Counterpart of ``repro.metrics`` for what the port uses so far:

  error_stats / ErrorStats   ARE%/MRED/NMED/PRE%/WCE/error-rate
  relative_error             per-lane relative error distances
  classification_accuracy    top-1 %
  psnr / ssim                image quality (Fig. 3/4)
  grid8 / sample_uints / stratified_pairs / DIV_FRAC_OUT /
  PACKED_DIV_FRAC_OUT        shared operand sets and the divider's
                             fixed-point conventions of every sweep
  time_callable / TimingStats  warmup + device-synchronised timing
  trajectory                 the BENCH document's schema + migration +
                             the regression gate (diff_runs); pure stdlib
  divergence                 the exact-vs-approximate twin's loss delta,
                             gradient cosine and parameter drift
                             (tree_dot / tree_norm / grad_cosine /
                             param_drift on nested dicts of tensors) and
                             DivergenceTrace, its JSON report

``errors``, ``image`` and ``operands`` are pure numpy and ``trajectory``
pure stdlib, copied rather than imported (the port imports nothing of
``repro``).
"""
from .divergence import (
    DIVERGENCE_SCHEMA,
    DivergenceTrace,
    grad_cosine,
    param_drift,
    tree_dot,
    tree_norm,
)
from .errors import (
    ErrorStats,
    classification_accuracy,
    error_stats,
    relative_error,
)
from .image import psnr, ssim
from .operands import (
    DIV_FRAC_OUT,
    PACKED_DIV_FRAC_OUT,
    grid8,
    sample_uints,
    stratified_pairs,
)
from .timing import TimingStats, time_callable
from .trajectory import (
    GateReport,
    Thresholds,
    TrajectoryError,
    diff_runs,
    load_trajectory,
)

__all__ = [
    "DIVERGENCE_SCHEMA",
    "DivergenceTrace",
    "grad_cosine",
    "param_drift",
    "tree_dot",
    "tree_norm",
    "ErrorStats",
    "error_stats",
    "relative_error",
    "classification_accuracy",
    "psnr",
    "ssim",
    "DIV_FRAC_OUT",
    "PACKED_DIV_FRAC_OUT",
    "grid8",
    "sample_uints",
    "stratified_pairs",
    "TimingStats",
    "time_callable",
    "GateReport",
    "Thresholds",
    "TrajectoryError",
    "diff_runs",
    "load_trajectory",
]
