"""repro_torch.metrics — error, operand and timing metrics.

Counterpart of ``repro.metrics`` for what the port uses so far:

  error_stats / ErrorStats   ARE%/MRED/NMED/PRE%/WCE/error-rate
  relative_error             per-lane relative error distances
  classification_accuracy    top-1 %
  grid8 / sample_uints / stratified_pairs / DIV_FRAC_OUT /
  PACKED_DIV_FRAC_OUT        shared operand sets and the divider's
                             fixed-point conventions of every sweep
  time_callable / TimingStats  warmup + device-synchronised timing
  trajectory                 the BENCH document's schema + migration +
                             the regression gate (diff_runs); pure stdlib

``errors`` and ``operands`` are pure numpy and ``trajectory`` pure stdlib,
copied rather than imported (the port imports nothing of ``repro``). Image
metrics and the training-divergence metrics are not ported yet.
"""
from .errors import (
    ErrorStats,
    classification_accuracy,
    error_stats,
    relative_error,
)
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
    "ErrorStats",
    "error_stats",
    "relative_error",
    "classification_accuracy",
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
