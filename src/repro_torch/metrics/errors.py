"""Error statistics for approximate-arithmetic outputs — defined once.

Counterpart of ``repro.metrics.errors``: the port's own copy of the same
pure-numpy definitions (the port imports nothing of ``repro``), so an
error sweep through the CUDA kernels reports exactly the statistics the
reference reports for the same integer outputs. Every error sweep
compares an approximate integer result against an exact (real-valued)
reference. The statistics follow the approximate-computing literature the
paper (and its RAPID follow-up) report:

  ARE%        mean relative error, percent  (the paper's Table 2 column)
  MRED        mean relative error distance  (= ARE% / 100; RAPID's metric)
  NMED        mean |error| normalized by the max exact magnitude
  PRE%        peak (max) relative error, percent (Table 2's PRE column)
  WCE         worst-case absolute error
  error_rate  fraction of outputs that differ at all from the exact value

Relative metrics are computed over the lanes where the exact value is
nonzero (zero lanes are bypassed by the hardware's zero flag and carry no
relative-error meaning); absolute metrics and ``error_rate`` cover every
lane. All arithmetic is float64 on host — these are *reporting* functions,
never traced.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = [
    "ErrorStats",
    "error_stats",
    "relative_error",
    "classification_accuracy",
]


@dataclass(frozen=True)
class ErrorStats:
    """The full error profile of one (approx, exact) comparison."""
    n: int              # number of compared lanes
    are_pct: float      # mean relative error, %
    mred: float         # mean relative error distance (fraction)
    nmed: float         # mean |err| / max |exact|
    pre_pct: float      # peak relative error, %
    wce: float          # worst-case absolute error
    error_rate: float   # fraction of lanes with any error

    def as_dict(self) -> dict:
        """Plain-JSON form (the BENCH_simdive.json ``error`` object)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def __str__(self) -> str:  # compact CSV-friendly rendering
        return (f"ARE={self.are_pct:.3f}% PRE={self.pre_pct:.2f}% "
                f"NMED={self.nmed:.2e} WCE={self.wce:.4g} "
                f"err-rate={self.error_rate:.3f}")


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).ravel()


def relative_error(approx, exact) -> np.ndarray:
    """Per-lane relative error distance |approx - exact| / |exact|.

    Lanes with ``exact == 0`` report 0 when the approximation is also 0 and
    ``inf`` otherwise (so a nonzero output where zero is required is never
    silently forgiven); aggregate via :func:`error_stats`, which restricts
    relative statistics to the nonzero-exact lanes.
    """
    a, e = _f64(approx), _f64(exact)
    err = np.abs(a - e)
    with np.errstate(divide="ignore", invalid="ignore"):
        re = np.where(e != 0, err / np.abs(e),
                      np.where(err == 0, 0.0, np.inf))
    return re


def error_stats(approx, exact) -> ErrorStats:
    """Aggregate :class:`ErrorStats` of ``approx`` against ``exact``.

    Shapes must match (broadcasting is deliberately not supported — a shape
    mismatch in an error sweep is always a bug, never an intent).
    """
    a, e = _f64(approx), _f64(exact)
    if a.shape != e.shape:
        raise ValueError(f"shape mismatch: approx {a.shape} vs exact {e.shape}")
    if a.size == 0:
        raise ValueError("error_stats needs at least one lane")
    if not np.isfinite(e).all():
        # a non-finite reference (a zero divisor upstream, usually) would
        # silently turn every aggregate into NaN — fail the sweep loudly
        raise ValueError(
            f"exact reference contains {int((~np.isfinite(e)).sum())} "
            "non-finite lane(s) (zero divisor in the operand set?)")
    err = np.abs(a - e)
    nz = e != 0
    re = err[nz] / np.abs(e[nz])
    mred = float(re.mean()) if re.size else 0.0
    pre = float(re.max()) if re.size else 0.0
    emax = float(np.abs(e).max())
    return ErrorStats(
        n=int(a.size),
        are_pct=100.0 * mred,
        mred=mred,
        nmed=float(err.mean() / emax) if emax > 0 else 0.0,
        pre_pct=100.0 * pre,
        wce=float(err.max()),
        error_rate=float((err != 0).mean()),
    )


def classification_accuracy(logits, labels) -> float:
    """Top-1 accuracy in percent of ``logits (N, C)`` against ``labels (N,)``."""
    pred = np.asarray(logits).argmax(-1)
    return float((pred == np.asarray(labels)).mean()) * 100.0
