"""SIMDive's error-reduction tables (paper section 3.3), tunable.

Counterpart of ``repro.core.error_lut``; the table construction is this
package's own copy of the closed-form derivation. The (x1, x2) fraction
square is split into ``2^index_bits`` x ``2^index_bits`` regions by the
MSBs of each operand's fraction, one average-error coefficient per region;
``coeff_bits`` quantizes the entries — the accuracy knob.

With the ideal log-domain correction c* depending only on the fractions:

    mul:  s = (1+x1)(1+x2)        c* = s - 1 - (x1+x2)          if s <  2
                                  c* = s/2  - (x1+x2)           if s >= 2
    div:  r = (1+x1)/(1+x2)       c* = r - 1 - (x1-x2)          if r >= 1
                                  c* = 2r - 2 - (x1-x2)         if r <  1

each table entry is the region mean of c* in integer units of 2^-F,
quantized to ``coeff_bits``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.faults.inject import (
    apply_lane_faults,
    apply_table_faults,
    faults_enabled,
)

from .mitchell import frac_bits

__all__ = [
    "ideal_correction_mul",
    "ideal_correction_div",
    "build_table",
    "build_table_clean",
    "table_for",
    "region_index",
    "refresh_tables",
    "materialized_tables",
    "apply_table_faults",
    "apply_lane_faults",
]

_GRID = 256  # frac-grid resolution per axis used for region averaging


def ideal_correction_mul(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Ideal log-domain correction for the multiplier (scale-free)."""
    s = (1.0 + x1) * (1.0 + x2)
    return np.where(s < 2.0, s - 1.0, 0.5 * s) - (x1 + x2)


def ideal_correction_div(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Ideal log-domain correction for the divider (scale-free, signed)."""
    r = (1.0 + x1) / (1.0 + x2)
    return np.where(r >= 1.0, r - 1.0, 2.0 * r - 2.0) - (x1 - x2)


@lru_cache(maxsize=None)
def _build_table_impl(op: str, width: int, coeff_bits: int,
                      index_bits: int = 3) -> np.ndarray:
    if op not in ("mul", "div"):
        raise ValueError(op)
    F = frac_bits(width)
    n = 1 << index_bits
    # midpoint-integrate c* over each region on a fine frac grid
    g = (np.arange(_GRID, dtype=np.float64) + 0.5) / _GRID
    X1, X2 = np.meshgrid(g, g, indexing="ij")
    C = ideal_correction_mul(X1, X2) if op == "mul" \
        else ideal_correction_div(X1, X2)
    r1 = np.minimum((X1 * n).astype(np.int64), n - 1)
    r2 = np.minimum((X2 * n).astype(np.int64), n - 1)
    idx = r1 * n + r2
    sums = np.bincount(idx.ravel(), weights=C.ravel(), minlength=n * n)
    cnts = np.bincount(idx.ravel(), minlength=n * n)
    ints = np.rint(sums / cnts * (1 << F))    # region mean, units of 2^-F
    if coeff_bits <= 0:
        tab = np.zeros(n * n, dtype=np.int32)
    else:
        step = max(1, 1 << max(0, F - 2 - coeff_bits))
        q = np.rint(ints / step) * step
        # keep the corrected mantissa inside its field: |c| < 2^(F-1)
        lim = (1 << (F - 1)) - 1
        tab = np.clip(q, -lim, lim).astype(np.int32)
    tab.setflags(write=False)                 # the cached array is shared
    return tab


def build_table_clean(op: str, width: int, coeff_bits: int,
                      index_bits: int = 3) -> np.ndarray:
    """The pristine correction table (never fault-injected)."""
    return _build_table_impl(op, width, coeff_bits, index_bits)


def build_table(op: str, width: int, coeff_bits: int,
                index_bits: int = 3) -> np.ndarray:
    """Region-mean correction table as int32 in units of 2^-F.

    op          : 'mul' or 'div'
    width       : lane width (8/16/32) -- sets F = width-1
    coeff_bits  : coefficient bits kept (0 => all-zero table, i.e. plain
                  Mitchell); quantization step = 2^(F-2-coeff_bits),
                  floored at one integer unit
    index_bits  : MSBs of each fraction used for the region index (3 = the
                  paper's 64 regions, 4 = the 256-region variant)

    The single point every consumer reads tables through, so it is also
    where :mod:`repro_torch.faults` upsets configuration memory: armed
    table faults corrupt a *copy* after the cached pristine build.
    Disarmed, the cached array is returned as it is.
    """
    tab = _build_table_impl(op, width, coeff_bits, index_bits)
    if faults_enabled():
        tab = apply_table_faults(tab, op=op, width=width)
    return tab


# (op, width, coeff_bits, index_bits, device, dtype) -> the one tensor every
# consumer on that device reads: the registry refresh_tables rewrites
_TABLES: dict[tuple, torch.Tensor] = {}


def _materialize(key: tuple) -> torch.Tensor:
    op, width, coeff_bits, index_bits, _, dtype = key
    return torch.from_numpy(
        build_table(op, width, coeff_bits, index_bits).astype(np.int64)
    ).to(dtype)


def table_for(op: str, width: int, coeff_bits: int, index_bits: int = 3, *,
              device: torch.device | str = "cpu",
              dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Tensor copy of :func:`build_table` on ``device``, one per (table,
    device, dtype), materialized at first use and the same tensor object
    — the same ``data_ptr`` — for as long as the process lives: an arming
    rewrites it in place (:func:`refresh_tables`), so the kernels and the
    CUDA graphs that hold its address read the armed table.

    The plain datapath gathers from an ``int64`` table (the carrier's
    dtype); the CUDA kernels read an ``int32`` one.
    """
    key = (op, width, coeff_bits, index_bits, torch.device(device), dtype)
    tab = _TABLES.get(key)
    if tab is None:
        tab = _TABLES[key] = _materialize(key).to(key[4])
    return tab


def materialized_tables() -> dict[tuple, torch.Tensor]:
    """Every table tensor :func:`table_for` has handed out, by (op, width,
    coeff_bits, index_bits, device, dtype): the memory the plain versions
    and the kernels read, which the scrub reads back."""
    return dict(_TABLES)


def refresh_tables() -> None:
    """Rewrite every materialized table from :func:`build_table` under the
    current arming, in place (``copy_`` on the current stream). All new
    contents are built before the first write, so a fault that cannot
    reach a table (an ``index`` past its end) raises with every table
    unchanged."""
    new = [(t, _materialize(key)) for key, t in _TABLES.items()]
    for t, src in new:
        t.copy_(src)


def region_index(x1_fp: torch.Tensor, x2_fp: torch.Tensor, width: int,
                 index_bits: int = 3) -> torch.Tensor:
    """``2*index_bits``-bit region index from the two aligned fractions
    (the low F bits of the log values): their ``index_bits`` MSBs,
    concatenated — the wiring of the paper's coefficient LUTs."""
    sh = frac_bits(width) - index_bits
    return ((x1_fp >> sh) << index_bits) | (x2_fp >> sh)
