"""Shared operand sets + evaluation conventions for the error sweeps.

Counterpart of ``repro.metrics.operands``, the port's own copy (pure
numpy, the same seeded draws). The reference's sweeps — Table 2, Fig. 1,
the BENCH grid and its conformance suite — and the port's
(:mod:`repro_torch.tuning.frontier`, ``chip_smoke.py``) draw their
operands from these definitions, so "the 8-bit grid" means the same
operand set on both sides. Arrays are host numpy; call sites wrap them
with ``torch.from_numpy`` and move them to their device.

``DIV_FRAC_OUT`` is the divider fixed-point output format of the whole
evaluation (paper's 16/8 divider: 12 fractional quotient bits keeps every
quotient above the quantization floor); Table 2, the BENCH grid and the
conformance bounds must all quantize quotients identically or trajectory
diffs compare different formats under the same config key.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DIV_FRAC_OUT", "PACKED_DIV_FRAC_OUT", "grid8", "sample_uints",
           "stratified_pairs"]

#: divider fixed-point output bits used by every error sweep
DIV_FRAC_OUT = 12

#: quotient bits of every *packed* 8-bit sweep (BENCH grid and tier-2
#: bounds alike): packed lanes double on output, so 8 fractional bits is
#: the widest format whose quotients (max 255 << 8) still fit the 16-bit
#: output lane
PACKED_DIV_FRAC_OUT = 8


def grid8(include_zero: bool = False, flat: bool = True):
    """The exhaustive 8-bit operand grid as two uint32 arrays.

    ``include_zero`` adds the zero row/column (the zero-flag bypass is
    part of the datapath contract; accuracy sweeps exclude it because a
    zero operand has no relative error). ``flat`` ravels the meshgrid.
    """
    a = np.arange(0 if include_zero else 1, 256, dtype=np.uint32)
    A, B = np.meshgrid(a, a, indexing="ij")
    if flat:
        return A.ravel(), B.ravel()
    return A, B


def sample_uints(width: int, n: int, seed: int, *, lo: int = 1,
                 b_width: int | None = None, b_lo: int | None = None):
    """Seeded uniform operand pair; ``b_width`` narrows the second operand
    (the paper's N/8 divider format).

    ``b_lo`` floors the second operand independently of ``lo``: a divider
    sweep that wants zeros among the dividends (the zero-flag bypass) must
    still never sample a zero divisor — ``b == 0`` makes the exact quotient
    non-finite and poisons every relative statistic of the config (the
    exhaustive path excludes zeros via :func:`grid8`; this keeps the
    sampled paths consistent with it). Defaults to ``lo``.
    """
    rng = np.random.default_rng(seed)
    dt = np.uint32 if width <= 16 else np.uint64
    a = rng.integers(lo, 1 << width, n, dtype=np.uint64).astype(dt)
    b = rng.integers(lo if b_lo is None else b_lo,
                     1 << (b_width or width), n,
                     dtype=np.uint64).astype(dt)
    return a, b


def stratified_pairs(width: int, seed: int, *, per_stratum: int = 2,
                     b_width: int | None = None):
    """Exponent-pair-stratified operand pairs: every (k1, k2) LOD stratum
    covered.

    The datapath's behaviour is piecewise in the operands' leading-one
    positions — the LOD outputs (k1, k2) select the correction region and
    the anti-log shift — so uniform sampling at width 32 leaves most of
    the 32x32 exponent-pair square untouched (uniform uints concentrate in
    the top few octaves). This draws ``per_stratum`` pairs from *every*
    (k1, k2) combination: operand ``a`` uniform in ``[2^k1, 2^(k1+1))``,
    ``b`` uniform in ``[2^k2, 2^(k2+1))`` — so each LOD combination is
    exercised at least once per sweep (ROADMAP's width-32
    exhaustive-enough item). Zero operands are deliberately excluded (the
    zero-flag bypass has its own exhaustive tests; a zero divisor would
    poison relative statistics).

    ``b_width`` narrows the second operand's strata to ``b_width``
    leading-one positions (the paper's N/8 divider format). Returns two
    equally-shaped 1-D arrays of ``width*b_strata*per_stratum`` operands,
    uint32 up to width 16 and uint64 beyond.
    """
    if per_stratum < 1:
        raise ValueError(f"per_stratum must be >= 1, got {per_stratum}")
    rng = np.random.default_rng(seed)
    dt = np.uint32 if width <= 16 else np.uint64
    k1 = np.arange(width, dtype=np.uint64)
    k2 = np.arange(b_width or width, dtype=np.uint64)
    K1, K2 = np.meshgrid(k1, k2, indexing="ij")
    K1 = np.repeat(K1.ravel(), per_stratum)
    K2 = np.repeat(K2.ravel(), per_stratum)
    # value in [2^k, 2^(k+1)): the leading one pinned at bit k, the low
    # bits uniform (rng.random keeps this exact for k up to 52)
    lo1, lo2 = (np.uint64(1) << K1), (np.uint64(1) << K2)
    a = lo1 + (rng.random(K1.size) * lo1).astype(np.uint64)
    b = lo2 + (rng.random(K2.size) * lo2).astype(np.uint64)
    return a.astype(dt), b.astype(dt)
