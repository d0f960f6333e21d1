"""Composable SIMDive datapath stages in plain PyTorch — the shared log
front-end, written once on the host side.

Counterpart of ``repro.kernels.datapath``. A single Mitchell log datapath —
LOD -> log conversion -> ternary add with a region correction -> anti-log —
serves multiplication, division and the mixed mode; only the adder wiring
differs. The device side of the same stages is
``csrc/simdive_datapath.cuh``, which every CUDA kernel includes; each
kernel's plain version composes the functions below, so kernel and plain
version are the same arithmetic written twice, once per side.

Stage map (FPGA block -> function):

    LOD + log conversion            lod_log
    region index + coefficient LUT  region_corr
    ternary add + anti-log, mul     antilog_mul
    ternary add + anti-log, div     antilog_div
    fused correct + anti-log        log_mul / log_div
    whole SISD unit (Fig. 2b)       lane_op

All tensors are int64 carriers of the lane values (unsigned 32-bit values
for widths 8 and 16, the 64-bit bus at width 32; see
:mod:`repro_torch.core.mitchell`); tables are int64 tensors on the
operands' device. The sign network (``sign_split`` / ``sign_join``) carries
signed int32 values on the same int64 carrier, and the sub-word lane wiring
of the packed kernel (``lane_expand`` / ``lane_repack``) splits uint32
words into lanes and repacks results onto the doubled output bus on it.
"""
from __future__ import annotations

import torch

from repro_torch.core.error_lut import region_index, table_for
from repro_torch.core.mitchell import (
    as_carrier,
    bus_max,
    check_width,
    frac_bits,
    from_lanes,
    mitchell_antilog_div,
    mitchell_antilog_mul,
    mitchell_log,
    wrap_int32,
)
from repro_torch.faults.inject import apply_lane_faults, faults_enabled

__all__ = [
    "fraction_mask",
    "lod_log",
    "region_corr",
    "split_tables",
    "op_table",
    "antilog_mul",
    "antilog_div",
    "log_mul",
    "log_div",
    "lane_op",
    "wrap_int32",
    "sign_split",
    "sign_join",
    "lane_expand",
    "lane_repack",
]


# ------------------------------------------------------------- front end --
def fraction_mask(width: int) -> int:
    """Mask selecting the F-bit fraction field of a log value."""
    return (1 << frac_bits(width)) - 1


def lod_log(a: torch.Tensor, width: int) -> torch.Tensor:
    """Stage 1: LOD + log conversion, ``L = (k << F) | x_fp``.

    Fault hook: site='log' upsets land on this stage's output register
    ``L`` (:mod:`repro_torch.faults.inject`); disarmed the hook is a no-op.
    """
    L = mitchell_log(a, width)
    if faults_enabled():
        L = apply_lane_faults(L, site="log", width=width)
    return L


# ------------------------------------------------------------ correction --
def region_corr(la: torch.Tensor, lb: torch.Tensor, tab: torch.Tensor,
                width: int, index_bits: int = 3,
                gate: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 2: region index from both log fractions + coefficient gather.

    ``gate`` (optional bool tensor): zero detection — a False lane gets a
    zero coefficient, the zero-flag bypass of the LUT.
    """
    m = fraction_mask(width)
    corr = tab[region_index(la & m, lb & m, width, index_bits)]
    if gate is not None:
        corr = torch.where(gate, corr, torch.zeros_like(corr))
    return corr


def split_tables(tab: torch.Tensor, index_bits: int, op: str):
    """Mixed-functionality table wiring: '[mul | div]' -> per-half views."""
    if op != "mixed":
        return tab, tab
    T = 1 << (2 * index_bits)
    return tab[:T], tab[T:]


def op_table(op: str, width: int, coeff_bits: int, index_bits: int = 3, *,
             device: torch.device | str = "cpu",
             dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Materialize the coefficient table an op needs ('mixed' -> [mul|div])."""
    if op == "mixed":
        return torch.cat([
            table_for("mul", width, coeff_bits, index_bits, device=device,
                      dtype=dtype),
            table_for("div", width, coeff_bits, index_bits, device=device,
                      dtype=dtype),
        ])
    return table_for(op, width, coeff_bits, index_bits, device=device,
                     dtype=dtype)


# -------------------------------------------------------------- anti-log --
def antilog_mul(la: torch.Tensor, lb: torch.Tensor, width: int,
                corr: torch.Tensor | None = None, round_out: bool = False,
                zero: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 3a: ternary add + product anti-log, with zero-flag bypass
    (``zero`` marks lanes where either operand is 0: x * 0 = 0)."""
    p = mitchell_antilog_mul(la, lb, width, corr=corr, round_out=round_out)
    if zero is not None:
        p = torch.where(zero, torch.zeros_like(p), p)
    return p


def antilog_div(la: torch.Tensor, lb: torch.Tensor, width: int,
                corr: torch.Tensor | None = None, frac_out: int = 0,
                round_out: bool = False,
                num_zero: torch.Tensor | None = None,
                den_zero: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 3b: ternary subtract + quotient anti-log, with zero flags.

    x / 0 saturates to the all-ones bus value; 0 / x = 0 — applied in that
    order so 0 / 0 = 0.
    """
    q = mitchell_antilog_div(la, lb, width, corr=corr, frac_out=frac_out,
                             round_out=round_out)
    if den_zero is not None:
        q = torch.where(den_zero, torch.full_like(q, bus_max(width)), q)
    if num_zero is not None:
        q = torch.where(num_zero, torch.zeros_like(q), q)
    return q


# --------------------------------------------------------- fused log ops --
def log_mul(la: torch.Tensor, lb: torch.Tensor, tab: torch.Tensor, width: int,
            index_bits: int = 3, round_out: bool = False,
            zero: torch.Tensor | None = None) -> torch.Tensor:
    """Fused stages 2+3a: region lookup + ternary add + anti-log."""
    corr = region_corr(la, lb, tab, width, index_bits,
                       gate=None if zero is None else ~zero)
    return antilog_mul(la, lb, width, corr=corr, round_out=round_out,
                       zero=zero)


def log_div(la: torch.Tensor, lb: torch.Tensor, tab: torch.Tensor, width: int,
            index_bits: int = 3, frac_out: int = 0, round_out: bool = False,
            num_zero: torch.Tensor | None = None,
            den_zero: torch.Tensor | None = None) -> torch.Tensor:
    """Fused stages 2+3b: region lookup + ternary subtract + anti-log."""
    zero = None
    for flag in (num_zero, den_zero):
        if flag is not None:
            zero = flag if zero is None else zero | flag
    corr = region_corr(la, lb, tab, width, index_bits,
                       gate=None if zero is None else ~zero)
    return antilog_div(la, lb, width, corr=corr, frac_out=frac_out,
                       round_out=round_out, num_zero=num_zero,
                       den_zero=den_zero)


# ------------------------------------------------------------------ signs --
def sign_split(x: torch.Tensor, width: int):
    """Signed int32 values -> (magnitude clamped to the lane, sign {-1,+1}).

    Both on the int64 carrier. ``|INT32_MIN|`` is 2^31 as in the
    reference's uint32 cast, and clamps to the lane maximum like every
    magnitude beyond the lane.
    """
    x = as_carrier(x)
    sign = torch.where(x < 0, -1, 1)
    mag = x.abs().clamp_(max=(1 << width) - 1)
    return mag, sign


def sign_join(mag: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Reattach a sign product to an unsigned datapath result: the
    reference casts the uint32 result to int32 (a product of 2^32 - 1 at
    width 16 wraps to -1) and multiplies with int32 wrap-around."""
    return wrap_int32(wrap_int32(as_carrier(mag)) * as_carrier(sign))


# ------------------------------------------------------------ lane wiring --
def lane_expand(words: torch.Tensor, width: int) -> list[torch.Tensor]:
    """Split packed uint32 words into their sub-word lanes (little-endian).

    ``words`` is any integer tensor of word values (``uint32`` included);
    returns ``32 // width`` carrier tensors of the words' shape, lane 0
    from the least-significant bits — the software rendition of the FPGA's
    shared nibble LODs.
    """
    w = from_lanes(words)
    mask = (1 << width) - 1
    return [(w >> (width * i)) & mask for i in range(32 // width)]


def lane_repack(lanes: list[torch.Tensor], owidth: int) -> torch.Tensor:
    """Repack 2w-bit lane results into uint32 words on the doubled bus.

    Little-endian lane order, interleaved along the last axis: for 8-bit
    inputs, lanes (0, 1) -> output word 2k and lanes (2, 3) -> word 2k+1.
    ``owidth >= 32`` degenerates to one result per output word (mask
    ``2^32 - 1``). Returns the words on the int64 carrier.

    Fault hook: site='pack' upsets land on the packed output bus words
    (:mod:`repro_torch.faults.inject`); disarmed the hook is a no-op. Only
    the packed kernel's body (``packed_simd.packed_word_op``) repacks
    here; ``packed_ref`` repacks through ``simd_pack.pack``, as the
    reference's does, and so never fires it.
    """
    olpw = max(32 // owidth, 1)
    omask = (1 << min(owidth, 32)) - 1
    words = []
    for j in range(len(lanes) // olpw):
        w = torch.zeros_like(lanes[0])
        for i in range(olpw):
            w = w | ((lanes[j * olpw + i] & omask) << (owidth * i))
        words.append(w)
    lead = lanes[0].shape[:-1]
    out = torch.stack(words, dim=-1).reshape(*lead, -1)
    if faults_enabled():
        out = apply_lane_faults(out, site="pack", width=owidth)
    return out


# -------------------------------------------------------- composed SISD --
def lane_op(a: torch.Tensor, b: torch.Tensor, tab: torch.Tensor, *,
            width: int, index_bits: int = 3, op: str = "mul",
            frac_out: int = 0, mode: torch.Tensor | None = None,
            round_out: bool = False) -> torch.Tensor:
    """One full SIMDive SISD unit (Fig. 2b): the canonical stage composition.

    ``op``: 'mul' | 'div' | 'mixed'. For 'mixed', ``tab`` is the
    concatenated [mul | div] table pair (see :func:`op_table`) and ``mode``
    selects per element (nonzero => mul); both halves share the LOD + log
    front-end. Returns the int64 carrier; zero semantics: x*0 = 0,
    x/0 = all-ones, then 0/x = 0.
    """
    if op not in ("mul", "div", "mixed"):
        raise ValueError(f"op must be 'mul' | 'div' | 'mixed', got {op!r}")
    check_width(width)
    a, b = as_carrier(a), as_carrier(b)
    la = lod_log(a, width)
    lb = lod_log(b, width)
    nz = (a != 0) & (b != 0)
    if op == "mul":
        return log_mul(la, lb, tab, width, index_bits, round_out=round_out,
                       zero=~nz)
    if op == "div":
        return log_div(la, lb, tab, width, index_bits, frac_out=frac_out,
                       round_out=round_out, num_zero=a == 0, den_zero=b == 0)
    if mode is None:
        raise ValueError("op='mixed' needs a per-element mode tensor")
    tab_m, tab_d = split_tables(tab, index_bits, op)
    cm = region_corr(la, lb, tab_m, width, index_bits, gate=nz)
    cd = region_corr(la, lb, tab_d, width, index_bits, gate=nz)
    p = antilog_mul(la, lb, width, corr=cm, round_out=round_out, zero=~nz)
    q = antilog_div(la, lb, width, corr=cd, frac_out=frac_out,
                    round_out=round_out, num_zero=a == 0, den_zero=b == 0)
    return torch.where(mode != 0, p, q)
