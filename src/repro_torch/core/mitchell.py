"""Bit-exact fixed-point Mitchell logarithmic multiplier / divider (PyTorch).

Counterpart of ``repro.core.mitchell``. Format, for lane width ``N``:

  * operands are unsigned integers in [1, 2^N - 1]; zero is bypassed by a
    zero flag by the callers (``kernels.datapath``),
  * ``k = floor(log2 A)``, fraction ``x = A - 2^k`` left-aligned into
    ``F = N - 1`` fractional bits, log value ``L = (k << F) | x_fp``,
  * multiply ``Ls = L1 + L2``, divide ``Ls = L1 - L2`` (signed),
  * anti-log with floor semantics: ``(2^F + Xs) << I >> F``.

**One integer form.** The reference keeps a hardware-faithful form and a
float-assisted fast form of every stage and proves them bit-identical; that
duality is a matter of its compiler, so this module keeps only the integer
form and the tests hold it equal to both.

**The lane carrier.** The reference carries lanes in ``uint32``. PyTorch's
unsigned types lack most integer operators, so everything here computes on
an ``int64`` *carrier*: a tensor of dtype ``torch.int64`` whose values are
the unsigned 32-bit lane values, 0 ... 2^32 - 1. Where the reference's
``uint32`` arithmetic wraps, the carrier is masked with :data:`BUS_MASK`,
so values stay equal bit for bit. Widths 8 and 16 are supported; width 32
needs a 64-bit unsigned bus and is refused (see :func:`check_width`).
"""
from __future__ import annotations

import torch

__all__ = [
    "SUPPORTED_WIDTHS",
    "PORTED_WIDTHS",
    "BUS_MASK",
    "frac_bits",
    "check_width",
    "lane_max_float",
    "as_carrier",
    "to_lanes",
    "from_lanes",
    "wrap_int32",
    "leading_one",
    "mitchell_log",
    "mitchell_antilog_mul",
    "mitchell_antilog_div",
    "mitchell_mul",
    "mitchell_div",
]

SUPPORTED_WIDTHS = (8, 16, 32)
#: widths whose arithmetic the port computes (tables exist for all three)
PORTED_WIDTHS = (8, 16)
#: the 32-bit output bus of the widths <= 16 datapath
BUS_MASK = 0xFFFFFFFF


def frac_bits(width: int) -> int:
    """Fraction field width F of the log representation (= N - 1)."""
    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"width must be one of {SUPPORTED_WIDTHS}, got {width}")
    return width - 1


def check_width(width: int) -> None:
    """Raise unless ``width`` is one the port's arithmetic covers."""
    frac_bits(width)
    if width not in PORTED_WIDTHS:
        raise NotImplementedError(
            f"width {width} needs a 64-bit unsigned bus, which neither the "
            "int64 carrier nor the CUDA kernels provide yet; use width 8 or 16")


def lane_max_float(width: int) -> float:
    """Largest float32 <= 2^width - 1: the clamp bound when quantizing
    floats into a width-bit lane (``float32(2^32 - 1)`` rounds *up*)."""
    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"width must be one of {SUPPORTED_WIDTHS}, got {width}")
    return float((1 << width) - (1 << max(width - 24, 0)))


def as_carrier(a: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of lane values -> the int64 carrier."""
    if a.dtype == torch.int64:
        return a
    if a.dtype.is_floating_point or a.dtype == torch.bool:
        raise TypeError(f"lane operands must be integers, got {a.dtype}")
    return a.to(torch.int64)


def from_lanes(x: torch.Tensor) -> torch.Tensor:
    """Public lane tensor (``uint32``, or any integer dtype) -> int64 carrier.

    ``uint32`` goes through its ``int32`` bit pattern, which needs only
    operators every device implements for every dtype involved."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & BUS_MASK
    return as_carrier(x)


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor of lane values in [0, 2^32) -> public ``uint32`` lanes
    (values >= 2^31 wrap into the ``int32`` bit pattern on the way)."""
    if x.dtype == torch.uint32:
        return x
    if x.dtype == torch.int32:
        return x.view(torch.uint32)
    x = as_carrier(x)
    half = 1 << 31
    return (((x + half) & BUS_MASK) - half).to(torch.int32).view(torch.uint32)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Carrier values reduced to the int32 they wrap to (two's complement):
    the reference's int32 arithmetic, which wraps mod 2^32."""
    half = 1 << 31
    return ((x + half) & BUS_MASK) - half


def leading_one(a: torch.Tensor) -> torch.Tensor:
    """Position of the leading one bit (floor(log2 a)); 0 for a == 0.

    Read from the exponent field of the float64 form of ``a`` (exact for
    every value of the carrier), the tensor counterpart of ``clz``.
    """
    _, e = torch.frexp(a.to(torch.float64))
    return (e.to(torch.int64) - 1).clamp_(min=0)


def mitchell_log(a: torch.Tensor, width: int) -> torch.Tensor:
    """Fixed-point approximate log2: ``L = (k << F) | ((a ^ 2^k) << (F - k))``.

    ``a`` is a carrier tensor with values < 2^width.
    """
    F = frac_bits(width)
    k = leading_one(a)
    frac = a ^ (1 << k)                        # strip the leading one
    return (k << F) | (frac << (F - k))        # left-align into F bits


def _antilog_floor(ls: torch.Tensor, width: int,
                   round_out: bool = False) -> torch.Tensor:
    """Anti-log ``(2^F + Xs) << I >> F`` with the barrel shifter's floor
    semantics; ``round_out`` adds the half-LSB at the truncated position.
    Saturates to the 2*width-bit bus maximum when ``I >= 2 * width``."""
    F = frac_bits(width)
    I = ls >> F
    mant = (1 << F) + (ls & ((1 << F) - 1))    # 1.Xs, F+1 bits
    shl = (I - F).clamp_(min=0)
    shr = (F - I).clamp_(min=0)
    if round_out:
        half = 1 << (shr.clamp(min=1) - 1)     # 1 << (shr-1)
        mant = mant + torch.where(shr > 0, half, torch.zeros_like(half))
    # a lane that saturates below may shift far; keep the shift in range
    out = ((mant << shl.clamp(max=32)) >> shr) & BUS_MASK
    max_out = BUS_MASK if 2 * width == 32 else (1 << (2 * width)) - 1
    return torch.where(I >= 2 * width, torch.full_like(out, max_out), out)


def mitchell_antilog_mul(l1: torch.Tensor, l2: torch.Tensor, width: int,
                         corr: torch.Tensor | None = None,
                         round_out: bool = False) -> torch.Tensor:
    """Product anti-log of two log values (+ optional signed correction,
    added in the same ternary add and clipped at zero).

    The sums wrap as the reference's do: ``l1 + l2`` mod 2^32 (uint32),
    then the correction added in int32 and clipped at zero. In-range
    operands never wrap; an upset log value or table entry
    (:mod:`repro_torch.faults`) can."""
    ls = l1 + l2
    if corr is not None:
        ls = wrap_int32(ls + corr.to(torch.int64)).clamp_(min=0)
    else:
        ls = ls & BUS_MASK
    return _antilog_floor(ls, width, round_out=round_out)


def mitchell_antilog_div(l1: torch.Tensor, l2: torch.Tensor, width: int,
                         corr: torch.Tensor | None = None,
                         frac_out: int = 0,
                         round_out: bool = False) -> torch.Tensor:
    """Quotient anti-log ``round_down(Q * 2^frac_out)``. The signed
    subtraction realizes the borrow case, in the reference's int32, which
    wraps (only upset operands reach that far); both shift directions are
    clipped to 31 like the reference's 32-bit barrel shifter."""
    F = frac_bits(width)
    ls = l1 - l2
    if corr is not None:
        ls = ls + corr.to(torch.int64)
    ls = wrap_int32(ls)
    I = ls >> F                                # arithmetic: floors
    mant = (ls & ((1 << F) - 1)) + (1 << F)    # 1.Xs, always positive
    sh = I + (frac_out - F)                    # total shift of the mantissa
    pos = sh.clamp(0, 31)
    negsh = (-sh).clamp(0, 31)
    if round_out:
        half = 1 << (negsh.clamp(min=1) - 1)   # 1 << (negsh-1)
        mant = mant + torch.where(sh < 0, half, torch.zeros_like(half))
    return torch.where(sh >= 0, (mant << pos) & BUS_MASK, mant >> negsh)


def mitchell_mul(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Plain Mitchell product (no correction). Zero operands give zero."""
    check_width(width)
    a, b = as_carrier(a), as_carrier(b)
    p = mitchell_antilog_mul(mitchell_log(a, width), mitchell_log(b, width),
                             width)
    return torch.where((a == 0) | (b == 0), torch.zeros_like(p), p)


def mitchell_div(a: torch.Tensor, b: torch.Tensor, width: int,
                 frac_out: int = 0) -> torch.Tensor:
    """Plain Mitchell quotient ``round_down(a/b * 2^frac_out)``; b == 0
    returns the all-ones bus value, then a == 0 returns 0."""
    check_width(width)
    a, b = as_carrier(a), as_carrier(b)
    q = mitchell_antilog_div(mitchell_log(a, width), mitchell_log(b, width),
                             width, frac_out=frac_out)
    q = torch.where(b == 0, torch.full_like(q, BUS_MASK), q)
    return torch.where(a == 0, torch.zeros_like(q), q)
