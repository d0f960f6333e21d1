"""SIMDive approximate multiplier / divider with tunable accuracy.

Counterpart of ``repro.core.simdive``: Mitchell's log-domain datapath plus
the region error-reduction coefficient added in the same add step.
``coeff_bits`` is the accuracy knob (0 = plain Mitchell); ``index_bits``
widens the table. All three functions compose the stage library in
:mod:`repro_torch.kernels.datapath`, which the CUDA kernels mirror;
``simdive_sqrt`` (beyond the paper) halves the Mitchell log.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .mitchell import check_width, from_lanes, wrap_bus

__all__ = ["SimdiveSpec", "simdive_mul", "simdive_div", "simdive_sqrt"]


@dataclass(frozen=True)
class SimdiveSpec:
    """Static configuration of one SIMDive lane-op."""
    width: int = 8          # lane width: 8 / 16 / 32
    coeff_bits: int = 6     # accuracy knob; 0 => plain Mitchell
    index_bits: int = 3     # 3 => 64 regions (paper), 4 => 256
    round_output: bool = True  # half-LSB rounding carry at the anti-log output


def _lane_op(a, b, spec: SimdiveSpec, op: str, frac_out: int = 0):
    from repro_torch.kernels import datapath as dp

    tab = dp.op_table(op, spec.width, spec.coeff_bits, spec.index_bits,
                      device=a.device)
    return dp.lane_op(a, b, tab, width=spec.width,
                      index_bits=spec.index_bits, op=op, frac_out=frac_out,
                      round_out=spec.round_output)


def simdive_mul(a: torch.Tensor, b: torch.Tensor,
                spec: SimdiveSpec) -> torch.Tensor:
    """Corrected approximate product of unsigned ints (< 2^width each),
    on the int64 carrier (see :mod:`repro_torch.core.mitchell`)."""
    return _lane_op(a, b, spec, "mul")


def simdive_div(a: torch.Tensor, b: torch.Tensor, spec: SimdiveSpec,
                frac_out: int = 0) -> torch.Tensor:
    """Corrected approximate quotient ``round_down(a/b * 2^frac_out)``."""
    return _lane_op(a, b, spec, "div", frac_out=frac_out)


def simdive_sqrt(a: torch.Tensor, width: int, frac_out: int = 0) -> torch.Tensor:
    """Log-domain square root ``round_down(sqrt(a) * 2^frac_out)``: halve
    the Mitchell log, then the quotient anti-log with a zero divisor log,
    no correction and no output rounding (0 -> 0). ``a`` is any integer
    tensor of values < 2^width, taken as uint32 lanes (uint64 at width 32)
    as the reference casts them; returns the int64 carrier. The log
    stage's fault hook applies, as in the reference."""
    from repro_torch.kernels import datapath as dp

    check_width(width)
    au = wrap_bus(from_lanes(a), width)
    half = dp.lod_log(au, width) >> 1
    return dp.antilog_div(half, torch.zeros_like(half), width,
                          frac_out=frac_out, num_zero=au == 0)
