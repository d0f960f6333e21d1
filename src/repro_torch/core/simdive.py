"""SIMDive approximate multiplier / divider with tunable accuracy.

Counterpart of ``repro.core.simdive``: Mitchell's log-domain datapath plus
the region error-reduction coefficient added in the same add step.
``coeff_bits`` is the accuracy knob (0 = plain Mitchell); ``index_bits``
widens the table. Both functions compose the stage library in
:mod:`repro_torch.kernels.datapath`, which the CUDA kernels mirror.
``simdive_sqrt`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SimdiveSpec", "simdive_mul", "simdive_div"]


@dataclass(frozen=True)
class SimdiveSpec:
    """Static configuration of one SIMDive lane-op."""
    width: int = 8          # lane width: 8 / 16 (32: tables only)
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
