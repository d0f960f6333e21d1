"""Competitor designs from the paper's evaluation taxonomy (Table 2).

Counterpart of ``repro.core.baselines``: the baselines SIMDive is measured
against, one definition each.

  trunc_mul       truncated multiplier — multiply the top-``keep`` bits
                  exactly (the DRUM-style family)
  const_corr_op   Mitchell datapath + one *constant* log-domain correction,
                  the mean of the ideal correction surface — MBM for
                  multiplication, INZeD for division

They have no kernel in the reference either: on CUDA tensors they run as
torch ops, on the int64 carrier of :mod:`repro_torch.core.mitchell`, and
return it, at widths 8, 16 and 32 (the 64-bit bus at width 32).
"""
from __future__ import annotations

import numpy as np
import torch

from .error_lut import ideal_correction_div, ideal_correction_mul
from .mitchell import (
    check_width,
    frac_bits,
    from_lanes,
    leading_one,
    mitchell_antilog_div,
    mitchell_antilog_mul,
    mitchell_log,
    wrap_bus,
)

__all__ = ["trunc_mul", "const_corr_op"]


def trunc_mul(a: torch.Tensor, b: torch.Tensor, width: int,
              keep: int) -> torch.Tensor:
    """Truncated multiplier: multiply the top-``keep`` bits exactly."""
    check_width(width)
    au, bu = from_lanes(a), from_lanes(b)
    sa = (leading_one(au) - (keep - 1)).clamp(min=0)
    sb = (leading_one(bu) - (keep - 1)).clamp(min=0)
    return wrap_bus(((au >> sa) * (bu >> sb)) << (sa + sb), width)


def const_corr_op(op: str, width: int):
    """Single-constant-correction op (MBM for 'mul', INZeD for 'div').

    The constant is the mean of the ideal log-domain correction surface
    over the fraction square — the best single coefficient, i.e. SIMDive
    with one region. Returns ``mul(a, b)`` or ``div(a, b, frac_out)`` on
    unsigned operands; zero handling matches the SIMDive datapath
    (x * 0 = 0, 0 / x = 0).
    """
    check_width(width)
    g = (np.arange(512) + 0.5) / 512
    X1, X2 = np.meshgrid(g, g, indexing="ij")
    f = ideal_correction_mul if op == "mul" else ideal_correction_div
    cc = int(round(float(f(X1, X2).mean()) * (1 << frac_bits(width))))

    def logs(a, b):
        au, bu = from_lanes(a), from_lanes(b)
        return au, bu, mitchell_log(au, width), mitchell_log(bu, width)

    def mul(a, b):
        au, bu, la, lb = logs(a, b)
        p = mitchell_antilog_mul(la, lb, width, corr=torch.full_like(la, cc))
        return torch.where((au == 0) | (bu == 0), torch.zeros_like(p), p)

    def div(a, b, frac_out):
        au, _, la, lb = logs(a, b)
        q = mitchell_antilog_div(la, lb, width, corr=torch.full_like(la, cc),
                                 frac_out=frac_out)
        return torch.where(au == 0, torch.zeros_like(q), q)

    return mul if op == "mul" else div
