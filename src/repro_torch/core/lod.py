"""Segmented 4-bit leading-one detector (paper §3.2).

Counterpart of ``repro.core.lod``. The FPGA design detects the leading one
per 4-bit nibble in parallel (a zero flag and a local position per nibble),
then picks the most significant non-zero nibble for the configured lane
width; the same nibbles serve 8-, 16- and 32-bit lanes. Here the nibble
stage is three comparisons and the select tree a ``where`` ladder, on the
int64 carrier of :mod:`repro_torch.core.mitchell`. A leading-one detector
needs no 64-bit bus, so width 32 is covered too. The tests hold it equal to
the reference and to :func:`repro_torch.core.mitchell.leading_one`.
"""
from __future__ import annotations

import torch

from .mitchell import from_lanes

__all__ = ["nibble_lod", "segmented_leading_one"]


def nibble_lod(nib: torch.Tensor):
    """Per-nibble (4-bit value) zero flag and local leading-one position.

    ``zero`` is the zero-detection flag; ``pos`` (0..3, in ``nib``'s dtype)
    is the local position, valid only where ``zero`` is False.
    """
    zero = nib == 0
    pos = ((nib >= 2).to(nib.dtype) + (nib >= 4).to(nib.dtype)
           + (nib >= 8).to(nib.dtype))
    return zero, pos


def segmented_leading_one(a: torch.Tensor, width: int) -> torch.Tensor:
    """floor(log2(a)) for a > 0 via the segmented 4-bit LOD; 0 for a == 0.

    ``width`` is the lane width in bits (a multiple of 4); ``a`` is any
    integer tensor of values < 2^width (``uint32`` included). Returns the
    int64 carrier.
    """
    if width % 4 != 0:
        raise ValueError("segmented LOD works on 4-bit segments")
    a = from_lanes(a)
    k = torch.zeros_like(a)
    found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for j in range(width // 4 - 1, -1, -1):        # MSB nibble first
        zero, pos = nibble_lod((a >> (4 * j)) & 0xF)
        here = ~found & ~zero
        k = torch.where(here, 4 * j + pos, k)
        found = found | here
    return k
