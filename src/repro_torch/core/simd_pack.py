"""Sub-word SIMD packing: 4x8-bit / 2x16-bit lanes in one uint32 word.

Counterpart of ``repro.core.simd_pack``: the plain lane semantics that the
``packed`` op (``repro_torch.kernels.packed_simd``) computes. On the card
the win of the same packing is memory traffic: operands cross device
memory packed (4 values per 32-bit word) and are expanded only in
registers.

Mixed functionality (paper §3.2): :func:`packed_mixed` takes a per-lane
mode mask so each lane independently multiplies or divides — the one-hot
``Mul/Div mode`` signal of Fig. 2(a).

Words and lanes are ``torch.uint32`` at this module's boundary, as in the
reference; the shifts run on the int64 carrier of
:mod:`repro_torch.core.mitchell` (``from_lanes`` / ``to_lanes``), since
PyTorch's ``uint32`` lacks most integer operators. The reference's output
conventions are kept exactly: :func:`packed_mul` repacks its 16-bit
products two to a word at width 8 but returns *unpacked* uint32 lanes at
width 16; :func:`packed_div` and :func:`packed_mixed` return unpacked
lanes.
"""
from __future__ import annotations

import torch

from .mitchell import BUS_MASK, from_lanes, to_lanes
from .simdive import SimdiveSpec, simdive_div, simdive_mul

__all__ = [
    "pack", "unpack", "packed_mul", "packed_div", "packed_mixed",
    "lanes_per_word",
]


def lanes_per_word(width: int) -> int:
    if width not in (8, 16):
        raise ValueError("packing supports 8- or 16-bit lanes in 32-bit words")
    return 32 // width


def pack(lanes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ``(..., L)`` unsigned lane values into ``(..., L/lpw)`` uint32.

    Lane 0 occupies the least-significant bits (little-endian lanes, like
    the FPGA's sub-word wiring). Values are taken modulo 2^32 and not
    masked to the lane, as the reference's ``uint32`` shifts take them.
    """
    lpw = lanes_per_word(width)
    if lanes.shape[-1] % lpw:
        raise ValueError(f"last dim must be a multiple of {lpw}")
    x = (from_lanes(lanes) & BUS_MASK).reshape(*lanes.shape[:-1], -1, lpw)
    out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(lpw):
        out |= (x[..., i] << (width * i)) & BUS_MASK
    return to_lanes(out)


def unpack(words: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack`: ``(..., W)`` uint32 -> ``(..., W*lpw)``."""
    lpw = lanes_per_word(width)
    mask = (1 << width) - 1
    w = from_lanes(words)
    parts = [(w >> (width * i)) & mask for i in range(lpw)]
    return to_lanes(torch.stack(parts, dim=-1).reshape(*words.shape[:-1], -1))


def packed_mul(aw: torch.Tensor, bw: torch.Tensor,
               spec: SimdiveSpec) -> torch.Tensor:
    """Lane-parallel SIMDive product of packed words.

    Products of w-bit lanes need 2w bits, so the output uses two words per
    input word (the FPGA's doubled output bus): at width 8 the 16-bit
    products are packed two to a word, ``(..., W) -> (..., 2W)``; at width
    16 the 32-bit products come back as unpacked uint32 lanes (the same
    shape).
    """
    a = unpack(aw, spec.width)
    b = unpack(bw, spec.width)
    p = simdive_mul(a, b, spec)                    # 2w-bit values
    return pack(p, 2 * spec.width) if spec.width == 8 else to_lanes(p)


def packed_div(aw: torch.Tensor, bw: torch.Tensor, spec: SimdiveSpec,
               frac_out: int = 0) -> torch.Tensor:
    """Lane-parallel SIMDive quotient of packed words (unpacked output)."""
    a = unpack(aw, spec.width)
    b = unpack(bw, spec.width)
    return to_lanes(simdive_div(a, b, spec, frac_out=frac_out))


def packed_mixed(aw: torch.Tensor, bw: torch.Tensor, mode: torch.Tensor,
                 spec: SimdiveSpec, frac_out: int = 0) -> torch.Tensor:
    """Mixed functionality: per-lane mul (mode nonzero) or div (mode 0).

    ``mode`` has the unpacked lane shape; this is the SIMD unit of Fig. 2(a)
    where every sub-unit carries its own one-hot Mul/Div signal. Output is
    unpacked uint32 lanes (products at integer scale, quotients at
    ``2^frac_out`` scale) so both result kinds coexist.
    """
    a = unpack(aw, spec.width)
    b = unpack(bw, spec.width)
    p = simdive_mul(a, b, spec)
    q = simdive_div(a, b, spec, frac_out=frac_out)
    sel = mode if mode.dtype == torch.bool else from_lanes(mode) != 0
    return to_lanes(torch.where(sel, p, q))
