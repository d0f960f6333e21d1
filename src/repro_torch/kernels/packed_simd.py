"""Packed sub-word SIMDive kernel — 4x8-bit / 2x16-bit lanes per uint32 word
(Fig. 2a): kernel wrapper and plain versions.

Counterpart of ``repro.kernels.packed_simd`` (``packed_word_op``,
``packed_pallas``) and of ``repro.kernels.ref.packed_ref``. The CUDA kernel
is ``csrc/packed_simd.cu``; its plain PyTorch versions are
:func:`packed_word_op` (the kernel body as a word -> word function:
``lane_expand`` -> ``lane_op`` per lane -> ``lane_repack``) and
:func:`packed_ref` (unpack, one ``lane_op`` over all lanes, mask, pack).

Operands cross device memory packed, 4 lane values per 32-bit word, and
are expanded only in registers. Outputs, ``(..., 2 * Nw)`` uint32 words:

  * mul:   2*width-bit products on the doubled bus — two 16-bit lanes a
           word at width 8, one 32-bit lane a word at width 16;
  * div:   quotients at ``frac_out`` fractional bits (at most 8 at width 8,
           where they must fit the 16-bit output lane), same packing;
  * mixed: a per-lane mode (packed like the operands; a lane whose whole
           ``width``-bit mode field is nonzero multiplies), same packing.

The word mapping is flat — output words ``2i`` and ``2i + 1`` belong to
input word ``i`` — so any rank and any word count go straight in: the
kernel masks its ragged tail itself, where the reference pads divisor
words with lanes of 1 and slices the result back.

Bound on an H100 (see the note in the source): integer operations — 16
bytes of device memory per 4-lane word at width 8 against some 32 integer
operations a lane.
"""
from __future__ import annotations

import torch

from repro_torch.core.mitchell import check_width, from_lanes, to_lanes
from repro_torch.core.simd_pack import pack, unpack
from repro_torch.core.simdive import SimdiveSpec
from . import build
from . import datapath as dp
from .elemwise import cuda_operand

__all__ = ["DEFAULT_BLOCK", "packed_word_op", "packed_ref", "packed_cuda"]

#: launch shape the op registers: (threads per block,); 4 words a thread.
#: The only one: the TPU's (bm, bn) word tiles mean nothing on the card,
#: and 128 / 512 threads time the same (PERF.md, PR 15)
DEFAULT_BLOCK = (256,)
_OPS = {"mul": 0, "div": 1, "mixed": 2}


def _lane_kwargs(spec: SimdiveSpec, op: str, frac_out: int) -> dict:
    return dict(width=spec.width, index_bits=spec.index_bits, op=op,
                frac_out=frac_out, round_out=spec.round_output)


def _check_mode(op: str, mode) -> None:
    if op == "mixed" and mode is None:
        raise ValueError("op='mixed' needs packed per-lane mode words")


def packed_word_op(aw: torch.Tensor, bw: torch.Tensor, tab: torch.Tensor,
                   mode: torch.Tensor | None = None, *, spec: SimdiveSpec,
                   op: str, frac_out: int) -> torch.Tensor:
    """The packed kernel body as a plain word -> word function: expand the
    lanes, run the shared SISD datapath per lane, repack onto the doubled
    bus. ``tab`` is the op's int64 table (:func:`datapath.op_table`).
    Returns ``(..., 2 * Nw)`` uint32 words."""
    _check_mode(op, mode)
    width = spec.width                      # 8 (4 lanes) or 16 (2 lanes)
    a_lanes = dp.lane_expand(aw, width)
    b_lanes = dp.lane_expand(bw, width)
    m_lanes = (dp.lane_expand(mode, width) if op == "mixed"
               else [None] * len(a_lanes))
    outs = [dp.lane_op(a, b, tab, mode=m, **_lane_kwargs(spec, op, frac_out))
            for a, b, m in zip(a_lanes, b_lanes, m_lanes)]
    return to_lanes(dp.lane_repack(outs, 2 * width))


def packed_ref(aw: torch.Tensor, bw: torch.Tensor, spec: SimdiveSpec,
               op: str = "mul", mode: torch.Tensor | None = None,
               frac_out: int = 0) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``packed_ref``): unpack, one
    ``lane_op`` over all lanes, mask to ``2 * width`` bits and pack; at
    width 16 the 32-bit lanes are the output words as they are. Unlike the
    kernel it does not refuse ``frac_out > 8`` at width 8: it masks."""
    _check_mode(op, mode)
    a = unpack(aw, spec.width)
    b = unpack(bw, spec.width)
    m = unpack(mode, spec.width) if op == "mixed" else None
    tab = dp.op_table(op, spec.width, spec.coeff_bits, spec.index_bits,
                      device=a.device)
    lanes = dp.lane_op(from_lanes(a), from_lanes(b), tab,
                       mode=None if m is None else from_lanes(m),
                       **_lane_kwargs(spec, op, frac_out))
    owidth = 2 * spec.width
    if owidth >= 32:
        return to_lanes(lanes)  # one result per output word already
    return pack(lanes & ((1 << owidth) - 1), owidth)


def packed_cuda(aw: torch.Tensor, bw: torch.Tensor, spec: SimdiveSpec,
                op: str = "mul", mode: torch.Tensor | None = None,
                frac_out: int = 0, block=DEFAULT_BLOCK) -> torch.Tensor:
    """Launch the CUDA kernel on same-shape word tensors of rank >= 1.

    Returns ``(..., 2 * Nw)`` uint32 words. Launches on the current stream
    and does not synchronise. Raises on CPU tensors, on width 32, on
    ``frac_out > 8`` at width 8 (the quotient would overflow its 16-bit
    output lane) and on a failed build or launch — it never gives way to
    the plain version.
    """
    if op not in _OPS:
        raise ValueError(f"op must be 'mul' | 'div' | 'mixed', got {op!r}")
    check_width(spec.width)
    if not 0 <= frac_out <= 31:
        raise ValueError(f"frac_out must be in [0, 31], got {frac_out}")
    if spec.width == 8 and frac_out > 8:
        raise ValueError("frac_out > 8 overflows the 16-bit output lanes")
    _check_mode(op, mode)
    au = cuda_operand(aw, "aw", kernel="packed")
    if au.dim() == 0:
        raise ValueError("packed: word tensors need at least one dimension")
    bu = cuda_operand(bw, "bw", au, kernel="packed")
    mu = (cuda_operand(mode, "mode", au, kernel="packed")
          if op == "mixed" else None)
    tab = dp.op_table(op, spec.width, spec.coeff_bits, spec.index_bits,
                      device=au.device, dtype=torch.int32)
    out = torch.empty((*au.shape[:-1], 2 * au.shape[-1]), dtype=torch.uint32,
                      device=au.device)
    lib = build.load(au.device)
    with torch.cuda.device(au.device):
        code = lib.simdive_packed(
            au.data_ptr(), bu.data_ptr(),
            mu.data_ptr() if mu is not None else None, out.data_ptr(),
            au.numel(), tab.data_ptr(), tab.numel(), spec.width,
            spec.index_bits, _OPS[op], frac_out, int(spec.round_output),
            int(block[0]), build.current_stream())
    build.check(code, "simdive_packed")
    packed_cuda.launches += 1
    return out


#: kernel launches made through the wrapper (read by chip_smoke.py)
packed_cuda.launches = 0
