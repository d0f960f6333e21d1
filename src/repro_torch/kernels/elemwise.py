"""Fused SIMDive element-wise multiplier / divider: kernel wrapper and plain
version.

Counterpart of ``repro.kernels.elemwise`` (``elemwise_pallas``) and of
``repro.kernels.ref.elemwise_ref``. The CUDA kernel is
``csrc/elemwise.cu``; its plain PyTorch version is :func:`elemwise_ref`,
which composes :func:`repro_torch.kernels.datapath.lane_op`.

**Lane dtype.** The public lane dtype of both is ``torch.uint32`` (the
reference's). Integer inputs of any other dtype are converted on entry
(values must lie in [0, 2^width)); the result is always ``uint32``, so
x / 0 reads back as 4294967295 like the reference's. The kernel works in
native ``uint32``; the plain version converts to the int64 carrier and back.

Bound on an H100 (see the note in the source): 12 bytes of device memory
per lane over 3.35 TB/s; launch latency at small shapes. On the served
path the decode step's divider runs fused into ``decode_attention``; this
kernel serves ``measure_error`` and ``simdive_elemwise``.
"""
from __future__ import annotations

import torch

from repro_torch.core.mitchell import check_width, from_lanes, to_lanes
from repro_torch.core.simdive import SimdiveSpec
from . import build
from . import datapath as dp

__all__ = ["DEFAULT_BLOCK", "elemwise_ref", "elemwise_cuda"]

#: launch shape the op registers: (threads per block,); 4 lanes per thread
DEFAULT_BLOCK = (256,)
_OPS = {"mul": 0, "div": 1, "mixed": 2}


def elemwise_ref(a: torch.Tensor, b: torch.Tensor, spec: SimdiveSpec,
                 op: str = "mul", mode: torch.Tensor | None = None,
                 frac_out: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``lane_op`` over same-shape lanes -> uint32."""
    tab = dp.op_table(op, spec.width, spec.coeff_bits, spec.index_bits,
                      device=a.device)
    out = dp.lane_op(from_lanes(a), from_lanes(b), tab, width=spec.width,
                     index_bits=spec.index_bits, op=op, frac_out=frac_out,
                     mode=None if mode is None else from_lanes(mode),
                     round_out=spec.round_output)
    return to_lanes(out)


def cuda_operand(x: torch.Tensor, name: str,
                 like: torch.Tensor | None = None, *,
                 kernel: str = "elemwise") -> torch.Tensor:
    """A lane / word operand as the lane kernels take it: on the card,
    ``uint32``, contiguous and 16-byte aligned, shaped like ``like``."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} CUDA kernel: {name} lies on {x.device}, "
                         "not on a CUDA device")
    if like is not None and (x.shape != like.shape or x.device != like.device):
        raise ValueError(f"{kernel}: {name} {tuple(x.shape)} on {x.device} "
                         f"does not match a {tuple(like.shape)} on "
                         f"{like.device}")
    x = to_lanes(x).contiguous()
    if x.data_ptr() % 16:          # the kernel uses 16-byte loads
        x = x.clone()
    return x


def elemwise_cuda(a: torch.Tensor, b: torch.Tensor, spec: SimdiveSpec,
                  op: str = "mul", mode: torch.Tensor | None = None,
                  frac_out: int = 0, block=DEFAULT_BLOCK) -> torch.Tensor:
    """Launch the CUDA kernel on same-shape lane tensors of any rank.

    Launches on the current stream and does not synchronise. Raises on CPU
    tensors, on width 32 and on a failed build or launch — it never gives
    way to the plain version.
    """
    if op not in _OPS:
        raise ValueError(f"op must be 'mul' | 'div' | 'mixed', got {op!r}")
    check_width(spec.width)
    if not 0 <= frac_out <= 31:
        raise ValueError(f"frac_out must be in [0, 31], got {frac_out}")
    if op == "mixed" and mode is None:
        raise ValueError("op='mixed' needs a per-element mode tensor")
    au = cuda_operand(a, "a")
    bu = cuda_operand(b, "b", au)
    mu = cuda_operand(mode, "mode", au) if op == "mixed" else None
    tab = dp.op_table(op, spec.width, spec.coeff_bits, spec.index_bits,
                      device=au.device, dtype=torch.int32)
    out = torch.empty_like(au)
    lib = build.load(au.device)
    with torch.cuda.device(au.device):
        code = lib.simdive_elemwise(
            au.data_ptr(), bu.data_ptr(),
            mu.data_ptr() if mu is not None else None, out.data_ptr(),
            au.numel(), tab.data_ptr(), tab.numel(), spec.width,
            spec.index_bits, _OPS[op], frac_out, int(spec.round_output),
            int(block[0]), build.current_stream())
    build.check(code, "simdive_elemwise")
    elemwise_cuda.launches += 1
    return out


#: kernel launches made through the wrapper (read by chip_smoke.py)
elemwise_cuda.launches = 0
