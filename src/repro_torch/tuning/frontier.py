"""Accuracy frontiers: the error half of the facts the autotuner selects
from.

Counterpart of ``repro.tuning.frontier`` for :func:`measure_error` and its
operand conventions. One call gives the analytic error stats of one
``(kernel, op, width, coeff_bits, index_bits)`` registry config, computed
through the same ``get_op`` entry the port's users call:

  * ``'elemwise'`` — exhaustive over the full operand square at width 8,
    exponent-pair *stratified* samples at width 16
    (:func:`repro_torch.metrics.stratified_pairs`);
  * ``'packed'`` — the same per-lane stats *through* the SIMD pack ->
    packed kernel -> unpack word path;
  * ``'matmul_int'`` / ``'matmul_emul'`` — accumulate-level stats against
    the exact int64 matmul.

It runs on the card by default: the operands are made with numpy from the
reference's seeds, moved to ``device`` and dispatched with
``backend='auto'``, so CUDA tensors reach the hand-written kernels
(``device='cpu'`` runs the plain versions, as the tests do; the reference
hard-codes its ``'ref'`` backend because it runs on a CPU). Integer
outputs that are bit-equal give the reference's float64 statistics
exactly. Width 32 raises ``NotImplementedError`` as everywhere in the
port.

``FrontierPoint``, ``build_frontier``, ``pareto``, ``bench_timings``,
``frontier_table`` and ``default_bench_path`` are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import require_device
from repro_torch.core.mitchell import check_width

__all__ = [
    "FRONTIER_SEED",
    "DEFAULT_MATMUL_SHAPE",
    "SUPPORTED_WIDTHS",
    "measure_error",
]

#: widths the datapath defines; the port computes 8 and 16 (32 raises)
SUPPORTED_WIDTHS = (8, 16, 32)

# (kernel, op, width, coeff_bits, index_bits, shape, device) -> error tuple;
# every sweep is deterministic, so per-process memoization is free. The
# device is part of the key: a CPU result must never answer a card call.
_ERROR_CACHE: dict[tuple, tuple[tuple, str]] = {}

#: default (M, K, N) problem for the matmul frontier kernels — K sits in
#: the BENCH grid's sweep so accumulate-length effects are represented
DEFAULT_MATMUL_SHAPE = (64, 128, 64)

#: seed shared with the reference's BENCH grid — same convention, same
#: reproducibility contract
FRONTIER_SEED = 0


def _error_operands(op: str, width: int):
    """Operand set + source tag for one error sweep (numpy uint32)."""
    from repro_torch.metrics import grid8, stratified_pairs

    if width == 8:
        a, b = grid8()
        return a, b, "exhaustive"
    a, b = stratified_pairs(
        width, FRONTIER_SEED,
        # every (k1, k2) LOD stratum at least once; bounded total size
        per_stratum=max(1, 4096 // (width * (8 if op == "div" else width))),
        b_width=8 if op == "div" else None)   # paper's N/8 divider format
    return a, b, "stratified"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.float64)


def measure_error(op: str, width: int, coeff_bits: int,
                  index_bits: int = 3, *, kernel: str = "elemwise",
                  shape: tuple | None = None,
                  device: torch.device | str = "cuda") -> tuple[tuple, str]:
    """Analytic error stats of one registry config.

    Returns ``(sorted (stat, value) pairs, source)``. ``kernel`` selects
    the datapath level:

    * ``'elemwise'`` — per-lane stats; source is 'exhaustive' (width 8:
      the full operand square) or 'stratified' (16: every exponent-pair
      stratum sampled). Divider quotients are quantized at the
      evaluation-wide ``DIV_FRAC_OUT`` format, like the BENCH grid.
    * ``'packed'`` — the same per-lane stats but *through* the SIMD
      pack/unpack word path (all ``32/width`` lanes of every word at
      once; div quotients at ``PACKED_DIV_FRAC_OUT``). Width 8 only: at
      width 16 it raises ``ValueError``, as the reference does.
    * ``'matmul_int'`` / ``'matmul_emul'`` — accumulate-level stats vs
      the exact int64 matmul (op must be ``'matmul'``; ``shape`` is the
      ``(M, K, N)`` problem, default :data:`DEFAULT_MATMUL_SHAPE`). Source
      is 'sampled'.

    ``device`` is where the operands go (default the card: the kernels run;
    ``'cpu'``: the plain versions). A CUDA device on a host without one
    raises. Memoized per process and device; everything is fixed-seed
    deterministic.
    """
    dev = require_device(device)
    key = (kernel, op, width, coeff_bits, index_bits, shape, str(dev))
    hit = _ERROR_CACHE.get(key)
    if hit is not None:
        return hit
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import get_op
    from repro_torch.metrics import DIV_FRAC_OUT, error_stats

    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"width must be one of {SUPPORTED_WIDTHS}, "
                         f"got {width}")
    check_width(width)
    spec = SimdiveSpec(width=width, coeff_bits=coeff_bits,
                       index_bits=index_bits)
    if kernel == "elemwise":
        if shape is not None:
            raise ValueError("shape only applies to the matmul kernels")
        if op not in ("mul", "div"):
            raise ValueError(
                f"elemwise measure_error handles 'mul'/'div', got {op!r}")
        a_np, b_np, source = _error_operands(op, width)
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np).to(dev)
        # round_output stays at its default, as in the reference, so these
        # stats describe the same configs the BENCH grid reports
        bound = get_op("elemwise", spec, "auto")
        if op == "mul":
            out = _host(bound(a, b, op="mul"))
            true = a_np.astype(np.float64) * b_np.astype(np.float64)
        else:
            out = _host(bound(a, b, op="div", frac_out=DIV_FRAC_OUT)
                        ) / 2.0 ** DIV_FRAC_OUT
            true = a_np.astype(np.float64) / b_np.astype(np.float64)
    elif kernel == "packed":
        out, true, source = _measure_packed_error(op, width, spec, dev)
    elif kernel in ("matmul_int", "matmul_emul"):
        if op != "matmul":
            raise ValueError(
                f"kernel {kernel!r} measures op 'matmul', got {op!r}")
        out, true, source = _measure_matmul_error(
            kernel, width, spec, shape or DEFAULT_MATMUL_SHAPE, dev)
    else:
        raise ValueError(
            f"measure_error handles kernels 'elemwise'/'packed'/"
            f"'matmul_int'/'matmul_emul', got {kernel!r}")
    stats = tuple(sorted(error_stats(out, true).as_dict().items()))
    _ERROR_CACHE[key] = (stats, source)
    return stats, source


def _measure_packed_error(op: str, width: int, spec, dev: torch.device):
    """Per-lane error through the pack -> packed kernel -> unpack path."""
    from repro_torch.core.simd_pack import pack, unpack
    from repro_torch.kernels import get_op
    from repro_torch.metrics import PACKED_DIV_FRAC_OUT, sample_uints

    if op not in ("mul", "div"):
        raise ValueError(
            f"packed measure_error handles 'mul'/'div', got {op!r}")
    if width != 8:
        # the reference unpacks the packed results as 2 * width-bit lanes;
        # at width 16 its packed op already returns unpacked 32-bit lanes,
        # and unpacking 32-bit lanes is refused — the port keeps the refusal
        raise ValueError(
            f"packed measure_error unpacks its results as {2 * width}-bit "
            "lanes, and packing supports 8- or 16-bit lanes in 32-bit words "
            f"(width {width} gives {2 * width}-bit results); the reference "
            "refuses the same sweep")
    n, rows = 16_384, 64           # the BENCH grid's packed sweep size
    a_np, b_np = sample_uints(width, n, FRONTIER_SEED, b_lo=1)
    a_l = torch.from_numpy(a_np.reshape(rows, -1)).to(dev)
    b_l = torch.from_numpy(b_np.reshape(rows, -1)).to(dev)
    aw, bw = pack(a_l, width), pack(b_l, width)
    bound = get_op("packed", spec, "auto")
    kw = {"op": op} if op == "mul" else \
        {"op": op, "frac_out": PACKED_DIV_FRAC_OUT}
    lanes = _host(unpack(bound(aw, bw, **kw), 2 * width))
    af = a_np.reshape(rows, -1).astype(np.float64)
    bf = b_np.reshape(rows, -1).astype(np.float64)
    if op == "mul":
        return lanes, af * bf, "sampled"
    return lanes / 2.0 ** PACKED_DIV_FRAC_OUT, af / bf, "sampled"


def _measure_matmul_error(kernel: str, width: int, spec, shape,
                          dev: torch.device):
    """Accumulate-level error of one matmul kernel vs exact int64."""
    from repro_torch.core.approx import quantize_sign_magnitude
    from repro_torch.kernels import get_op

    m, k, n_out = shape
    rng = np.random.default_rng(FRONTIER_SEED + 2)   # BENCH grid convention
    bound = get_op(kernel, spec, "auto")
    if kernel == "matmul_int":
        hi = (1 << width) - 1
        x_np = rng.integers(-hi, hi + 1, (m, k), dtype=np.int32)
        w_np = rng.integers(-hi, hi + 1, (k, n_out), dtype=np.int32)
        appr = _host(bound(torch.from_numpy(x_np).to(dev),
                           torch.from_numpy(w_np).to(dev)))
        exact = x_np.astype(np.int64) @ w_np.astype(np.int64)
    else:   # matmul_emul: the model-facing quantized emulation
        xf = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        wf = torch.from_numpy(rng.normal(size=(k, n_out)).astype(np.float32))
        qx, sx, _ = quantize_sign_magnitude(xf.to(dev), width)
        qw, sw, _ = quantize_sign_magnitude(wf.to(dev), width, axis=0)
        appr = _host(bound(qx, sx, qw, sw))
        qx, sx, qw, sw = (t.cpu().numpy().astype(np.int64)
                          for t in (qx, sx, qw, sw))
        exact = (qx * sx) @ (qw * sw)
    return appr, exact, "sampled"
