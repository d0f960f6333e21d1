"""Accuracy/throughput frontiers: the facts the autotuner selects from.

Counterpart of ``repro.tuning.frontier``. One :class:`FrontierPoint` per
``(kernel, op, width, coeff_bits, index_bits, backend)`` config joins

  * **analytic error stats** — :func:`measure_error`, computed through the
    same ``get_op`` entry the port's users call: ``'elemwise'`` exhaustive
    over the full operand square at width 8, exponent-pair *stratified*
    samples at width 16 (:func:`repro_torch.metrics.stratified_pairs`);
    ``'packed'`` the same per-lane stats *through* the SIMD pack -> packed
    kernel -> unpack word path; ``'matmul_int'`` / ``'matmul_emul'``
    accumulate-level stats against the exact int64 matmul; and
  * **measured throughput** — ``best_us`` joined from a BENCH trajectory by
    the gate's own :func:`repro_torch.metrics.trajectory.grid_key`
    (:func:`bench_timings`). Timing is *joined*, never measured here:
    selection must be deterministic given a frozen BENCH file.

:func:`measure_error` runs on the card by default: the operands are made
with numpy from the reference's seeds, moved to ``device`` and dispatched
with ``backend='auto'``, so CUDA tensors reach the hand-written kernels
(``device='cpu'`` runs the plain versions, as the tests do; the reference
hard-codes its ``'ref'`` backend because it runs on a CPU). Integer
outputs that are bit-equal give the reference's float64 statistics
exactly. Its cache is keyed per device, so CPU and card results never mix.
Width 32 raises ``NotImplementedError`` as everywhere in the port.

Where the timings come from: :func:`default_bench_path` reads
``SIMDIVE_BENCH`` as the reference does, then looks only for
``BENCH_simdive_torch.json``, in the working directory and then at the
repo root. It never falls back to the reference's ``BENCH_simdive.json``:
its ``best_us`` are the JAX package's timings on a CPU, and a policy built
on the card must not carry them in its ``stats``. Without a port BENCH
file the join is empty and selection falls back to the static cost order.
An explicit ``bench=`` path, document or run record is read exactly as the
reference reads it. The join keys on the point's ``backend`` as written (a
``simdive-policy/v1`` interchange name: ``auto``, ``ref``, ``pallas``...).

A config the trajectory has never timed still yields a frontier point —
its ``best_us`` is ``None`` and selection falls back to the static cost
order (fewer ``coeff_bits``, narrower lane). ``us_per_item`` (best_us /
items) is the cross-width comparable statistic: different widths sweep
different operand counts, so raw ``best_us`` only ranks points within one
width. :func:`pareto` reduces a point set to its non-dominated
accuracy/throughput subset — the frontier proper.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.device import require_device
from repro_torch.core.mitchell import check_width

__all__ = [
    "FRONTIER_SEED",
    "DEFAULT_COEFF_SWEEP",
    "DEFAULT_MATMUL_SHAPE",
    "SUPPORTED_WIDTHS",
    "FrontierPoint",
    "default_bench_path",
    "measure_error",
    "bench_timings",
    "build_frontier",
    "pareto",
    "frontier_table",
]

#: the trajectory grid's coeff_bits sweep — frontier points line up with
#: the BENCH grid's keys so the timing join actually hits
DEFAULT_COEFF_SWEEP = (0, 2, 4, 6, 8)

#: widths the datapath defines; the port computes 8 and 16 (32 raises)
SUPPORTED_WIDTHS = (8, 16, 32)

#: the port's BENCH trajectory; the reference's BENCH_simdive.json is never
#: read by default (its timings are the JAX package's, on a CPU)
BENCH_FILE = "BENCH_simdive_torch.json"


@dataclass(frozen=True)
class FrontierPoint:
    """One measured config: a concrete registry dispatch + its stats.

    ``error`` is a sorted tuple of ``(stat, value)`` pairs (hashable;
    see :meth:`error_dict`); ``error_source`` records how it was computed
    ('exhaustive', 'stratified' or 'sampled'); ``best_us``/``items``/
    ``us_per_item`` come from the BENCH join and are ``None`` when the
    trajectory has no timing for the config.
    """
    kernel: str
    op: str
    width: int
    coeff_bits: int
    index_bits: int
    backend: str
    error: tuple
    error_source: str
    best_us: float | None = None
    items: int | None = None

    @property
    def us_per_item(self) -> float | None:
        if self.best_us is None or not self.items:
            return None
        return self.best_us / self.items

    def error_dict(self) -> dict:
        return dict(self.error)

    def stat(self, metric: str) -> float | None:
        return self.error_dict().get(metric)

    def label(self) -> str:
        return (f"{self.kernel}/{self.op}/{self.width}b/cb{self.coeff_bits}/"
                f"ib{self.index_bits}/{self.backend}")


def default_bench_path() -> str | None:
    """The port's BENCH trajectory to join timings from, best effort.

    ``SIMDIVE_BENCH`` env var, then ``BENCH_simdive_torch.json`` in the
    current directory, then at the repo root relative to this source tree.
    ``None`` when neither exists — frontiers still build, just without
    timings. ``BENCH_simdive.json`` (the reference's CPU timings) is never
    a fallback.
    """
    env = os.environ.get("SIMDIVE_BENCH")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.path.join(os.getcwd(), BENCH_FILE),
        os.path.normpath(os.path.join(here, "..", "..", "..", BENCH_FILE)),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


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


# ------------------------------------------------------------- timings ---
# path -> ((mtime_ns, size), timings): the trajectory is an append-only
# history file that build_policy would otherwise re-parse once per
# (op, width); the (mtime, size) stamp invalidates on any append
_TIMINGS_CACHE: dict = {}


def bench_timings(bench) -> dict:
    """``(kernel, op, width, coeff_bits, index_bits, backend) ->
    (best_us, items)`` from a BENCH trajectory.

    ``bench`` is a path, a loaded trajectory document, or a single run
    record; the latest grid-bearing run is indexed with the gate's own
    :func:`~repro_torch.metrics.trajectory.grid_key` and the shape-bucket
    component is then folded away (a frontier cares *that* a config was
    timed, not at which operand shape). Failed entries and entries without
    a positive ``best_us`` are skipped. Returns ``{}`` for ``bench=None``
    or an unreadable path: timing is an optional join, never a hard input.
    """
    from repro_torch.metrics.trajectory import (
        grid_key,
        latest_grid_run,
        load_trajectory,
    )

    if bench is None:
        return {}
    if isinstance(bench, str):
        try:
            st = os.stat(bench)
            stamp = (st.st_mtime_ns, st.st_size)
            hit = _TIMINGS_CACHE.get(bench)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            doc = load_trajectory(bench, missing_ok=False)
        except Exception:  # noqa: BLE001 — optional join, degrade quietly
            return {}
        run = latest_grid_run(doc)
    elif isinstance(bench, dict) and "runs" in bench:
        run = latest_grid_run(bench)
    else:
        run = bench                      # a single run record
    out: dict = {}
    for entry in (run or {}).get("grid", []):
        if entry.get("status") != "ok":
            continue
        tp = entry.get("throughput") or {}
        best = tp.get("best_us", tp.get("mean_us"))
        if not isinstance(best, (int, float)) or best <= 0:
            continue
        cfg = grid_key(entry)[:6]        # drop the shape-bucket component
        prev = out.get(cfg)
        if prev is None or best < prev[0]:
            out[cfg] = (float(best), tp.get("items"))
    if isinstance(bench, str):
        _TIMINGS_CACHE[bench] = (stamp, out)
    return out


# ------------------------------------------------------------ frontier ---
def build_frontier(op: str, *, width: int, coeff_sweep=DEFAULT_COEFF_SWEEP,
                   index_bits: int = 3, backend: str = "auto",
                   bench="auto", error_fn=None,
                   kernel: str = "elemwise",
                   shape: tuple | None = None,
                   device: torch.device | str = "cuda") -> tuple:
    """All frontier points of one ``(kernel, op, width)`` sweep.

    ``bench`` joins measured ``best_us``: 'auto' resolves via
    :func:`default_bench_path`, ``None`` skips the join, anything else is
    passed to :func:`bench_timings`. ``kernel`` picks the measurement
    level (see :func:`measure_error`; ``shape`` is the matmul ``(M, K,
    N)``) and is part of the timing-join identity, as is ``backend`` (the
    interchange name the points carry; the port's default is ``'auto'``,
    the reference's ``'ref'``). ``device`` is where :func:`measure_error`
    runs (default the card). ``error_fn(op, width, coeff_bits,
    index_bits) -> (stats_pairs, source)`` overrides the analytic
    measurement (fixture injection for unit tests — production callers
    never pass it; it bypasses the kernel/shape/device dimensions).
    """
    if bench == "auto":
        bench = default_bench_path()
    timings = bench_timings(bench)
    points = []
    for cb in coeff_sweep:
        if error_fn is not None:
            stats, source = error_fn(op, width, cb, index_bits)
        else:
            stats, source = measure_error(op, width, cb, index_bits,
                                          kernel=kernel, shape=shape,
                                          device=device)
        point = FrontierPoint(kernel=kernel, op=op, width=width,
                              coeff_bits=cb, index_bits=index_bits,
                              backend=backend, error=tuple(stats),
                              error_source=source)
        timed = timings.get((kernel, op, width, cb, index_bits, backend))
        if timed is not None:
            point = replace(point, best_us=timed[0], items=timed[1])
        points.append(point)
    return tuple(points)


def pareto(points, metric: str = "are_pct") -> tuple:
    """The non-dominated subset: no other point is at least as accurate
    *and* strictly cheaper (by ``us_per_item``, falling back to
    ``coeff_bits`` as the static cost proxy when timings are absent)."""
    def cost(p):
        c = p.us_per_item
        return (0, c) if c is not None else (1, p.coeff_bits)

    kept = []
    for p in points:
        e = p.stat(metric)
        if e is None:
            continue
        dominated = any(
            q is not p and q.stat(metric) is not None
            and q.stat(metric) <= e and cost(q) <= cost(p)
            and (q.stat(metric) < e or cost(q) < cost(p))
            for q in points)
        if not dominated:
            kept.append(p)
    return tuple(sorted(kept, key=lambda p: (p.stat(metric), cost(p))))


def frontier_table(points, metric: str = "are_pct") -> str:
    """Human-readable frontier rendering, the reference's table."""
    lines = [f"{'config':38s} {metric:>10s} {'best_us':>10s} "
             f"{'us/item':>10s}  source"]
    for p in sorted(points, key=lambda p: (p.width, p.coeff_bits)):
        e = p.stat(metric)
        err = f"{e:.4f}" if e is not None else "-"   # unknown metric name
        us = f"{p.best_us:.0f}" if p.best_us is not None else "-"
        upi = f"{p.us_per_item:.2e}" if p.us_per_item is not None else "-"
        lines.append(f"{p.label():38s} {err:>10s} {us:>10s} {upi:>10s}  "
                     f"{p.error_source}")
    return "\n".join(lines)
