"""Port vs reference: the packed sub-word SIMD path.

The same numpy-seeded operands go through the JAX package and the port on
the CPU; every integer result must be bit-equal:

* ``core.simd_pack`` (``pack`` / ``unpack`` / ``lanes_per_word`` and
  ``packed_mul`` / ``packed_div`` / ``packed_mixed``), refusals included;
* ``kernels.datapath.lane_expand`` / ``lane_repack``;
* the ``packed`` op: the port's ``get_op(..., backend="ref")`` against the
  reference's ``ref`` backend and its Pallas kernel in interpret mode,
  ragged and 1-D word tensors, mode lanes nonzero only in their high bits;
  the exhaustive 8-bit square at all four lane positions; the port's plain
  kernel body (``packed_word_op``) against its ``packed_ref``; packed lanes
  against the elemwise lanes;
* ``metrics`` (``error_stats`` and the operand sets) and
  ``tuning.frontier.measure_error(device="cpu")``, whose packed rows must
  also give the committed BENCH_simdive.json error columns.

The CUDA kernel itself runs only on a GPU (``chip_smoke.py``); here its
wrapper's refusals are checked, which all happen before any launch.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.simd_pack as r_pack
import repro.kernels.datapath as r_dp
import repro.metrics as r_metrics
from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import get_op as r_get_op
from repro.kernels.packed_simd import packed_pallas as r_packed_pallas
from repro.tuning import measure_error as r_measure_error
import repro_torch.core.simd_pack as t_pack
import repro_torch.kernels.datapath as t_dp
import repro_torch.metrics as t_metrics
from repro_torch.core.mitchell import from_lanes, to_lanes
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import get_op, simdive_packed
from repro_torch.kernels import packed_simd as ps
from repro_torch.tuning import frontier
from repro_torch.tuning import measure_error

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))          # a writable copy


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _words(shape, seed, *, zeros=True):
    """Random uint32 words; some lanes of some words forced to 0 (whole
    8- and 16-bit lanes) so zero factors, x / 0, 0 / x and 0 / 0 show."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    if zeros:
        a.reshape(-1)[::7] &= np.uint32(0xFFFF0000)
        b.reshape(-1)[::5] &= np.uint32(0x0000FFFF)
        b.reshape(-1)[::3] &= np.uint32(0xFF00FF00)
    return a, b


def _mode(shape, width, seed):
    """Packed mode words whose nonzero lanes are nonzero only in their
    high bit (0x80 / 0x8000): a kernel that tests bit 0 would divide."""
    rng = np.random.default_rng(seed)
    lpw = 32 // width
    sel = rng.integers(0, 2, (*shape, lpw), dtype=np.uint64)
    hi = np.uint64(1 << (width - 1))
    shifts = np.arange(lpw, dtype=np.uint64) * np.uint64(width)
    return ((sel * hi) << shifts).sum(-1).astype(np.uint32)


# ------------------------------------------------------------- simd_pack --
@pytest.mark.parametrize("width", [8, 16])
def test_pack_unpack_match_reference(width):
    rng = np.random.default_rng(width)
    lanes = rng.integers(0, 1 << width, (5, 12), dtype=np.uint32)
    words = r_pack.pack(jnp.asarray(lanes), width)
    got = t_pack.pack(_t(lanes), width)
    _eq(got, words)
    _eq(t_pack.unpack(got, width), r_pack.unpack(words, width))
    _eq(t_pack.unpack(got, width), lanes)
    # lane 0 in the least-significant bits
    assert int(got[0, 0]) & ((1 << width) - 1) == int(lanes[0, 0])
    assert t_pack.lanes_per_word(width) == r_pack.lanes_per_word(width)
    # values beyond the lane bleed into the next one in both (no masking)
    wide = rng.integers(0, 1 << 31, (3, 8), dtype=np.uint32)
    _eq(t_pack.pack(_t(wide), width), r_pack.pack(jnp.asarray(wide), width))


def test_pack_refusals_match_reference():
    for width in (4, 32):
        with pytest.raises(ValueError, match="8- or 16-bit"):
            r_pack.lanes_per_word(width)
        with pytest.raises(ValueError, match="8- or 16-bit"):
            t_pack.lanes_per_word(width)
        with pytest.raises(ValueError, match="8- or 16-bit"):
            t_pack.unpack(torch.zeros(3, dtype=torch.uint32), width)
    with pytest.raises(ValueError, match="multiple of 4"):
        r_pack.pack(jnp.zeros((2, 6), jnp.uint32), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        t_pack.pack(torch.zeros(2, 6, dtype=torch.int64), 8)


@pytest.mark.parametrize("width,coeff_bits", [(8, 0), (8, 6), (16, 6)])
def test_packed_mul_div_mixed_match_reference(width, coeff_bits):
    aw, bw = _words((6, 10), seed=width + coeff_bits)
    rspec = RSpec(width=width, coeff_bits=coeff_bits)
    tspec = TSpec(width=width, coeff_bits=coeff_bits)
    ra, rb, ta, tb = jnp.asarray(aw), jnp.asarray(bw), _t(aw), _t(bw)
    fo = 8 if width == 8 else 15
    got = t_pack.packed_mul(ta, tb, tspec)
    _eq(got, r_pack.packed_mul(ra, rb, rspec))
    # the reference's conventions: products repacked at width 8 only
    prod = t_pack.unpack(got, 16) if width == 8 else got
    assert tuple(prod.shape) == (6, 10 * 32 // width)
    _eq(t_pack.packed_div(ta, tb, tspec, frac_out=fo),
        r_pack.packed_div(ra, rb, rspec, frac_out=fo))
    lanes = 32 // width
    mode = np.random.default_rng(3).integers(0, 2, (6, 10 * lanes),
                                             dtype=np.uint32)
    _eq(t_pack.packed_mixed(ta, tb, _t(mode), tspec, frac_out=fo),
        r_pack.packed_mixed(ra, rb, jnp.asarray(mode), rspec, frac_out=fo))
    _eq(t_pack.packed_mixed(ta, tb, _t(mode).bool(), tspec, frac_out=fo),
        r_pack.packed_mixed(ra, rb, jnp.asarray(mode), rspec, frac_out=fo))


# ------------------------------------------------------------ lane wiring --
@pytest.mark.parametrize("width", [8, 16])
def test_lane_expand_and_repack_match_reference(width):
    aw, _ = _words((4, 9), seed=11 + width)
    r_lanes = r_dp.lane_expand(jnp.asarray(aw), width)
    t_lanes = t_dp.lane_expand(_t(aw), width)
    assert len(t_lanes) == len(r_lanes) == 32 // width
    for got, want in zip(t_lanes, r_lanes):
        _eq(to_lanes(got), want)
    # results 2*width bits wide, distinct per lane, some beyond the lane
    # (repack masks them to owidth bits)
    rng = np.random.default_rng(width)
    outs = [rng.integers(0, 1 << 32, (4, 9), dtype=np.uint64
                         ).astype(np.uint32) for _ in r_lanes]
    owidth = 2 * width
    want = r_dp.lane_repack([jnp.asarray(o) for o in outs], owidth)
    got = t_dp.lane_repack([from_lanes(_t(o)) for o in outs], owidth)
    _eq(to_lanes(got), want)
    assert tuple(got.shape) == (4, 18)
    if width == 8:   # lanes (0, 1) -> word 2k, lanes (2, 3) -> word 2k + 1
        o = [int(x[1, 2]) & 0xFFFF for x in outs]
        assert int(got[1, 4]) == o[0] | (o[1] << 16)
        assert int(got[1, 5]) == o[2] | (o[3] << 16)


# ------------------------------------------------------------- packed op --
PACKED_CASES = [
    (shape, width, cb, op)
    for shape in ((9, 30), (7,), (2, 3, 5))
    for width in (8, 16)
    for cb in (0, 6)
    for op in ("mul", "div", "mixed")
]


def _packed_both(shape, width, cb, op, r_backend):
    aw, bw = _words(shape, seed=len(shape) * 31 + width + cb)
    mode = _mode(shape, width, seed=cb + 1) if op == "mixed" else None
    fo = 0 if op == "mul" else (8 if width == 8 else 15)
    kw = dict(op=op, frac_out=fo)
    want = r_get_op("packed", RSpec(width=width, coeff_bits=cb), r_backend)(
        jnp.asarray(aw), jnp.asarray(bw),
        mode=None if mode is None else jnp.asarray(mode), **kw)
    got = get_op("packed", TSpec(width=width, coeff_bits=cb), "ref")(
        _t(aw), _t(bw), mode=None if mode is None else _t(mode), **kw)
    return got, want


@pytest.mark.parametrize("shape,width,coeff_bits,op", PACKED_CASES)
def test_packed_ref_matches_reference(shape, width, coeff_bits, op):
    got, want = _packed_both(shape, width, coeff_bits, op, "ref")
    assert tuple(got.shape) == (*shape[:-1], 2 * shape[-1])
    _eq(got, want)


@pytest.mark.parametrize("shape,width,op", [
    (shape, width, op) for shape in ((9, 30), (7,)) for width in (8, 16)
    for op in ("mul", "div", "mixed")])
def test_packed_ref_matches_reference_pallas_kernel(shape, width, op):
    """Against ``packed_pallas`` in interpret mode, through the
    reference's pad-and-slice op (divisor pad words of lanes = 1)."""
    got, want = _packed_both(shape, width, 6, op, "pallas")
    _eq(got, want)


def test_packed_ref_matches_pallas_kernel_called_directly():
    aw, bw = _words((8, 32), seed=5)
    mode = _mode((8, 32), 8, seed=6)
    for op in ("mul", "div", "mixed"):
        kw = dict(op=op, frac_out=0 if op == "mul" else 8)
        want = r_packed_pallas(jnp.asarray(aw), jnp.asarray(bw),
                               RSpec(width=8, coeff_bits=6),
                               mode=jnp.asarray(mode), block=(8, 32),
                               interpret=True, **kw)
        got = ps.packed_ref(_t(aw), _t(bw), TSpec(width=8, coeff_bits=6),
                            mode=_t(mode) if op == "mixed" else None, **kw)
        _eq(got, want)


def _packed_grid8(shift: int):
    """Every 8-bit pair, zeros included, as (64, 256) packed words, pairs
    rotated ``shift`` lanes so each pair sits at every lane position
    across the four shifts (the reference conformance suite's layout)."""
    A, B = r_metrics.grid8(include_zero=True)
    a = np.roll(A, shift).reshape(64, -1)
    b = np.roll(B, shift).reshape(64, -1)
    return a, b, np.asarray(r_pack.pack(jnp.asarray(a), 8))


@pytest.mark.parametrize("shift", range(4))
@pytest.mark.parametrize("op,frac_out", [("mul", 0), ("div", 0), ("div", 4),
                                         ("div", 8), ("mixed", 8)])
def test_packed_exhaustive_square_at_every_lane_position(op, frac_out,
                                                         shift):
    a, b, aw = _packed_grid8(shift)
    bw = np.asarray(r_pack.pack(jnp.asarray(b), 8))
    mode = _mode(aw.shape, 8, seed=13 + shift) if op == "mixed" else None
    kw = dict(op=op, frac_out=frac_out)
    want = r_get_op("packed", RSpec(width=8, coeff_bits=6), "ref")(
        jnp.asarray(aw), jnp.asarray(bw),
        mode=None if mode is None else jnp.asarray(mode), **kw)
    got = simdive_packed(_t(aw), _t(bw), TSpec(width=8, coeff_bits=6),
                         mode=None if mode is None else _t(mode), **kw)
    _eq(got, want)


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("op", ["mul", "div", "mixed"])
def test_packed_word_op_matches_packed_ref(width, op):
    """The kernel body's plain form (expand -> lane_op per lane ->
    repack) equals the unpack -> lane_op -> pack oracle."""
    aw, bw = _words((5, 13), seed=21 + width)
    mode = _t(_mode((5, 13), width, seed=2)) if op == "mixed" else None
    spec = TSpec(width=width, coeff_bits=6)
    fo = 0 if op == "mul" else 8
    tab = t_dp.op_table(op, width, spec.coeff_bits, spec.index_bits)
    got = ps.packed_word_op(_t(aw), _t(bw), tab, mode, spec=spec, op=op,
                            frac_out=fo)
    want = ps.packed_ref(_t(aw), _t(bw), spec, op=op, mode=mode,
                         frac_out=fo)
    assert got.dtype == torch.uint32
    assert torch.equal(got, want)


@pytest.mark.parametrize("op,frac_out", [("mul", 0), ("div", 8)])
def test_packed_lanes_equal_elemwise_lanes(op, frac_out):
    """Packing is pure data movement: each packed 16-bit result lane equals
    the elemwise datapath's lane on the unpacked operands, masked to 16
    bits (x / 0 = all-ones reads back as 0xFFFF)."""
    a, b, aw = _packed_grid8(0)
    bw = t_pack.pack(_t(b), 8)
    spec = TSpec(width=8, coeff_bits=6)
    kw = dict(op=op, frac_out=frac_out)
    lanes = t_pack.unpack(simdive_packed(_t(aw), bw, spec, **kw), 16)
    elem = get_op("elemwise", spec, "ref")(_t(a), _t(b), **kw)
    assert torch.equal(from_lanes(lanes), from_lanes(elem) & 0xFFFF)


def test_packed_cuda_refusals_happen_before_any_launch():
    spec8 = TSpec(width=8, coeff_bits=6)
    w = torch.zeros(4, 8, dtype=torch.uint32)
    n0 = ps.packed_cuda.launches
    with pytest.raises(ValueError, match="16-bit output lanes"):
        ps.packed_cuda(w, w, spec8, op="div", frac_out=9)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ps.packed_cuda(w, w, spec8)
    with pytest.raises(NotImplementedError, match="width 32"):
        ps.packed_cuda(w, w, TSpec(width=32))
    with pytest.raises(ValueError, match="mode"):
        ps.packed_cuda(w, w, spec8, op="mixed")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        simdive_packed(w, w, spec8, backend="cuda")
    assert ps.packed_cuda.launches == n0
    # the plain version masks instead of refusing, as the reference's does
    aw, bw = _words((2, 8), seed=1)
    got = ps.packed_ref(_t(aw), _t(bw), spec8, op="div", frac_out=9)
    want = r_get_op("packed", RSpec(width=8, coeff_bits=6), "ref")(
        jnp.asarray(aw), jnp.asarray(bw), op="div", frac_out=9)
    _eq(got, want)


# --------------------------------------------------------------- metrics --
def test_error_stats_match_reference():
    rng = np.random.default_rng(4)
    exact = rng.integers(0, 1000, 500).astype(np.float64)
    approx = exact + rng.normal(size=500).round()
    assert (t_metrics.error_stats(approx, exact).as_dict()
            == r_metrics.error_stats(approx, exact).as_dict())
    np.testing.assert_array_equal(t_metrics.relative_error(approx, exact),
                                  r_metrics.relative_error(approx, exact))
    logits = rng.normal(size=(50, 10))
    labels = rng.integers(0, 10, 50)
    assert (t_metrics.classification_accuracy(logits, labels)
            == r_metrics.classification_accuracy(logits, labels))
    for mod in (t_metrics, r_metrics):
        with pytest.raises(ValueError, match="non-finite"):
            mod.error_stats([1.0], [np.inf])


def test_operand_sets_match_reference():
    assert t_metrics.DIV_FRAC_OUT == r_metrics.DIV_FRAC_OUT
    assert t_metrics.PACKED_DIV_FRAC_OUT == r_metrics.PACKED_DIV_FRAC_OUT
    for zero in (False, True):
        for got, want in zip(t_metrics.grid8(zero), r_metrics.grid8(zero)):
            np.testing.assert_array_equal(got, want)
    for args, kw in (((8, 16_384, 0), dict(b_lo=1)),
                     ((16, 1000, 3), dict(b_width=8))):
        for got, want in zip(t_metrics.sample_uints(*args, **kw),
                             r_metrics.sample_uints(*args, **kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for width, kw in ((16, {}), (16, dict(b_width=8, per_stratum=3))):
        for got, want in zip(t_metrics.stratified_pairs(width, 0, **kw),
                             r_metrics.stratified_pairs(width, 0, **kw)):
            np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- frontier --
#: the committed BENCH_simdive.json packed rows (width 8, n 16,384, seed 0)
BENCH_ARE_PCT = {("mul", 0): 3.7907387302052022,
                 ("mul", 6): 0.8436527329338157,
                 ("div", 0): 4.200281250156062,
                 ("div", 6): 0.9291081884186443}


@pytest.mark.parametrize("op,coeff_bits", sorted(BENCH_ARE_PCT))
def test_measure_error_packed_matches_reference_and_bench(op, coeff_bits):
    got = measure_error(op, 8, coeff_bits, kernel="packed", device="cpu")
    want = r_measure_error(op, 8, coeff_bits, kernel="packed")
    assert got == want
    assert dict(got[0])["are_pct"] == BENCH_ARE_PCT[(op, coeff_bits)]
    assert dict(got[0])["n"] == 16_384


@pytest.mark.parametrize("kernel,op,width", [
    ("elemwise", "mul", 8), ("elemwise", "div", 8),
    ("elemwise", "mul", 16), ("elemwise", "div", 16),
    ("matmul_int", "matmul", 8), ("matmul_emul", "matmul", 8)])
def test_measure_error_matches_reference(kernel, op, width):
    got = measure_error(op, width, 6, kernel=kernel, device="cpu")
    want = r_measure_error(op, width, 6, kernel=kernel)
    assert got == want


def test_measure_error_refusals_match_reference():
    for fn, kw in ((measure_error, dict(device="cpu")), (r_measure_error,
                                                         {})):
        with pytest.raises(ValueError, match="8- or 16-bit"):
            fn("mul", 16, 6, kernel="packed", **kw)
        with pytest.raises(ValueError):
            fn("mixed", 8, 6, kernel="packed", **kw)
        with pytest.raises(ValueError):
            fn("mul", 8, 6, kernel="matmul_int", **kw)
        with pytest.raises(ValueError):
            fn("mul", 12, 6, **kw)
    # width 32 is measured, not refused (the elemwise sweep on uint64
    # lanes); packed at width 32 is refused by both, as above
    assert measure_error("mul", 32, 6, device="cpu") == \
        r_measure_error("mul", 32, 6)
    for fn, kw in ((measure_error, dict(device="cpu")), (r_measure_error,
                                                         {})):
        with pytest.raises(ValueError):
            fn("mul", 32, 6, kernel="packed", **kw)


def test_measure_error_cache_is_keyed_by_device():
    measure_error("mul", 8, 0, kernel="packed", device="cpu")
    keys = [k for k in frontier._ERROR_CACHE if k[:4] == ("packed", "mul",
                                                          8, 0)]
    assert keys and all(k[-1] == "cpu" for k in keys)
