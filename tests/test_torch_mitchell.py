"""Port vs reference: the integer arithmetic contract, bit for bit.

Everything here is integer-in / integer-out, so there is no tolerance:
the PyTorch datapath (one integer form on an int64 carrier) must equal the
JAX reference on the same operands — against its default (fast) stages
*and* against the hardware-faithful stages its Pallas kernel bodies use
(``in_kernel=True``). Operands are made with numpy from a seed and handed
to both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import error_lut as r_lut
from repro.core import mitchell as r_mit
from repro.core import simdive as r_sd
from repro.kernels import datapath as r_dp
from repro_torch.core import error_lut as t_lut
from repro_torch.core import mitchell as t_mit
from repro_torch.core import simdive as t_sd
from repro_torch.kernels import datapath as t_dp

torch.set_num_threads(1)


def _square8():
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return a.ravel(), b.ravel()


def _stratified16(seed, per_pair=6):
    """Width-16 operand pairs covering every (k1, k2) leading-one pair,
    plus every zero case."""
    rng = np.random.default_rng(seed)
    a, b = [], []
    for k1 in range(16):
        for k2 in range(16):
            a.append(rng.integers(1 << k1, 1 << (k1 + 1), per_pair))
            b.append(rng.integers(1 << k2, 1 << (k2 + 1), per_pair))
    a, b = np.concatenate(a), np.concatenate(b)
    edge = np.array([0, 1, 2, 0xFFFF, 0x8000, 0x7FFF])
    ea, eb = np.meshgrid(edge, edge, indexing="ij")
    return (np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()]))


def _ref_lane_op(a, b, *, width, coeff_bits, index_bits, op, frac_out, mode,
                 round_out, in_kernel):
    tab = r_dp.op_table(op, width, coeff_bits, index_bits)
    out = r_dp.lane_op(
        jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32), tab,
        width=width, index_bits=index_bits, op=op, frac_out=frac_out,
        mode=None if mode is None else jnp.asarray(mode, jnp.uint32),
        round_out=round_out, in_kernel=in_kernel)
    assert out.dtype == jnp.uint32
    return np.asarray(out).astype(np.int64)


def _port_lane_op(a, b, *, width, coeff_bits, index_bits, op, frac_out, mode,
                  round_out):
    tab = t_dp.op_table(op, width, coeff_bits, index_bits)
    out = t_dp.lane_op(
        torch.from_numpy(a), torch.from_numpy(b), tab, width=width,
        index_bits=index_bits, op=op, frac_out=frac_out,
        mode=None if mode is None else torch.from_numpy(mode),
        round_out=round_out)
    assert out.dtype == torch.int64
    return out.numpy()


@pytest.mark.parametrize("index_bits", [3, 4])
@pytest.mark.parametrize("coeff_bits", range(9))
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("op", ["mul", "div"])
def test_tables_array_equal(op, width, coeff_bits, index_bits):
    ref = r_lut.build_table(op, width, coeff_bits, index_bits)
    port = t_lut.build_table(op, width, coeff_bits, index_bits)
    assert port.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        t_lut.build_table_clean(op, width, coeff_bits, index_bits), ref)


@pytest.mark.parametrize("in_kernel", [False, True])
@pytest.mark.parametrize("coeff_bits", [0, 6])
@pytest.mark.parametrize("op,frac_out", [("mul", 0), ("div", 8),
                                         ("mixed", 8)])
def test_lane_op_width8_exhaustive(op, frac_out, coeff_bits, in_kernel):
    """All 256 x 256 operand pairs, zeros included."""
    a, b = _square8()
    mode = np.random.default_rng(1).integers(0, 2, a.shape) \
        if op == "mixed" else None
    kw = dict(width=8, coeff_bits=coeff_bits, index_bits=3, op=op,
              frac_out=frac_out, mode=mode, round_out=True)
    np.testing.assert_array_equal(
        _port_lane_op(a, b, **kw), _ref_lane_op(a, b, in_kernel=in_kernel,
                                                **kw))


@pytest.mark.parametrize("in_kernel", [False, True])
@pytest.mark.parametrize("op,frac_out,index_bits", [
    ("mul", 0, 3), ("div", 15, 3), ("div", 0, 4), ("mixed", 8, 3)])
def test_lane_op_width16_stratified(op, frac_out, index_bits, in_kernel):
    """Every leading-one pair (k1, k2) plus the zero / edge cross."""
    a, b = _stratified16(seed=2)
    mode = np.random.default_rng(3).integers(0, 2, a.shape) \
        if op == "mixed" else None
    kw = dict(width=16, coeff_bits=8, index_bits=index_bits, op=op,
              frac_out=frac_out, mode=mode, round_out=True)
    np.testing.assert_array_equal(
        _port_lane_op(a, b, **kw), _ref_lane_op(a, b, in_kernel=in_kernel,
                                                **kw))


@pytest.mark.parametrize("round_out", [False, True])
def test_lane_op_plain_mitchell_no_rounding(round_out):
    """coeff_bits 0 with and without the rounding carry (the 'mitchell'
    serving mode runs round_out=False)."""
    a, b = _square8()
    for op, fo in (("mul", 0), ("div", 8)):
        kw = dict(width=8, coeff_bits=0, index_bits=3, op=op, frac_out=fo,
                  mode=None, round_out=round_out)
        np.testing.assert_array_equal(
            _port_lane_op(a, b, **kw), _ref_lane_op(a, b, in_kernel=True,
                                                    **kw))


def test_zero_semantics_order():
    """x/0 = all-ones, then 0/x = 0, so 0/0 = 0; x*0 = 0."""
    a = torch.tensor([5, 0, 0, 7])
    b = torch.tensor([0, 5, 0, 0])
    tab = t_dp.op_table("div", 16, 8)
    q = t_dp.lane_op(a, b, tab, width=16, op="div", frac_out=15)
    assert q.tolist() == [0xFFFFFFFF, 0, 0, 0xFFFFFFFF]
    p = t_dp.lane_op(a, b, t_dp.op_table("mul", 16, 8), width=16, op="mul")
    assert p.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("width", [8, 16])
def test_mitchell_mul_div_match_reference(width):
    if width == 8:
        a, b = _square8()
    else:
        a, b = _stratified16(seed=4)
    ja, jb = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        t_mit.mitchell_mul(ta, tb, width).numpy(),
        np.asarray(r_mit.mitchell_mul(ja, jb, width)).astype(np.int64))
    for fo in (0, width - 1):
        np.testing.assert_array_equal(
            t_mit.mitchell_div(ta, tb, width, frac_out=fo).numpy(),
            np.asarray(r_mit.mitchell_div(ja, jb, width, frac_out=fo)
                       ).astype(np.int64))


def test_mitchell_log_and_leading_one_match_reference():
    a = np.arange(1 << 16)
    ta = torch.from_numpy(a)
    ja = jnp.asarray(a, jnp.uint32)
    np.testing.assert_array_equal(
        t_mit.leading_one(ta).numpy(),
        np.asarray(r_mit.leading_one_cascade(ja, 16)).astype(np.int64))
    np.testing.assert_array_equal(
        t_mit.mitchell_log(ta, 16).numpy(),
        np.asarray(r_mit.mitchell_log(ja, 16, fast=False)).astype(np.int64))


@pytest.mark.parametrize("width,coeff_bits", [(8, 6), (16, 8)])
def test_simdive_mul_div_match_reference(width, coeff_bits):
    a, b = _square8() if width == 8 else _stratified16(seed=5)
    rs = r_sd.SimdiveSpec(width=width, coeff_bits=coeff_bits)
    ts = t_sd.SimdiveSpec(width=width, coeff_bits=coeff_bits)
    ja, jb = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        t_sd.simdive_mul(ta, tb, ts).numpy(),
        np.asarray(r_sd.simdive_mul(ja, jb, rs)).astype(np.int64))
    np.testing.assert_array_equal(
        t_sd.simdive_div(ta, tb, ts, frac_out=width - 1).numpy(),
        np.asarray(r_sd.simdive_div(ja, jb, rs, frac_out=width - 1)
                   ).astype(np.int64))


def test_region_index_matches_reference():
    rng = np.random.default_rng(6)
    x1 = rng.integers(0, 1 << 15, 4096)
    x2 = rng.integers(0, 1 << 15, 4096)
    for ib in (3, 4):
        np.testing.assert_array_equal(
            t_lut.region_index(torch.from_numpy(x1), torch.from_numpy(x2),
                               16, ib).numpy(),
            np.asarray(r_lut.region_index(jnp.asarray(x1, jnp.uint32),
                                          jnp.asarray(x2, jnp.uint32),
                                          16, ib)))


def test_lane_helpers_and_limits():
    for w in (8, 16, 32):
        assert t_mit.lane_max_float(w) == r_mit.lane_max_float(w)
        assert t_mit.frac_bits(w) == r_mit.frac_bits(w)
    vals = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    lanes = t_mit.to_lanes(vals)
    assert lanes.dtype == torch.uint32
    assert lanes.numpy().tolist() == vals.tolist()
    assert t_mit.from_lanes(lanes).tolist() == vals.tolist()
    assert t_mit.to_lanes(lanes) is lanes


def test_width32_is_refused_not_silently_wrong():
    """Width 32 is computed, not refused: on the 64-bit bus it equals the
    reference's uint64 datapath (products of 2^63 and more included); a
    width the datapath does not define is still refused."""
    edges = np.array([0, 1, 3, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                     np.uint64)
    a, b = (x.ravel() for x in np.meshgrid(edges, edges, indexing="ij"))
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    got = t_mit.to_lanes(t_mit.mitchell_mul(ta, tb, 32), 32)
    assert got.dtype == torch.uint64
    want = np.asarray(r_mit.mitchell_mul(jnp.asarray(a), jnp.asarray(b), 32))
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.numpy()[-1]) >= 1 << 63          # (2^32-1)^2
    t_tab = t_dp.op_table("mul", 32, 6)
    r_tab = r_dp.op_table("mul", 32, 6)
    got = t_dp.lane_op(ta, tb, t_tab, width=32, op="mul", round_out=True)
    want = r_dp.lane_op(jnp.asarray(a), jnp.asarray(b), r_tab, width=32,
                        op="mul", round_out=True)
    np.testing.assert_array_equal(t_mit.to_lanes(got, 32).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError):
        t_mit.frac_bits(12)


def test_fault_seams_are_noops():
    tab = t_lut.build_table("div", 16, 8)
    assert t_lut.apply_table_faults(tab, op="div", width=16) is tab
    x = torch.arange(4)
    assert t_lut.apply_lane_faults(x, site="log", width=16) is x
