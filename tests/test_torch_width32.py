"""Port vs reference at width 32: the 64-bit bus, bit for bit.

The reference computes width 32 in ``uint64`` under x64 (on for every test:
``tests/conftest.py``); the port computes it on its int64 carrier read as
the 64-bit bus (``repro_torch.core.mitchell``) and hands back
``torch.uint64`` lanes. The same numpy operands — stratified over every
(k1, k2) leading-one pair, plus the edge words 0, 1, 2^31, 2^32 - 1 and
powers of two +- 1 — go through both:

* integer stages bit for bit: the Mitchell log / anti-logs, the width-32
  tables, ``lane_op`` (mul / div / mixed, with and without output
  rounding), ``simdive_sqrt``, the baselines, the ``elemwise`` and
  ``sqrt`` ops against the reference's ``ref`` (and, on a few hundred
  lanes, its Pallas kernel in interpret mode), and the same under armed
  faults (log bits 0 / 20 / 31, a transient, a table flip);
* the float stages at ``div_width`` 32: ``_fixed_point_div`` and
  ``approx_rmsnorm`` bit for bit, ``attention_div`` / ``approx_softmax``
  and both attention plain versions within the tolerances stated below;
* ``measure_error`` at width 32 equal to the reference's statistics, and
  the smoke smollm-360m served under a width-32 policy.
"""
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import approx as ra
from repro.core import baselines as r_base
from repro.core import error_lut as r_lut
from repro.core import mitchell as r_mit
from repro.core.simdive import SimdiveSpec as RSpec
from repro.core.simdive import simdive_sqrt as r_sqrt
from repro.faults import inject as r_inject
from repro.kernels import datapath as r_dp
from repro.kernels import flash_attention as r_fa
from repro.kernels import get_op as r_get_op
from repro.models import build as r_build
from repro.models import layers as r_layers
from repro.tuning import measure_error as r_measure_error
from repro.tuning.select import TuningPolicy as RPolicy
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import approx as ta
from repro_torch.core import baselines as t_base
from repro_torch.core import error_lut as t_lut
from repro_torch.core import mitchell as t_mit
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.core.simdive import simdive_sqrt
from repro_torch.faults.inject import FaultSpec, set_faults
from repro_torch.kernels import datapath as t_dp
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import get_op, launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.metrics import stratified_pairs
from repro_torch.models import build as t_build
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_reference
from repro_torch.tuning import PolicyEntry, TuningPolicy, measure_error

torch.set_num_threads(1)

W = 32
SPEC = dict(width=W, coeff_bits=8, index_bits=3)
#: the edge words: zero, one, the top bit of the lane, the lane maximum and
#: powers of two +- 1
EDGES = np.unique(np.array(
    [0, 1, 2, 3, (1 << 32) - 1, (1 << 32) - 2]
    + [(1 << k) + d for k in (8, 16, 24, 31) for d in (-1, 0, 1)],
    np.uint64))

# float stages. attention: both packages quantize the same float32 rows,
# but their acc / l differ by float32 round-off; at width 32 the row
# scale puts max(|acc|, l) in [2^30, 2^31), where one float32 ulp of acc
# is 2^7 lane units, 2^-23 of the operand: it moves a quotient at
# frac_out 15 by at most one step, 2^-15 ~ 3.1e-5 of a |v|-scale output,
# before the float32 output rounds. Four steps of margin:
W32_ATTN_TOL = dict(rtol=0, atol=1.25e-4)
# the softmax's divider operands come from float32 exp / sum computed by
# two libraries (a few ulps apart): at the fixed scale 2^16 a probability
# p < 1 is at most 2^16 lane units, so one ulp moves it by < 1 unit and
# the quotient by one step of 2^-15 (frac_out 15) — two steps of margin
W32_SOFTMAX_TOL = dict(rtol=0, atol=2 ** -14)
# served logits, float32, two layers, every attention and divide at width
# 32: the attention tolerance above, carried through two layers and the
# head (as SIMDIVE_LOGIT_TOL carries the 16-bit one in test_torch_model)
W32_LOGIT_TOL = 5e-4


@pytest.fixture
def exact_reference_scale(monkeypatch):
    """The reference's row scale made the power of two it means (R-10).

    ``repro.kernels.flash_attention.softmax_div`` and
    ``repro.core.approx.attention_div`` scale each row by
    ``jnp.exp2(w - 2 - ex)``, which XLA on the CPU computes inexactly: at
    width 32 ``exp2(30.0)`` is 2^30 - 960, so a row whose denominator is
    a power of two (every causal first row: l = 1) quantizes just under
    it, into another leading-one position and correction region, and its
    quotients move by a region's step (~1 %). At widths 8 and 16 the
    rounding to the lane absorbs the error. The port (and the kernels)
    scale by the exact power of two; here the reference's ``exp2`` (whose
    only callers take integral exponents) is made exact so that the two
    are compared on the same arithmetic."""
    exp2 = jnp.exp2

    def exact(x):
        x = jnp.asarray(x)
        return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))

    jax.clear_caches()
    monkeypatch.setattr(jnp, "exp2", exact)
    yield exp2
    monkeypatch.setattr(jnp, "exp2", exp2)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _disarmed():
    set_faults([])
    r_inject.set_faults([])
    yield
    set_faults([])
    r_inject.set_faults([])


def _operands(seed: int, per_stratum: int = 1):
    """Stratified width-32 pairs plus every pair of the edge words, as
    uint64."""
    a, b = stratified_pairs(W, seed, per_stratum=per_stratum)
    ea, eb = (x.ravel() for x in np.meshgrid(EDGES, EDGES, indexing="ij"))
    return (np.concatenate([a, ea]).astype(np.uint64),
            np.concatenate([b, eb]).astype(np.uint64))


def _t(x: np.ndarray) -> torch.Tensor:
    """uint64 numpy lanes -> the port's int64 carrier (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _u64(x: torch.Tensor) -> np.ndarray:
    """The port's lanes or carrier -> uint64 numpy (same bits)."""
    return t_mit.to_lanes(x, W).numpy()


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(_u64(got), want)


# --------------------------------------------------------------- mitchell --
def test_mitchell_stages_bit_equal():
    a, b = _operands(1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    la, lb = r_mit.mitchell_log(ja, W), r_mit.mitchell_log(jb, W)
    tla, tlb = t_mit.mitchell_log(_t(a), W), t_mit.mitchell_log(_t(b), W)
    _equal(tla, la)
    assert int(tla.max()) < 1 << 36                  # 36-bit log words
    _equal(t_mit.mitchell_antilog_mul(tla, tlb, W),
           r_mit.mitchell_antilog_mul(la, lb, W))
    for fo in (0, 8, 16):
        _equal(t_mit.mitchell_antilog_div(tla, tlb, W, frac_out=fo),
               r_mit.mitchell_antilog_div(la, lb, W, frac_out=fo))
        _equal(t_mit.mitchell_div(_t(a), _t(b), W, frac_out=fo),
               r_mit.mitchell_div(ja, jb, W, frac_out=fo))
    _equal(t_mit.mitchell_mul(_t(a), _t(b), W),
           r_mit.mitchell_mul(ja, jb, W))


def test_saturation_and_the_unsigned_read():
    """The anti-log saturates to 2^64 - 1 past the bus (the carrier's -1);
    x / 0 is the same word; both read back unsigned as lanes and floats."""
    la = t_mit.mitchell_log(torch.tensor([(1 << 32) - 1]), W)
    big = la + (1 << 31)                               # I = 64 after the sum
    p = t_mit.mitchell_antilog_mul(big, la, W)
    assert int(p) == -1 and int(_u64(p)[0]) == (1 << 64) - 1
    np.testing.assert_array_equal(
        _u64(p), np.asarray(r_mit.mitchell_antilog_mul(
            jnp.asarray(_u64(big)), jnp.asarray(_u64(la)), W)))
    q = t_mit.mitchell_div(torch.tensor([5]), torch.tensor([0]), W)
    assert int(_u64(q)[0]) == (1 << 64) - 1
    words = np.array([(1 << 64) - 1, (1 << 63) + (1 << 39) + 1, 1 << 63,
                      (1 << 40) + 1, 12345], np.uint64)
    for dtype, ndt in ((torch.float32, np.float32),
                       (torch.float64, np.float64)):
        got = t_mit.lanes_to_float(_t(words), dtype)
        np.testing.assert_array_equal(got.numpy(), words.astype(ndt))


# ----------------------------------------------------------------- tables --
@pytest.mark.parametrize("index_bits", [3, 4])
@pytest.mark.parametrize("coeff_bits", [0, 6, 8])
@pytest.mark.parametrize("op", ["mul", "div"])
def test_width32_tables_equal_reference(op, coeff_bits, index_bits):
    want = r_lut.build_table(op, W, coeff_bits, index_bits)
    got = t_lut.build_table(op, W, coeff_bits, index_bits)
    assert got.dtype == want.dtype == np.int32
    assert got.size == want.size == 1 << (2 * index_bits)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() < 1 << 30                 # |c| < 2^(F-1)
    tab = t_lut.table_for(op, W, coeff_bits, index_bits)
    np.testing.assert_array_equal(tab.numpy(), want.astype(np.int64))


# ----------------------------------------------------------------- lane_op --
@pytest.mark.parametrize("round_out", [False, True])
@pytest.mark.parametrize("op,frac_out", [("mul", 0), ("div", 0),
                                         ("div", 8), ("div", 16),
                                         ("mixed", 8)])
def test_lane_op_bit_equal(op, frac_out, round_out):
    a, b = _operands(2, per_stratum=2)
    mode = (np.arange(a.size) % 3 == 0).astype(np.uint32)
    r_tab = r_dp.op_table(op, W, 8)
    t_tab = t_dp.op_table(op, W, 8)
    kw = dict(width=W, op=op, frac_out=frac_out, round_out=round_out)
    want = r_dp.lane_op(jnp.asarray(a), jnp.asarray(b), r_tab,
                        mode=jnp.asarray(mode) if op == "mixed" else None,
                        **kw)
    got = t_dp.lane_op(_t(a), _t(b), t_tab,
                       mode=torch.from_numpy(mode.astype(np.int64))
                       if op == "mixed" else None, **kw)
    _equal(got, want)


@pytest.mark.parametrize("frac_out", [0, 8])
def test_simdive_sqrt_bit_equal(frac_out):
    a, _ = _operands(3, per_stratum=4)
    want = r_sqrt(jnp.asarray(a), W, frac_out=frac_out)
    _equal(simdive_sqrt(_t(a), W, frac_out=frac_out), want)
    lanes = get_op("sqrt", TSpec(width=W), "ref")(_t(a), frac_out=frac_out)
    assert lanes.dtype == torch.uint64
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(want))


def test_baselines_bit_equal():
    a, b = _operands(4)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for keep in (4, 12, 24):
        _equal(t_base.trunc_mul(_t(a), _t(b), W, keep),
               r_base.trunc_mul(ja, jb, W, keep))
    _equal(t_base.const_corr_op("mul", W)(_t(a), _t(b)),
           r_base.const_corr_op("mul", W)(ja, jb))
    nz = b != 0
    for fo in (0, 16):
        _equal(t_base.const_corr_op("div", W)(_t(a[nz]), _t(b[nz]), fo),
               r_base.const_corr_op("div", W)(ja[nz], jb[nz], fo))


# -------------------------------------------------------------------- ops --
@pytest.mark.parametrize("op,frac_out", [("mul", 0), ("div", 0), ("div", 8),
                                         ("div", 16), ("mixed", 8)])
def test_elemwise_op_equals_reference(op, frac_out):
    """The registry's ``elemwise`` at width 32 against the reference's
    ``ref``; on a few hundred lanes also against its Pallas kernel in
    interpret mode (uint64 lanes in its VMEM blocks)."""
    a, b = _operands(5)
    mode = (np.arange(a.size) % 2).astype(np.uint32)
    kw = dict(op=op, frac_out=frac_out)
    r_kw = dict(kw, mode=jnp.asarray(mode) if op == "mixed" else None)
    t_kw = dict(kw, mode=torch.from_numpy(mode) if op == "mixed" else None)
    got = get_op("elemwise", TSpec(**SPEC), "ref")(
        torch.from_numpy(a), torch.from_numpy(b), **t_kw)
    assert got.dtype == torch.uint64
    want = r_get_op("elemwise", RSpec(**SPEC), "ref")(
        jnp.asarray(a), jnp.asarray(b), **r_kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = 384
    kern = r_get_op("elemwise", RSpec(**SPEC), "pallas-interpret",
                    block=(8, 128))(
        jnp.asarray(a[-n:]), jnp.asarray(b[-n:]),
        **dict(kw, mode=jnp.asarray(mode[-n:]) if op == "mixed" else None))
    np.testing.assert_array_equal(got.numpy()[-n:], np.asarray(kern))
    assert not any(launch_counts().values())


# ----------------------------------------------------------------- faults --
FAULTS = {
    "log-bit0": dict(site="log", bit=0),
    "log-bit20": dict(site="log", bit=20, kind="stuck1"),
    "log-bit31": dict(site="log", bit=31),
    "log-bit20-transient": dict(site="log", bit=20, persistence="transient",
                                rate=0.5, seed=7),
    "table-div-bit20": dict(site="table", bit=20, op="div", index=27),
    "table-mul-bit28": dict(site="table", bit=28, kind="stuck1", op="mul"),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_faults_at_width_32_equal_reference(name):
    """Armed in both packages: every lane op and the square root equal
    the reference's under the upset, the log word keeping its high bits
    (k at 31..35) and the strike hash reading its low 32."""
    a, b = _operands(6)
    spec = FAULTS[name]
    r_inject.set_faults([r_inject.FaultSpec(width=W, **spec)])
    set_faults([FaultSpec(width=W, **spec)])
    r_op = r_get_op("elemwise", RSpec(**SPEC), "ref")
    t_op = get_op("elemwise", TSpec(**SPEC), "ref")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    changed = 0
    for op, fo in (("mul", 0), ("div", 16)):
        want = np.asarray(r_op(ja, jb, op=op, frac_out=fo))
        got = t_op(ta_, tb_, op=op, frac_out=fo).numpy()
        np.testing.assert_array_equal(got, want)
        set_faults([])
        changed += int((t_op(ta_, tb_, op=op, frac_out=fo).numpy()
                        != got).sum())
        set_faults([FaultSpec(width=W, **spec)])
    assert changed > 0
    want = np.asarray(r_sqrt(ja, W, frac_out=8))
    np.testing.assert_array_equal(_u64(simdive_sqrt(ta_, W, frac_out=8)),
                                  want)
    if spec["site"] == "log":
        L = t_dp.lod_log(_t(a), W)
        np.testing.assert_array_equal(
            _u64(L), np.asarray(r_dp.lod_log(ja, W)))


# ------------------------------------------------------- approx dividers --
def _cfgs(**kw):
    kw = dict(mode="simdive", div_width=W, coeff_bits=8, **kw)
    return ra.ApproxConfig(**kw), ta.ApproxConfig(**kw)


def test_fixed_point_div_bit_equal():
    """The reference's width > 16 branch: both operands at the fixed scale
    2^16, clipped at lane_max_float(32) = 2^32 - 2^8 (a numerator past it
    included), no shared exponent."""
    rng = np.random.default_rng(7)
    num = rng.uniform(0, 40000, (5, 37)).astype(np.float32)
    num[0, :4] = [0.0, 1e-6, 65535.99, 70000.0]
    den = rng.uniform(0.25, 900, (5, 37)).astype(np.float32)
    rc, tc = _cfgs(frac_out=16)
    want = np.asarray(ra._fixed_point_div(jnp.asarray(num), jnp.asarray(den),
                                          rc))
    got = ta._fixed_point_div(torch.from_numpy(num), torch.from_numpy(den),
                              tc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_approx_softmax_within_tolerance():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 7, 40)) * 4).astype(np.float32)
    rc, tc = _cfgs()
    want = np.asarray(ra.approx_softmax(jnp.asarray(x), -1, rc))
    got = ta.approx_softmax(torch.from_numpy(x), -1, tc).numpy()
    np.testing.assert_allclose(got, want, **W32_SOFTMAX_TOL)
    exact = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    assert np.abs(got - exact).max() > 1e-5          # the divider is on


def test_approx_rmsnorm_normalizes_and_equals_reference():
    """At div_width 32 the sqrt operand ``qm = (ms + eps) * 2^32`` fits the
    lane for mean squares below 1, so the log-domain rsqrt follows them
    (R-4 is a width-16 defect): within one Mitchell rsqrt of the exact
    norm. From a mean square of 1 on, ``qm`` clips at the lane maximum, as
    the reference's does, and the rsqrt is a constant (ROADMAP R-10).
    Bit-equal to the reference throughout."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal((3, 64)) * s
                        for s in (1e-3, 0.3, 0.6, 20.0)]).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    rc, tc = _cfgs(use_in_norm=True)
    want = np.asarray(ra.approx_rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                        1e-5, rc))
    got = ta.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                            1e-5, tc).numpy()
    np.testing.assert_array_equal(got, want)
    ms = (x.astype(np.float64) ** 2).mean(-1)
    exact = x / np.sqrt(ms[:, None] + 1e-5) * gamma
    rel = np.abs(got - exact).max(-1) / np.abs(exact).max(-1)
    inside = ms + 1e-5 < 1.0
    assert inside[:9].all() and not inside[9:].any()
    assert rel[inside].max() < 0.15                  # one Mitchell rsqrt
    inv = (got / (x * gamma))[~inside]               # the clipped rows
    np.testing.assert_allclose(inv, inv.flat[0], rtol=1e-6)


def test_attention_div_within_tolerance():
    rng = np.random.default_rng(10)
    acc = (rng.standard_normal((2, 3, 5, 64)) * 3).astype(np.float32)
    l = rng.uniform(0.5, 40.0, (2, 3, 5)).astype(np.float32)
    rc, tc = _cfgs()
    want = np.asarray(ra.attention_div(jnp.asarray(acc), jnp.asarray(l), rc))
    got = ta.attention_div(torch.from_numpy(acc), torch.from_numpy(l),
                           tc).numpy()
    # the same float32 rows in both packages: the quantized lanes agree,
    # so the quotients do to the last bit
    np.testing.assert_array_equal(got, want)
    qn, qd = t_fa.softmax_div_quantize(torch.from_numpy(acc),
                                       torch.from_numpy(l), W)
    top = torch.maximum(qn.amax(-1), qd[..., 0])
    assert int(top.min()) >= 1 << 30 and int(top.max()) < 1 << 31


def test_r10_reference_row_scale_misses_the_power_of_two(
        exact_reference_scale):
    """R-10: a row whose denominator is a power of two (l = 1, a causal
    first row). The port scales it by exactly 2^(30 - ex) and equals the
    reference's own datapath on those lanes bit for bit; the reference,
    where XLA's exp2 misses the power of two, quantizes l just under 2^30
    and its quotients leave by a correction region's step."""
    inexact = exact_reference_scale
    rng = np.random.default_rng(13)
    acc = (rng.standard_normal((4, 64)) * 0.25).astype(np.float32)
    l = np.ones(4, np.float32)
    rc, tc = _cfgs()
    got = ta.attention_div(torch.from_numpy(acc), torch.from_numpy(l),
                           tc).numpy()
    # the reference with its scale exact (the fixture): bit-equal
    want = np.asarray(ra.attention_div(jnp.asarray(acc), jnp.asarray(l), rc))
    np.testing.assert_array_equal(got, want)
    qn, qd = t_fa.softmax_div_quantize(torch.from_numpy(acc),
                                       torch.from_numpy(l), W)
    assert (qd == 1 << 30).all() and int(qn.max()) < 1 << 30   # l = top
    if int(inexact(jnp.float32(30.0))) != 1 << 30:
        jnp.exp2 = inexact                       # the fixture restores it
        jax.clear_caches()
        raw = np.asarray(ra.attention_div(jnp.asarray(acc), jnp.asarray(l),
                                          rc))
        rel = np.abs(raw - got) / np.maximum(np.abs(got), 1e-3)
        assert rel.max() > 2e-3                       # a region's step


# -------------------------------------------------------------- attention --
def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32))


@pytest.mark.parametrize("mask", [dict(causal=True, window=0, q_offset=0),
                                  dict(causal=True, window=24, q_offset=16),
                                  dict(causal=False, window=0, q_offset=0)],
                         ids=["causal", "window", "full"])
def test_flash_attention_ref_at_width_32(mask, exact_reference_scale):
    q, k, v = _qkv((3, 72, 32), (3, 88, 32), seed=11)
    got = t_fa.flash_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), spec=TSpec(**SPEC),
        approx_div=True, frac_out=15, **mask).numpy()
    want = np.asarray(r_fa.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), spec=RSpec(**SPEC),
        approx_div=True, frac_out=15, **mask))
    np.testing.assert_allclose(got, want, **W32_ATTN_TOL)
    w16 = t_fa.flash_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), approx_div=True,
        **mask).numpy()
    assert not np.array_equal(got, w16)              # another divider


@pytest.mark.parametrize("ring_full,pos", [(False, 9), (True, 21)])
def test_decode_attention_append_at_width_32(ring_full, pos,
                                            exact_reference_scale):
    rng = np.random.default_rng(12)
    B, Smax, KVH, G, dh = 3, 16, 2, 2, 16
    q = rng.standard_normal((B, KVH, G, dh), dtype=np.float32)
    kc, vc = (rng.standard_normal((B, Smax, KVH, dh), dtype=np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, KVH, dh), dtype=np.float32)
              for _ in range(2))
    slot = pos % Smax if ring_full else pos
    rc, tc = _cfgs(emulate=False)
    want = np.asarray(r_layers.decode_attention_append(
        *(jnp.asarray(x) for x in (q, kc, vc, kn, vn)), jnp.int32(pos),
        jnp.int32(slot), ring_full=ring_full, approx=rc))
    got = t_layers.decode_attention_append(
        *(torch.from_numpy(x) for x in (q, kc, vc, kn, vn)), pos, slot,
        ring_full=ring_full, approx=tc).numpy()
    np.testing.assert_allclose(got, want, **W32_ATTN_TOL)


# ---------------------------------------------------------------- tuning --
def test_measure_error_at_width_32_equals_reference():
    """The stratified uint64 sweep on the plain versions: the reference's
    statistics exactly (mul: ARE 0.8914580128946921 % on 4,096 pairs under
    jax 0.9.0)."""
    for op in ("mul", "div"):
        got = measure_error(op, W, 8, device="cpu")
        assert got == r_measure_error(op, W, 8)
        assert got[1] == "stratified"
    stats = dict(measure_error("mul", W, 8, device="cpu")[0])
    assert stats["n"] == 4096
    assert stats["are_pct"] == pytest.approx(0.8914580128946921, rel=1e-12)


# ----------------------------------------------------------------- serve --
@pytest.mark.parametrize("use_in_norm", [False, True])
def test_smoke_generate_under_width32_policy(tmp_path, use_in_norm,
                                             exact_reference_scale):
    """smollm-360m smoke (two layers, float32), one width-32 policy file
    served by both packages: logits within W32_LOGIT_TOL, greedy tokens
    equal where the reference's top-2 margin decides them; with
    ``use_in_norm`` every block norm runs the width-32 sqrt and divide."""
    from repro.launch import serve as r_serve

    path = str(tmp_path / "w32.json")
    TuningPolicy(entries=(
        PolicyEntry(op="attention", width=W, coeff_bits=8, frac_out=15),
        PolicyEntry(op="div", width=W, coeff_bits=8))).save(path)
    kw = dict(mode="simdive", use_in_norm=use_in_norm)
    r_approx = ra.ApproxConfig(**kw, policy=RPolicy.load(path))
    t_approx = ta.ApproxConfig(**kw, policy=TuningPolicy.load(path))
    r_cfg = replace(r_get_config("smollm-360m", smoke=True),
                    dtype="float32").with_approx(r_approx)
    t_cfg = replace(t_get_config("smollm-360m", smoke=True),
                    dtype="float32").with_approx(t_approx)
    assert t_approx.resolve_attention()[0].width == W
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg, device="cpu")
    B, P, GEN = 2, 16, 6
    prompts = np.random.default_rng(0).integers(0, r_cfg.vocab_size, (B, P))
    pj = jnp.asarray(prompts, jnp.int32)
    logits, cache = r_lm.prefill(r_params, {"tokens": pj})
    cache = r_serve.merge_cache(r_lm.empty_cache(B, P + GEN), cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want_tok, want = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, cache = r_lm.decode_step(r_params, cache, tok,
                                         jnp.int32(P + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want_tok.append(np.asarray(tok))
        want.append(np.asarray(logits))
    want_tok, want = np.stack(want_tok, 1), np.stack(want, 1)
    got_tok, got = t_serve.generate(t_lm, t_params,
                                    torch.from_numpy(prompts), P + GEN, GEN,
                                    return_logits=True)
    got_tok, got = got_tok.numpy(), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * W32_LOGIT_TOL
    for b in range(B):
        for i in range(GEN):
            np.testing.assert_allclose(got[b, i], want[b, i], rtol=0,
                                       atol=W32_LOGIT_TOL)
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break
    assert decided.mean() > 0.5
    assert not any(launch_counts().values())


# -------------------------------------------------------------- campaign --
@pytest.mark.parametrize("name", ["table-div-bit20", "log-bit20-transient"])
def test_campaign_site_at_width_32_equals_reference(name):
    """``faults.campaign.measure_site`` at width 32 (``--widths 32``): the
    same report as the reference's on the same operands, the faulted
    outputs read back unsigned (a product of 2^63 or more under an
    upset)."""
    from repro.faults import campaign as r_campaign
    from repro_torch.faults import campaign as t_campaign

    spec = dict(FAULTS[name], width=W)
    op = spec.get("op") or "mul"
    kw = dict(width=W, coeff_bits=8, n=4096, seed=3)
    got = t_campaign.measure_site(FaultSpec(**spec), op, device="cpu", **kw)
    want = r_campaign.measure_site(r_inject.FaultSpec(**spec), op,
                                   backend="ref", **kw)
    assert got.as_dict() == want.as_dict()
    assert got.changed_rate > 0
