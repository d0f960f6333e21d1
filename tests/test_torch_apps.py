"""Port vs reference: the paper's two application studies' glue
(``repro_torch.apps``), the campaign's ``--ann`` and the width-16 repair of
the emulated matmul's kernel path.

The reference's glue lives in its benchmark folder
(``benchmarks/table4_ann.py``, ``benchmarks/fig34_imaging.py``, imported,
not edited). The same numpy-seeded inputs go through both:

* ``make_dataset``'s arrays and ``synth_image`` are equal;
* ``quantized_infer`` from the reference's trained weights, carried across
  as float32: logits bit-equal and accuracies equal on the accurate 8-bit
  baseline, SIMDive w8 cb6 and the Mitchell rung, disarmed and under the
  campaign's stuck-1 (bit 20 of the width-8 mul table) armed in both;
* ``train_float`` from the reference's initial draw, carried across, for
  20 steps: weights within ``TRAIN_ATOL`` / ``TRAIN_RTOL``. The reference
  runs with x64 on (``tests/conftest.py``), where its float64 learning
  rate lifts its weights to float64 after the first step; the port trains
  in float32 throughout, so the two part by float32 round-off;
* ``blend`` / ``gaussian`` equal at every rung of the mul ladder;
* ``ann_accuracy_drop`` equal to the reference's, the training replaced in
  both by the same carried weights and the dataset cut in both.

The width-16 witness: on a 64 x 784 x 100 layer shaped like Table 4's first
(uniform [0, 1) activations, normal weights scaled by 784^-0.5), the
``logmatmul`` kernel's int32 arithmetic differs from the int64 oracle on
most outputs at width 16; its wide form's plain version equals the oracle
at widths 8 and 16, and the emulated matmul's kernel path takes the wide
form exactly where int32 could wrap.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benchmarks import fig34_imaging as r_f34
from benchmarks import table4_ann as r_t4
from repro.core import SimdiveSpec as RSpec
from repro.core.approx import quantize_sign_magnitude as r_quantize
from repro.faults import campaign as r_campaign
from repro.faults import inject as r_inject
from repro.kernels import get_op as r_get_op
from repro.kernels import ops as r_ops
from repro.metrics import classification_accuracy as r_accuracy
from repro_torch.apps import fig34_imaging as t_f34
from repro_torch.apps import table4_ann as t_t4
from repro_torch.core.approx import quantize_sign_magnitude
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.faults import campaign
from repro_torch.faults.inject import FaultSpec, active_faults, fault_injection
from repro_torch.kernels import get_op
from repro_torch.kernels import logmatmul as lm
from repro_torch.kernels import ops as t_ops
from repro_torch.metrics import classification_accuracy

#: the campaign's ANN fault: a stuck-1 at bit 20 of the width-8 mul table
ANN_FAULT = dict(site="table", bit=20, kind="stuck1", op="mul", width=8)
#: train_float after 20 steps, float32 (port) against float64 (reference)
TRAIN_ATOL, TRAIN_RTOL = 1e-5, 1e-4
#: Table 4's quantized multipliers: reference op, port op
MULS = {
    "accurate8": (lambda a, b: a.astype(jnp.int64) @ b.astype(jnp.int64),
                  t_t4.exact_matmul),
    "simdive": (r_get_op("matmul_int", RSpec(width=8, coeff_bits=6), "ref"),
                get_op("matmul_int", TSpec(width=8, coeff_bits=6), "auto")),
    "mitchell": (
        r_get_op("matmul_int", RSpec(width=8, coeff_bits=0,
                                     round_output=False), "ref"),
        get_op("matmul_int", TSpec(width=8, coeff_bits=0,
                                   round_output=False), "auto")),
}
#: Fig. 3/4's mul ladder (the tuner's default_candidates("mul"))
RUNGS = ((8, 0), (8, 2), (8, 4), (8, 6), (16, 6))


@pytest.fixture(scope="module")
def data():
    return r_t4.make_dataset(n_train=600, n_test=200, seed=0)


@pytest.fixture(scope="module")
def ref_weights(data):
    """The reference's trained 784-16-10 MLP, as float32 numpy arrays."""
    (xtr, ytr), _ = data
    ws, _ = r_t4.train_float(xtr, ytr, hidden=(16,), steps=40, seed=0)
    return [np.asarray(w, np.float32) for w in ws]


# ================================================================ Table 4 ==
@pytest.mark.parametrize("seed,n_train,n_test", [(0, 120, 40), (5, 33, 7)])
def test_make_dataset_equals_reference(seed, n_train, n_test):
    got = t_t4.make_dataset(n_train=n_train, n_test=n_test, seed=seed)
    want = r_t4.make_dataset(n_train=n_train, n_test=n_test, seed=seed)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and np.array_equal(gx, wx)
        assert np.array_equal(gy, wy)


@pytest.mark.parametrize("armed", [False, True], ids=["disarmed", "armed"])
@pytest.mark.parametrize("name", list(MULS))
def test_quantized_infer_matches_reference(data, ref_weights, name, armed):
    _, (xte, yte) = data
    r_mul, t_mul = MULS[name]
    ws_t = t_t4.to_torch(ref_weights, "cpu")
    if armed:
        with r_inject.fault_injection(r_inject.FaultSpec(**ANN_FAULT)):
            want = np.asarray(r_t4.quantized_infer(
                [jnp.asarray(w) for w in ref_weights], xte, r_mul))
        with fault_injection(FaultSpec(**ANN_FAULT)):
            got = t_t4.quantized_infer(ws_t, xte, t_mul)
    else:
        want = np.asarray(r_t4.quantized_infer(
            [jnp.asarray(w) for w in ref_weights], xte, r_mul))
        got = t_t4.quantized_infer(ws_t, xte, t_mul)
    assert active_faults() == ()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy(), want)
    assert classification_accuracy(got.numpy(), yte) == r_accuracy(want, yte)


def test_the_campaign_fault_moves_the_simdive_logits(data, ref_weights):
    """The armed cases above are not vacuous: the fault reaches the
    SIMDive rungs' integer products (the accurate baseline is immune)."""
    _, (xte, _) = data
    ws_t = t_t4.to_torch(ref_weights, "cpu")
    for name in ("accurate8", "simdive"):
        mul = MULS[name][1]
        clean = t_t4.quantized_infer(ws_t, xte, mul)
        with fault_injection(FaultSpec(**ANN_FAULT)):
            faulted = t_t4.quantized_infer(ws_t, xte, mul)
        assert torch.equal(clean, faulted) == (name == "accurate8")


def test_train_float_matches_reference_from_its_initial_draw(data):
    import jax

    (xtr, ytr), _ = data
    key, init = jax.random.PRNGKey(0), []
    for fan_in, fan_out in ((784, 16), (16, 10)):
        key, k = jax.random.split(key)
        init.append(np.asarray(jax.random.normal(k, (fan_in, fan_out),
                                                 jnp.float32)
                               * (fan_in ** -0.5)))
    want, r_fwd = r_t4.train_float(xtr, ytr, hidden=(16,), steps=20, seed=0)
    got, t_fwd = t_t4.train_float(xtr, ytr, hidden=(16,), steps=20, seed=0,
                                  init=init, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TRAIN_ATOL, rtol=TRAIN_RTOL)
    moved = max(float(np.abs(np.asarray(w) - i).max())
                for w, i in zip(want, init))
    assert moved > 100 * TRAIN_ATOL       # training moved the weights
    np.testing.assert_allclose(
        t_fwd(got, torch.from_numpy(xtr[:50])).numpy(),
        np.asarray(r_fwd(want, jnp.asarray(xtr[:50]))), atol=1e-4, rtol=1e-4)


def test_train_float_seeded_init_and_refusals(data):
    (xtr, ytr), _ = data
    a, _ = t_t4.train_float(xtr, ytr, hidden=(8,), steps=3, seed=4,
                            device="cpu")
    b, _ = t_t4.train_float(xtr, ytr, hidden=(8,), steps=3, seed=4,
                            device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(w.shape) for w in a] == [(784, 8), (8, 10)]
    assert torch.get_float32_matmul_precision() == "highest"
    with pytest.raises(ValueError, match="do not match"):
        t_t4.train_float(xtr, ytr, hidden=(8,), steps=1,
                         init=[np.zeros((784, 9), np.float32),
                               np.zeros((9, 10), np.float32)], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            t_t4.train_float(xtr, ytr, steps=1)


def test_exact_matmul_is_the_int64_product():
    rng = np.random.default_rng(3)
    a = rng.integers(-255, 256, (37, 784)).astype(np.int32)
    b = rng.integers(-255, 256, (784, 11)).astype(np.int32)
    got = t_t4.exact_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    big = torch.full((1, 1 << 20), 1 << 17, dtype=torch.int64)
    with pytest.raises(ValueError, match="not exact in float64"):
        t_t4.exact_matmul(big, big.T)


# ============================================================= Fig. 3 / 4 ==
@pytest.mark.parametrize("width,cb", RUNGS, ids=[f"w{w}cb{c}" for w, c in RUNGS])
def test_blend_and_gaussian_match_reference(width, cb):
    """Both stages at one rung of the ladder, on small images (64 x 64):
    the window sum reaches past the lane, and an 8-bit divider cannot hold
    273 — the clamps and the leading-one detector must agree."""
    i1, i2 = t_f34.synth_image(1, hw=64), t_f34.synth_image(2, hw=64)
    assert np.array_equal(i1, r_f34.synth_image(1, hw=64))
    rop = r_get_op("elemwise", RSpec(width=width, coeff_bits=cb), "ref")
    top = get_op("elemwise", TSpec(width=width, coeff_bits=cb), "auto")
    r_mul = lambda a, b: rop(a, b, op="mul")                    # noqa: E731
    r_div = lambda a, b: rop(a, b, op="div", frac_out=r_f34.FO)  # noqa: E731
    t_mul = lambda a, b: top(a, b, op="mul")                    # noqa: E731
    t_div = lambda a, b: top(a, b, op="div", frac_out=t_f34.FO)  # noqa: E731
    r_acc_mul = lambda a, b: a.astype(jnp.uint32) * b           # noqa: E731
    r_acc_div = lambda a, b: ((a.astype(jnp.uint64) << r_f34.FO)  # noqa: E731
                              // b.astype(jnp.uint64)).astype(jnp.uint32)
    for r_m, t_m in ((r_acc_mul, t_f34.exact_mul), (r_mul, t_mul)):
        want = r_f34.blend(i1, i2, r_m)
        got = t_f34.blend(i1, i2, t_m, device="cpu")
        assert np.array_equal(got, want)
    base = np.asarray(r_f34.blend(i1, i2, r_acc_mul), np.uint32)
    for (r_m, r_d), (t_m, t_d) in (
            ((r_acc_mul, r_acc_div), (t_f34.exact_mul, t_f34.exact_div)),
            ((r_acc_mul, r_div), (t_f34.exact_mul, t_div)),
            ((r_mul, r_div), (t_mul, t_div))):
        want = r_f34.gaussian(base, r_m, r_d)
        got = t_f34.gaussian(base, t_m, t_d, device="cpu")
        assert np.array_equal(got, want)
    assert np.array_equal(t_f34.GAUSS, r_f34.GAUSS) and t_f34.FO == r_f34.FO


# ============================================================== the campaign ==
def test_ann_accuracy_drop_matches_reference(monkeypatch, ref_weights):
    """The campaign's ANN entry in both packages on the same carried
    weights and the same (cut) dataset: every field of the report equal,
    nothing left armed."""
    full = r_t4.make_dataset
    small = lambda seed=0: full(n_train=64, n_test=200,  # noqa: E731
                                seed=seed)
    monkeypatch.setattr(r_t4, "make_dataset", small)
    monkeypatch.setattr(t_t4, "make_dataset", small)
    monkeypatch.setattr(r_t4, "train_float", lambda *a, **k: (
        [jnp.asarray(w) for w in ref_weights], None))
    rspec = r_inject.FaultSpec(**ANN_FAULT)
    want = r_campaign.ann_accuracy_drop(rspec)
    got = campaign.ann_accuracy_drop(FaultSpec(**ANN_FAULT), device="cpu",
                                     ws=ref_weights)
    assert got == want
    assert got["acc_drop_pct_points"] > 0
    assert active_faults() == ()
    plain = campaign.ann_accuracy_drop(FaultSpec(**ANN_FAULT), device="cpu",
                                       backend="ref", ws=ref_weights)
    assert plain == got


# ================================================ the width-16 repair ==
@pytest.fixture(scope="module")
def witness():
    """Table 4's first layer's shape, 64 rows: (64, 784) x (784, 100)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (64, 784)).astype(np.float32)
    w = (rng.normal(size=(784, 100)) * 784 ** -0.5).astype(np.float32)
    return x, w


def _quantized(x, w, width):
    qx, sx, _ = quantize_sign_magnitude(torch.from_numpy(x), width)
    qw, sw, _ = quantize_sign_magnitude(torch.from_numpy(w), width, axis=0)
    return qx, sx, qw, sw


@pytest.mark.parametrize("width", [8, 16])
def test_wide_plain_form_equals_the_int64_oracle(witness, width):
    x, w = witness
    qx, sx, qw, sw = _quantized(x, w, width)
    spec = TSpec(width=width, coeff_bits=6)
    oracle = t_ops._matmul_emul_ref(qx, sx, qw, sw, spec=spec)
    rq = [r_quantize(jnp.asarray(x), width), r_quantize(jnp.asarray(w),
                                                        width, axis=0)]
    r_oracle = np.asarray(r_ops._matmul_emul_ref(
        rq[0][0], rq[0][1], rq[1][0], rq[1][1],
        spec=RSpec(width=width, coeff_bits=6)))
    assert np.array_equal(oracle.numpy(), r_oracle)
    xi, wi = qx * sx, qw * sw
    wide = lm.logmatmul_wide_ref(xi, wi, spec)
    assert wide.dtype == torch.int64 and torch.equal(wide, oracle)
    narrow = lm.logmatmul_ref(xi, wi, spec).to(torch.int64)
    wrong = float((narrow != oracle).float().mean())
    if width == 8:
        assert wrong == 0.0
    else:                         # the fault the wide form repairs
        assert wrong > 0.5 and float(oracle.abs().max()) > 2 ** 31


@pytest.mark.parametrize("width", [8, 16])
def test_emulated_kernel_path_takes_the_wide_form_where_int32_wraps(
        monkeypatch, witness, width):
    """``_matmul_emul_cuda``'s choice, on the CPU with the kernel wrapper
    stood in for by the plain version of the form it is asked for."""
    calls = []

    def stand_in(x, w, spec, block=lm.DEFAULT_BLOCK, *, wide=False):
        calls.append(wide)
        return (lm.logmatmul_wide_ref if wide else lm.logmatmul_ref)(
            x, w, spec)

    monkeypatch.setattr(lm, "logmatmul_cuda", stand_in)
    x, w = witness
    qx, sx, qw, sw = _quantized(x, w, width)
    spec = TSpec(width=width, coeff_bits=6)
    got = t_ops._matmul_emul_cuda(qx, sx, qw, sw, spec=spec,
                                  block=lm.DEFAULT_BLOCK)
    assert calls == [width == 16]
    assert got.dtype == torch.int64
    assert torch.equal(got, t_ops._matmul_emul_ref(qx, sx, qw, sw,
                                                   spec=spec))


def test_needs_wide_and_the_wide_blocks():
    assert not lm.needs_wide(32768, 8) and lm.needs_wide(32769, 8)
    assert lm.needs_wide(1, 16) and not lm.needs_wide(0, 16)
    for block in (lm.DEFAULT_BLOCK, *lm.BLOCK_CANDIDATES):
        lm.check_block(block, wide=True)
        (bm, bn, bk), ku, depth = lm.split_block(block)
        # the skinny tile's warps meet in shared memory, twice as wide; the
        # large tile's sums stay in registers
        assert lm.smem_bytes(block, True) - lm.smem_bytes(block) \
            == (8 * bm * bn * 4 if lm.is_skinny(block) else 0)
    assert lm.smem_bytes((128, 128, 32, 2, 2), True) \
        == lm.smem_bytes((128, 128, 32, 2, 2))
    x = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lm.logmatmul_cuda(x, x.T.contiguous(), TSpec(width=16), wide=True)
