"""Port vs reference: the segmented leading-one detector (``core/lod.py``),
the paper's baselines (``core/baselines.py``) and the image metrics
(``metrics/image.py``).

The same numpy operands go through ``repro`` and ``repro_torch``.
Tolerances: integer outputs bit for bit (exhaustive at width 8, sampled
at width 16; the LOD also at width 32, which needs no 64-bit bus);
``psnr`` / ``ssim`` exactly (the same float64 numpy arithmetic).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import baselines as r_base
from repro.core import lod as r_lod
from repro.metrics import image as r_image
from repro_torch.core import baselines, lod
from repro_torch.core.mitchell import leading_one
from repro_torch.metrics import psnr, ssim

torch.set_num_threads(1)

N16 = 1 << 16          # sampled width-16 pairs


def _lod_operands(width):
    if width <= 16:
        return np.arange(1 << width, dtype=np.uint32)
    rng = np.random.default_rng(width)
    edges = [0, 1, 2, 3] + [x for k in range(1, 32)
                            for x in ((1 << k) - 1, 1 << k, (1 << k) + 1)]
    edges.append((1 << 32) - 1)
    return np.concatenate([np.array(edges, np.uint64),
                           rng.integers(0, 1 << 32, 1 << 14, np.uint64)]
                          ).astype(np.uint32)


def test_nibble_lod_matches_reference():
    nib = np.arange(16, dtype=np.uint32)
    rz, rp = r_lod.nibble_lod(jnp.asarray(nib))
    tz, tp = lod.nibble_lod(torch.from_numpy(nib.astype(np.int64)))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(rz))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    assert tp.tolist() == [0, 0, 1, 1, 2, 2, 2, 2] + [3] * 8


@pytest.mark.parametrize("width", [8, 16, 32])
def test_segmented_leading_one_matches_reference(width):
    a = _lod_operands(width)
    want = np.asarray(r_lod.segmented_leading_one(jnp.asarray(a), width))
    for x in (torch.from_numpy(a.astype(np.int64)),
              torch.from_numpy(a.view(np.int32)).view(torch.uint32)):
        got = lod.segmented_leading_one(x, width)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        # and the shift-free leading-one of core.mitchell
        np.testing.assert_array_equal(got.numpy(), leading_one(
            torch.from_numpy(a.astype(np.int64))).numpy())


def test_segmented_leading_one_refuses_partial_nibbles():
    for width in (6, 10):
        with pytest.raises(ValueError, match="4-bit segments"):
            r_lod.segmented_leading_one(jnp.arange(4, dtype=jnp.uint32), width)
        with pytest.raises(ValueError, match="4-bit segments"):
            lod.segmented_leading_one(torch.arange(4), width)


def _pairs(width):
    if width == 8:
        g = np.arange(256, dtype=np.uint32)
        a, b = np.meshgrid(g, g, indexing="ij")
        return a.ravel(), b.ravel()
    rng = np.random.default_rng(16)
    a = rng.integers(0, 1 << 16, N16).astype(np.uint32)
    b = rng.integers(0, 1 << 16, N16).astype(np.uint32)
    a[:64], b[64:128] = 0, 0
    b[:32] = 0
    return a, b


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("keep", [2, 4, 6])
@pytest.mark.parametrize("width", [8, 16])
def test_trunc_mul_matches_reference(width, keep):
    a, b = _pairs(width)
    want = np.asarray(r_base.trunc_mul(jnp.asarray(a), jnp.asarray(b), width,
                                       keep))
    got = baselines.trunc_mul(_t(a), _t(b), width, keep)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("width", [8, 16])
def test_const_corr_mul_matches_reference(width):
    a, b = _pairs(width)
    want = np.asarray(r_base.const_corr_op("mul", width)(jnp.asarray(a),
                                                         jnp.asarray(b)))
    got = baselines.const_corr_op("mul", width)(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("frac_out", [0, 8, 12])
@pytest.mark.parametrize("width", [8, 16])
def test_const_corr_div_matches_reference(width, frac_out):
    a, b = _pairs(width)
    want = np.asarray(r_base.const_corr_op("div", width)(
        jnp.asarray(a), jnp.asarray(b), frac_out))
    got = baselines.const_corr_op("div", width)(_t(a), _t(b), frac_out)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_baselines_refuse_width_32():
    """Both baselines run at width 32, as the reference's do: on the
    64-bit bus, bit for bit (the name is kept from when they refused)."""
    rng = np.random.default_rng(32)
    edges = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                     np.uint64)
    a = np.concatenate([rng.integers(0, 1 << 32, 512, dtype=np.uint64),
                        np.repeat(edges, edges.size)])
    b = np.concatenate([rng.integers(0, 1 << 32, 512, dtype=np.uint64),
                        np.tile(edges, edges.size)])
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for keep in (8, 16):
        want = np.asarray(r_base.trunc_mul(ja, jb, 32, keep))
        got = baselines.trunc_mul(ta, tb, 32, keep)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    want = np.asarray(r_base.const_corr_op("mul", 32)(ja, jb))
    got = baselines.const_corr_op("mul", 32)(ta, tb)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    nz = b != 0
    want = np.asarray(r_base.const_corr_op("div", 32)(ja[nz], jb[nz], 12))
    got = baselines.const_corr_op("div", 32)(ta[nz], tb[nz], 12)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def _images(seed, shape=(40, 52)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.float64)
    noisy = np.clip(a + rng.normal(0, 6, shape), 0, 255).round()
    return a, noisy, rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_equal_the_reference(seed):
    a, noisy, other = _images(seed)
    for b in (a, noisy, other):
        assert psnr(a, b) == r_image.psnr(a, b)
        assert ssim(a, b) == r_image.ssim(a, b)
        assert ssim(a, b, peak=1.0, win=5) == r_image.ssim(a, b, peak=1.0,
                                                           win=5)
    assert psnr(a, a) == 99.0 and ssim(a, a) == pytest.approx(1.0)
    for bad in (np.zeros((40, 51)), np.zeros((4, 4))):
        for f in (ssim, r_image.ssim):
            with pytest.raises(ValueError):
                f(np.zeros(bad.shape) if bad.shape == (4, 4) else a, bad)
