"""Port vs reference: the divider's float uses — ``_fixed_point_div``,
``approx_softmax``, ``approx_rmsnorm`` — and a model served with
``ApproxConfig(use_in_norm=True)``.

The same numpy-seeded float32 inputs go through ``repro.core.approx`` and
``repro_torch.core.approx`` (``tests/conftest.py`` turns jax's x64 on, as
for every reference test). Tolerances, each with its reason:

- ``_fixed_point_div`` on identical float operands: bit for bit (the same
  block scale, the same lanes, the same divider);
- ``approx_softmax``: the exponentials and row sums are float32 on both
  sides but summed in another order, which can move one rounded divider
  operand by one unit. Such a unit moves a quotient by ~1/q of itself,
  or, where it crosses one of the 64 correction regions, by up to a few
  percent: at most ``SOFTMAX_MOVED_SHARE`` of the outputs may differ, by
  at most ``SOFTMAX_ATOL`` (measured: none);
- ``approx_rmsnorm`` (ROADMAP R-4 included): the mean square is summed in
  another order too, but at the default 16-bit lane it is clipped to the
  lane for any mean square above 2^-16, so the rsqrt is the same constant
  and the outputs are bit-equal (measured); rows under the clip may see
  their ``qm`` move by one unit: ``RMSNORM_RTOL`` of the output there;
- the straight-through gradients: float32 round-off of the exact
  Jacobians, ``GRAD_TOL``;
- the smollm-360m smoke model (two layers, float32): ``USE_IN_NORM_TOL``
  (see there).
"""
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import approx as ra
from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import get_op as r_get_op
from repro.launch import serve as r_serve
from repro.models import build as r_build
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import approx as ta
from repro_torch.core.mitchell import from_lanes
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import get_op, launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.models import build as t_build
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

SOFTMAX_MOVED_SHARE = 1e-3
SOFTMAX_ATOL = 2e-2
RMSNORM_RTOL = 1e-2
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# the smoke model with use_in_norm: the norms are bit-equal (a constant
# rsqrt, R-4), so the logits differ only as the divider-only model's do —
# float32 summation order, and a 16-bit attention divider operand moved by
# one unit (tests/test_torch_model.py SIMDIVE_LOGIT_TOL, 5e-4, derived
# there); measured 2.9e-6
USE_IN_NORM_TOL = 5e-4

CONFIGS = {
    "simdive": dict(mode="simdive"),
    "mitchell": dict(mode="mitchell"),
    "simdive-w8": dict(mode="simdive", div_width=8, frac_out=12),
    "simdive-cb4-fo12": dict(mode="simdive", coeff_bits=4, frac_out=12),
}


def _cfgs(name, **extra):
    kw = dict(CONFIGS[name], **extra)
    return ra.ApproxConfig(**kw), ta.ApproxConfig(**kw)


# ------------------------------------------------------ _fixed_point_div --
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixed_point_div_bit_equal(name):
    rng = np.random.default_rng(1)
    num = rng.uniform(0, 1, (6, 33)).astype(np.float32)
    num[0, :3] = 0.0
    den = rng.uniform(0.5, 9, (6, 33)).astype(np.float32)
    rc, tc = _cfgs(name)
    want = np.asarray(ra._fixed_point_div(jnp.asarray(num), jnp.asarray(den),
                                          rc))
    got = ta._fixed_point_div(torch.from_numpy(num), torch.from_numpy(den),
                              tc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert launch_counts()["elemwise"] == 0


def test_fixed_point_div_refuses_width_32():
    """No longer refused: at ``div_width`` 32 both operands take the
    reference's fixed scale 2^16 into uint64 lanes (no shared exponent),
    and the quotients equal its own, bit for bit."""
    rng = np.random.default_rng(32)
    num = rng.uniform(0, 3000, (6, 33)).astype(np.float32)
    num[0, :3] = 0.0
    den = rng.uniform(0.5, 9, (6, 33)).astype(np.float32)
    rc, tc = _cfgs("simdive", div_width=32)
    want = np.asarray(ra._fixed_point_div(jnp.asarray(num), jnp.asarray(den),
                                          rc))
    got = ta._fixed_point_div(torch.from_numpy(num), torch.from_numpy(den),
                              tc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fixed_point_exponent_is_exact_at_powers_of_two():
    """floor(log2 top) read from the exponent field: exact at, just below
    and just above every power of two. The reference floors a float32
    log2, which under this jax lands on the wrong side of k at most
    ``nextafter(2^k, 0)`` and at some ``2^k`` and ``nextafter(2^k, inf)``
    (k >= 13); there its scale is twice or half the port's. Wherever its
    floor is exact, both packages' quotients agree bit for bit."""
    e = np.arange(-60, 60)
    p2 = np.exp2(e).astype(np.float32)
    below = np.nextafter(p2, np.float32(0))
    above = np.nextafter(p2, np.float32(np.inf))
    top = np.concatenate([p2, below, above])
    want = np.concatenate([e, e - 1, e])
    rc, tc = _cfgs("simdive")
    qn = np.array([int(ta._fixed_point_operands(
        torch.tensor([t]), torch.tensor([t / 4]), 16)[0]) for t in top])
    np.testing.assert_array_equal(
        qn, np.round(top.astype(np.float64) * np.exp2(14.0 - want)))
    assert qn.min() >= 1 << 14 and qn.max() <= 1 << 15
    r_floor = np.asarray(jnp.floor(jnp.log2(jnp.asarray(top))))
    exact = r_floor == want
    assert exact.mean() > 0.5
    for t in top[exact][::5]:
        num, den = np.float32([t, t / 3]), np.float32([t / 4, t / 5])
        np.testing.assert_array_equal(
            ta._fixed_point_div(torch.from_numpy(num), torch.from_numpy(den),
                                tc).numpy(),
            np.asarray(ra._fixed_point_div(jnp.asarray(num),
                                           jnp.asarray(den), rc)))


# --------------------------------------------------------- approx_softmax --
def _softmax_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 7, 40)) * 3).astype(dtype)


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_approx_softmax_matches_reference(name, axis):
    x = _softmax_inputs(2)
    rc, tc = _cfgs(name)
    want = np.asarray(ra.approx_softmax(jnp.asarray(x), axis, rc))
    got = ta.approx_softmax(torch.from_numpy(x), axis, tc).numpy()
    moved = got != want
    assert moved.mean() <= SOFTMAX_MOVED_SHARE
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
    # the approximation takes effect (fixed-point rows do not sum to 1)
    exact = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=axis))
    assert np.abs(got - exact).max() > 1e-3


def test_approx_softmax_off_is_the_exact_softmax():
    x = _softmax_inputs(3)
    for kw in (dict(mode="exact"), dict(mode="simdive", use_in_softmax=False),
               dict(mode="simdive", policy_only=True)):
        got = ta.approx_softmax(torch.from_numpy(x), -1,
                                ta.ApproxConfig(**kw)).numpy()
        want = np.asarray(ra.approx_softmax(jnp.asarray(x), -1,
                                            ra.ApproxConfig(**kw)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_approx_softmax_bf16_matches_reference():
    """bf16 input: ``x - max`` in bf16 on both sides, then float32."""
    x = _softmax_inputs(4)
    xb = jnp.asarray(x, jnp.bfloat16)
    rc, tc = _cfgs("simdive")
    want = np.asarray(ra.approx_softmax(xb, -1, rc).astype(jnp.float32))
    got = ta.approx_softmax(torch.from_numpy(x).to(torch.bfloat16), -1, tc)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    assert (got != want).mean() <= SOFTMAX_MOVED_SHARE
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)


# --------------------------------------------------------- approx_rmsnorm --
def _rms_inputs(seed, scales=(1.0,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(scales), 4, 64)).astype(np.float32)
    x *= np.float32(scales)[:, None, None]
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    return x.reshape(-1, 64), gamma


# the rsqrt's numerator 2^31 is out of the lane at every width; at 16 bits
# both reference forms agree with the port, at 8 they do not (see
# test_rmsnorm_at_div_width_8_is_out_of_every_form)
RMS_CONFIGS = [n for n in sorted(CONFIGS)
               if CONFIGS[n].get("div_width", 16) == 16]


@pytest.mark.parametrize("name", RMS_CONFIGS)
def test_approx_rmsnorm_matches_reference(name):
    """Rows of every scale: clipped (scale >= 0.01) and not (1e-4, 1e-3)."""
    x, gamma = _rms_inputs(5, scales=(1e-4, 1e-3, 1e-2, 1.0, 10.0))
    rc, tc = _cfgs(name, use_in_norm=True)
    want = np.asarray(ra.approx_rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                        1e-6, rc))
    got = ta.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                            1e-6, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=RMSNORM_RTOL, atol=0)
    # rows 8.. (scales 1e-2, 1, 10) have their qm clipped to the lane
    np.testing.assert_array_equal(got[8:], want[8:])
    assert launch_counts()["sqrt"] == launch_counts()["elemwise"] == 0


def test_approx_rmsnorm_reproduces_r4():
    """ROADMAP R-4: at div_width 16 the rsqrt is a constant for any mean
    square above 2^-16 — 1.5 for unit-scale rows, so approx / exact is
    ~1.51 on seed-0 normal rows — in both packages."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    g = np.ones(64, np.float32)
    rc, tc = _cfgs("simdive", use_in_norm=True)
    got = ta.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6,
                            tc).numpy()
    want = np.asarray(ra.approx_rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6,
                                        rc))
    np.testing.assert_array_equal(got, want)
    exact = x / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True)
                        + 1e-6)
    assert abs(float((got / exact).mean()) - 1.5125) < 1e-3
    np.testing.assert_allclose(got, 1.5 * x, rtol=1e-6)
    for scale in (0.1, 10.0):
        y = ta.approx_rmsnorm(torch.from_numpy(x * np.float32(scale)),
                              torch.from_numpy(g), 1e-6, tc).numpy()
        np.testing.assert_allclose(y, 1.5 * scale * x, rtol=1e-6)


def test_rmsnorm_out_of_lane_numerator_words():
    """The rsqrt's numerator 2^31 lies outside the 16-bit lane: the same
    quotient words in both packages for every r in 1..256, the four the
    port's records quote among them."""
    r = np.arange(1, 257, dtype=np.uint32)
    one = np.full_like(r, 1 << 31)
    want = np.asarray(r_get_op("elemwise", RSpec(width=16, coeff_bits=6),
                               "ref")(jnp.asarray(one), jnp.asarray(r),
                                      op="div", frac_out=16))
    got = get_op("elemwise", TSpec(width=16, coeff_bits=6), "ref")(
        torch.from_numpy(one.astype(np.int64)),
        torch.from_numpy(r.astype(np.int64)), op="div", frac_out=16)
    np.testing.assert_array_equal(from_lanes(got).numpy(),
                                  want.astype(np.int64))
    known = {255: 3221225472, 256: 3221225472, 1: 0, 181: 2147483648}
    assert {k: int(want[k - 1]) for k in known} == known


def test_rmsnorm_at_div_width_8_is_out_of_every_form():
    """At div_width 8 the numerator 2^31 is 23 bits past the lane, where
    the reference's two datapath forms part (ROADMAP R-6): its default
    float-assisted anti-log saturates every quotient, its faithful form's
    LOD cascade sees only the lane's low steps and gives 0. The port keeps
    one integer datapath (the default form's leading-one, the faithful
    form's shifts), the CUDA kernel's, and equals neither there; its
    in-lane stages — the clipped ``qm`` and ``r = sqrt(qm)`` — equal the
    reference's. No served path uses an 8-bit divider for the norm."""
    from repro.core.fastpath import faithful_mode
    from repro.core.simdive import simdive_sqrt as r_sqrt
    from repro_torch.core.simdive import simdive_sqrt

    r = np.arange(1, 16, dtype=np.uint32)
    one = np.full_like(r, 1 << 31)
    div = r_get_op("elemwise", RSpec(width=8, coeff_bits=6), "ref")
    default = np.asarray(div(jnp.asarray(one), jnp.asarray(r), op="div",
                             frac_out=16))
    with faithful_mode():
        faithful = np.asarray(div(jnp.asarray(one), jnp.asarray(r),
                                  op="div", frac_out=16))
    assert (default == 0xFFFFFFFF).all() and (faithful == 0).all()
    got = from_lanes(get_op("elemwise", TSpec(width=8, coeff_bits=6), "ref")(
        torch.from_numpy(one.astype(np.int64)),
        torch.from_numpy(r.astype(np.int64)), op="div", frac_out=16))
    assert not (got == 0xFFFFFFFF).all() and not (got == 0).all()
    qm = np.arange(1, 256, dtype=np.uint32)      # the clip's whole range
    np.testing.assert_array_equal(
        simdive_sqrt(torch.from_numpy(qm.astype(np.int64)), 8).numpy(),
        np.asarray(r_sqrt(jnp.asarray(qm), 8)).astype(np.int64))


def test_x64_is_on_and_the_port_equals_the_reference_under_it():
    """The reference casts ``qm`` to uint64, which is uint32 with x64 off;
    the tests run with x64 on (conftest), where the port's int64 carrier
    gives the same words."""
    assert jax.config.jax_enable_x64
    x, gamma = _rms_inputs(6, scales=(3e-4,))
    rc, tc = _cfgs("simdive", use_in_norm=True)
    np.testing.assert_array_equal(
        ta.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-5,
                          tc).numpy(),
        np.asarray(ra.approx_rmsnorm(jnp.asarray(x), jnp.asarray(gamma), 1e-5,
                                     rc)))


def test_approx_rmsnorm_off_is_the_exact_rmsnorm():
    x, gamma = _rms_inputs(7)
    for kw in (dict(mode="exact", use_in_norm=True), dict(mode="simdive"),
               dict(mode="simdive", use_in_norm=True, policy_only=True)):
        got = ta.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                                1e-6, ta.ApproxConfig(**kw)).numpy()
        want = np.asarray(ra.approx_rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                            1e-6, ra.ApproxConfig(**kw)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- gradients --
def test_approx_softmax_gradient_matches_reference_vjp():
    x = _softmax_inputs(8)
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    rc, tc = _cfgs("simdive")
    _, vjp = jax.vjp(lambda v: ra.approx_softmax(v, -1, rc), jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    ta.approx_softmax(xt, -1, tc).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **GRAD_TOL)


def test_approx_rmsnorm_gradient_matches_reference_vjp():
    x, gamma = _rms_inputs(10, scales=(1e-3, 1.0))
    g = np.random.default_rng(11).standard_normal(x.shape).astype(np.float32)
    rc, tc = _cfgs("simdive", use_in_norm=True)
    _, vjp = jax.vjp(lambda v, w: ra.approx_rmsnorm(v, w, 1e-6, rc),
                     jnp.asarray(x), jnp.asarray(gamma))
    want_x, want_g = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    ta.approx_rmsnorm(xt, gt, 1e-6, tc).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               **GRAD_TOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ model --
def test_use_in_norm_smoke_model_matches_reference():
    """smollm-360m smoke (two layers, float32) with every block norm on
    ``approx_rmsnorm``: the port's generate against the reference's, logits
    within USE_IN_NORM_TOL and greedy tokens equal where the reference's
    top-2 margin exceeds twice it. The final norm stays exact in both
    packages (neither passes ``approx`` to it). ``use_in_norm`` adds no
    parameter, so the reference's tree converts as it is
    (``params_from_reference``, unchanged)."""
    B, P, GEN = 2, 16, 6
    kw = dict(mode="simdive", use_in_norm=True)
    r_cfg = replace(r_get_config("smollm-360m", smoke=True), dtype="float32")
    t_cfg = replace(t_get_config("smollm-360m", smoke=True), dtype="float32")
    r_cfg = r_cfg.with_approx(ra.ApproxConfig(**kw))
    t_cfg = t_cfg.with_approx(ta.ApproxConfig(**kw))
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg, device="cpu")
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

    got_tok, got = t_serve.generate(t_lm, t_params, torch.from_numpy(prompts),
                                    P + GEN, GEN, return_logits=True)
    got_tok, got = got_tok.numpy(), got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * USE_IN_NORM_TOL
    for b in range(B):
        for i in range(GEN):
            np.testing.assert_allclose(got[b, i], want[b, i], rtol=0,
                                       atol=USE_IN_NORM_TOL)
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break
    assert decided.mean() > 0.5
    assert not any(launch_counts().values())
    # the norm's approximation takes effect: against the divider-only model
    base = t_build(replace(t_cfg, approx=ta.ApproxConfig(mode="simdive")),
                   device="cpu")
    base_logits = t_serve.generate(base, t_params, torch.from_numpy(prompts),
                                   P + GEN, GEN, return_logits=True)[1]
    assert np.abs(base_logits.numpy()[:, 0] - got[:, 0]).max() > \
        10 * USE_IN_NORM_TOL
