"""Port vs reference: the emulated SIMDive linears, from the sign network up.

Integer stages bit for bit: ``sign_split`` / ``sign_join``, the
``matmul_int`` op (the port's ``logmatmul_ref``, plain version of the CUDA
kernel) against the reference's ``ref`` oracle and its Pallas kernel in
interpret mode — depth 0 and the pipelined schedule at every depth x
``k_unroll`` of the reference's own grid — and ``matmul_emul`` against the
reference's int64 oracle in its fast and faithful forms. Float stages:
``quantize_sign_magnitude`` equal, ``approx_matmul`` /
``approx_matmul_int8`` within the tolerance stated below, straight-through
gradients against ``jax.grad``. Also the dispatch, the registered blocks
— the skinny-M tiles' shared-memory formula and refusals among them — and
the block autotune (timed here with CPU callables standing in for kernels:
no kernel runs on this host).
"""
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import approx as r_approx
from repro.core.fastpath import faithful_mode
from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import datapath as r_dp
from repro.kernels import get_op as r_get_op
from repro.launch import serve as r_serve
from repro.models import layers as r_layers
from repro_torch.core import approx as t_approx
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import datapath as t_dp
from repro_torch.kernels import (
    autotune_cache,
    clear_autotune_cache,
    export_autotune_cache,
    get_op,
    launch_counts,
    preload_autotune_cache,
    reset_launch_counts,
    simdive_matmul_int,
)
from repro_torch.kernels import logmatmul as lm
from repro_torch.kernels import registry
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as t_layers

torch.set_num_threads(1)

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
# approx_matmul forward: the integer core is bit-equal and both sides scale
# in float32 with the same operations, so outputs agree to float32
# round-off: measured 0; bound 1 ulp of the largest output
FWD_RTOL = 2 ** -23


def _ints(shape, hi, seed):
    return np.random.default_rng(seed).integers(-hi + 1, hi, shape,
                                                dtype=np.int64)


# ------------------------------------------------------------------ signs --
@pytest.mark.parametrize("width", [8, 16])
def test_sign_split_and_join_match_reference(width):
    x = _ints((257,), 1 << 20, seed=width)
    x[:8] = [0, 1, -1, INT32_MIN, INT32_MAX, (1 << width) - 1, -(1 << width),
             1 << width]
    x32 = x.astype(np.int32)
    r_mag, r_sign = r_dp.sign_split(jnp.asarray(x32), width)
    t_mag, t_sign = t_dp.sign_split(torch.from_numpy(x32), width)
    np.testing.assert_array_equal(t_mag.numpy(), np.asarray(r_mag))
    np.testing.assert_array_equal(t_sign.numpy(), np.asarray(r_sign))
    assert int(t_mag[3]) == (1 << width) - 1            # |INT32_MIN| clamps
    # products up to 2^32 - 1 (a saturated width-16 product) wrap to int32
    mag = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 65025],
                   np.uint32)
    for s in (1, -1):
        sign = np.full(mag.shape, s, np.int32)
        want = np.asarray(r_dp.sign_join(jnp.asarray(mag), jnp.asarray(sign)))
        got = t_dp.sign_join(torch.from_numpy(mag.astype(np.int64)),
                             torch.from_numpy(sign))
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- matmul_int --
SPECS = [dict(width=8, coeff_bits=6),
         dict(width=8, coeff_bits=0, round_output=False),  # plain Mitchell
         dict(width=16, coeff_bits=6),
         dict(width=16, coeff_bits=8, index_bits=4)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("mkn,blocks", [
    ((16, 24, 16), (16, 16, 24)),
    ((20, 72, 33), (16, 16, 24)),     # padding every axis
    ((8, 8, 8), (8, 8, 8)),
    ((33, 50, 17), (16, 32, 32)),
    # decode shapes around the skinny tiles' 4 and 8 rows, ragged N and K
    ((1, 50, 17), (8, 16, 16)),
    ((4, 50, 17), (8, 16, 16)),
    ((5, 50, 17), (8, 16, 16)),
    ((9, 50, 17), (8, 16, 16)),
])
def test_matmul_int_ref_matches_reference(spec, mkn, blocks):
    M, K, N = mkn
    hi = min(1 << spec["width"], 1 << 10)
    x = _ints((M, K), hi, seed=M + K).astype(np.int32)
    w = _ints((K, N), hi, seed=N).astype(np.int32)
    x[0, :3] = 0                                       # zero magnitudes
    w[1, :2] = 0
    x[-1, -1], w[-1, -1] = INT32_MIN, INT32_MAX        # clamp to the lane
    rs = RSpec(**spec)
    want_ref = np.asarray(r_get_op("matmul_int", rs, "ref")(
        jnp.asarray(x), jnp.asarray(w)))
    want_pl = np.asarray(r_get_op("matmul_int", rs, "pallas-interpret",
                                  block=blocks)(jnp.asarray(x),
                                                jnp.asarray(w)))
    got = get_op("matmul_int", TSpec(**spec), "ref")(torch.from_numpy(x),
                                                     torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_pl)


@pytest.mark.parametrize("k_unroll", [1, 8])
@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_matmul_int_ref_matches_every_reference_schedule(k_unroll, depth):
    """The reference's depth x k_unroll grid (tests/test_kernels.py) at
    widths 8 and 16: every schedule of its Pallas kernel equals the port's
    plain version."""
    M, K, N = 24, 96, 40                               # padding on every axis
    for width, hi in ((8, 1 << 8), (16, 1 << 10)):
        x = _ints((M, K), hi, seed=depth).astype(np.int32)
        w = _ints((K, N), hi, seed=k_unroll).astype(np.int32)
        want = r_get_op("matmul_int", RSpec(width=width, coeff_bits=6),
                        "pallas-interpret",
                        block=(16, 16, 16, k_unroll, depth))(
            jnp.asarray(x), jnp.asarray(w))
        got = simdive_matmul_int(torch.from_numpy(x), torch.from_numpy(w),
                                 TSpec(width=width, coeff_bits=6),
                                 backend="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_int_width16_wraps_like_reference():
    """Width-16 sums beyond int32 wrap around; operands beyond the lane and
    INT32_MIN clamp; leading dims flatten."""
    spec = dict(width=16, coeff_bits=6)
    x = _ints((2, 3, 72), 1 << 16, seed=5).astype(np.int32)
    w = _ints((72, 9), 1 << 16, seed=6).astype(np.int32)
    x[0, 0, :40] = 65535
    w[:40, 0] = 65535                                  # sum > 2^31: wraps
    x[1, 2, 0], w[0, 1] = INT32_MIN, INT32_MAX
    want = np.asarray(r_get_op("matmul_int", RSpec(**spec), "ref")(
        jnp.asarray(x.reshape(6, 72)), jnp.asarray(w)))
    got = get_op("matmul_int", TSpec(**spec), "ref")(torch.from_numpy(x),
                                                     torch.from_numpy(w))
    assert got.shape == (2, 3, 9)
    np.testing.assert_array_equal(got.reshape(6, 9).numpy(), want)
    exact = x.reshape(6, 72).astype(np.int64) @ w.astype(np.int64)
    assert exact[0, 0] > INT32_MAX and want[0, 0] < exact[0, 0] - (1 << 31)


# ------------------------------------------------------------ matmul_emul --
def _emul_operands(M, K, N, width, seed):
    rng = np.random.default_rng(seed)
    qx = rng.integers(0, 1 << width, (M, K), dtype=np.int64)
    qw = rng.integers(0, 1 << width, (K, N), dtype=np.int64)
    sx = rng.choice([-1, 1], (M, K)).astype(np.int32)
    sw = rng.choice([-1, 1], (K, N)).astype(np.int32)
    qx[:, ::7] = 0
    qw[::5] = 0
    return qx, sx, qw, sw


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("width,k_chunk", [(8, 32), (8, 128), (16, 32)])
def test_matmul_emul_ref_matches_reference(width, k_chunk, faithful):
    qx, sx, qw, sw = _emul_operands(7, 150, 11, width, seed=width + k_chunk)
    spec = dict(width=width, coeff_bits=6)
    with faithful_mode(faithful):
        want = r_get_op("matmul_emul", RSpec(**spec), "ref")(
            jnp.asarray(qx.astype(np.uint32)), jnp.asarray(sx),
            jnp.asarray(qw.astype(np.uint32)), jnp.asarray(sw),
            k_chunk=k_chunk)
    got = get_op("matmul_emul", TSpec(**spec), "ref")(
        torch.from_numpy(qx), torch.from_numpy(sx), torch.from_numpy(qw),
        torch.from_numpy(sw), k_chunk=k_chunk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_emul_ref_equals_matmul_int_where_int32_is_exact():
    qx, sx, qw, sw = _emul_operands(5, 64, 6, 8, seed=1)
    spec = TSpec(width=8, coeff_bits=6)
    emul = get_op("matmul_emul", spec, "ref")(
        torch.from_numpy(qx), torch.from_numpy(sx), torch.from_numpy(qw),
        torch.from_numpy(sw), k_chunk=16)
    joined = get_op("matmul_int", spec, "ref")(
        torch.from_numpy(qx * sx).to(torch.int32),
        torch.from_numpy(qw * sw).to(torch.int32))
    assert torch.equal(emul, joined.to(torch.int64))


# ---------------------------------------------------------- float stages --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, 0])
def test_quantize_sign_magnitude_matches_reference(dtype, axis):
    x = np.random.default_rng(3).normal(size=(13, 40)).astype(np.float32)
    x[0] = 0.0
    x[:, 1] = 0.0                                       # an all-zero column
    x[2, 2] = -3.5
    rx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for width in (8, 16):
        r_mag, r_sign, r_scale = r_approx.quantize_sign_magnitude(rx, width,
                                                                  axis)
        t_mag, t_sign, t_scale = t_approx.quantize_sign_magnitude(tx, width,
                                                                  axis)
        assert t_scale.dtype == tx.dtype                # kept in x's dtype
        assert str(np.asarray(r_scale).dtype) == dtype
        np.testing.assert_array_equal(t_mag.numpy(), np.asarray(r_mag))
        np.testing.assert_array_equal(t_sign.numpy(), np.asarray(r_sign))
        np.testing.assert_array_equal(
            t_scale.to(torch.float32).numpy(),
            np.asarray(r_scale).astype(np.float32))


def _cfgs(mode="simdive", **kw):
    return (r_approx.ApproxConfig(mode=mode, **kw),
            t_approx.ApproxConfig(mode=mode, backend="ref", **kw))


@pytest.mark.parametrize("mode,width", [("simdive", 8), ("mitchell", 8),
                                        ("simdive", 16)])
def test_approx_matmul_forward_and_grads_match_reference(mode, width):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 37)).astype(np.float32)
    w = rng.normal(size=(37, 11)).astype(np.float32)
    g = rng.normal(size=(2, 5, 11)).astype(np.float32)
    r_cfg, t_cfg = _cfgs(mode, width=width, k_chunk=16)
    want = np.asarray(r_approx.approx_matmul(jnp.asarray(x), jnp.asarray(w),
                                             r_cfg))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = t_approx.approx_matmul(tx, tw, t_cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_RTOL * np.abs(want).max())
    # straight-through: the exact product's gradients
    r_gx, r_gw = jax.grad(
        lambda a, b: jnp.sum(r_approx.approx_matmul(a, b, r_cfg) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_gx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(r_gw),
                               rtol=1e-5, atol=1e-5)
    # the integer core is the shared matmul_emul on shared operands
    qx, sx, scx = t_approx.quantize_sign_magnitude(tx.detach().reshape(10, 37),
                                                   width)
    qw, sw, scw = t_approx.quantize_sign_magnitude(tw.detach(), width, axis=0)
    acc = get_op("matmul_emul", t_cfg.spec(), "ref")(qx, sx, qw, sw,
                                                     k_chunk=16)
    assert torch.equal(got.detach().reshape(10, 11),
                       acc.to(torch.float32) * (scx * scw))


def test_approx_matmul_inactive_and_approx_backward():
    """Inactive: the plain matmul. ``backward='approx'``: both gradient
    products run the forward's quantize + ``matmul_emul`` (gx = g @ w^T,
    gw = x^T @ g), equal to the reference's ``_approx_matmul_bwd`` to one
    float32 ulp of the largest gradient (the integer cores are bit-equal
    on the shared operands, held below; both sides rescale in float32)."""
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t_approx.approx_matmul(x, w, t_approx.ApproxConfig()),
                       x @ w)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, 37)).astype(np.float32)
    w = rng.normal(size=(37, 11)).astype(np.float32)
    g = rng.normal(size=(2, 5, 11)).astype(np.float32)
    r_cfg, t_cfg = _cfgs(backward="approx", k_chunk=16)
    r_gx, r_gw = jax.grad(
        lambda a, b: jnp.sum(r_approx.approx_matmul(a, b, r_cfg) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (t_approx.approx_matmul(tx, tw, t_cfg) * torch.from_numpy(g)).sum() \
        .backward()
    for got, want in ((tx.grad, r_gx), (tw.grad, r_gw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FWD_RTOL * np.abs(want).max())
    # not the straight-through gradients: the products are approximate
    assert not np.allclose(tx.grad.numpy(), g @ w.T, rtol=1e-6, atol=0)
    # the integer core of gw is matmul_emul on x^T (one scale) and g (a
    # scale a column)
    tg = torch.from_numpy(g).reshape(10, 11)
    qa, sa, sca = t_approx.quantize_sign_magnitude(
        torch.from_numpy(x).reshape(10, 37).T, 8)
    qb, sb, scb = t_approx.quantize_sign_magnitude(tg, 8, axis=0)
    acc = get_op("matmul_emul", t_cfg.spec(), "ref")(qa, sa, qb, sb,
                                                     k_chunk=16)
    assert torch.equal(tw.grad, acc.to(torch.float32) * (sca * scb))


def test_approx_config_guard_raises(monkeypatch):
    """Guarded dispatch (the reference's ``GuardTripped``): the config takes
    ``guard=True``, a guarded linear equals the unguarded one on a clean
    output, and raises ``GuardTripped`` when its matmul's accumulator
    leaves the bound K (2^w - 1)^2 — here a plain version patched to
    return one."""
    assert not t_approx.ApproxConfig(mode="simdive").guard
    cfg = t_approx.ApproxConfig(mode="simdive", guard=True, backend="ref")
    assert cfg.guard
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 5)).astype(np.float32))
    plain = t_approx.approx_matmul(x, w, replace(cfg, guard=False))
    assert torch.equal(t_approx.approx_matmul(x, w, cfg), plain)
    entry = get_op("matmul_emul", cfg.spec(), "ref").entry

    def upset(qx, sx, qw, sw, *, spec, k_chunk):
        acc = entry.ref(qx, sx, qw, sw, spec=spec, k_chunk=k_chunk)
        acc[1, 2] = 32 * 255 ** 2 + 1
        return acc

    monkeypatch.setitem(registry._REGISTRY, "matmul_emul",
                        replace(entry, ref=upset))
    with pytest.raises(registry.GuardTripped, match="accumulator") as ei:
        t_approx.approx_matmul(x, w, cfg)
    assert (ei.value.op, ei.value.backend, ei.value.bad, ei.value.total) == \
        ("matmul_emul", "ref", 1, 15)
    t_approx.approx_matmul(x, w, replace(cfg, guard=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_matmul_int8_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 80)).astype(np.float32)
    w = rng.normal(size=(80, 64)).astype(np.float32)
    rq = r_layers.quantize_weight(jnp.asarray(w))
    tq = t_layers.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(rq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(rq.scale))
    assert tq.q.dtype == torch.int8 and tq.shape == (80, 64)
    r_cfg, t_cfg = _cfgs()
    rx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(r_approx.approx_matmul_int8(rx, rq.q, rq.scale, r_cfg)
                      ).astype(np.float32)
    got = t_approx.approx_matmul_int8(tx, tq.q, tq.scale, t_cfg)
    assert got.dtype == tx.dtype
    # bf16 output: one bf16 ulp of the largest output
    tol = (FWD_RTOL if dtype == "float32" else 2 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=tol)
    with pytest.raises(ValueError, match="width >= 8"):
        t_approx.approx_matmul_int8(tx, tq.q, tq.scale,
                                    t_approx.ApproxConfig(mode="simdive",
                                                          width=4))


def test_quantize_params_matches_reference():
    rng = np.random.default_rng(2)
    tree = {"embed": rng.normal(size=(1, 50, 96)).astype(np.float32),
            "stack": {"layers": {
                "wq": rng.normal(size=(2, 96, 96)).astype(np.float32),
                "wk": rng.normal(size=(2, 96, 32)).astype(np.float32),
                "mlp": {"w2": rng.normal(size=(2, 128, 96)).astype(
                    np.float32)}}}}
    want = r_serve.quantize_params(jax.tree.map(jnp.asarray, tree))
    got = t_serve.quantize_params(jax.tree.map(torch.from_numpy, tree))
    layers_r, layers_t = want["stack"]["layers"], got["stack"]["layers"]
    for name in ("wq",):
        np.testing.assert_array_equal(layers_t[name].q.numpy(),
                                      np.asarray(layers_r[name].q))
        np.testing.assert_array_equal(layers_t[name].scale.numpy(),
                                      np.asarray(layers_r[name].scale))
    np.testing.assert_array_equal(layers_t["mlp"]["w2"].q.numpy(),
                                  np.asarray(layers_r["mlp"]["w2"].q))
    # too narrow (32 < 64) and not a linear: left float on both sides
    assert isinstance(layers_t["wk"], torch.Tensor)
    assert not isinstance(layers_r["wk"], r_layers.QuantizedWeight)
    assert isinstance(got["embed"], torch.Tensor)
    assert layers_t["wq"][1].q.shape == (96, 96)      # layer slice
    assert layers_t["wq"][1].scale.shape == (1, 96)


# ------------------------------------------------------ dispatch + blocks --
def test_matmul_dispatch_and_blocks_on_cpu():
    x = torch.ones(4, 8, dtype=torch.int32)
    w = torch.ones(8, 3, dtype=torch.int32)
    spec = TSpec(width=8, coeff_bits=6)
    reset_launch_counts()
    auto = get_op("matmul_int", spec)(x, w)               # auto -> ref
    assert torch.equal(auto, get_op("matmul_int", spec, "ref")(x, w))
    with pytest.raises(ValueError, match="backend 'cuda' was given a tensor"):
        get_op("matmul_int", spec, "cuda")(x, w)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lm.logmatmul_cuda(x, w, spec)
    assert launch_counts() == {"attention": 0, "attention_pipelined": 0,
                               "attention_pipelined_w32": 0,
                               "attention_w32": 0, "decode_attention": 0,
                               "decode_attention_w32": 0, "elemwise": 0,
                               "elemwise_w32": 0, "matmul": 0,
                               "matmul_pipelined": 0, "packed": 0,
                               "sqrt": 0, "sqrt_w32": 0}
    # every registered block fits an SM's shared memory and is compiled
    entry = get_op("matmul_emul", spec).entry
    assert entry.default_block == lm.DEFAULT_BLOCK
    assert {b[4] > 0 for b in entry.block_candidates} == {False, True}
    for block in entry.block_candidates:
        assert lm.smem_bytes(block) <= 227 * 1024
        lm.check_block(block)
    # the TPU's blocks do not fit: (128, 128, 128) at depth 2 needs 256 KB
    assert lm.smem_bytes((128, 128, 128, 8, 2)) > 232448
    with pytest.raises(ValueError, match="not a compiled tile"):
        lm.check_block((128, 128, 128, 8, 2))
    with pytest.raises(ValueError, match="multiple of k_unroll"):
        lm.check_block((64, 128, 31, 2, 0))
    with pytest.raises(ValueError, match="shared memory"):
        lm.check_block((8, 128, 2048, 4, 4))
    # the square tiles are gone: neither compiled nor registered
    for square in ((64, 64, 32, 4, 0), (16, 64, 64, 4, 3)):
        with pytest.raises(ValueError, match="not a compiled tile"):
            lm.check_block(square)
    assert lm.split_block((128, 128, 32)) == ((128, 128, 32), 4, 0)
    assert lm.split_block((128, 128, 32, 2)) == ((128, 128, 32), 2, 0)


SKINNY = [b for b in lm.BLOCK_CANDIDATES if lm.is_skinny(b)]


@pytest.mark.parametrize("block", SKINNY, ids=str)
def test_skinny_blocks_are_compiled_and_fit(block):
    """Every registered skinny-M block is a compiled tile, passes
    check_block and fits an H100 block's shared memory."""
    (bm, bn, bk), ku, depth = lm.check_block(block)
    assert bn == lm.SKINNY_BN and (bm, bn, ku) in lm.TILES
    assert bm in (4, 8)
    assert lm.smem_bytes(block) <= 227 * 1024


def test_skinny_smem_formula_and_refusals():
    """The skinny tile's shared memory: 3 words per staged x element, the 8
    warps' partial sums, and the per-lane weight ring at depth >= 1 — no w
    slab at depth 0."""
    # 3 x 4 x 256 x-words + 8 warps x 4 rows x 128 sums, 4 bytes each
    assert lm.smem_bytes((4, 128, 256, 4, 0)) == (3072 + 4096) * 4 == 28672
    # + 8 warps x 2 slots x 4 rows x 32 lanes x 16 bytes
    assert lm.smem_bytes((4, 128, 256, 4, 2)) == 28672 + 32768
    assert lm.smem_bytes((8, 128, 64, 4, 0)) == (3 * 8 * 64 + 8 * 8 * 128) * 4
    # a ring that does not fit an SM's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        lm.check_block((4, 128, 4096, 4, 4))
    lm.check_block((4, 128, 4096, 4, 0))               # depth 0 still fits
    # skinny row counts that are not compiled
    for bm in (2, 16):
        with pytest.raises(ValueError, match="not a compiled tile"):
            lm.check_block((bm, 128, 256, 4, 0))
    with pytest.raises(ValueError, match="not a compiled tile"):
        lm.check_block((4, 128, 256, 8, 2))              # k_unroll 8
    with pytest.raises(ValueError, match="depth"):
        lm.check_block((4, 128, 256, 4, 5))
    assert lm.is_skinny(lm.DEFAULT_BLOCK)
    assert lm.is_skinny((8, 128, 64))
    assert not lm.is_skinny((64, 64, 32, 4, 0))


def test_block_candidates_hold_skinny_blocks_of_both_schedules():
    """The autotune can pick the skinny tile in either schedule, and the
    large-M tile (64 rows) in either; nothing else — the square
    tiles are gone (refused as not compiled)."""
    depths = {b[4] > 0 for b in SKINNY}
    assert depths == {False, True}
    large = [b for b in lm.BLOCK_CANDIDATES if lm.is_large(b)]
    assert {b[4] > 0 for b in large} == {False, True}
    assert {b[0] for b in large} == set(lm.LARGE_ROWS)
    assert len(large) <= 4
    assert {(b[0], b[1]) for b in lm.BLOCK_CANDIDATES} \
        == {(4, 128), (8, 128), (64, 128)}
    assert SKINNY + large == list(lm.BLOCK_CANDIDATES)
    entry = get_op("matmul_emul", TSpec(width=8, coeff_bits=6)).entry
    assert set(lm.BLOCK_CANDIDATES) == set(entry.block_candidates)
    assert entry.default_block == lm.DEFAULT_BLOCK == (8, 128, 256, 4, 0)
    for square in ((64, 64, 32, 4, 0), (64, 64, 32, 4, 2), (64, 64, 32, 4, 4),
                   (16, 64, 64, 4, 0), (16, 64, 64, 4, 3)):
        with pytest.raises(ValueError, match="not a compiled tile"):
            lm.check_block(square)


def test_autotune_measures_once_caches_and_round_trips(monkeypatch):
    """The measure-and-cache loop, driven with CPU callables in place of a
    kernel: the fastest candidate wins and is cached under the reference's
    key; SIMDIVE_AUTOTUNE=0 takes the default untimed; export -> preload
    round-trips and drops blocks outside the candidates."""
    import time

    calls = []

    def fake_kernel(a, b, *, spec, block, k_chunk=128):
        calls.append(block)
        time.sleep(0.004 if block != (2, 2) else 0.0)
        return a

    entry = registry.OpImpl(name="matmul_emul", ref=None, cuda=fake_kernel,
                            default_block=(1, 1),
                            block_candidates=((1, 1), (2, 2), (3, 3)))
    spec = TSpec(width=8)
    a, b = torch.zeros(4, 300), torch.zeros(300, 20)
    clear_autotune_cache()
    try:
        got = registry._pick_block(entry, spec, "cuda", (a, b),
                                   {"k_chunk": 128})
        assert got == (2, 2) and set(calls) == {(1, 1), (2, 2), (3, 3)}
        key = ("matmul_emul", 8, ((4, 512), (512, 32)), "cuda",
               (("k_chunk", 128),))
        assert autotune_cache() == {key: (2, 2)}
        n = len(calls)
        assert registry._pick_block(entry, spec, "cuda", (a, b),
                                    {"k_chunk": 128}) == (2, 2)
        assert len(calls) == n                          # cached, not re-timed
        monkeypatch.setenv("SIMDIVE_AUTOTUNE", "0")
        assert registry._pick_block(entry, spec, "cuda", (a, b),
                                    {"k_chunk": 64}) == (1, 1)
        assert len(calls) == n
        records = export_autotune_cache()
        clear_autotune_cache()
        real = registry._REGISTRY["matmul_emul"]
        pinned = [{"key": records[0]["key"], "block": list(blk)}
                  for blk in (real.block_candidates[-1], (128, 128, 128))]
        assert preload_autotune_cache(pinned) == 1   # the TPU block is refused
        assert list(autotune_cache().values()) == [real.block_candidates[-1]]
    finally:
        clear_autotune_cache()
