"""Port vs reference: attention and its SIMDive divider.

* ``softmax_div`` on *given integer operands* is bit-equal: rows are built
  so that both packages quantize them to the same integers (scale 1), and
  the float results must then be identical.
* float-in / float-out functions (``flash_attention_ref``, the chunked
  ``layers.flash_attention``, ``attention_div``) are compared in float32
  against the reference's dense oracle and its Pallas kernel in interpret
  mode, within tolerances stated beside each check.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.approx import ApproxConfig as RApprox
from repro.core.approx import attention_div as r_attention_div
from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import flash_attention as r_fa
from repro.kernels import get_op as r_get_op
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.approx import attention_div as t_attention_div
from repro_torch.core.error_lut import table_for
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import get_op, simdive_attention
from repro_torch.models import layers as t_layers

torch.set_num_threads(1)

# exact divide, float32: both sides are a dense / online softmax of the same
# numbers; they differ only in summation order (a few float32 ulps of
# values of order 1)
EXACT_TOL = dict(rtol=3e-5, atol=3e-5)
# SIMDive divider: acc and l differ between the two by float32 round-off,
# which can move a rounded 16-bit operand by one unit. The row scale puts
# max(|acc|, l) in [2^14, 2^15), so one unit of the numerator moves the
# quotient by at most 1 / qd <= 2^-12 of |v|-scale outputs (|v| < 5 here):
# 4 units of margin on 2^-14 * 5.
APPROX_TOL = dict(rtol=0, atol=1.25e-3)


def _qkv(BH, Sq, Skv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Sq, dh), dtype=np.float32),
            rng.standard_normal((BH, Skv, dh), dtype=np.float32),
            rng.standard_normal((BH, Skv, dh), dtype=np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ------------------------------------------------------------- integers --
@pytest.mark.parametrize("width,coeff_bits,frac_out,index_bits", [
    (16, 8, 15, 3), (16, 0, 15, 3), (16, 8, 12, 4), (8, 6, 8, 3)])
def test_softmax_div_bit_equal_on_integer_operands(width, coeff_bits,
                                                   frac_out, index_bits):
    """Integer-valued rows whose largest entry has its leading one at bit
    width-2: the row scale is exactly 1 in both packages, so both feed the
    divider the same integers and the outputs must be identical floats."""
    rng = np.random.default_rng(width + coeff_bits)
    rows, dh = 48, 24
    top = 1 << (width - 2)
    acc = rng.integers(-(top - 1), top, (rows, dh)).astype(np.float32)
    acc[:, 0] = top + rng.integers(0, top, rows)       # anchors the scale
    acc[3, 1:] = 0.0                                   # zero numerators
    l = rng.integers(1, 2 * top, rows).astype(np.float32)
    r_tab = r_fa._div_table(width, coeff_bits, index_bits)
    t_tab = table_for("div", width, coeff_bits, index_bits)
    kw = dict(width=width, index_bits=index_bits, frac_out=frac_out,
              round_out=True)
    got = t_fa.softmax_div(*_t(acc, l), t_tab, **kw).numpy()
    for in_kernel in (False, True):
        want = np.asarray(r_fa.softmax_div(*_j(acc, l), r_tab,
                                           in_kernel=in_kernel, **kw))
        np.testing.assert_array_equal(got, want)
    qn, qd = t_fa.softmax_div_quantize(*_t(acc, l), width)
    np.testing.assert_array_equal(qn.numpy(), np.abs(acc).astype(np.int64))
    np.testing.assert_array_equal(qd.numpy()[:, 0], l.astype(np.int64))


def test_row_exponent_is_exact_at_powers_of_two():
    """floor(log2 top) read from the exponent field: exact at, just below
    and just above every power of two the quantizer can meet."""
    e = np.arange(-90, 90)
    p2 = np.exp2(e).astype(np.float32)
    below = np.nextafter(p2, np.float32(0))
    above = np.nextafter(p2, np.float32(np.inf))
    top = np.concatenate([p2, below, above])
    want = np.concatenate([e, e - 1, e])
    acc = torch.from_numpy(top)[:, None]
    qn, _ = t_fa.softmax_div_quantize(acc, torch.zeros(len(top)), 16)
    # scale = 2^(14 - ex)  =>  qn = round(top * scale) in [2^14, 2^15)
    assert int(qn.min()) >= 1 << 14 and int(qn.max()) <= 1 << 15
    np.testing.assert_array_equal(
        qn.numpy()[:, 0],
        np.round(top.astype(np.float64) * np.exp2(14.0 - want)))


# ----------------------------------------------------- plain vs reference --
MASKS = [
    dict(causal=True, window=0, q_offset=0),
    dict(causal=False, window=0, q_offset=0),
    dict(causal=True, window=24, q_offset=0),
    dict(causal=True, window=0, q_offset=16),
]


@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_flash_attention_ref_matches_reference(mask, approx_div):
    q, k, v = _qkv(3, 80, 96, 32, seed=11)            # ragged Sq != Skv
    tol = APPROX_TOL if approx_div else EXACT_TOL
    got = t_fa.flash_attention_ref(*_t(q, k, v), approx_div=approx_div,
                                   **mask).numpy()
    want = np.asarray(r_fa.flash_attention_ref(*_j(q, k, v),
                                               approx_div=approx_div, **mask))
    np.testing.assert_allclose(got, want, **tol)
    # and the reference's Pallas kernel (online softmax), interpret mode
    kern = np.asarray(r_get_op("attention", r_fa.DEFAULT_DIV_SPEC, "pallas",
                               block=(32, 32))(
        *_j(q, k, v), approx_div=approx_div, **mask))
    np.testing.assert_allclose(got, kern, **tol)


def test_flash_attention_ref_kv_len_and_kv_group():
    q, k, v = _qkv(4, 40, 64, 16, seed=12)
    got = t_fa.flash_attention_ref(*_t(q, k, v), causal=False, kv_len=50
                                   ).numpy()
    want = np.asarray(r_fa.flash_attention_ref(*_j(q, k, v), causal=False,
                                               kv_len=50))
    np.testing.assert_allclose(got, want, **EXACT_TOL)
    # kv_group=2: kv head bh // 2 == the materialised repeat
    tq, tk, tv = _t(q, k[:2], v[:2])
    grouped = simdive_attention(tq, tk, tv, approx_div=True, kv_group=2,
                                backend="ref")
    repeated = simdive_attention(tq, tk.repeat_interleave(2, 0),
                                 tv.repeat_interleave(2, 0), approx_div=True,
                                 backend="ref")
    assert torch.equal(grouped, repeated)


@pytest.mark.parametrize("mode", ["exact", "simdive", "mitchell"])
@pytest.mark.parametrize("window", [0, 24])
def test_layers_flash_attention_matches_reference(mode, window):
    """The chunked online-softmax path of models/layers (CPU tensors resolve
    'auto' to it) vs the reference's, GQA layout (B,S,KVH,G,dh)."""
    from repro.models import layers as r_layers

    rng = np.random.default_rng(13)
    B, S, KVH, G, dh = 2, 72, 2, 3, 16
    q = rng.standard_normal((B, S, KVH, G, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, KVH, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, KVH, dh), dtype=np.float32)
    r_cfg = RApprox(mode=mode, emulate=False)
    t_cfg = TApprox(mode=mode, emulate=False)
    want = np.asarray(r_layers.flash_attention(
        *_j(q, k, v), causal=True, window=window, q_chunk=32, kv_chunk=32,
        approx=r_cfg))
    got = t_layers.flash_attention(
        *_t(q, k, v), causal=True, window=window, q_chunk=32, kv_chunk=32,
        approx=t_cfg).numpy()
    tol = EXACT_TOL if mode == "exact" else APPROX_TOL
    np.testing.assert_allclose(got, want, **tol)
    # chunking cannot move the result beyond float round-off
    other = t_layers.flash_attention(
        *_t(q, k, v), causal=True, window=window, q_chunk=72, kv_chunk=16,
        approx=t_cfg).numpy()
    np.testing.assert_allclose(got, other, **tol)


def test_layers_flash_attention_agrees_with_kernel_contract():
    """models/layers' GQA path == the op on the flattened (BH,S,dh) layout
    with kv_group (what the CUDA route is handed)."""
    rng = np.random.default_rng(14)
    B, S, KVH, G, dh = 2, 40, 2, 3, 16
    q = torch.from_numpy(rng.standard_normal((B, S, KVH, G, dh),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KVH, dh),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KVH, dh),
                                             dtype=np.float32))
    cfg = TApprox(mode="simdive", emulate=False, backend="ref")
    spec, backend, _ = cfg.resolve_attention()
    via_op = t_layers._flash_attention_kernel(
        q, k, v, causal=True, window=0, approx=cfg, q_offset=0, spec=spec,
        backend=backend)
    chunked = t_layers.flash_attention(q, k, v, causal=True, approx=cfg)
    np.testing.assert_allclose(via_op.numpy(), chunked.numpy(), **APPROX_TOL)


@pytest.mark.parametrize("policy_only", [False, True])
def test_attention_div_matches_reference(policy_only):
    rng = np.random.default_rng(15)
    acc = (rng.standard_normal((2, 3, 5, 64)) * 3).astype(np.float32)
    l = rng.uniform(0.5, 40.0, (2, 3, 5)).astype(np.float32)
    got = t_attention_div(*_t(acc, l), TApprox(mode="simdive",
                                               policy_only=policy_only))
    want = r_attention_div(*_j(acc, l), RApprox(mode="simdive",
                                                policy_only=policy_only))
    # same floats in, same quantizer, same integer divider: equal except
    # where the two log2 implementations could disagree (none here), so
    # the bound is the exact-divide one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT_TOL)
    if not policy_only:
        assert np.abs(got.numpy() - acc / l[..., None]).max() > 1e-4


# ------------------------------------------------ the pipelined schedule --
RING_CASES = {
    # Sq, Skv not multiples of the reference's 32-row chunks (padded inside)
    "ragged": (dict(causal=False, window=0, q_offset=0), (1, 72, 88, 16)),
    "masked": (dict(causal=True, window=24, q_offset=8), (1, 64, 72, 16)),
}


@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_blocks_match_reference_pipelined_kernel(depth, case,
                                                      approx_div):
    """The reference's ``_kernel_pipelined`` (block (32, 32, depth), Pallas
    interpret mode) against the port's op and ``simdive_attention`` given
    the port's ring block (64, 64, depth): on CPU tensors the block is
    ignored and the plain version runs, which the reference's pipelined
    kernel must match within the file's tolerances."""
    mask, (BH, Sq, Skv, dh) = RING_CASES[case]
    q, k, v = _qkv(BH, Sq, Skv, dh, seed=20 + depth)
    tol = APPROX_TOL if approx_div else EXACT_TOL
    want = np.asarray(r_get_op("attention", r_fa.DEFAULT_DIV_SPEC, "pallas",
                               block=(32, 32, depth))(
        *_j(q, k, v), approx_div=approx_div, **mask))
    block = (64, 64, depth)
    via_op = get_op("attention", t_fa.DEFAULT_DIV_SPEC, "ref", block=block)(
        *_t(q, k, v), approx_div=approx_div, **mask)
    via_shim = simdive_attention(*_t(q, k, v), approx_div=approx_div,
                                 block=block, **mask)
    np.testing.assert_allclose(via_op.numpy(), want, **tol)
    assert torch.equal(via_shim, via_op)
    assert torch.equal(via_op, simdive_attention(
        *_t(q, k, v), approx_div=approx_div, **mask))


def test_attention_op_registers_blocks_and_check_block_refuses():
    """Default (64, 64) plus the candidates the autotune times; each passes
    ``check_block`` for the worst case the wrapper takes (f32, d_head 128);
    a tile that is not compiled, a depth above 4 and a ring that does not
    fit are refused."""
    entry = get_op("attention", t_fa.DEFAULT_DIV_SPEC).entry
    assert entry.default_block == t_fa.DEFAULT_BLOCK == (64, 64)
    assert entry.block_candidates == ((64, 64), (64, 64, 2))
    assert set(entry.kernels) == {"attention", "attention_pipelined",
                                  "attention_w32", "attention_pipelined_w32"}
    assert entry.kernels["attention_pipelined"] is \
        t_fa.flash_attention_pipelined_cuda
    for block in (entry.default_block, *entry.block_candidates):
        assert t_fa.check_block(block) == ((64, 64), len(block) == 3 and 2)
    assert get_op("attention", t_fa.DEFAULT_DIV_SPEC, "cuda",
                  block=(64, 64, 2)).block == (64, 64, 2)
    # the reference's TPU blocks are not compiled tiles
    for block in ((32, 32), (512, 512), (512, 512, 2), (1024, 512, 2)):
        with pytest.raises(ValueError, match="not a compiled tile"):
            t_fa.check_block(block)
    with pytest.raises(ValueError, match="depth must be in"):
        t_fa.check_block((64, 64, 5), torch.bfloat16, 64)
    with pytest.raises(ValueError, match="2 or 3 components"):
        t_fa.check_block((64,))
    # the ring's shared memory: f32 at d_head 128 fits depth 2, not 3
    assert t_fa.smem_bytes((64, 64, 2)) == 181760
    assert t_fa.smem_bytes((64, 64, 3)) == 247808
    with pytest.raises(ValueError, match="shared memory"):
        t_fa.check_block((64, 64, 3))
    with pytest.raises(ValueError, match="shared memory"):
        t_fa.check_block((64, 64, 4), torch.float32, 128)
    # ... while bf16 (the tensor-core body: bf16 q, k, v tiles, rows padded
    # by 16 bytes) fits every depth at both head sizes
    for dh in (64, 128):
        for depth in range(1, 5):
            t_fa.check_block((64, 64, depth), torch.bfloat16, dh)
    assert t_fa.smem_bytes((64, 64, 2), torch.bfloat16, 64) == 46080
    assert t_fa.smem_bytes((64, 64), torch.bfloat16, 64) == 27648
    assert t_fa.smem_bytes((64, 64, 4), torch.bfloat16, 128) == 156672


# d_head 80 (zamba2-2.7b): every depth fits both dtypes. bf16: a q tile and
# max(depth, 1) (k, v) slots of 64 rows of 88 bf16 (80 + 16 bytes of pad);
# f32 depth 0: q, k (rows + 1 word), v and p tiles; depth D: q and p
# tiles and D slots of (k, v) rows of 81 words
DH80_SMEM = {(torch.bfloat16, 0): 33792, (torch.bfloat16, 1): 33792,
             (torch.bfloat16, 2): 56320, (torch.bfloat16, 3): 78848,
             (torch.bfloat16, 4): 101376, (torch.float32, 0): 78592,
             (torch.float32, 1): 78848, (torch.float32, 2): 120320,
             (torch.float32, 3): 161792, (torch.float32, 4): 203264}


@pytest.mark.parametrize("dtype,depth", list(DH80_SMEM),
                         ids=[f"{str(d).split('.')[-1]}-depth{n}"
                              for d, n in DH80_SMEM])
def test_smem_and_check_block_at_d_head_80(dtype, depth):
    block = (64, 64, depth) if depth else (64, 64)
    assert t_fa.smem_bytes(block, dtype, 80) == DH80_SMEM[dtype, depth]
    assert t_fa.check_block(block, dtype, 80) == ((64, 64), depth)
    assert 80 in t_fa._HEAD_DIMS


@pytest.mark.parametrize("approx_div", [False, True])
def test_flash_attention_ref_at_d_head_80_matches_reference(approx_div):
    """zamba2-2.7b's head size through the plain version and the layer's
    GQA path (G 1), against the reference's plain version and its Pallas
    kernel in interpret mode."""
    q, k, v = _qkv(2, 40, 40, 80, seed=21)
    tol = APPROX_TOL if approx_div else EXACT_TOL
    got = t_fa.flash_attention_ref(*_t(q, k, v), approx_div=approx_div
                                   ).numpy()
    want = np.asarray(r_fa.flash_attention_ref(*_j(q, k, v),
                                               approx_div=approx_div))
    np.testing.assert_allclose(got, want, **tol)
    kern = np.asarray(r_get_op("attention", r_fa.DEFAULT_DIV_SPEC, "pallas",
                               block=(32, 32))(
        *_j(q, k, v), approx_div=approx_div))
    np.testing.assert_allclose(got, kern, **tol)


def test_check_aligned_refuses_bf16_views_off_16_bytes():
    """Both bf16 schedules load q / k / v 16 bytes at a time: a bf16 k that
    is 4-byte but not 16-byte aligned is refused by the check ``_launch``
    runs before any launch; f32 needs only its 4-byte element alignment."""
    flat = torch.zeros(4 * 16 * 64 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    q = flat[:4 * 16 * 64].view(4, 16, 64)
    k_off = flat[2:2 + 4 * 16 * 64].view(4, 16, 64)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 4
    t_fa.check_aligned(q, q, q)
    with pytest.raises(ValueError, match="k starts at .* not 16-byte"):
        t_fa.check_aligned(q, k_off, q)
    with pytest.raises(ValueError, match="v starts at .* not 16-byte"):
        t_fa.check_aligned(q, q, k_off)
    f = torch.zeros(4 * 16 * 64 + 1)
    t_fa.check_aligned(*(f[1:].view(4, 16, 64),) * 3)


def test_pipelined_wrapper_refuses_cpu_tensors_and_depth0_blocks():
    q, k, v = _t(*_qkv(2, 8, 8, 64, seed=18))
    t_fa.flash_attention_cuda.launches = 0
    t_fa.flash_attention_pipelined_cuda.launches = 0
    with pytest.raises(ValueError, match="not on a CUDA device"):
        t_fa.flash_attention_pipelined_cuda(q, k, v, block=(64, 64, 2))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        t_fa.flash_attention_cuda(q, k, v, block=(64, 64, 2))
    with pytest.raises(ValueError, match="has depth 0"):
        t_fa.flash_attention_pipelined_cuda(q, k, v, block=(64, 64))
    with pytest.raises(ValueError, match="backend 'cuda' was given"):
        get_op("attention", TSpec(width=16, coeff_bits=8), "cuda",
               block=(64, 64, 2))(q, k, v)
    assert t_fa.flash_attention_pipelined_cuda.launches == 0
    assert t_fa.flash_attention_cuda.launches == 0


def test_attention_wrappers_refuse_cpu_tensors_and_bad_shapes():
    q, k, v = _t(*_qkv(2, 8, 8, 64, seed=16))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        t_fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        t_fa.softmax_div_cuda(torch.zeros(4, 8), torch.ones(4))
    with pytest.raises(ValueError, match="backend 'cuda' was given"):
        get_op("attention", TSpec(width=16, coeff_bits=8), "cuda")(q, k, v)
    assert t_fa.flash_attention_cuda.launches == 0
    assert t_fa.DEFAULT_DIV_SPEC == TSpec(width=16, coeff_bits=8,
                                          index_bits=3)
    assert (r_fa.DEFAULT_DIV_SPEC.width, r_fa.DEFAULT_DIV_SPEC.coeff_bits,
            r_fa.DEFAULT_FRAC_OUT) == (16, 8, t_fa.DEFAULT_FRAC_OUT)
    assert RSpec().width == TSpec().width


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
@pytest.mark.parametrize("ring_full,pos,window", [
    (False, 9, 0), (False, 14, 6), (True, 9, 0), (True, 21, 0)])
@pytest.mark.parametrize("mode", ["exact", "simdive"])
def test_decode_attention_append_matches_reference(mode, ring_full, pos,
                                                   window, per_row):
    """Single-token attention over a read-only cache plus the new token:
    linear and ring caches (wrapped and not), a sliding window, scalar and
    (B,) positions."""
    from repro.models import layers as r_layers

    rng = np.random.default_rng(17)
    B, Smax, KVH, G, dh = 3, 16, 2, 2, 16
    q = rng.standard_normal((B, KVH, G, dh), dtype=np.float32)
    kc = rng.standard_normal((B, Smax, KVH, dh), dtype=np.float32)
    vc = rng.standard_normal((B, Smax, KVH, dh), dtype=np.float32)
    kn = rng.standard_normal((B, 1, KVH, dh), dtype=np.float32)
    vn = rng.standard_normal((B, 1, KVH, dh), dtype=np.float32)
    slot = pos % Smax if ring_full else pos
    if per_row:
        r_pos, r_slot = (jnp.full((B,), pos, jnp.int32),
                         jnp.full((B,), slot, jnp.int32))
        t_pos, t_slot = torch.full((B,), pos), torch.full((B,), slot)
    else:
        r_pos, r_slot, t_pos, t_slot = (jnp.int32(pos), jnp.int32(slot), pos,
                                        slot)
    want = np.asarray(r_layers.decode_attention_append(
        *_j(q, kc, vc, kn, vn), r_pos, r_slot, ring_full=ring_full,
        window=window, approx=RApprox(mode=mode, emulate=False)))
    got = t_layers.decode_attention_append(
        *_t(q, kc, vc, kn, vn), t_pos, t_slot, ring_full=ring_full,
        window=window, approx=TApprox(mode=mode, emulate=False)).numpy()
    np.testing.assert_allclose(
        got, want, **(EXACT_TOL if mode == "exact" else APPROX_TOL))
