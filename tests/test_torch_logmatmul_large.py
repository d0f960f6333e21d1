"""The large-M ``logmatmul`` tile's plain side, on the CPU.

The kernel (``csrc/logmatmul.cuh``, the large tile) runs only on the card;
here its arithmetic is held through its plain model,
``logmatmul.large_tile_sum``: at width 8 with rounding the FLOAT form
(operand words whose sum is a product's float bits, a clamp to the bus
maximum, float32 partial sums that round and accumulate, flushed into the
integer sum every slab); without rounding the kernel takes the
datapath's own anti-log (its GENERAL form). It must equal the
datapath (``datapath.log_mul`` + ``sign_join``, and the reference's own
``log_mul``) on every signed width-8 operand pair, for every table the
registry builds at both index widths, and the exact sum across the flush
boundaries. Also the registered blocks of the new family: the compiled
tiles, the shared-memory formula, the refusals, and that every registered
block takes an armed log fault above the 20 bits the removed square tiles
held. Exact equality throughout: the kernel is bit-exact by design.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import datapath as r_dp
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.faults.inject import FaultSpec, fault_injection
from repro_torch.kernels import datapath as t_dp
from repro_torch.kernels import logmatmul as lm

torch.set_num_threads(1)

#: every signed width-8 operand, zero once (|INT32_MIN| and past-the-lane
#: values clamp to 255: the flush tests take them)
SIGNED8 = torch.arange(-255, 256, dtype=torch.int32)
#: K just past each float partial sum's span (32- and 64-k slabs) and the
#: boundaries of a 256-k span
FLUSH_K = (31, 32, 33, 63, 64, 65, 127, 129, 255, 256, 257, 511, 513)
LARGE = [b for b in lm.BLOCK_CANDIDATES if lm.is_large(b)]


def _datapath_products(x, w, spec, tab):
    """Every (x, w) product through the plain datapath, signed as the
    reference's sign_join makes it: (len(x), len(w)) int64."""
    xm, sx = t_dp.sign_split(x, 8)
    wm, sw = t_dp.sign_split(w, 8)
    lx = t_dp.lod_log(xm, 8)[:, None]
    lw = t_dp.lod_log(wm, 8)[None]
    zero = (xm == 0)[:, None] | (wm == 0)[None]
    p = t_dp.log_mul(lx, lw, tab, 8, spec.index_bits,
                     round_out=spec.round_output, zero=zero)
    return t_dp.sign_join(p, sx[:, None] * sw[None])


@pytest.mark.parametrize("rnd", [True, False], ids=["round", "floor"])
@pytest.mark.parametrize("coeff_bits", range(9))
@pytest.mark.parametrize("ib", [3, 4])
def test_large_tile_product_on_every_signed_pair(ib, coeff_bits, rnd):
    """Each of the 511 x 511 signed width-8 products (K = 1) the large
    tile makes equals ``log_mul`` + ``sign_join``, for every coefficient
    table the registry builds (coeff_bits 0..8 at index_bits 3 and 4),
    rounding on (the FLOAT form) and off (the GENERAL form)."""
    spec = TSpec(width=8, coeff_bits=coeff_bits, index_bits=ib,
                 round_output=rnd)
    tab = t_dp.op_table("mul", 8, coeff_bits, ib)
    got = lm.large_tile_sum(SIGNED8[:, None], SIGNED8[None], spec)
    want = _datapath_products(SIGNED8, SIGNED8, spec, tab)
    assert torch.equal(got, want)


def test_large_tile_product_equals_the_reference_datapath():
    """The same pairs against the reference's own ``log_mul`` and sign
    join (index_bits 3, coeff_bits 6, rounding: the served spec)."""
    spec = TSpec(width=8, coeff_bits=6)
    got = lm.large_tile_sum(SIGNED8[:, None], SIGNED8[None], spec)
    v = np.arange(-255, 256, dtype=np.int64)
    xm, sx = r_dp.sign_split(jnp.asarray(v, jnp.int32), 8)
    lx = r_dp.lod_log(xm, 8)
    tab = jnp.asarray(t_dp.op_table("mul", 8, 6, 3).numpy())
    zero = (xm == 0)[:, None] | (xm == 0)[None]
    p = r_dp.log_mul(lx[:, None], lx[None], tab, 8, 3, round_out=True,
                     zero=zero)
    want = r_dp.sign_join(p, sx[:, None] * sx[None])
    assert np.array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("rnd", [True, False], ids=["round", "floor"])
def test_large_tile_product_with_negative_entries(rnd):
    """A table with entries across (-64, 64) — what an upset entry that
    stays clean leaves — reaches a negative ternary sum (the clip at 0:
    the FLOAT form's exponent of -1, rounded to 1): still every pair equal
    to the datapath on the same table."""
    rng = np.random.default_rng(7)
    tab = torch.from_numpy(rng.integers(-63, 64, 64))
    tab[0] = -63
    spec = TSpec(width=8, coeff_bits=6, round_output=rnd)
    got = lm.large_tile_sum(SIGNED8[:, None], SIGNED8[None], spec, tab=tab)
    assert torch.equal(got, _datapath_products(SIGNED8, SIGNED8, spec, tab))
    with pytest.raises(ValueError, match="entries in"):
        lm.large_tile_sum(SIGNED8[:, None], SIGNED8[None], spec,
                          tab=torch.full((64,), 64))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("K", FLUSH_K)
def test_large_tile_sum_across_the_flush_boundaries(K, chunk):
    """Sums of K products equal the exact int64 sum just past every
    flush: rows of saturating products (255 x 255 with both signs), rows
    of alternating signs, INT32_MIN, and random operands — the float
    partial sum at its widest (64 x 65,535 < 2^22) included."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-255, 256, (6, K))).to(torch.int32)
    w = torch.from_numpy(rng.integers(-255, 256, (K, 5))).to(torch.int32)
    x[0], x[1] = 255, -255
    x[2] = torch.tensor([255, -255] * K)[:K]
    x[3, ::3] = -(1 << 31)
    w[:, 0] = 255
    w[:, 1] = torch.tensor([-255, 255] * K)[:K]
    for rnd in (True, False):
        spec = TSpec(width=8, coeff_bits=6, round_output=rnd)
        got = lm.large_tile_sum(x, w, spec, chunk=chunk)
        assert torch.equal(got, lm.logmatmul_wide_ref(x, w, spec)), rnd
        assert torch.equal(t_dp.wrap_int32(got).to(torch.int32),
                           lm.logmatmul_ref(x, w, spec))


def test_large_blocks_are_compiled_registered_and_fit():
    """The large family: the 64-row tile of 128 columns (k_unroll 2)
    compiled, registered in both schedules, each within an H100 block's
    shared memory; its formula — two staged words an element of both
    operand slabs, D raw slabs at depth D, nothing more for the wide
    form — and its refusals (bk a multiple of 16 up to 64, no other row
    count)."""
    assert (64, 128, 2) in lm.TILES
    assert set(lm.LARGE_ROWS) == {64}
    assert LARGE and all(lm.is_large(b) and not lm.is_skinny(b)
                         for b in LARGE)
    for block in LARGE:
        lm.check_block(block)
        assert lm.smem_bytes(block) <= 227 * 1024
        assert lm.smem_bytes(block, True) == lm.smem_bytes(block)
    assert lm.smem_bytes((64, 128, 32, 2, 0)) == (2 * 32 * 68
                                                  + 2 * 32 * 128) * 4
    assert lm.smem_bytes((64, 128, 32, 2, 2)) == (2 * 32 * 68 + 2 * 32 * 128
                                                  + 2 * (64 * 40 + 4096)) * 4
    # a 4-deep ring of 32-k slabs fits, of 64-k slabs does not
    lm.check_block((64, 128, 32, 2, 4))
    with pytest.raises(ValueError, match="shared memory"):
        lm.check_block((64, 128, 64, 2, 4))
    for bad in ((64, 128, 24, 2, 0), (64, 128, 128, 2, 0)):
        with pytest.raises(ValueError, match="multiple of 16 up to 64"):
            lm.check_block(bad)
    for bad in ((64, 128, 32, 4, 0), (32, 128, 32, 2, 0),
                (128, 128, 32, 2, 2)):
        with pytest.raises(ValueError, match="not a compiled tile"):
            lm.check_block(bad)
    with pytest.raises(ValueError, match="depth"):
        lm.check_block((64, 128, 32, 2, 5))
    assert lm.is_large((64, 128, 32)) and not lm.is_large(lm.DEFAULT_BLOCK)


@pytest.mark.parametrize("op", ["matmul_int", "matmul_emul"])
def test_blocks_follow_the_rows(monkeypatch, op):
    """The registry's candidates for a call follow its rows (every leading
    dim of x): below LARGE_MIN_M the skinny blocks only, the skinny
    default first; from there on every registered block, the large
    tile's depth-0 block first. With the autotune off the first is
    served untimed."""
    from repro_torch.kernels import registry

    spec = TSpec(width=8, coeff_bits=6)
    entry = registry.get_op(op, spec).entry
    assert lm.DEFAULT_BLOCK in entry.block_candidates
    assert lm.LARGE_DEFAULT_BLOCK in entry.block_candidates
    assert lm.is_large(lm.LARGE_DEFAULT_BLOCK)
    assert lm.LARGE_DEFAULT_BLOCK[4] == 0 and lm.LARGE_MIN_M == 64
    skinny = {b for b in lm.BLOCK_CANDIDATES if lm.is_skinny(b)}
    w = torch.ones((96, 16), dtype=torch.int32)
    tuned = registry.export_autotune_cache()
    monkeypatch.setenv("SIMDIVE_AUTOTUNE", "0")
    try:
        for lead, want in (((4,), lm.DEFAULT_BLOCK),
                           ((63,), lm.DEFAULT_BLOCK),
                           ((64,), lm.LARGE_DEFAULT_BLOCK),
                           ((2, 512), lm.LARGE_DEFAULT_BLOCK),
                           ((2048,), lm.LARGE_DEFAULT_BLOCK)):
            x = torch.ones((*lead, 96), dtype=torch.int32)
            tensors = (x, w) if op == "matmul_int" else (x, x, w, w)
            blocks = entry.blocks_for(*tensors)
            assert blocks == lm.blocks_for(x.numel() // 96)
            assert blocks[0] == want == lm.default_block(x.numel() // 96)
            assert len(set(blocks)) == len(blocks)
            assert set(blocks) == (skinny if want == lm.DEFAULT_BLOCK
                                   else set(lm.BLOCK_CANDIDATES)), lead
            registry.clear_autotune_cache()
            assert registry._pick_block(entry, spec, "cuda", tensors,
                                        {}) == want, lead
    finally:
        registry.clear_autotune_cache()
        registry.preload_autotune_cache(tuned)


@pytest.mark.parametrize("bit", [19, 20, 25, 31])
def test_every_registered_block_takes_an_armed_log_fault(bit):
    """No registered block refuses an armed log fault, whatever bit it
    strikes: each call under the arming gets past every check to the
    device check (these tensors lie on the CPU), where the square tiles'
    20-bit operand word once refused bits 20 and up."""
    x = torch.ones(4, 8, dtype=torch.int32)
    w = torch.ones(8, 3, dtype=torch.int32)
    spec = TSpec(width=8, coeff_bits=6)
    with fault_injection(FaultSpec(site="log", bit=bit, kind="flip",
                                   width=8)):
        for block in (lm.DEFAULT_BLOCK, *lm.BLOCK_CANDIDATES):
            with pytest.raises(ValueError, match="not on a CUDA device"):
                lm.logmatmul_cuda(x, w, spec, block)
