"""Port vs reference: the ``elemwise`` op through both registries.

The port's ``get_op("elemwise", backend="ref")`` (the plain PyTorch
version of the CUDA kernel) against the reference's ``backend="ref"``
oracle and its Pallas kernel in interpret mode — bit-equal, ragged shapes
included (the reference pads to blocks; the port does not need to).
Also the dispatch rules: ``auto`` follows the tensors' device, ``cuda``
on a CPU tensor raises, and nothing launches a kernel on this host.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import get_op as r_get_op
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import (
    get_op,
    launch_counts,
    reset_launch_counts,
    resolve_backend,
    simdive_elemwise,
)
from repro_torch.kernels import registry
from repro_torch.kernels.registry import shape_bucket

torch.set_num_threads(1)


def _operands(shape, width, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << width, shape, dtype=np.int64)
    b = rng.integers(0, 1 << width, shape, dtype=np.int64)
    flat_a, flat_b = a.reshape(-1), b.reshape(-1)
    flat_a[::7] = 0                      # zero numerators / factors
    flat_b[::5] = 0                      # zero denominators (and 0/0)
    mode = rng.integers(0, 2, shape, dtype=np.int64)
    return a.astype(np.uint32), b.astype(np.uint32), mode.astype(np.uint32)


CASES = [
    # shape, width, coeff_bits, op, frac_out
    ((37, 53), 8, 6, "mul", 0),
    ((37, 53), 8, 6, "div", 8),
    ((37, 53), 8, 6, "mixed", 8),
    ((1000,), 16, 8, "div", 15),         # 1-D
    ((3, 20, 64), 16, 8, "div", 15),     # the decode finalize's rank
    ((19, 31), 16, 8, "mul", 0),
    ((19, 31), 16, 0, "mixed", 8),       # plain Mitchell tables
]


@pytest.mark.parametrize("ref_backend", ["ref", "pallas"])
@pytest.mark.parametrize("shape,width,coeff_bits,op,frac_out", CASES)
def test_elemwise_ref_matches_reference(shape, width, coeff_bits, op,
                                        frac_out, ref_backend):
    a, b, mode = _operands(shape, width, seed=len(shape) + width)
    kw = dict(op=op, frac_out=frac_out)
    want = r_get_op("elemwise", RSpec(width=width, coeff_bits=coeff_bits),
                    ref_backend)(
        jnp.asarray(a), jnp.asarray(b),
        mode=jnp.asarray(mode) if op == "mixed" else None, **kw)
    got = get_op("elemwise", TSpec(width=width, coeff_bits=coeff_bits),
                 "ref")(
        torch.from_numpy(a), torch.from_numpy(b),
        mode=torch.from_numpy(mode) if op == "mixed" else None, **kw)
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_elemwise_accepts_any_integer_dtype_and_returns_uint32():
    a, b, _ = _operands((64,), 16, seed=9)
    spec = TSpec(width=16, coeff_bits=8)
    want = simdive_elemwise(torch.from_numpy(a), torch.from_numpy(b), spec,
                            op="div", frac_out=15).numpy()
    for dt in (torch.int64, torch.int32):
        got = simdive_elemwise(torch.from_numpy(a.astype(np.int64)).to(dt),
                               torch.from_numpy(b.astype(np.int64)).to(dt),
                               spec, op="div", frac_out=15)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[(b == 0) & (a != 0)].tolist() == \
        [0xFFFFFFFF] * int(((b == 0) & (a != 0)).sum())


def test_dispatch_auto_follows_device_and_cuda_refuses_cpu_tensors():
    a = torch.tensor([3, 4], dtype=torch.int64)
    spec = TSpec(width=8, coeff_bits=6)
    assert resolve_backend("auto", a) == "ref"
    assert resolve_backend("ref", a) == "ref"
    assert resolve_backend("cuda", a) == "cuda"
    with pytest.raises(ValueError, match="backend must be one of"):
        resolve_backend("pallas", a)
    reset_launch_counts()
    out = get_op("elemwise", spec)(a, a, op="mul")        # auto -> ref
    assert out.tolist() == get_op("elemwise", spec, "ref")(
        a, a, op="mul").tolist()
    with pytest.raises(ValueError, match="backend 'cuda' was given a tensor"):
        get_op("elemwise", spec, "cuda")(a, a, op="mul")
    # nothing on this host launched a kernel
    assert launch_counts() == {"attention": 0, "attention_pipelined": 0,
                               "attention_pipelined_w32": 0,
                               "attention_w32": 0, "decode_attention": 0,
                               "decode_attention_w32": 0, "elemwise": 0,
                               "elemwise_w32": 0, "matmul": 0,
                               "matmul_pipelined": 0, "packed": 0,
                               "sqrt": 0, "sqrt_w32": 0}


def test_registry_surface():
    # one count per kernel schedule; both matmul ops share the logmatmul
    # ones; the width-32 forms count apart too
    assert sorted(launch_counts()) == [
        "attention", "attention_pipelined", "attention_pipelined_w32",
        "attention_w32", "decode_attention", "decode_attention_w32",
        "elemwise", "elemwise_w32", "matmul", "matmul_pipelined", "packed",
        "sqrt", "sqrt_w32"]
    assert get_op("elemwise", TSpec()).entry.default_block == (256,)
    assert get_op("packed", TSpec()).entry.default_block == (256,)
    # attention takes (q_chunk, kv_chunk[, depth]) blocks
    assert get_op("attention", TSpec()).entry.default_block == (64, 64)
    assert get_op("attention", TSpec(), block=(64, 64, 2)).block == \
        (64, 64, 2)
    # an op registered without a default block takes no launch shape
    registry.register_op("one_tile", ref=lambda x, *, spec: x)
    try:
        with pytest.raises(ValueError, match="takes no block="):
            get_op("one_tile", TSpec(), block=(32, 32))
    finally:
        del registry._REGISTRY["one_tile"]
    assert shape_bucket((3, 100, 64)) == (4, 128, 64)
    assert get_op("matmul_emul", TSpec()).entry.default_block == \
        (8, 128, 256, 4, 0)
    # sqrt: 'auto' serves a CPU tensor from the plain version, 'cuda'
    # refuses it; one launch shape, no block
    lanes = torch.tensor([65535, 256, 1, 0]).to(torch.int32).view(
        torch.uint32)
    assert get_op("sqrt", TSpec(width=16)).backend == "auto"
    assert resolve_backend("auto", lanes) == "ref"
    assert get_op("sqrt", TSpec(width=16))(lanes).tolist() == [255, 16, 1, 0]
    with pytest.raises(ValueError, match="backend 'cuda'"):
        get_op("sqrt", TSpec(width=16), "cuda")(lanes)
    assert get_op("sqrt", TSpec()).entry.default_block is None
    with pytest.raises(KeyError, match="unknown op"):
        get_op("rsqrt", TSpec())
    # width 32: the reference's uint64 lanes, the saturated product and
    # x / 0 both the 64-bit all-ones word
    a = torch.tensor([1, (1 << 32) - 1, 7])
    b = torch.tensor([1, (1 << 32) - 1, 0])
    w32 = get_op("elemwise", TSpec(width=32, coeff_bits=8), "ref")
    prod, quot = w32(a, b, op="mul"), w32(a, b, op="div", frac_out=16)
    assert prod.dtype == quot.dtype == torch.uint64
    r32 = r_get_op("elemwise", RSpec(width=32, coeff_bits=8), "ref")
    ra, rb = jnp.asarray(a.numpy(), jnp.uint64), jnp.asarray(b.numpy(),
                                                             jnp.uint64)
    np.testing.assert_array_equal(prod.numpy(), np.asarray(r32(ra, rb)))
    np.testing.assert_array_equal(
        quot.numpy(), np.asarray(r32(ra, rb, op="div", frac_out=16)))
    assert int(prod.numpy()[1]) == int(quot.numpy()[2]) == (1 << 64) - 1
    with pytest.raises(ValueError, match="mode"):
        get_op("elemwise", TSpec(), "ref")(
            torch.tensor([1]), torch.tensor([1]), op="mixed")
