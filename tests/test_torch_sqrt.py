"""Port vs reference: the log-domain square root (``simdive_sqrt``) and the
op ``sqrt``.

The same numpy operands go through ``repro.core.simdive.simdive_sqrt`` /
``repro.kernels.get_op("sqrt", ..., "ref")`` and their port counterparts.
Tolerance: integer outputs bit for bit (every 8- and 16-bit operand at
``frac_out`` 0, 8 and 16; under each armed log-site fault as well); guard
verdicts with the same reason, ``bad`` and ``total``. The CUDA kernel
(``csrc/elemwise.cu``) is held to the plain version on the card by
``chip_smoke.py`` phase 9; here ``cuda`` on a CPU tensor must raise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.fastpath import faithful_mode
from repro.core.simdive import SimdiveSpec as RSpec
from repro.core.simdive import simdive_sqrt as r_sqrt
from repro.faults import inject as r_inject
from repro.kernels import get_op as r_get_op
from repro.kernels import registry as r_registry
from repro_torch.core.mitchell import from_lanes
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.core.simdive import simdive_sqrt
from repro_torch.faults import inject
from repro_torch.kernels import get_op, launch_counts, registry
from repro_torch.kernels.elemwise import sqrt_cuda, sqrt_ref

torch.set_num_threads(1)

FRAC_OUTS = (0, 8, 16)


def _operands(width):
    return np.arange(1 << width, dtype=np.uint32)


@pytest.mark.parametrize("frac_out", FRAC_OUTS)
@pytest.mark.parametrize("width", [8, 16])
def test_sqrt_matches_reference_exhaustively(width, frac_out):
    a = _operands(width)
    want = np.asarray(r_sqrt(jnp.asarray(a), width, frac_out=frac_out))
    want_op = np.asarray(r_get_op("sqrt", RSpec(width=width), "ref")(
        jnp.asarray(a), frac_out=frac_out))
    np.testing.assert_array_equal(want_op, want)
    ta = torch.from_numpy(a.astype(np.int64))
    got = simdive_sqrt(ta, width, frac_out=frac_out)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the op: uint32 lanes in and out, 'auto' on a CPU tensor is the plain
    # version (no kernel launches here)
    for backend in ("ref", "auto"):
        out = get_op("sqrt", TSpec(width=width), backend)(
            ta.to(torch.int32).view(torch.uint32), frac_out=frac_out)
        assert out.dtype == torch.uint32
        np.testing.assert_array_equal(from_lanes(out).numpy(),
                                      want.astype(np.int64))
    assert launch_counts()["sqrt"] == 0


def test_sqrt_known_words():
    """The values the port's records quote for width 16."""
    a = torch.tensor([65535, 1, 2, 255, 256, 40000])
    assert simdive_sqrt(a, 16).tolist() == [255, 1, 1, 15, 16, 206]
    assert np.asarray(r_sqrt(jnp.asarray(a.numpy(), jnp.uint32),
                             16)).tolist() == [255, 1, 1, 15, 16, 206]


def test_width_32_is_refused():
    """Width 32 is no longer refused: the square root of a 32-bit lane on
    the 64-bit bus, equal to the reference's uint64 one."""
    a = torch.tensor([0, 1, 2, 3, (1 << 31) + 5, (1 << 32) - 1])
    for fo in (0, 8):
        want = np.asarray(r_sqrt(jnp.asarray(a.numpy(), jnp.uint64), 32,
                                 frac_out=fo))
        np.testing.assert_array_equal(
            simdive_sqrt(a, 32, frac_out=fo).numpy(), want.astype(np.int64))
        lanes = get_op("sqrt", TSpec(width=32), "ref")(a, frac_out=fo)
        assert lanes.dtype == torch.uint64
        np.testing.assert_array_equal(lanes.numpy(), want)


def test_cuda_backend_refuses_cpu_tensors():
    a = torch.arange(16, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="backend 'cuda'"):
        get_op("sqrt", TSpec(width=16), "cuda")(a)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        sqrt_cuda(a, TSpec(width=16))
    # the op registers one launch shape: no block to pick
    with pytest.raises(ValueError, match="takes no block="):
        get_op("sqrt", TSpec(width=16), block=(256,))
    assert launch_counts()["sqrt"] == 0
    np.testing.assert_array_equal(
        from_lanes(sqrt_ref(a, TSpec(width=16))).numpy(),
        simdive_sqrt(a, 16).numpy())


def _log_sites(width):
    """The campaign's log sites (a stuck-1 at bit w/2, a transient flip at
    bit w-1) and a flip at bit 31, the top of the 32-bit log register."""
    return [
        dict(site="log", bit=width // 2, kind="stuck1", width=width),
        dict(site="log", bit=width - 1, kind="flip", width=width,
             persistence="transient", rate=0.05),
        dict(site="log", bit=31, kind="flip", width=width),
    ]


@pytest.mark.parametrize("site", range(3))
@pytest.mark.parametrize("width", [8, 16])
def test_sqrt_under_log_faults_matches_reference(width, site):
    """The log stage's fault hook reaches the square root as in the
    reference: the same upset words give the same results, and at least
    one result moves. At bit 31 the halved log lies far outside the lane
    and the reference's two datapath forms part (ROADMAP R-6: its
    float-assisted default saturates the quotient, its integer faithful
    form shifts by the clipped 31): there the port, which keeps the
    integer form, is held to the faithful one."""
    kw = _log_sites(width)[site]
    a = _operands(width)
    clean = simdive_sqrt(torch.from_numpy(a.astype(np.int64)), width, 8)
    with r_inject.fault_injection(r_inject.FaultSpec(**kw)):
        want = np.asarray(r_sqrt(jnp.asarray(a), width, frac_out=8))
        with faithful_mode():
            faithful = np.asarray(r_sqrt(jnp.asarray(a), width, frac_out=8))
    if kw["bit"] == 31:
        assert (want != faithful).any()
        want = faithful
    else:
        np.testing.assert_array_equal(faithful, want)
    with inject.fault_injection(inject.FaultSpec(**kw)):
        got = simdive_sqrt(torch.from_numpy(a.astype(np.int64)), width, 8)
        got_op = get_op("sqrt", TSpec(width=width), "ref")(
            torch.from_numpy(a.astype(np.int64)), frac_out=8)
    assert inject.active_faults() == ()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(from_lanes(got_op).numpy(),
                                  want.astype(np.int64))
    assert not torch.equal(got, clean)


def _verdict(check):
    try:
        check()
    except (r_registry.GuardTripped, registry.GuardTripped) as e:
        return (type(e).__name__, e.op, e.backend, e.width, e.reason, e.bad,
                e.total, str(e))
    return None


@pytest.mark.parametrize("width,frac", [(8, 0), (16, 0), (16, 8)])
def test_guard_bound_matches_reference(width, frac):
    """A result above 2^((w+1)//2 + frac + 1) trips, in both packages, with
    the same reason and count; the exhaustive clean outputs pass."""
    a = _operands(width)
    clean = np.array(r_sqrt(jnp.asarray(a), width, frac_out=frac))
    lim = 1 << ((width + 1) // 2 + frac + 1)
    assert clean.max() <= lim
    bad = clean.copy()
    bad[::97] = lim + 1
    bad[5] = 0xFFFFFFFF
    kw = {"frac_out": frac} if frac else {}
    for out, tripped in ((clean, False), (bad, True)):
        r = _verdict(lambda: r_registry._guard_check(
            "sqrt", RSpec(width=width), "ref", (a,), kw, out))
        t = _verdict(lambda: registry._guard_check(
            "sqrt", TSpec(width=width), "ref", [torch.from_numpy(a)], kw,
            torch.from_numpy(out)))
        assert r == t
        assert (t is not None) == tripped
    assert t[5] == len(bad[::97]) + (5 % 97 != 0)


def test_guarded_sqrt_trips_under_a_log_upset_like_the_reference():
    """End to end: a stuck-1 at bit 30 of the width-16 log register drives
    results out of range, and ``guard=True`` raises in both packages with
    the same fields. The halved log is out of the lane there, so the
    reference runs its integer faithful form (R-6; its default form
    saturates every nonzero operand instead)."""
    a = _operands(16)
    kw = dict(site="log", bit=30, kind="stuck1", width=16)
    with r_inject.fault_injection(r_inject.FaultSpec(**kw)), faithful_mode():
        r = _verdict(lambda: r_get_op("sqrt", RSpec(width=16), "ref",
                                      guard=True)(jnp.asarray(a)))
    with inject.fault_injection(inject.FaultSpec(**kw)):
        t = _verdict(lambda: get_op("sqrt", TSpec(width=16), "ref",
                                    guard=True)(torch.from_numpy(a)))
    assert r is not None and r == t
    assert t[:4] == ("GuardTripped", "sqrt", "ref", 16) and 0 < t[5] < t[6]
    # disarmed, the same call passes
    assert _verdict(lambda: get_op("sqrt", TSpec(width=16), "ref",
                                   guard=True)(torch.from_numpy(a))) is None
