"""Port vs reference: the fault subsystem (``faults/`` inject, scrub,
campaign) on the CPU.

Each of the reference's ``tests/test_faults.py`` cases, ported as a parity
test: the same specs and the same numpy operands go through
``repro.faults`` and ``repro_torch.faults``. Tolerances: integer outputs
bit for bit, ``SiteResult`` fields and scrub findings exactly, messages
equal.

The reference keeps two forms of its datapath — a float-assisted default
and the integer faithful form (``repro.core.fastpath.faithful_mode``) —
and proves them equal on in-range operands; the port keeps the integer
form alone. Under some table upsets the two reference forms disagree with
each other (ROADMAP R-6): there the port equals the faithful form, and
``test_r6_*`` pins where and by how much. Elsewhere the port is held to
the default form (which then equals the faithful one).
"""
import json
from dataclasses import asdict

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SimdiveSpec as RSpec
from repro.core.approx import ApproxConfig as RApprox
from repro.core.error_lut import build_table_clean as r_clean
from repro.core.fastpath import faithful_mode
from repro.core.simd_pack import pack as r_pack
from repro.faults import campaign as r_campaign
from repro.faults import inject as r_inject
from repro.faults import scrub as r_scrub
from repro.kernels import get_op as r_get_op
from repro.kernels.registry import GuardTripped as RGuardTripped
from repro_torch.core import error_lut
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.error_lut import build_table, build_table_clean
from repro_torch.core.mitchell import from_lanes
from repro_torch.core.simd_pack import pack
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.faults import campaign, inject, scrub
from repro_torch.faults.inject import (FaultSpec, active_faults,
                                       apply_lane_faults, apply_table_faults,
                                       fault_injection, faults_enabled,
                                       set_faults)
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import get_op
from repro_torch.kernels.packed_simd import packed_ref, packed_word_op
from repro_torch.kernels.registry import GuardTripped
from repro_torch.metrics import DIV_FRAC_OUT

torch.set_num_threads(1)

W8 = (8, 6)                                   # (width, coeff_bits)
# the reference's own sites where its two forms disagree, found by sweeping
# the campaign's sites (R-6): (op, width, FaultSpec kwargs) -> quotients that
# differ between default and faithful, over the exhaustive width-8 square
R6_SITES = {
    ("div", 8, 20, "flip"): 992,
    ("div", 8, 28, "stuck1"): 992,
}


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends disarmed in both packages — a leaked
    arming would corrupt every test that runs after it."""
    set_faults([])
    r_inject.set_faults([])
    yield
    set_faults([])
    r_inject.set_faults([])


def _grid8():
    a = np.arange(1, 256, dtype=np.uint32)
    A, B = np.meshgrid(a, a)
    return A.ravel(), B.ravel()


def _both_specs(**kw):
    return r_inject.FaultSpec(**kw), FaultSpec(**kw)


def _arm(**kw):
    """Arm the same spec in both packages (the fixture disarms)."""
    r, t = _both_specs(**kw)
    r_inject.set_faults([r])
    set_faults([t])


def _t_elemwise(A, B, width, coeff_bits, op):
    fo = {"frac_out": DIV_FRAC_OUT} if op == "div" else {}
    bound = get_op("elemwise", TSpec(width=width, coeff_bits=coeff_bits),
                   "ref")
    out = bound(torch.from_numpy(A.astype(np.int64)),
                torch.from_numpy(B.astype(np.int64)), op=op, **fo)
    return from_lanes(out).numpy()


def _r_elemwise(A, B, width, coeff_bits, op, faithful=False):
    fo = {"frac_out": DIV_FRAC_OUT} if op == "div" else {}
    bound = r_get_op("elemwise", RSpec(width=width, coeff_bits=coeff_bits),
                     "ref")
    with faithful_mode(faithful):
        return np.asarray(bound(jnp.asarray(A), jnp.asarray(B), op=op, **fo)
                          ).astype(np.int64)


def _message(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return None


# ================================================================== spec ==
@pytest.mark.parametrize("kw", [
    dict(site="alu", bit=0), dict(site="log", bit=0, kind="toggle"),
    dict(site="log", bit=0, persistence="forever"), dict(site="log", bit=32),
    dict(site="table", bit=3, persistence="transient"),
    dict(site="log", bit=3, op="mul"), dict(site="pack", bit=3, index=4),
    dict(site="log", bit=3, persistence="transient", rate=0.0),
    dict(site="table", bit=3, index=-1), dict(site="log", bit=3, width=12),
    dict(site="table", bit=3, op="sqrt"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_spec_validation_equals_reference(kw):
    """Every malformed spec raises the reference's exception and message."""
    want = _message(lambda: r_inject.FaultSpec(**kw))
    assert want is not None
    assert _message(lambda: FaultSpec(**kw)) == want


def test_spec_table_faults_must_be_persistent():
    with pytest.raises(ValueError, match="persistent"):
        FaultSpec(site="table", bit=3, persistence="transient")


def test_set_faults_type_checks():
    with pytest.raises(TypeError, match="FaultSpec"):
        set_faults([{"site": "table", "bit": 3}])
    with pytest.raises(TypeError, match="FaultSpec"):
        set_faults([r_inject.FaultSpec(site="table", bit=3)])
    assert active_faults() == ()


def test_lane_specs_beyond_the_register_refuse_before_arming():
    """More lane specs than the kernels' register holds raise before
    anything is armed (table specs do not count)."""
    specs = [FaultSpec(site="log", bit=b) for b in range(
        inject.MAX_LANE_FAULTS + 1)]
    with pytest.raises(ValueError, match="fault register holds"):
        set_faults(specs)
    assert active_faults() == ()
    ok = specs[:inject.MAX_LANE_FAULTS] + [FaultSpec(site="table", bit=3)]
    set_faults(ok)
    assert active_faults() == tuple(ok)


def test_set_faults_refuses_inside_a_graph_capture(monkeypatch):
    """Arming writes tables and the register on the stream: inside a CUDA
    graph capture that would be captured, not done. It raises there, with
    nothing armed (the capture is patched in on this host)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        set_faults([FaultSpec(site="log", bit=3)])
    assert active_faults() == ()


def test_lane_register_words():
    """The register the kernels read: the lane specs' count, then each
    as (site, width, kind, mask, transient, threshold, seed word) with
    the reference's strike threshold and seed scramble."""
    specs = [FaultSpec(site="table", bit=3),
             FaultSpec(site="log", bit=31, kind="stuck1", width=16),
             FaultSpec(site="pack", bit=7, width=16, persistence="transient",
                       rate=0.05, seed=3),
             FaultSpec(site="log", bit=2, kind="stuck0",
                       persistence="transient", rate=1.0)]
    reg = inject.lane_register(specs)
    assert reg.dtype == np.uint32 and reg.shape == (4 + 8 * 8,)
    assert list(reg[:4]) == [3, 0, 0, 0]
    assert list(reg[4:12]) == [1, 16, 2, 1 << 31, 0, 0, 0, 0]
    assert list(reg[12:20]) == [2, 16, 0, 1 << 7, 1,
                                int(0.05 * 4294967296.0),
                                (3 * 0x9E3779B9 + 0x6A09E667) & 0xFFFFFFFF,
                                0]
    assert list(reg[20:28]) == [1, 0, 1, 1 << 2, 1, 0xFFFFFFFF, 0x6A09E667,
                                0]
    assert not reg[28:].any()


# ================================================================ inject ==
def test_disarmed_table_is_the_cached_pristine_object():
    t = build_table("div", 8, 6)
    assert t is build_table_clean("div", 8, 6)
    assert not faults_enabled() and active_faults() == ()
    np.testing.assert_array_equal(t, r_clean("div", 8, 6))


def test_table_tensor_keeps_its_data_ptr_through_an_arming():
    """``table_for`` hands out one tensor per (table, device, dtype); an
    arming rewrites it in place, so its storage — what a CUDA graph holds
    the address of — never moves."""
    t = error_lut.table_for("div", 8, 6, dtype=torch.int32)
    ptr, clean = t.data_ptr(), t.clone()
    with fault_injection(FaultSpec(site="table", bit=20, op="div", width=8)):
        during = error_lut.table_for("div", 8, 6, dtype=torch.int32)
        assert during is t and during.data_ptr() == ptr
        assert not torch.equal(during, clean)
        np.testing.assert_array_equal(during.numpy(),
                                      build_table("div", 8, 6))
    after = error_lut.table_for("div", 8, 6, dtype=torch.int32)
    assert after is t and after.data_ptr() == ptr
    assert torch.equal(after, clean)


def test_armed_then_disarmed_is_bit_identical():
    A, B = _grid8()
    before = _t_elemwise(A, B, *W8, "div")
    _arm(site="table", bit=20, op="div", width=8)
    during = _t_elemwise(A, B, *W8, "div")
    assert (during != before).any(), "armed fault changed nothing"
    np.testing.assert_array_equal(during,
                                  _r_elemwise(A, B, *W8, "div", True))
    set_faults([])
    np.testing.assert_array_equal(before, _t_elemwise(A, B, *W8, "div"))
    assert build_table("div", 8, 6) is build_table_clean("div", 8, 6)


def test_table_fault_targets_one_op_only():
    _arm(site="table", bit=20, op="div", width=8)
    assert build_table("mul", 8, 6) is build_table_clean("mul", 8, 6)
    np.testing.assert_array_equal(build_table("div", 8, 6),
                                  r_inject.apply_table_faults(
                                      r_clean("div", 8, 6), op="div",
                                      width=8))
    assert (build_table("div", 8, 6) != build_table_clean("div", 8, 6)).any()


@pytest.mark.parametrize("kw", [
    dict(bit=5, kind="flip", index=27), dict(bit=5, kind="stuck1"),
    dict(bit=5, kind="stuck0"), dict(bit=31, kind="flip", index=0),
    dict(bit=30, kind="stuck1")], ids=lambda kw: "-".join(map(str,
                                                            kw.values())))
def test_table_fault_single_entry_and_kinds(kw):
    """Each kind on one entry or the whole column: the upset table equals
    the reference's bit for bit."""
    _arm(site="table", op="mul", **kw)
    live = build_table("mul", 8, 6)
    np.testing.assert_array_equal(
        live, r_inject.apply_table_faults(r_clean("mul", 8, 6), op="mul",
                                          width=8))
    diff = live.view(np.uint32) ^ build_table_clean("mul", 8, 6).view(
        np.uint32)
    if kw.get("index") is not None:
        assert (np.delete(diff, kw["index"]) == 0).all()


def test_table_fault_out_of_range_index_raises(monkeypatch):
    """The reference raises where the table is built; the port also where
    an arming would reach a materialized table — with the previous arming
    and every table left as they were."""
    tab = build_table_clean("mul", 8, 6)
    spec = FaultSpec(site="table", bit=0, op="mul", index=tab.size)
    r_inject.set_faults([r_inject.FaultSpec(site="table", bit=0, op="mul",
                                            index=tab.size)])
    with pytest.raises(ValueError, match="out of range") as want:
        r_inject.apply_table_faults(tab, op="mul", width=8)
    t = error_lut.table_for("mul", 8, 6)          # materialized
    clean = t.clone()
    with pytest.raises(ValueError, match="out of range") as got:
        set_faults([spec])
    assert str(got.value) == str(want.value)
    assert active_faults() == () and torch.equal(t, clean)
    # nothing materialized at width 16 (a test run earlier in this process
    # may have left such a table, which the arming would reach): arming
    # succeeds, building raises
    monkeypatch.setattr(error_lut, "_TABLES", {
        k: v for k, v in error_lut._TABLES.items()
        if not (k[0] == "mul" and k[1] == 16)})
    set_faults([FaultSpec(site="table", bit=0, op="mul", index=300,
                          width=16)])
    with pytest.raises(ValueError, match="out of range"):
        build_table("mul", 16, 7)


def test_apply_table_faults_never_mutates_the_cached_table():
    clean = build_table_clean("div", 8, 6)
    snapshot = clean.copy()
    with fault_injection(FaultSpec(site="table", bit=20, op="div")):
        live = build_table("div", 8, 6)
        assert live is not clean
        assert apply_table_faults(clean, op="mul", width=8) is clean
    np.testing.assert_array_equal(clean, snapshot)


def test_log_fault_hits_lod_log_stage():
    A, B = _grid8()
    clean = _t_elemwise(A, B, *W8, "mul")
    _arm(site="log", bit=2, kind="stuck1", width=8)
    faulted = _t_elemwise(A, B, *W8, "mul")
    assert (faulted != clean).any()
    np.testing.assert_array_equal(faulted, _r_elemwise(A, B, *W8, "mul"))
    # width targeting: a w16-only log fault leaves the w8 path untouched
    _arm(site="log", bit=2, kind="stuck1", width=16)
    np.testing.assert_array_equal(clean, _t_elemwise(A, B, *W8, "mul"))


@pytest.mark.parametrize("width", [8, 16])
def test_log_fault_at_bit_31_on_the_int64_carrier(width):
    """A log upset at bit 31 gives the uint32 value on the int64 carrier,
    and the anti-log's sums then wrap as the reference's uint32 / int32
    do: both ops equal the reference bit for bit."""
    L = dp.lod_log(torch.arange(1, 200), width)
    with fault_injection(FaultSpec(site="log", bit=31, kind="stuck1")):
        hit = dp.lod_log(torch.arange(1, 200), width)
    assert torch.equal(hit, L | (1 << 31)) and int(hit.max()) < 1 << 32
    rng = np.random.default_rng(width)
    A = rng.integers(1, 1 << width, 4096).astype(np.uint32)
    B = rng.integers(1, 1 << width, 4096).astype(np.uint32)
    cb = 6 if width == 8 else 8
    for kind in ("flip", "stuck1"):
        _arm(site="log", bit=31, kind=kind, width=width)
        for op in ("mul", "div"):
            np.testing.assert_array_equal(
                _t_elemwise(A, B, width, cb, op),
                _r_elemwise(A, B, width, cb, op))


@pytest.mark.parametrize("rate,seed", [(0.05, 3), (0.01, 0), (1.0, 9),
                                       (0.5, 12345)])
def test_transient_strikes_equal_the_reference_element_for_element(rate,
                                                                   seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(0, 1 << 32, 50000, dtype=np.uint64),
                        [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]]
                       ).astype(np.uint32)
    want = np.asarray(r_inject._strike(jnp.asarray(x), rate, seed))
    got = inject._strike(torch.from_numpy(x.astype(np.int64)), rate, seed)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transient_strikes_are_deterministic_and_rate_bounded():
    A, B = _grid8()
    clean = _t_elemwise(A, B, *W8, "mul")
    kw = dict(site="log", bit=7, persistence="transient", rate=0.05, seed=3)
    _arm(**kw)
    f1 = _t_elemwise(A, B, *W8, "mul")
    np.testing.assert_array_equal(f1, _r_elemwise(A, B, *W8, "mul"))
    set_faults([FaultSpec(**kw)])
    np.testing.assert_array_equal(f1, _t_elemwise(A, B, *W8, "mul"))
    hit = float((f1 != clean).mean())
    assert 0.0 < hit < 0.25
    set_faults([FaultSpec(**{**kw, "seed": 4})])
    assert (_t_elemwise(A, B, *W8, "mul") != f1).any()


def test_pack_fault_fires_in_the_packed_kernel_body_only():
    """The pack hook fires in ``packed_word_op`` (the kernel body) and not
    in ``packed_ref``, and the faulted words equal the reference's packed
    kernel (Pallas, interpret mode) under the same arming."""
    rng = np.random.default_rng(0)
    a = rng.integers(1, 256, 4096, dtype=np.uint32)
    b = rng.integers(1, 256, 4096, dtype=np.uint32)
    aw, bw = r_pack(jnp.asarray(a), 8), r_pack(jnp.asarray(b), 8)
    taw = pack(torch.from_numpy(a.astype(np.int64)), 8)
    tbw = pack(torch.from_numpy(b.astype(np.int64)), 8)
    spec = TSpec(width=8, coeff_bits=6)
    tab = dp.op_table("mul", 8, 6)
    clean = from_lanes(packed_word_op(taw, tbw, tab, spec=spec, op="mul",
                                      frac_out=0)).numpy()
    r_bound = r_get_op("packed", RSpec(width=8, coeff_bits=6),
                       "pallas-interpret")
    np.testing.assert_array_equal(
        clean, np.asarray(r_bound(aw, bw, op="mul")).astype(np.int64))
    _arm(site="pack", bit=3, width=16)
    faulted = from_lanes(packed_word_op(taw, tbw, tab, spec=spec, op="mul",
                                        frac_out=0)).numpy()
    assert (faulted != clean).any()
    np.testing.assert_array_equal(
        faulted, np.asarray(r_bound(aw, bw, op="mul")).astype(np.int64))
    np.testing.assert_array_equal(
        from_lanes(packed_ref(taw, tbw, spec, op="mul")).numpy(), clean)


def test_apply_lane_faults_keeps_uint32_values():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    with fault_injection(FaultSpec(site="pack", bit=31)):
        got = apply_lane_faults(x, site="pack", width=16)
        assert apply_lane_faults(x, site="log", width=16) is x
    assert got.tolist() == [1 << 31, (1 << 31) + 1, (1 << 32) - 1, 0,
                            (1 << 31) - 1]


# ======================================================= R-6: two forms ==
@pytest.mark.parametrize("key", sorted(R6_SITES),
                         ids=lambda k: f"{k[0]}-w{k[1]}-bit{k[2]}-{k[3]}")
def test_r6_reference_forms_split_and_the_port_is_faithful(key):
    """Where the reference's default and faithful forms disagree under an
    upset table, the port equals the faithful form on every quotient."""
    op, width, bit, kind = key
    A, B = _grid8()
    _arm(site="table", bit=bit, kind=kind, op=op, width=width)
    default = _r_elemwise(A, B, *W8, op)
    faithful = _r_elemwise(A, B, *W8, op, faithful=True)
    got = _t_elemwise(A, B, *W8, op)
    assert int((default != faithful).sum()) == R6_SITES[key]
    np.testing.assert_array_equal(got, faithful)
    assert int((got == default).sum()) == A.size - R6_SITES[key]


def test_r6_faithful_lookup_rounds_entries_past_float32():
    """At a table upset beyond 2^24 the faithful form's one-hot float32
    lookup rounds the entry (and saturates it at 2^31 - 1), so neither
    reference form is the integer datapath there: the port, given the
    entries as float32 rounds and saturates them, equals the faithful
    form; given the upset table itself, it computes with the exact
    entries."""
    A, B = _grid8()
    _arm(site="table", bit=31, kind="flip", op="div", width=8)
    faithful = _r_elemwise(A, B, *W8, "div", faithful=True)
    live = build_table("div", 8, 6)
    rounded = np.clip(live.astype(np.float32).astype(np.float64),
                      -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)
    assert (rounded != live).any()
    a, b = (torch.from_numpy(x.astype(np.int64)) for x in (A, B))
    lanes = dp.lane_op(a, b, torch.from_numpy(rounded), width=8, op="div",
                       frac_out=DIV_FRAC_OUT, round_out=True)
    np.testing.assert_array_equal(lanes.numpy(), faithful)
    assert (_t_elemwise(A, B, *W8, "div") != faithful).any()


# ================================================================ detect ==
def test_guard_is_clean_safe_on_the_exhaustive_grid():
    A, B = _grid8()
    guarded = get_op("elemwise", TSpec(width=8, coeff_bits=6), "ref",
                     guard=True)
    a, b = (torch.from_numpy(x.astype(np.int64)) for x in (A, B))
    guarded(a, b, op="mul")
    guarded(a, b, op="div", frac_out=8)


def _trip(fn):
    try:
        fn()
    except (GuardTripped, RGuardTripped) as e:
        return e.op, e.width, e.reason, e.bad, e.total
    return None


def test_guard_trips_on_divider_table_fault_with_the_faithful_reason():
    """The port trips where the reference trips, with the reason, ``bad``
    and ``total`` of its faithful form (the default form saturates where
    the faithful one leaves the lane: R-6)."""
    A, B = _grid8()
    _arm(site="table", bit=20, op="div", width=8)
    t = get_op("elemwise", TSpec(width=8, coeff_bits=6), "ref", guard=True)
    r = r_get_op("elemwise", RSpec(width=8, coeff_bits=6), "ref", guard=True)
    got = _trip(lambda: t(torch.from_numpy(A.astype(np.int64)),
                          torch.from_numpy(B.astype(np.int64)), op="div",
                          frac_out=8))
    with faithful_mode():
        want = _trip(lambda: r(jnp.asarray(A), jnp.asarray(B), op="div",
                               frac_out=8))
    assert got is not None and got == want
    assert "outside the width" in got[2]
    op, width, _, bad, total = got
    assert op == "elemwise" and width == 8 and 0 < bad <= total


def _findings(fs):
    return [asdict(f) if hasattr(f, "__dataclass_fields__") else f
            for f in fs]


IDENTS = (("mul", 8, 6, 3), ("div", 8, 6, 3), ("div", 16, 8, 3),
          ("div", 16, 0, 3), ("mul", 8, 6, 4))


@pytest.mark.parametrize("kw", [
    dict(site="table", bit=11, op="mul", width=8),
    dict(site="table", bit=20, kind="stuck1", op="div"),
    dict(site="table", bit=3, kind="stuck0"),
    dict(site="table", bit=31, op="mul", index=5),
    dict(site="log", bit=4, width=8)],
    ids=lambda kw: "-".join(map(str, kw.values())))
def test_scrub_findings_equal_the_reference(kw):
    assert scrub.scrub_tables(IDENTS) == ()
    for ident in IDENTS:                          # materialize every copy
        error_lut.table_for(*ident)
        error_lut.table_for(*ident, dtype=torch.int32)
    _arm(**kw)
    got = scrub.scrub_tables(IDENTS)
    want = r_scrub.scrub_tables(IDENTS)
    assert _findings(got) == _findings(want)
    assert [str(f) for f in got] == [str(f) for f in want]
    set_faults([])
    assert scrub.scrub_tables(IDENTS) == ()       # repair detected


def test_scrub_flags_any_table_upset_and_clears_after_repair():
    idents = (("mul", 8, 6, 3), ("div", 8, 6, 3))
    assert scrub.scrub_tables(idents) == ()
    with fault_injection(FaultSpec(site="table", bit=11, op="mul", width=8)):
        findings = scrub.scrub_tables(idents)
        assert len(findings) == 1
        f = findings[0]
        assert f.op == "mul" and f.entries == 64 and f.bits == 64
        assert "mul w8" in str(f)
    assert scrub.scrub_tables(idents) == ()


def test_scrub_reads_back_a_copy_corrupted_behind_set_faults():
    """The scrub reads the memory the kernels read: a materialized tensor
    upset directly — no arming — is flagged, one entry and one bit."""
    t = error_lut.table_for("div", 16, 6, dtype=torch.int32)
    ident = ("div", 16, 6, 3)
    assert scrub.scrub_tables([ident]) == ()
    try:
        t[9] ^= 1 << 4
        found = scrub.scrub_tables([ident])
        assert [(f.op, f.width, f.coeff_bits, f.entries, f.bits)
                for f in found] == [("div", 16, 6, 1, 1)]
        assert not faults_enabled()
    finally:
        error_lut.refresh_tables()
    assert scrub.scrub_tables([ident]) == ()


def test_config_table_identities_equal_the_reference():
    cases = [dict(), dict(mode="simdive", use_in_softmax=True),
             dict(mode="simdive", use_in_softmax=True, emulate=True),
             dict(mode="mitchell", use_in_softmax=True, emulate=True),
             dict(mode="simdive", coeff_bits=3, div_width=16,
                  use_in_softmax=True)]
    for kw in cases:
        want = r_scrub.config_table_identities(RApprox(**kw), n_layers=4)
        got = scrub.config_table_identities(TApprox(**kw), n_layers=4)
        assert got == want, kw
    assert scrub.config_table_identities(TApprox()) == ()
    idents = scrub.config_table_identities(
        TApprox(mode="simdive", use_in_softmax=True))
    assert "div" in {t[0] for t in idents}
    assert all(len(t) == 4 for t in idents)


def test_vacuous_stuck_at_scrubs_clean():
    clean = build_table_clean("div", 16, 8).view(np.uint32)
    always_set = [b for b in range(32) if (clean & (1 << b) != 0).all()]
    assert always_set, "no universally-set bit in this table"
    spec = dict(site="table", bit=always_set[0], kind="stuck1", op="div",
                width=16)
    _arm(**spec)
    assert scrub.scrub_tables((("div", 16, 8, 3),)) == () \
        == r_scrub.scrub_tables((("div", 16, 8, 3),))


# ============================================================== campaign ==
def _sites():
    out = []
    for width in (8, 16):
        for op in ("mul", "div"):
            for spec in r_campaign.default_sites(op, width):
                out.append((op, width, spec))
    return out


@pytest.mark.parametrize(
    "op,width,rspec", _sites(),
    ids=lambda v: v if isinstance(v, (str, int)) else
    f"{v.site}-bit{v.bit}-{v.kind}-{v.persistence}")
def test_default_campaign_site_equals_reference(op, width, rspec):
    """Every default campaign site at widths 8 and 16: the faulted elemwise
    outputs bit for bit and ``measure_site``'s ``SiteResult`` field for
    field, against the faithful form where R-6 applies and the default
    form elsewhere."""
    tspec = FaultSpec(**asdict(rspec))
    assert campaign.default_sites(op, width) == tuple(
        FaultSpec(**asdict(s)) for s in r_campaign.default_sites(op, width))
    cb = 6 if width == 8 else 8
    faithful = (op, width, rspec.bit, rspec.kind) in R6_SITES \
        and rspec.site == "table"
    A, B = campaign._operands(op, width, 65536, 0)
    r_inject.set_faults([rspec])
    set_faults([tspec])
    np.testing.assert_array_equal(_t_elemwise(A, B, width, cb, op),
                                  _r_elemwise(A, B, width, cb, op, faithful))
    set_faults([])
    r_inject.set_faults([])
    got = campaign.measure_site(tspec, op, width=width, coeff_bits=cb,
                                device="cpu")
    with faithful_mode(faithful):
        want = r_campaign.measure_site(rspec, op, width=width,
                                       coeff_bits=cb)
    assert got.as_dict() == want.as_dict()


def test_pack_site_equals_reference():
    """The campaign's pack site: the CPU's ``packed_word_op`` against the
    reference's interpret-mode packed kernel, field for field."""
    rspec = r_inject.FaultSpec(site="pack", bit=7, kind="flip", width=16)
    got = campaign.measure_pack_site(FaultSpec(**asdict(rspec)), n=4096,
                                     device="cpu")
    want = r_campaign.measure_pack_site(rspec, n=4096)
    assert got.as_dict() == want.as_dict()
    assert got.changed_rate > 0


def test_measure_site_quantifies_amplification():
    spec = FaultSpec(site="table", bit=20, op="mul", width=8)
    r = campaign.measure_site(spec, "mul", width=8, coeff_bits=6,
                              device="cpu")
    assert r.scrub_detected and r.detected
    assert r.changed_rate > 0 and r.are_delta_pct > 0
    assert r.nonfinite_rate == 0.0
    d = r.as_dict()
    assert d["detected"] is True and d["site"] == "table"
    if not torch.cuda.is_available():          # the default device: the card
        with pytest.raises(RuntimeError, match="is_available"):
            campaign.measure_site(spec, "mul")


def test_campaign_smoke_passes(tmp_path):
    lines = []
    assert campaign.smoke(report=lines.append, device="cpu")
    assert any("PASS" in ln for ln in lines)
    assert campaign.main(["--smoke", "--device", "cpu"]) == 0
    # --ann runs: Table 4's classifier, clean and under the campaign's
    # stuck-1 at bit 20 of the width-8 mul table, beside the sweep
    out = tmp_path / "report.json"
    assert campaign.main(["--ann", "--widths", "8", "--device", "cpu",
                          "--out", str(out)]) == 0
    ann = json.loads(out.read_text())["ann"]
    assert set(ann) == {"spec", "acc_clean_pct", "acc_fault_pct",
                        "acc_drop_pct_points"}
    assert ann["spec"] == r_campaign._spec_dict(r_inject.FaultSpec(
        site="table", bit=20, kind="stuck1", op="mul", width=8))
    assert ann["acc_drop_pct_points"] > 0
    assert active_faults() == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            campaign.main(["--ann", "--widths", "8"])


# ====================================================== the kernels' side ==
def test_every_kernel_source_exports_its_fault_setter():
    """Each CUDA source holds its own copy of the fault register (each is
    compiled alone) and exports a setter named after it, which
    ``kernels.build`` calls on every arming; the register's layout is the
    one ``lane_register`` writes. Before the library is loaded there is
    nothing to write."""
    import re

    from repro_torch.kernels import build

    sources = sorted(build.CSRC.glob("*.cu"))
    assert build._fault_setters() == [f"simdive_faults_{p.stem}"
                                      for p in sources]
    for src in sources:
        assert f"SIMDIVE_FAULT_SETTER(simdive_faults_{src.stem})" \
            in src.read_text(), src.name
    header = (build.CSRC / "simdive_datapath.cuh").read_text()
    assert re.search(r"kMaxLaneFaults = (\d+);", header).group(1) == str(
        inject.MAX_LANE_FAULTS)
    fields = re.search(r"struct LaneFault \{(.*?)\};", header, re.S).group(1)
    assert len(re.findall(r"uint32_t (\w+);", fields)) == 8
    build.write_fault_register()
