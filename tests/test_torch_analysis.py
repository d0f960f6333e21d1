"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

The reference's analyzer cannot prove its datapath under this JAX: JAX
0.9 names its call primitive ``jit`` where older versions said ``pjit``,
and ``repro.analysis.widthcheck._CALL_PRIMS`` lists only ``pjit``, so every
``jnp.where`` it traces widens to the top of its dtype (ROADMAP R-1). With
``jit`` added to that set — through ``monkeypatch`` in this module only,
nothing of the reference changed — it proves every width clean, and its
verdicts are the oracle here:

* **the matrix** — the port's case labels (the reference's without its
  `` kernel`` / `` ref`` / `` kernel tile`` suffixes: the port has one
  integer form), skips with their reasons, verdicts and assumed
  contracts equal the reference's; ``decode_attention``, the port's own
  op, is the only extra;
* **the mutations** — each of the reference's mutation tests
  (``tests/test_analysis.py``) has a counterpart on the port's stages,
  which fires the same rule;
* **the port's own hazards** — a width-32 right shift of a bus value that
  may reach 2^63 on the int64 carrier, an inexact ``frexp``, and a
  data-dependent branch (a finding, not a proof);
* **the domain, the lint and the diff** against the reference's on the
  same inputs, and the ``--gate`` CLI.
"""
import json
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.analysis.widthcheck as r_wc
from repro.analysis import ArgSpec as RArgSpec
from repro.analysis import TraceCase as RTraceCase
from repro.analysis import check_case as r_check_case
from repro.analysis import domain as r_domain
from repro.analysis import to_json as r_to_json
from repro.analysis.lint import lint_file as r_lint_file
from repro.core.mitchell import frac_bits as r_frac_bits
from repro.core.mitchell import lane_max_float as r_lane_max_float
from repro.kernels import datapath as r_dp

from repro_torch.analysis import (ArgSpec, TraceCase, check_case,
                                  render_text, run_lint, run_matrix, to_json,
                                  verdict_for)
from repro_torch.analysis import domain as t_domain
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.diff import (OP_SOURCES, SHARED_SOURCES,
                                       changed_paths, ops_for_paths)
from repro_torch.analysis.lint import lint_file
from repro_torch.core.annotations import (analysis_tracing, ensure_range,
                                          require_range, tracing_active)
from repro_torch.core.mitchell import frac_bits, lane_max_float, leading_one
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import registry

_IB = 3
_SUFFIX = re.compile(r" (kernel tile|kernel|ref)\b")


@pytest.fixture(scope="module")
def patched_reference():
    """The reference analyzer with JAX 0.9's ``jit`` call primitive added
    to the primitives it recurses into (R-1), for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_wc, "_CALL_PRIMS", r_wc._CALL_PRIMS | {"jit"})
        yield r_wc


@pytest.fixture(scope="module")
def matrices(patched_reference):
    return patched_reference.run_matrix(), run_matrix()


def _rules(findings):
    return {f.rule for f in findings}


def _r_findings(fn, args, requires_x64=False):
    return r_check_case(RTraceCase(label="mutant", fn=fn, args=args,
                                   requires_x64=requires_x64)).findings


def _t_findings(fn, args, bus=torch.uint32):
    return check_case(TraceCase(label="mutant", fn=fn, args=args,
                                bus=bus)).findings


def _render(fs):
    return "\n".join(f.render() for f in fs)


# ============================================================ the matrix ==
def test_case_labels_equal_the_reference(matrices):
    ref, port = matrices
    ref_labels = {_SUFFIX.sub("", r.label) for r in ref.reports}
    port_labels = {r.label for r in port.reports}
    extra = {lb for lb in port_labels if lb.startswith("decode_attention/")}
    assert {lb.split(" ")[1] for lb in extra} == {"w8", "w16", "w32"}
    assert port_labels - extra == ref_labels
    assert len(port.reports) == len(port_labels)      # one case a label


def test_declared_skips_equal_the_reference(matrices):
    ref, port = matrices
    assert port.skips == ref.skips
    assert {(op, w) for op, w, _ in port.skips} == {
        ("matmul_emul", 32), ("matmul_int", 16), ("matmul_int", 32),
        ("packed", 32)}


def test_every_case_proves_clean_in_both(matrices):
    ref, port = matrices
    assert ref.ok, _render(ref.findings)
    assert port.ok, _render(port.findings)
    assert not port.gaps and not ref.gaps
    # nothing widened: every aten op of every case has a transfer rule
    assert all(not r.unknown_prims for r in port.reports)


def test_assumed_contracts_equal_the_reference(matrices):
    ref, port = matrices
    want = {}
    for r in ref.reports:
        want.setdefault(_SUFFIX.sub("", r.label), set()).update(r.assumed)
    for r in port.reports:
        if r.label.startswith("decode_attention/"):
            twin = r.label.replace("decode_attention/", "attention/")
            assert set(r.assumed) == want[twin], r.label
            continue
        assert set(r.assumed) == want[r.label], r.label
    for w in (8, 16, 32):
        assert {a for r in port.reports if f" w{w} " in r.label
                for a in r.assumed} == {
            f"antilog/{w} product bus",
            f"mitchell_log/{w} lane operand -> mitchell_log/{w} log value"}


def test_every_case_declares_its_bus(matrices):
    _, port = matrices
    for r in port.reports:
        w = int(re.search(r" w(\d+)", r.label).group(1))
        want = {"matmul_int": "int32", "matmul_emul": "int64"}.get(
            r.label.split(" ")[0], "uint64" if w == 32 else "uint32")
        assert r.bus == want, r.label
        assert r.requires_x64 == (want in ("uint64", "int64")), r.label


def test_every_registered_op_has_analysis_metadata():
    ops = registry.all_ops()
    assert {impl.name for impl in ops} >= {"decode_attention", "sqrt"}
    assert [impl.name for impl in ops if impl.analysis is None] == []


def test_verdict_for_names_proof_and_skip():
    assert verdict_for("sqrt", 8) == "proved safe (2 case(s), 0 skipped)"
    assert verdict_for("packed", 32).startswith(
        "skipped: packed lanes need >= 2 per 32-bit word")


def test_report_is_byte_deterministic():
    a, b = run_matrix(ops=["sqrt"]), run_matrix(ops=["sqrt"])
    assert render_text(a) == render_text(b)
    assert json.dumps(to_json(a), sort_keys=True) == \
        json.dumps(to_json(b), sort_keys=True)


# ============================================================= mutations ==
# each pair: the reference's mutant (tests/test_analysis.py) and the port's
# counterpart on its own stages; both must fire the rule the reference's
# test asserts, and the port's findings must name a line of this file or
# of the port
def test_mutation_repack_without_guard_is_lane_overlap(patched_reference):
    width = 8
    r_tab = r_dp.op_table("mul", width, 6, _IB)
    t_tab = dp.op_table("mul", width, 6, _IB)

    def r_mutant(aw, bw):
        outs = [r_dp.lane_op(a, b, r_tab, width=width, index_bits=_IB,
                             op="mul", in_kernel=True)
                for a, b in zip(r_dp.lane_expand(aw, width),
                                r_dp.lane_expand(bw, width))]
        w = jnp.zeros_like(outs[0])
        for i, lane in enumerate(outs[:2]):
            w = w | (lane << jnp.uint32(width * i))     # BUG: width stride
        return w

    def t_mutant(aw, bw):
        outs = [dp.lane_op(a, b, t_tab, width=width, index_bits=_IB,
                           op="mul")
                for a, b in zip(dp.lane_expand(aw, width),
                                dp.lane_expand(bw, width))]
        w = torch.zeros_like(outs[0])
        for i, lane in enumerate(outs[:2]):
            w = w | (lane << (width * i))               # BUG: width stride
        return w

    rfs = _r_findings(r_mutant, (RArgSpec((8, 64), np.uint32, 0,
                                          (1 << 32) - 1),) * 2)
    tfs = _t_findings(t_mutant, (ArgSpec((8, 64), torch.int64, 0,
                                         (1 << 32) - 1),) * 2)
    assert "lane-overlap" in _rules(rfs) & _rules(tfs), _render(tfs)
    assert any("test_torch_analysis" in f.source
               for f in tfs if f.rule == "lane-overlap")


def test_mutation_unconditional_antilog_shift_is_caught(patched_reference):
    width = 8
    F = r_frac_bits(width)
    assert frac_bits(width) == F

    def r_mutant(ls):
        fF = jnp.asarray(F, ls.dtype)
        Xs = ls & ((jnp.asarray(1, ls.dtype) << fF) - 1)
        mant = (jnp.asarray(1, ls.dtype) << fF) + Xs
        shl = (ls >> fF) - fF                   # BUG: no `I >= F` guard
        return mant << shl

    def t_mutant(ls):
        mant = (1 << F) + (ls & ((1 << F) - 1))
        shl = (ls >> F) - F                     # BUG: no `I >= F` guard
        return mant << shl

    rfs = _r_findings(r_mutant, (RArgSpec((64,), np.uint32, 0,
                                          (1 << (F + 5)) - 1),))
    tfs = _t_findings(t_mutant, (ArgSpec((64,), torch.int64, 0,
                                         (1 << (F + 5)) - 1),))
    for fs in (rfs, tfs):
        assert any("underflow" in f.message for f in fs), _render(fs)
    assert _rules(tfs) == _rules(rfs)
    assert all(f.source for f in tfs)


def test_mutation_narrow_accumulator_is_caught(patched_reference):
    # width-16 products fill the 32-bit bus; a sum of K = 512 of them in
    # the bus word overflows it (why matmul_int w16 is a declared skip).
    # The port's int64 carrier would hold the sum; the bus does not.
    width, K = 16, 512
    r_tab = r_dp.op_table("mul", width, 8, _IB)
    t_tab = dp.op_table("mul", width, 8, _IB)

    def r_mutant(a, b):
        p = r_dp.lane_op(a, b, r_tab, width=width, index_bits=_IB,
                         op="mul", in_kernel=True)
        return jnp.sum(p, axis=1, dtype=jnp.uint32)     # BUG: 32-bit acc

    def t_mutant(a, b):
        p = dp.lane_op(a, b, t_tab, width=width, index_bits=_IB, op="mul")
        return p.sum(dim=1)                             # BUG: on the bus

    rfs = _r_findings(r_mutant, (RArgSpec((8, K), np.uint32, 0,
                                          (1 << width) - 1),) * 2)
    tfs = _t_findings(t_mutant, (ArgSpec((8, K), torch.int64, 0,
                                         (1 << width) - 1),) * 2)
    assert _rules(rfs) == _rules(tfs) == {"overflow"}, _render(tfs)


def test_mutation_int32_accumulator_is_signedness_crossing(
        patched_reference):
    width = 16
    r_tab = r_dp.op_table("mul", width, 8, _IB)
    t_tab = dp.op_table("mul", width, 8, _IB)

    def r_mutant(a, b):
        p = r_dp.lane_op(a, b, r_tab, width=width, index_bits=_IB,
                         op="mul", in_kernel=True)
        return jnp.sum(p.astype(jnp.int32), axis=1)     # BUG: signed cast

    def t_mutant(a, b):
        p = dp.lane_op(a, b, t_tab, width=width, index_bits=_IB, op="mul")
        return p.to(torch.int32).sum(dim=1)             # BUG: signed cast

    rfs = _r_findings(r_mutant, (RArgSpec((8, 512), np.uint32, 0,
                                          (1 << width) - 1),) * 2)
    tfs = _t_findings(t_mutant, (ArgSpec((8, 512), torch.int64, 0,
                                         (1 << width) - 1),) * 2)
    assert "signedness" in _rules(rfs) & _rules(tfs), _render(tfs)
    assert _rules(tfs) == _rules(rfs)


def test_mutation_float32_lane_limit_is_lane_domain(patched_reference):
    # float32(2^32 - 1) rounds UP to 2^32: clipping against it admits an
    # operand one past the lane maximum (the reference's bug this pass
    # found); the port's clamp rounds its bound to the tensor's float32
    def r_mutant(x):
        lim = jnp.float32((1 << 32) - 1)        # BUG: not representable
        q = jnp.clip(jnp.round(x), 0, lim).astype(jnp.uint64)
        return r_dp.lod_log(q, 32)

    def r_fixed(x):
        lim = jnp.float32(r_lane_max_float(32))
        q = jnp.clip(jnp.round(x), 0, lim).astype(jnp.uint64)
        return r_dp.lod_log(q, 32)

    def t_mutant(x):
        lim = float((1 << 32) - 1)              # BUG: rounds to 2^32
        q = torch.round(x).clamp(0.0, lim).to(torch.int64)
        return dp.lod_log(q, 32)

    def t_fixed(x):
        q = torch.round(x).clamp(0.0, lane_max_float(32)).to(torch.int64)
        return dp.lod_log(q, 32)

    rx = (RArgSpec((64,), np.float32, 0.0, 1e30),)
    tx = (ArgSpec((64,), torch.float32, 0.0, 1e30),)
    rfs = _r_findings(r_mutant, rx, requires_x64=True)
    tfs = _t_findings(t_mutant, tx, bus=torch.uint64)
    assert _rules(rfs) == _rules(tfs) == {"lane-domain"}, _render(tfs)
    assert _r_findings(r_fixed, rx, requires_x64=True) == []
    assert _t_findings(t_fixed, tx, bus=torch.uint64) == []


def test_guarded_unsigned_sub_proves_clean_and_bare_sub_does_not(
        patched_reference):
    ru = RArgSpec((16,), np.uint32, 0, 1000)
    tu = ArgSpec((16,), torch.int64, 0, 1000)
    assert _r_findings(lambda a, b: jnp.where(a >= b, a - b,
                                              jnp.zeros_like(a)),
                       (ru, ru)) == []
    assert _t_findings(lambda a, b: torch.where(a >= b, a - b,
                                                torch.zeros_like(a)),
                       (tu, tu)) == []
    # the port's saturation idiom (a clamp at 0) proves clean too
    assert _t_findings(lambda a, b: (a - b).clamp(min=0), (tu, tu)) == []
    rfs = _r_findings(lambda a, b: a - b, (ru, ru))
    tfs = _t_findings(lambda a, b: a - b, (tu, tu))
    assert _rules(rfs) == _rules(tfs) == {"overflow"}
    assert any("underflow" in f.message for f in tfs)


# ================================================== the port's own hazards --
def _antilog(F, kept):
    def fn(ls):
        I = ls >> F
        mant = (1 << F) + (ls & ((1 << F) - 1))
        shl = (I - F).clamp(0, 32)
        shr = (F - I).clamp(min=0)
        if kept:
            return torch.where(I >= F, mant << shl, mant >> shr)
        return (mant << shl) >> shr             # BUG at w32: >> of >= 2^63
    return fn


def test_w32_right_shift_of_a_wide_bus_value_is_signedness():
    # the anti-log as it was written before this analyzer: a mantissa
    # shifted left (up to 2^64 - 1 on the width-32 bus) then right — the
    # int64 carrier shifts arithmetically, so a value >= 2^63 reads
    # negative. The kept form shifts each lane one way only.
    F = frac_bits(32)
    ls = (ArgSpec((64,), torch.int64, 0, (1 << (F + 7)) - 1),)
    fs = _t_findings(_antilog(F, kept=False), ls, bus=torch.uint64)
    assert _rules(fs) == {"signedness"}, _render(fs)
    assert "2^63" in fs[0].message and "test_torch_analysis" in fs[0].source
    assert _t_findings(_antilog(F, kept=True), ls, bus=torch.uint64) == []
    # the same shift at width 16 (a summed pair of log values: I <= 31)
    # is nobody's business: the carrier holds every value of the 32-bit
    # bus and more
    F = frac_bits(16)
    assert _t_findings(_antilog(F, kept=False),
                       (ArgSpec((64,), torch.int64, 0,
                                (1 << (F + 5)) - 1),)) == []


def test_w32_comparison_and_float_read_of_a_wide_bus_value():
    def cmp(a):
        return (a << 32) > 5                    # BUG: may be >= 2^63

    def to_float(a):
        return (a << 32).to(torch.float32)      # BUG: reads the sign bit

    a = (ArgSpec((8,), torch.int64, 0, (1 << 32) - 1),)
    for fn in (cmp, to_float):
        fs = _t_findings(fn, a, bus=torch.uint64)
        assert _rules(fs) == {"signedness"}, _render(fs)
    # the bus reader reads it right
    from repro_torch.core.mitchell import lanes_to_float
    assert _t_findings(lambda x: lanes_to_float(x << 32), a,
                       bus=torch.uint64) == []


def test_inexact_frexp_in_leading_one_is_signedness():
    # leading_one reads the exponent of the float64 form: exact for every
    # lane (< 2^32), not for a 60-bit value
    fs = _t_findings(leading_one, (ArgSpec((8,), torch.int64, 0,
                                           1 << 60),), bus=torch.uint64)
    assert _rules(fs) == {"signedness"}, _render(fs)
    assert "frexp" in fs[0].message
    assert _t_findings(leading_one, (ArgSpec((8,), torch.int64, 0,
                                             (1 << 32) - 1),),
                       bus=torch.uint64) == []


def test_data_dependent_branch_is_a_finding_not_a_proof():
    def branchy(a):
        if bool((a > 5).any()):                 # a host read of the data
            return a + 1
        return a

    fs = _t_findings(branchy, (ArgSpec((8,), torch.int64, 0, 255),))
    assert len(fs) == 1 and fs[0].message.startswith("trace failed")


def test_unknown_aten_ops_widen_and_are_listed():
    rep = check_case(TraceCase(
        label="unknown", fn=lambda a: torch.bitwise_and(
            torch.cumprod(a, 0), 255),
        args=(ArgSpec((8,), torch.int64, 0, 3),)))
    assert rep.ok and rep.unknown_prims == ["cumprod.default"]


def test_sum_that_wrap_bus_would_wrap_is_overflow_at_width_16():
    fs = _t_findings(lambda a: a.sum(dim=0),
                     (ArgSpec((2,), torch.int64, 0, (1 << 32) - 1),))
    assert _rules(fs) == {"overflow"}
    assert _t_findings(lambda a: a.sum(dim=0),
                       (ArgSpec((2,), torch.int64, 0, (1 << 31) - 1),)) == []


# ============================================================ the domain ==
_ARR = st.sampled_from([np.uint32, np.int32, np.int64, np.uint8]).flatmap(
    lambda dt: st.lists(
        st.integers(int(np.iinfo(dt).min), int(np.iinfo(dt).max)),
        min_size=1, max_size=6).map(lambda v: np.asarray(v, dtype=dt)))


def _key(v):
    return (np.dtype(v.dtype).name, v.lo, v.hi, v.bits)


@settings(max_examples=60, deadline=None)
@given(_ARR, _ARR)
def test_domain_equals_the_reference(a, b):
    for x in (a, b):
        assert _key(t_domain.from_concrete(x)) == \
            _key(r_domain.from_concrete(x))
        # a torch tensor of the same values reads the same (uint32 through
        # its int32 bits)
        if x.dtype != np.uint32:
            assert _key(t_domain.from_concrete(torch.from_numpy(x))) == \
                _key(r_domain.from_concrete(x))
    if a.dtype == b.dtype:
        assert _key(t_domain.join(t_domain.from_concrete(a),
                                  t_domain.from_concrete(b))) == \
            _key(r_domain.join(r_domain.from_concrete(a),
                               r_domain.from_concrete(b)))
    for dt in (np.uint32, np.int32, np.uint64, np.bool_):
        assert _key(t_domain.top(dt, (2,))) == _key(r_domain.top(dt, (2,)))


def test_argspec_reads_the_bus():
    lane = ArgSpec((4,), torch.int64, 0, 255)
    assert np.dtype(lane.absval(torch.uint32).dtype) == np.uint32
    assert np.dtype(lane.absval(torch.uint64).dtype) == np.uint64
    signed = ArgSpec((4,), torch.int64, -255, 255)
    assert np.dtype(signed.absval(torch.uint32).dtype) == np.int32
    assert _key(lane.absval(torch.uint32)) == \
        _key(RArgSpec((4,), np.uint32, 0, 255).absval())


# ============================================================== the lint ==
_LINT_FIXTURES = {
    "timing": "import time\nt = time.perf_counter()\nu = time.time()\n",
    "block": "f(block=(128, 256))\ng(block=None)\nh(block_shape=[8, 8])\n",
    "allow": ("import time\n"
              "# simdive-lint: allow(timing-outside-harness): grandfathered\n"
              "t = time.perf_counter()\n"
              "u = time.perf_counter()  # simdive-lint: allow(timing-outside-harness)\n"),
    "swallow": ("try:\n    x = 1\nexcept Exception:\n    pass\n"
                "try:\n    y = 2\nexcept (ValueError, BaseException):\n    pass\n"
                "try:\n    z = 3\n"
                "# simdive-lint: allow(swallowed-exception): test grandfather\n"
                "except Exception:\n    pass\n"
                "try:\n    w = 4\nexcept ValueError:\n    pass\n"
                "try:\n    v = 5\nexcept:\n    pass\n"),
}
#: equivalent places in the two trees: (reference path, port path)
_LINT_PLACES = [
    ("src/repro/core/mod.py", "src/repro_torch/core/mod.py"),
    ("src/repro/launch/mod.py", "src/repro_torch/launch/mod.py"),
    ("benchmarks/mod.py", "scripts/mod.py"),
    ("src/repro/metrics/timing.py", "src/repro_torch/metrics/timing.py"),
    ("src/repro/tuning/mod.py", "src/repro_torch/tuning/mod.py"),
]


@pytest.mark.parametrize("fixture", sorted(_LINT_FIXTURES))
def test_lint_equals_the_reference(tmp_path, fixture):
    for r_rel, t_rel in _LINT_PLACES:
        got = {}
        for tree, rel, lint in (("r", r_rel, r_lint_file),
                                ("t", t_rel, lint_file)):
            root = tmp_path / tree
            path = root / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(_LINT_FIXTURES[fixture])
            got[tree] = sorted((f.rule, int(f.source.rsplit(":", 1)[1]))
                               for f in lint(path, root))
        assert got["t"] == got["r"], (fixture, t_rel)
    # the harness script the port adds to the scanned layers
    root = tmp_path / "t"
    (root / "chip_smoke.py").write_text(_LINT_FIXTURES["swallow"])
    assert {f.rule for f in lint_file(root / "chip_smoke.py", root)} == \
        ({"swallowed-exception"} if fixture else set())


def test_lint_uint64_outside_the_bus_readers(tmp_path):
    body = ("import torch\n"
            "def to_lanes(x):\n    return x.view(torch.uint64)\n"
            "def other(x):\n    return x.view(torch.uint64)\n"
            "def from_lanes(x):\n"
            "    def inner(y):\n        return y.view(torch.uint64)\n"
            "    return inner(x)\n"
            "T = torch.uint64  # simdive-lint: allow(unguarded-uint64): tag\n")
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "mitchell.py").write_text(body)
    got = [(f.rule, f.source) for f in lint_file(core / "mitchell.py",
                                                  tmp_path)]
    assert got == [("unguarded-uint64", "src/repro_torch/core/mitchell.py:5")]
    (core / "other.py").write_text(body)
    lines = sorted(int(f.source.rsplit(":", 1)[1])
                   for f in lint_file(core / "other.py", tmp_path))
    assert lines == [3, 5, 8]


def test_lint_is_clean():
    fs = run_lint()
    assert fs == [], _render(fs)


# ============================================================== the diff ==
def test_ops_for_paths_tri_state():
    known = [impl.name for impl in registry.all_ops()]
    k = "src/repro_torch/kernels/"
    assert ops_for_paths([k + "csrc/packed_simd.cu"], known) == ("packed",)
    assert ops_for_paths([k + "logmatmul.py"], known) == \
        ("matmul_emul", "matmul_int")
    assert ops_for_paths([k + "csrc/flash_attention_w32.cu"], known) == \
        ("attention",)
    # the decode step's finalize is the flash module's softmax_div
    assert ops_for_paths([k + "flash_attention.py"], known) == \
        ("attention", "decode_attention")
    assert ops_for_paths([k + "csrc/elemwise.cu"], known) == \
        ("elemwise", "sqrt")
    assert ops_for_paths(["docs/x.md", "tests/test_y.py", "chip_smoke.py"],
                         known) == ()
    for shared in (k + "datapath.py", k + "csrc/simdive_datapath.cuh",
                   "src/repro_torch/core/approx.py",
                   "src/repro_torch/analysis/lint.py"):
        assert ops_for_paths([shared], known) is None
    assert ops_for_paths(["docs/x.md"], ["attention"]) is None
    assert set(OP_SOURCES) <= set(known)


def test_op_sources_exist_and_cover_every_kernel_source():
    import os
    root = os.path.join(os.path.dirname(__file__), "..")
    mapped = [p for ps in OP_SOURCES.values() for p in ps] + \
        [s for s in SHARED_SOURCES if not s.endswith("/")]
    for path in mapped:
        assert os.path.exists(os.path.join(root, path)), path
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    for name in os.listdir(csrc):
        assert f"src/repro_torch/kernels/csrc/{name}" in mapped, name


def test_changed_paths_rejects_bad_ref():
    with pytest.raises(RuntimeError, match="git diff"):
        changed_paths("no-such-ref-xyzzy")


# =============================================================== the CLI ==
def test_gate_json_has_the_reference_keys(tmp_path, matrices):
    ref, _ = matrices
    out = tmp_path / "gate.json"
    assert main(["--gate", "--json", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = r_to_json(ref, [])
    assert set(got) == set(want)
    assert set(got["cases"][0]) >= set(want["cases"][0])
    assert got["coverage_gaps"] == [] and got["lint"] == []
    assert all(c["ok"] for c in got["cases"]) and len(got["cases"]) == 35


def test_diff_head_on_a_clean_tree_skips_the_matrix(tmp_path, monkeypatch,
                                                    capsys):
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t"]
    subprocess.run(git + ["init", "-q", str(tmp_path)], check=True)
    subprocess.run(git + ["-C", str(tmp_path), "commit", "-q",
                          "--allow-empty", "-m", "x"], check=True)
    monkeypatch.chdir(tmp_path)
    assert main(["--diff", "HEAD", "--no-lint", "--json"]) == 0
    out = capsys.readouterr().out
    assert "matrix skipped" in out
    assert json.loads(out.split("\n", 1)[1])["cases"] == []


def test_cli_op_and_width_restrict_the_matrix(capsys):
    assert main(["--op", "sqrt", "--width", "8", "--no-lint"]) == 0
    out = capsys.readouterr().out
    assert "cases: 2  proved: 2" in out and "sqrt w8 fo8" in out


# ======================================================= the annotations ==
def test_annotations_are_identity_outside_tracing():
    x = torch.arange(8)
    assert not tracing_active()
    assert require_range(x, hi=7, what="t", assume=("lane-overlap",)) is x
    assert ensure_range(x, hi=7, bits=7, what="t") is x


def test_annotations_are_graph_nodes_under_tracing():
    from torch.fx.experimental.proxy_tensor import make_fx

    def fn(x):
        return ensure_range(require_range(x, hi=255, what="in"), hi=255,
                            what="out")

    gm = make_fx(fn, tracing_mode="fake")(torch.zeros(4, dtype=torch.int64))
    assert not any("range_contract" in str(n.target)
                   for n in gm.graph.nodes)
    with analysis_tracing():
        assert tracing_active()
        gm = make_fx(fn, tracing_mode="fake")(
            torch.zeros(4, dtype=torch.int64))
    assert not tracing_active()
    phases = [n.args[1] for n in gm.graph.nodes
              if "range_contract" in str(n.target)]
    assert phases == ["require", "ensure"]


def test_served_generate_is_the_same_with_the_annotations_armed():
    """The contracts and carrier casts run eagerly (the custom ops' eager
    forms) give the served tokens and logits bit for bit."""
    from test_torch_serve import _smoke

    from repro_torch.launch import serve
    from test_torch_model import GEN, P

    lm, params, prompts = _smoke(emulate=False)
    want = serve.generate(lm, params, prompts, P + GEN, GEN,
                          decode_fn=lm.decode_step, return_logits=True)
    with analysis_tracing():
        got = serve.generate(lm, params, prompts, P + GEN, GEN,
                             decode_fn=lm.decode_step, return_logits=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
