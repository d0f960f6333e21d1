"""Port vs reference: guarded dispatch (``get_op(..., guard=True)``).

The same outputs, made with numpy for every rule of the reference's
``_guard_check`` — clean, non-finite, attention over 4x max |v|, elemwise
out of its lane, a saturated quotient over a nonzero denominator, a
quotient under the floor, an accumulator over K (2^w - 1)^2 — go through
the reference's check and the port's: both pass or both trip, with the
same reason, ``bad`` and ``total``. ``decode_attention`` exists only in
the port; its rule is the attention rule over the cache rows the call
reads plus the new token, held here to the reference's attention rule
given exactly those rows as v. A call made while a CUDA graph is being
captured passes unchecked (the reference's tracer rule); on this host the
capture is a patched ``torch.cuda.is_current_stream_capturing`` (and
``is_available``, without which the port never asks).
"""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.simdive import SimdiveSpec as RSpec
from repro.kernels import get_op as r_get_op
from repro.kernels import registry as r_registry
from repro_torch.core.simdive import SimdiveSpec as TSpec
from repro_torch.kernels import get_op, registry
from repro_torch.kernels.decode_attention import decode_attention_ref

torch.set_num_threads(1)

SAT = 0xFFFFFFFF


def _verdict(check):
    """``None`` when ``check()`` passes, else the GuardTripped fields."""
    try:
        check()
    except (r_registry.GuardTripped, registry.GuardTripped) as e:
        return (type(e).__name__, e.op, e.backend, e.width, e.reason, e.bad,
                e.total, str(e))
    return None


def _both(name, width, arrays, kw, out, coeff_bits=6):
    """The reference's and the port's verdicts on the same numpy data."""
    r = _verdict(lambda: r_registry._guard_check(
        name, RSpec(width=width, coeff_bits=coeff_bits), "ref", arrays, kw,
        out))
    t = _verdict(lambda: registry._guard_check(
        name, TSpec(width=width, coeff_bits=coeff_bits), "ref",
        [torch.from_numpy(a) for a in arrays], kw, torch.from_numpy(out)))
    return r, t


def _lanes(rng, shape, width):
    a = rng.integers(1, 1 << width, shape).astype(np.uint32)
    b = rng.integers(1, 1 << width, shape).astype(np.uint32)
    b.reshape(-1)[::9] = 0                       # x / 0 lanes
    return a, b


def _div_out(a, b, frac):
    """An in-lane quotient (a << frac) // b, saturated where b == 0."""
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    q = np.where(b64 == 0, SAT, (a64 << frac) // np.maximum(b64, 1))
    return q.astype(np.uint32)


def _cases():
    rng = np.random.default_rng(11)
    cases = {}
    # attention: (q, k, v) -> out
    q, k, v = (rng.normal(size=(3, 16, 8)).astype(np.float32)
               for _ in range(3))
    out = 0.5 * v
    cases["attention-clean"] = ("attention", 16, (q, k, v), {}, out, None)
    bad = out.copy()
    bad[0, 0, :2] = np.nan
    bad[1, 3, 5] = np.inf
    cases["attention-nonfinite"] = ("attention", 16, (q, k, v), {}, bad,
                                    "non-finite")
    bad = out.copy()
    bad[2, :3, 1] = 5.0 * np.abs(v).max()
    bad[0, 1, 1] = -5.0 * np.abs(v).max()
    cases["attention-over-bound"] = ("attention", 16, (q, k, v), {}, bad,
                                     "4x max |v|")
    # elemwise mul, width 8 and 16
    for w in (8, 16):
        a, b = _lanes(rng, (40, 7), w)
        prod = (a.astype(np.uint64) * b.astype(np.uint64)).astype(np.uint32)
        cases[f"mul-w{w}-clean"] = ("elemwise", w, (a, b), {"op": "mul"},
                                    prod, None)
        if w == 8:                   # at width 16 the lane is the word
            bad = prod.copy()
            bad.reshape(-1)[[3, 50, 77]] = 1 << (2 * w)
            cases["mul-w8-out-of-lane"] = ("elemwise", w, (a, b),
                                           {"op": "mul"}, bad, "lane range")
    # elemwise div, frac_out 8 (the floor rule on) and 3 (off)
    a, b = _lanes(rng, (50, 9), 8)
    for frac in (8, 3):
        kw = {"op": "div", "frac_out": frac}
        quot = _div_out(a, b, frac)
        cases[f"div-f{frac}-clean"] = ("elemwise", 8, (a, b), kw, quot, None)
        bad = quot.copy()
        bad.reshape(-1)[[1, 2]] = (1 << (8 + frac)) + 5
        cases[f"div-f{frac}-out-of-lane"] = ("elemwise", 8, (a, b), kw, bad,
                                             "lane range")
        bad = quot.copy()
        nz = np.flatnonzero(b.reshape(-1) != 0)[:4]
        bad.reshape(-1)[nz] = SAT
        cases[f"div-f{frac}-saturated"] = ("elemwise", 8, (a, b), kw, bad,
                                           "saturated quotient")
        bad = quot.copy()
        ge = np.flatnonzero((a.reshape(-1) >= b.reshape(-1))
                            & (b.reshape(-1) != 0))[:5]
        bad.reshape(-1)[ge] = 3
        # frac 3: quotients under the floor are legitimate there
        cases[f"div-f{frac}-under-floor"] = (
            "elemwise", 8, (a, b), kw, bad,
            "quotient below" if frac >= 4 else None)
    # elemwise mixed: mul lanes and div lanes
    mode = rng.integers(0, 2, a.shape).astype(np.uint32)
    kw = {"op": "mixed", "frac_out": 8}
    mixed = np.where(mode != 0, (a.astype(np.int64) * b).astype(np.uint32),
                     _div_out(a, b, 8))
    cases["mixed-clean"] = ("elemwise", 8, (a, b), kw, mixed, None)
    bad = mixed.copy()
    bad.reshape(-1)[5] = 1 << 17
    cases["mixed-out-of-lane"] = ("elemwise", 8, (a, b), kw, bad,
                                  "lane range")
    bad = mixed.copy()
    bad.reshape(-1)[np.flatnonzero(b.reshape(-1) != 0)[:2]] = SAT
    cases["mixed-saturated"] = ("elemwise", 8, (a, b), kw, bad,
                                "saturated quotient")
    # matmul_int (int32) and matmul_emul (int64)
    K = 24
    x = rng.integers(-255, 256, (5, K)).astype(np.int32)
    wt = rng.integers(-255, 256, (K, 6)).astype(np.int32)
    acc = (x.astype(np.int64) @ wt).astype(np.int32)
    cases["matmul_int-clean"] = ("matmul_int", 8, (x, wt), {}, acc, None)
    bad = acc.copy()
    bad[0, 0] = K * 255 ** 2 + 1
    bad[4, 5] = -(K * 255 ** 2 + 7)
    cases["matmul_int-over-bound"] = ("matmul_int", 8, (x, wt), {}, bad,
                                      "accumulator")
    mag, sgn = np.abs(x), np.sign(x).astype(np.int32)
    emul = acc.astype(np.int64)
    cases["matmul_emul-clean"] = ("matmul_emul", 8, (mag, sgn, mag.T, sgn.T),
                                  {"k_chunk": 8}, emul, None)
    bad = emul.copy()
    bad[2, 3] = 1 << 40
    cases["matmul_emul-over-bound"] = ("matmul_emul", 8,
                                       (mag, sgn, mag.T, sgn.T),
                                       {"k_chunk": 8}, bad, "accumulator")
    # packed: words span the whole uint32 range, no range rule
    words = rng.integers(0, 1 << 32, (8, 16), dtype=np.uint64)
    cases["packed-any-word"] = ("packed", 8, (words.astype(np.uint32),) * 2,
                                {"op": "mul"}, words.astype(np.uint32), None)
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_guard_verdicts_equal_the_reference(case):
    name, width, arrays, kw, out, reason = CASES[case]
    r, t = _both(name, width, arrays, kw, out)
    if reason is None:
        assert r is None and t is None
    else:
        assert r is not None and reason in r[4]
        assert t[1:] == r[1:], (t, r)
        assert t[0] == "GuardTripped"


@pytest.mark.parametrize("spec", [(6, True), (0, False)],
                         ids=["cb6", "mitchell"])
def test_guard_clean_on_the_exhaustive_width8_grid(spec):
    """``get_op("elemwise", ..., guard=True)`` over every nonzero 8-bit
    pair (the reference's ``tests/test_faults.py`` grid): the SIMDive
    divider and multiplier never trip the guard; at the Mitchell spec (the
    scheduler's shed rung) the port's verdict is the reference's."""
    coeff_bits, rounding = spec
    lanes = np.arange(1, 256, dtype=np.uint32)
    A, B = (m.ravel() for m in np.meshgrid(lanes, lanes))
    r_op = r_get_op("elemwise", RSpec(width=8, coeff_bits=coeff_bits,
                                      round_output=rounding), "ref",
                    guard=True)
    t_op = get_op("elemwise", TSpec(width=8, coeff_bits=coeff_bits,
                                    round_output=rounding), "ref",
                  guard=True)
    ta, tb = torch.from_numpy(A), torch.from_numpy(B)
    for kw in ({"op": "mul"}, {"op": "div", "frac_out": 8}):
        r = _verdict(lambda: r_op(jnp.asarray(A), jnp.asarray(B), **kw))
        t = _verdict(lambda: t_op(ta, tb, **kw))
        assert t == (None if r is None else ("GuardTripped",) + r[1:])
        if coeff_bits:
            assert t is None


def test_guard_tripped_fields_and_message():
    kw = dict(op="elemwise", backend="cuda", width=8,
              reason="saturated quotient with nonzero denominator", bad=3,
              total=64)
    t, r = registry.GuardTripped(**kw), r_registry.GuardTripped(**kw)
    assert isinstance(t, RuntimeError)
    assert str(t) == str(r)
    assert (t.op, t.backend, t.width, t.reason, t.bad, t.total) == \
        ("elemwise", "cuda", 8, kw["reason"], 3, 64)
    assert "[3/64 elements]" in str(t)


def _capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def test_output_under_capture_passes_unchecked(monkeypatch):
    """A bad output under a (patched) CUDA-graph capture passes, through
    the check and through a guarded op; the same calls trip outside it."""
    name, width, arrays, kw, out, _ = CASES["div-f8-saturated"]
    spec = TSpec(width=width, coeff_bits=6)
    tensors = [torch.from_numpy(a) for a in arrays]
    entry = get_op("elemwise", spec, "ref").entry
    bad_op = registry.BoundOp(
        entry=replace(entry, ref=lambda *t, spec, **k: torch.from_numpy(out)),
        spec=spec, backend="ref", block=None, guard=True)
    with pytest.raises(registry.GuardTripped, match="saturated"):
        registry._guard_check(name, spec, "ref", tensors, kw,
                              torch.from_numpy(out))
    with pytest.raises(registry.GuardTripped, match="saturated"):
        bad_op(*tensors, **kw)
    _capturing(monkeypatch)
    registry._guard_check(name, spec, "ref", tensors, kw,
                          torch.from_numpy(out))
    assert torch.equal(bad_op(*tensors, **kw), torch.from_numpy(out))


def test_unguarded_op_returns_a_bad_output():
    _, width, arrays, kw, out, _ = CASES["div-f8-saturated"]
    spec = TSpec(width=width, coeff_bits=6)
    entry = get_op("elemwise", spec, "ref").entry
    op = registry.BoundOp(
        entry=replace(entry, ref=lambda *t, spec, **k: torch.from_numpy(out)),
        spec=spec, backend="ref", block=None)
    assert not op.guard
    assert torch.equal(op(*(torch.from_numpy(a) for a in arrays), **kw),
                       torch.from_numpy(out))
    assert get_op("elemwise", spec, guard=True).guard


def _decode_case(pos, ring_full=False, window=0, seed=3):
    rng = np.random.default_rng(seed)
    B, Smax, KVH, G, dh = 2, 12, 2, 3, 8
    q = rng.normal(size=(B, KVH, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, Smax, KVH, dh)).astype(np.float32)
    v = rng.normal(size=(B, Smax, KVH, dh)).astype(np.float32)
    k_new = rng.normal(size=(B, 1, KVH, dh)).astype(np.float32)
    v_new = rng.normal(size=(B, 1, KVH, dh)).astype(np.float32)
    rows = np.broadcast_to(np.asarray(pos), (B,))
    read = np.zeros((B, Smax), bool)
    for b, p in enumerate(rows):
        read[b] = np.arange(Smax) < p
        if window and Smax > window:
            read[b] &= np.arange(Smax) > p - window
    v[~read] = 1e3                      # rows the call never reads
    return q, k, v, k_new, v_new, read


@pytest.mark.parametrize("pos,window", [(7, 0), ((5, 0), 0), ((9, 11), 4)],
                         ids=["scalar", "per-row-one-empty", "window"])
@pytest.mark.parametrize("scale", [1.0, 3.9, 4.5, 30.0])
def test_decode_attention_rule_is_the_attention_rule_on_rows_read(
        pos, window, scale):
    """decode_attention (port only): the attention rule with v the rows
    the call reads plus the new token — never the unread rows, whatever
    they hold — equal to the reference's attention rule given those rows;
    the plain version's own output passes."""
    q, k, v, k_new, v_new, read = _decode_case(pos, window=window)
    pos_t = torch.tensor(pos) if isinstance(pos, tuple) else pos
    kw = {"pos": pos_t, "slot": pos_t, "window": window}
    vread = np.concatenate([v[read], v_new.reshape(-1, *v.shape[2:])])
    lim = np.abs(vread).max()
    out = np.full(q.shape, 0.1, np.float32)
    out[0, 1, 2, :3] = scale * lim
    t = _verdict(lambda: registry._guard_check(
        "decode_attention", TSpec(width=16, coeff_bits=6), "ref",
        [torch.from_numpy(a) for a in (q, k, v, k_new, v_new)], kw,
        torch.from_numpy(out)))
    r = _verdict(lambda: r_registry._guard_check(
        "attention", RSpec(width=16, coeff_bits=6), "ref", (q, k, vread),
        {}, out))
    assert (t is None) == (scale < 4.0)
    assert (t is None) == (r is None)
    if t is not None:
        assert t[4:7] == r[4:7]
        assert t[1] == "decode_attention"
    tensors = [torch.from_numpy(a) for a in (q, k, v, k_new, v_new)]
    op = get_op("decode_attention", TSpec(width=16, coeff_bits=6), "ref",
                guard=True)
    got = op(*tensors, approx_div=True, frac_out=15, **kw)
    assert torch.equal(got, decode_attention_ref(
        *tensors, spec=TSpec(width=16, coeff_bits=6), approx_div=True,
        frac_out=15, **kw))


def test_decode_attention_rule_with_ring_full():
    """Once the ring has wrapped every slot but the replaced one is read:
    a huge value there alone does not trip; in a read slot it does."""
    q, k, v, k_new, v_new, _ = _decode_case(20)
    tensors = [torch.from_numpy(a) for a in (q, k, v, k_new, v_new)]
    kw = {"pos": 20, "slot": 8, "ring_full": True}
    spec = TSpec(width=16, coeff_bits=6)
    v[:] = 1.0
    v_new[:] = 0.5
    v[:, 8] = 1e3                       # the slot being replaced
    out = torch.full(q.shape, 3.5)      # limit: 4 x 1.0
    registry._guard_check("decode_attention", spec, "ref", tensors, kw, out)
    out[0, 0, 0, 0] = 4.5
    with pytest.raises(registry.GuardTripped, match="4x max"):
        registry._guard_check("decode_attention", spec, "ref", tensors, kw,
                              out)
