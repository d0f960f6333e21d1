"""The tuner's selection layer (``tuning.select``, ``tuning.frontier``) in
both packages.

The same inputs go through the reference's ``repro.tuning`` and the port's
``repro_torch.tuning``: the reference's own fixtures from
``benchmarks/tune.py`` (``fixture_error_fn``, ``fixture_bench_run``,
imported, not edited), the committed ``BENCH_simdive.json`` given as an
explicit ``bench=`` path, and the real exhaustive width-8 and stratified
width-16 error sweeps (the port's on the plain versions, ``device='cpu'``).
Frontiers, ``pareto``, selections, ``BudgetError`` messages, policies
and their JSON must be the reference's. The reference defaults to its
``'ref'`` backend and the port to ``'auto'``, so the port is given
``backend='ref'`` wherever an entry is held to the reference's; that
default is pinned on its own.

The reference's tests run with x64 on (``tests/conftest.py``), where its
``width=None`` sweeps widths 8, 16 and 32; the port refuses width 32, so
``width=None`` is held against the reference with the reference's widths
restricted to (8, 16) the same way (its ``_available_widths`` patched).
"""
import json
import warnings
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benchmarks.tune import fixture_bench_run, fixture_error_fn
from repro.core.approx import ApproxConfig as RApprox
from repro.core.approx import approx_matmul as r_approx_matmul
from repro.tuning import frontier as r_frontier
from repro.tuning import select as r_select
from repro_torch import tuning as t_tuning
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.approx import approx_matmul as t_approx_matmul
from repro_torch.kernels import get_op
from repro_torch.core.simdive import SimdiveSpec
from repro_torch.tuning import frontier as t_frontier
from repro_torch.tuning import select as t_select

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BENCH = str(ROOT / "BENCH_simdive.json")

FIXTURE_KW = dict(bench=fixture_bench_run(cb0=300.0, cb4=150.0, cb6=200.0),
                  error_fn=fixture_error_fn, coeff_sweep=(0, 4, 6, 8))


def _point(p) -> tuple:
    return (p.kernel, p.op, p.width, p.coeff_bits, p.index_bits, p.backend,
            p.error, p.error_source, p.best_us, p.items, p.us_per_item,
            p.label())


def _frontiers(op, width, **kw):
    """The same frontier from both packages (the port on the CPU, its
    points labelled with the reference's 'ref' backend)."""
    t = t_frontier.build_frontier(op, width=width, backend="ref",
                                  device="cpu", **kw)
    r = r_frontier.build_frontier(op, width=width, **kw)
    return t, r


@pytest.fixture
def reference_widths_8_16(monkeypatch):
    """The reference's width=None restricted to the port's widths."""
    monkeypatch.setattr(r_select, "_available_widths", lambda: (8, 16))


# ------------------------------------------------------------- frontier --
@pytest.mark.parametrize("op", ["mul", "div"])
@pytest.mark.parametrize("width", [8, 16])
def test_fixture_frontier_and_pareto_equal_reference(op, width):
    t, r = _frontiers(op, width, **FIXTURE_KW)
    assert [_point(p) for p in t] == [_point(p) for p in r]
    assert [_point(p) for p in t_frontier.pareto(t)] == \
        [_point(p) for p in r_frontier.pareto(r)]
    assert t_frontier.frontier_table(t) == r_frontier.frontier_table(r)
    if (op, width) == ("mul", 8):
        # the fixture run times width-8 mul only: the join hits there
        assert {p.coeff_bits: p.best_us for p in t} == \
            {0: 300.0, 4: 150.0, 6: 200.0, 8: None}
        assert [p.coeff_bits for p in t_frontier.pareto(t)] == [8, 6, 4]
    assert all(p.error_source == "fixture" for p in t)


@pytest.mark.parametrize("op,width", [("mul", 8), ("div", 8), ("div", 16)])
def test_real_frontier_equals_reference(op, width):
    """The analytic sweeps themselves (exhaustive at width 8, stratified
    at 16) joined with the committed BENCH file's timings: every point,
    the Pareto set and the table text, as the reference's."""
    t, r = _frontiers(op, width, bench=BENCH)
    assert [_point(p) for p in t] == [_point(p) for p in r]
    assert any(p.best_us is not None for p in t)
    for metric in ("are_pct", "nmed", "no_such_stat"):
        assert [_point(p) for p in t_frontier.pareto(t, metric)] == \
            [_point(p) for p in r_frontier.pareto(r, metric)]
        assert t_frontier.frontier_table(t, metric) == \
            r_frontier.frontier_table(r, metric)


@pytest.mark.parametrize("form", ["path", "document", "run"])
def test_bench_timings_equal_reference(form):
    with open(BENCH) as f:
        doc = json.load(f)
    bench = {"path": BENCH, "document": doc,
             "run": [r for r in doc["runs"] if r.get("grid")][-1]}[form]
    t = t_frontier.bench_timings(bench)
    assert t == r_frontier.bench_timings(bench) and t
    assert t_frontier.bench_timings(None) == {}
    assert t_frontier.bench_timings(str(ROOT / "no_such.json")) == {}


def test_default_bench_path_never_reads_the_reference_file(tmp_path,
                                                           monkeypatch):
    """The port joins only its own BENCH trajectory: SIMDIVE_BENCH, then
    BENCH_simdive_torch.json in the working directory, then at the repo
    root — never BENCH_simdive.json, whose timings are the JAX package's
    on a CPU."""
    monkeypatch.delenv("SIMDIVE_BENCH", raising=False)
    monkeypatch.chdir(ROOT)
    assert r_frontier.default_bench_path() == BENCH        # the reference's
    assert not (ROOT / t_frontier.BENCH_FILE).exists()
    assert t_frontier.default_bench_path() is None
    # so the port's default selection carries no timing
    e = t_select.select_config("mul", width=8, error_budget=2.0,
                               error_fn=fixture_error_fn, device="cpu")
    assert "best_us" not in e.stats_dict()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_simdive.json").write_text("{}")
    assert t_frontier.default_bench_path() is None
    own = tmp_path / "BENCH_simdive_torch.json"
    own.write_text("{}")
    assert t_frontier.default_bench_path() == str(own)
    monkeypatch.setenv("SIMDIVE_BENCH", str(tmp_path / "mine.json"))
    assert t_frontier.default_bench_path() == str(tmp_path / "mine.json")


# ------------------------------------------------------------ selection --
SELECTIONS = {
    "fastest": dict(error_budget=2.0),
    "cheapest": dict(error_budget=2.0, prefer="cheapest"),
    "untimed-fallback": dict(error_budget=0.3),
    "div": dict(op="div", error_budget=1.0),
    "layer": dict(error_budget=2.0, layer="L3"),
    "index-bits-4": dict(error_budget=2.0, index_bits=4),
}


@pytest.mark.parametrize("case", sorted(SELECTIONS))
def test_fixture_selection_equals_reference(case):
    kw = dict(SELECTIONS[case])
    op = kw.pop("op", "mul")
    t = t_select.select_config(op, width=8, backend="ref", device="cpu",
                               **kw, **FIXTURE_KW)
    r = r_select.select_config(op, width=8, **kw, **FIXTURE_KW)
    assert t.as_dict() == r.as_dict() and t.label() == r.label()
    assert hash(t) == hash(t_select.PolicyEntry.from_dict(t.as_dict()))
    want_cb = {"fastest": 4, "cheapest": 4, "untimed-fallback": 8,
               "layer": 4}.get(case)
    if want_cb is not None:
        assert t.coeff_bits == want_cb


def test_selection_deterministic_given_a_frozen_bench_file(tmp_path):
    doc = {"schema": "simdive-bench/v2",
           "runs": [dict(fixture_bench_run(cb0=300.0, cb4=150.0, cb6=200.0),
                         created_unix=0)]}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(doc))
    kw = dict(width=8, error_budget=2.0, bench=str(path),
              error_fn=fixture_error_fn, coeff_sweep=(0, 4, 6, 8))
    a = t_select.select_config("mul", backend="ref", device="cpu", **kw)
    b = t_select.select_config("mul", backend="ref", device="cpu", **kw)
    assert a == b and hash(a) == hash(b)
    assert a.stats_dict()["best_us"] == 150.0
    assert a.as_dict() == r_select.select_config("mul", **kw).as_dict()


@pytest.mark.parametrize("width", [8, None])
def test_infeasible_budget_message_equals_reference(width,
                                                    reference_widths_8_16):
    kw = dict(width=width, error_budget=0.01, **FIXTURE_KW)
    with pytest.raises(t_select.BudgetError) as t_err:
        t_select.select_config("mul", backend="ref", device="cpu", **kw)
    with pytest.raises(r_select.BudgetError) as r_err:
        r_select.select_config("mul", **kw)
    assert str(t_err.value) == str(r_err.value)
    assert "nearest achievable" in str(t_err.value)
    assert "cb8" in str(t_err.value) and "0.25" in str(t_err.value)
    with pytest.raises(t_select.BudgetError) as t_err:
        t_select.select_config("mul", backend="ref", device="cpu",
                               metric="no_such_stat", **kw)
    with pytest.raises(r_select.BudgetError) as r_err:
        r_select.select_config("mul", metric="no_such_stat", **kw)
    assert str(t_err.value) == str(r_err.value)


def test_width_none_sweeps_the_port_widths(reference_widths_8_16):
    assert t_select._available_widths() == (8, 16)
    kw = dict(width=None, error_budget=2.0, **FIXTURE_KW)
    for prefer in ("fastest", "cheapest"):
        t = t_select.select_config("div", backend="ref", device="cpu",
                                   prefer=prefer, **kw)
        r = r_select.select_config("div", prefer=prefer, **kw)
        assert t.as_dict() == r.as_dict()
    with pytest.raises(NotImplementedError, match="width 32"):
        t_select.select_config("mul", width=32, error_budget=1.0,
                               device="cpu", coeff_sweep=(6,))


@pytest.mark.parametrize("bench", ["file", "none"])
def test_real_exhaustive_width8_selection_equals_reference(bench):
    """The acceptance case on the real datapath: select_config(op='mul',
    width=8, error_budget=0.9) over the full default sweep, the port's
    exhaustive sweep on the plain versions, with the BENCH file's timings
    joined and without any; the entry binds to a working dispatch."""
    kw = dict(width=8, error_budget=0.9, bench=BENCH if bench == "file"
              else None)
    t = t_select.select_config("mul", backend="ref", device="cpu", **kw)
    r = r_select.select_config("mul", **kw)
    assert t.as_dict() == r.as_dict()
    stats = t.stats_dict()
    assert stats["are_pct"] <= 0.9 and stats["error_source"] == "exhaustive"
    assert ("best_us" in stats) == (bench == "file")
    a = torch.arange(1, 200, dtype=torch.int64).to(torch.uint32)
    got = t.bind()(a, a, op="mul")
    want = get_op("elemwise", SimdiveSpec(width=8, coeff_bits=t.coeff_bits),
                  "ref")(a, a, op="mul")
    assert torch.equal(got, want)
    ref_out = np.asarray(r.bind()(jnp.asarray(np.arange(1, 200,
                                                        dtype=np.uint32)),
                                  jnp.asarray(np.arange(1, 200,
                                                        dtype=np.uint32)),
                                  op="mul"))
    assert np.array_equal(got.to(torch.int64).numpy(), ref_out)


def test_port_defaults_to_auto_and_the_card():
    """The port's select_config / build_policy / PolicyEntry default to
    backend 'auto' (the reference: 'ref', under which a policy built on
    the card would serve every op through the plain versions), and run
    their sweeps on the card unless asked for the CPU."""
    t = t_select.select_config("mul", width=8, error_budget=2.0,
                               device="cpu", **FIXTURE_KW)
    r = r_select.select_config("mul", width=8, error_budget=2.0,
                               **FIXTURE_KW)
    assert (t.backend, r.backend) == ("auto", "ref")
    assert t_select.PolicyEntry(op="mul", width=8, coeff_bits=6).backend \
        == "auto"
    assert {e.backend for e in t_select.build_policy(
        error_budget=2.0, width=8, device="cpu", **FIXTURE_KW).entries} \
        == {"auto"}
    # the timing join keys on the backend: 'auto' misses the fixture's
    # 'ref' rows, so the default entry carries no timing
    assert "best_us" not in t.stats_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            t_select.select_config("mul", width=8, error_budget=2.0,
                                   coeff_sweep=(6,), bench=None)


# -------------------------------------------------------------- policy ---
def _policies(**kw):
    kw = {"error_budget": 2.0, "width": 8, **kw, **FIXTURE_KW}
    return (t_select.build_policy(("mul", "div"), backend="ref",
                                  device="cpu", **kw),
            r_select.build_policy(("mul", "div"), **kw))


@pytest.mark.parametrize("meta", [None, {"source": "test", "run": 3}])
def test_build_policy_and_json_equal_reference(meta):
    t, r = _policies(meta=meta)
    assert t.as_dict() == r.as_dict()
    assert t.to_json() == r.to_json()
    assert t.to_json(indent=None) == r.to_json(indent=None)
    assert t.render() == r.render()
    assert t.distinct_configs() == r.distinct_configs()
    # round trips: the policy, its hash and its document are stable
    back = t_select.TuningPolicy.from_json(t.to_json())
    assert back == t and hash(back) == hash(t)
    assert t_select.TuningPolicy.from_dict(t.as_dict()).as_dict() == \
        t.as_dict()
    # and an ApproxConfig carrying either compares and hashes equal (the
    # served prefill and step are memoized on it)
    assert TApprox(mode="simdive", policy=back) == \
        TApprox(mode="simdive", policy=t)
    assert hash(TApprox(mode="simdive", policy=back)) == \
        hash(TApprox(mode="simdive", policy=t))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_policy_file_loads_in_the_other_package(tmp_path, writer):
    entries = dict(
        mul=dict(op="mul", width=8, coeff_bits=4, backend="pallas",
                 stats=(("are_pct", 1.0), ("n", 100))),
        att=dict(op="attention", width=16, coeff_bits=2, backend="auto",
                 frac_out=12, layer="L1"),
        mm=dict(op="matmul", width=16, coeff_bits=8, backend="ref",
                kernel="matmul"),
        tpu=dict(op="div", width=8, coeff_bits=6, backend="pallas-tpu"),
        interp=dict(op="div", width=16, coeff_bits=0,
                    backend="pallas-interpret", layer="L0"))
    t = t_select.TuningPolicy(
        entries=tuple(t_select.PolicyEntry(**e) for e in entries.values()),
        meta=(("source", "test"),))
    r = r_select.TuningPolicy(
        entries=tuple(r_select.PolicyEntry(**e) for e in entries.values()),
        meta=(("source", "test"),))
    assert t.to_json() == r.to_json()                   # byte-equal
    path = str(tmp_path / "policy.json")
    (t if writer == "port" else r).save(path)
    t_back, r_back = t_select.TuningPolicy.load(path), \
        r_select.TuningPolicy.load(path)
    assert t_back == t and r_back == r
    assert t_back.to_json() == r_back.to_json() == Path(path).read_text()[:-1]
    assert t_back.distinct_configs() == r_back.distinct_configs()


@pytest.mark.parametrize("name,port", sorted(t_select.BACKEND_NAMES.items()))
def test_backend_names_map_onto_the_port(name, port):
    """Every interchange name: a reference entry naming it resolves, in
    the port's ApproxConfig, to the port's backend (the plan rows print
    that), and in the reference's to the name itself."""
    pol = r_select.TuningPolicy(entries=(
        r_select.PolicyEntry(op="div", width=8, coeff_bits=4, backend=name),))
    loaded = t_select.TuningPolicy.from_json(pol.to_json())
    assert t_select.port_backend(name) == port
    assert port in ("auto", "ref", "cuda")
    spec, backend = TApprox(mode="simdive", policy=loaded).resolve("div")
    assert backend == port and (spec.width, spec.coeff_bits) == (8, 4)
    assert RApprox(mode="simdive", policy=pol).resolve("div")[1] == name
    assert loaded.entries[0].bind().backend == port


@pytest.mark.parametrize("name", ["cuda", "tpu", "", "PALLAS"])
def test_unknown_backend_names_are_refused(tmp_path, name):
    with pytest.raises(ValueError, match="'pallas'"):
        t_select.PolicyEntry(op="div", width=8, coeff_bits=4, backend=name)
    doc = r_select.TuningPolicy(entries=(r_select.PolicyEntry(
        op="div", width=8, coeff_bits=4, backend=name),)).as_dict()
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="interchange name"):
        t_select.TuningPolicy.load(str(path))
    with pytest.raises(ValueError, match="'pallas'"):
        t_select.select_config("mul", width=8, error_budget=2.0,
                               backend=name, device="cpu", **FIXTURE_KW)


LOOKUPS = [("matmul", None), ("matmul", "fc0"), ("matmul", "fc1"),
           ("div", None), ("div", "fc1"), ("attention", "fc1")]


@pytest.mark.parametrize("op,layer", LOOKUPS)
def test_lookup_scoping_equals_reference(op, layer):
    def entries(mod):
        return (mod.PolicyEntry(op="matmul", width=8, coeff_bits=6),
                mod.PolicyEntry(op="matmul", width=16, coeff_bits=4,
                                layer="fc1"),
                mod.PolicyEntry(op="attention", width=16, coeff_bits=2,
                                layer="fc1"))
    t_ent, r_ent = entries(t_select), entries(r_select)
    t_hit = t_select.TuningPolicy(entries=t_ent).lookup(op, layer)
    r_hit = r_select.TuningPolicy(entries=r_ent).lookup(op, layer)
    assert (None if t_hit is None else t_ent.index(t_hit)) == \
        (None if r_hit is None else r_ent.index(r_hit))


@pytest.mark.parametrize("doc", [
    {"schema": "not-a-policy", "entries": []},
    {"schema": "simdive-policy/v9", "entries": []},
    {"entries": []},
    ["simdive-policy/v1"],
])
def test_wrong_and_future_schemas_refused_as_reference(doc):
    with pytest.raises(ValueError) as t_err:
        t_select.TuningPolicy.from_dict(doc)
    with pytest.raises(ValueError) as r_err:
        r_select.TuningPolicy.from_dict(doc)
    assert str(t_err.value) == str(r_err.value)
    assert "simdive-policy/v1" in str(t_err.value)


def test_unknown_top_level_fields_warn_as_reference(tmp_path):
    t, r = _policies()
    doc = t.as_dict()
    doc["calibration"] = {"set": "imagenet"}
    doc["zz_extra"] = 1
    with warnings.catch_warnings(record=True) as t_w:
        warnings.simplefilter("always")
        got = t_select.TuningPolicy.from_dict(doc)
    with warnings.catch_warnings(record=True) as r_w:
        warnings.simplefilter("always")
        r_select.TuningPolicy.from_dict(doc)
    assert [str(w.message) for w in t_w] == [str(w.message) for w in r_w]
    assert "will not survive a re-save" in str(t_w[0].message)
    assert got == t
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(doc))
    with pytest.warns(UserWarning, match="calibration.*zz_extra"):
        assert t_select.TuningPolicy.load(str(path)) == t


def test_distinct_configs_equal_reference():
    """The reference's order; where an entry leaves ``frac_out`` unset
    beside a twin that sets it, the reference's sort compares None with
    an int and raises, and the port sorts the unset one first."""
    entries = [dict(op="attention", width=16, coeff_bits=8, frac_out=15),
               dict(op="attention", width=8, coeff_bits=2, frac_out=12),
               dict(op="div", width=16, coeff_bits=6),
               dict(op="attention", width=16, coeff_bits=8, layer="L2")]

    def policy(mod, n):
        return mod.TuningPolicy(entries=tuple(
            mod.PolicyEntry(**e) for e in entries[:n]))

    assert policy(t_select, 3).distinct_configs() == \
        policy(r_select, 3).distinct_configs()
    assert policy(t_select, 4).distinct_configs() == (
        ("attention", 8, 2, 3, 12), ("attention", 16, 8, 3, None),
        ("attention", 16, 8, 3, 15), ("div", 16, 6, 3, None))
    with pytest.raises(TypeError):
        policy(r_select, 4).distinct_configs()
    t = policy(t_select, 2)
    assert t.with_entries(t.entries[0]).entries == t.entries + t.entries[:1]


# ------------------------------------------------- ApproxConfig resolution --
def test_approx_config_resolves_policy_entries_as_reference():
    """A matching entry dispatches its knobs; a layer without one keeps
    the config's own — in the port and, on the same floats, within f32
    round-off of the reference."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    t_pol = t_select.TuningPolicy(entries=(t_select.PolicyEntry(
        op="matmul", width=8, coeff_bits=2, layer="fc0"),))
    r_pol = r_select.TuningPolicy(entries=(r_select.PolicyEntry(
        op="matmul", width=8, coeff_bits=2, layer="fc0"),))
    for layer, own in (("fc0", dict(width=8, coeff_bits=2)),
                       ("other", {})):
        via = t_approx_matmul(xt, wt, TApprox(mode="simdive", policy=t_pol,
                                              layer=layer))
        direct = t_approx_matmul(xt, wt, TApprox(mode="simdive", **own))
        assert torch.equal(via, direct)
        ref = r_approx_matmul(jnp.asarray(x), jnp.asarray(w),
                              RApprox(mode="simdive", policy=r_pol,
                                      layer=layer))
        np.testing.assert_allclose(via.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("frac_out", [None, 0, 12])
def test_attention_frac_out_zero_means_unset(frac_out):
    """resolve_attention takes an entry's frac_out only when it is set and
    nonzero, as the reference does: 0 leaves the config's own."""
    def resolve(mod, cfg_cls):
        pol = mod.TuningPolicy(entries=(mod.PolicyEntry(
            op="attention", width=8, coeff_bits=4, frac_out=frac_out,
            backend="ref"),))
        spec, backend, frac = cfg_cls(mode="simdive", policy=pol,
                                      frac_out=14).resolve_attention()
        return spec.width, spec.coeff_bits, backend, frac
    got = resolve(t_select, TApprox)
    assert got == resolve(r_select, RApprox)
    assert got[3] == (12 if frac_out == 12 else 14)


def test_tuning_exports_match_reference_selection_layer():
    from repro import tuning as r_tuning
    from repro.tuning import sensitivity as r_sensitivity
    from repro_torch.tuning import sensitivity as t_sensitivity
    # the whole of sensitivity, its ANN and imaging glue included
    assert t_sensitivity.__all__ == r_sensitivity.__all__
    assert set(t_tuning.__all__) == set(r_tuning.__all__)
    assert t_select.POLICY_SCHEMA == r_select.POLICY_SCHEMA
    assert t_frontier.DEFAULT_COEFF_SWEEP == r_frontier.DEFAULT_COEFF_SWEEP
