"""The BENCH trajectory (``metrics.trajectory``) in both packages.

The port keeps its own copy of the reference's pure-stdlib module. The
same documents go through both: the committed ``BENCH_simdive.json`` and
the fabricated runs of ``tests/test_trajectory.py`` (the fixture functions
of ``benchmarks/compare.py``, imported, not copied). Loading, migration,
``grid_key``, ``index_grid``, ``latest_grid_run`` and every class of the
gate (``diff_runs``) must give the reference's results: the same
documents, keys, findings (severity, kind, key, detail), counts and
rendered report.
"""
import ast
import copy
import json
from pathlib import Path

import pytest

from benchmarks.compare import fixture_entry, fixture_run, fixture_v1_entry
from repro.metrics import trajectory as r_traj
from repro_torch import metrics as t_metrics
from repro_torch.metrics import trajectory as t_traj

ROOT = Path(__file__).resolve().parents[1]
BENCH = str(ROOT / "BENCH_simdive.json")


def _findings(report):
    return [(f.severity, f.kind, f.key, f.detail, f.render())
            for f in report.findings]


def _same_report(t, r):
    assert _findings(t) == _findings(r)
    assert (t.ok, t.compared, t.render()) == (r.ok, r.compared, r.render())


def test_exports_match_reference():
    assert t_traj.__all__ == r_traj.__all__
    for name in ("SCHEMA_V1", "SCHEMA_V2", "ERROR_FIELDS"):
        assert getattr(t_traj, name) == getattr(r_traj, name)
    assert t_metrics.diff_runs is t_traj.diff_runs
    assert t_metrics.load_trajectory is t_traj.load_trajectory
    assert t_traj.Thresholds().__dict__ == r_traj.Thresholds().__dict__


# ---------------------------------------------------- the committed file --
def test_bench_file_loads_keys_and_indexes_as_reference():
    t_doc, r_doc = t_traj.load_trajectory(BENCH), r_traj.load_trajectory(BENCH)
    assert t_doc == r_doc and t_doc["runs"]
    for run in t_doc["runs"]:
        assert [t_traj.grid_key(e) for e in run["grid"]] == \
            [r_traj.grid_key(e) for e in run["grid"]]
        assert t_traj.index_grid(run) == r_traj.index_grid(run)
    n = len(t_doc["runs"])
    for before in (None, 0, 1, n - 1, n, n + 3):
        assert t_traj.latest_grid_run(t_doc, before=before) == \
            r_traj.latest_grid_run(r_doc, before=before)


def test_bench_file_gate_equals_reference():
    """The file's last grid run against its own history: the gate's
    findings and report are the reference's."""
    doc = t_traj.load_trajectory(BENCH)
    last = max(i for i, run in enumerate(doc["runs"]) if run.get("grid"))
    cand = doc["runs"][last]
    base = t_traj.latest_grid_run(doc, before=last) or cand
    for th in (None, {"strict_missing": True}, {"throughput_drop_pct": 0.0}):
        _same_report(
            t_traj.diff_runs(base, cand, th and t_traj.Thresholds(**th),
                             baseline_label="history", candidate_label="last"),
            r_traj.diff_runs(base, cand, th and r_traj.Thresholds(**th),
                             baseline_label="history", candidate_label="last"))


# --------------------------------------------------------------- loading --
def _bad_files(tmp_path):
    missing = tmp_path / "nope.json"
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{truncated")
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"schema": "simdive-bench/v9", "runs": []}))
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"not": "a trajectory"}))
    return {"missing": missing, "corrupt": corrupt, "future": future,
            "other": other}


@pytest.mark.parametrize("case", ["missing", "corrupt", "future", "other"])
def test_load_refusals_equal_reference(tmp_path, case):
    path = str(_bad_files(tmp_path)[case])
    if case == "missing":
        assert t_traj.load_trajectory(path) == r_traj.load_trajectory(path)
    with pytest.raises(t_traj.TrajectoryError) as t_err:
        t_traj.load_trajectory(path, missing_ok=False)
    with pytest.raises(r_traj.TrajectoryError) as r_err:
        r_traj.load_trajectory(path, missing_ok=False)
    assert str(t_err.value) == str(r_err.value)


def test_migration_equals_reference():
    v1_entry = fixture_v1_entry()
    v1_entry["some_future_field"] = {"x": 1}
    doc = {"schema": r_traj.SCHEMA_V1,
           "runs": [{"created_unix": 7, "custom_run_field": "kept",
                     "grid": [v1_entry]}]}
    out = t_traj.migrate_doc(doc)
    assert out == r_traj.migrate_doc(doc)
    assert doc["schema"] == r_traj.SCHEMA_V1           # input not mutated
    assert t_traj.migrate_doc(out) == out              # idempotent
    assert t_traj.grid_key(out["runs"][0]["grid"][0]) == \
        r_traj.grid_key(fixture_entry())
    for bad in ({"runs": ["x"]}, {"schema": r_traj.SCHEMA_V2,
                                  "runs": [{"grid": {}}]}):
        with pytest.raises(t_traj.TrajectoryError) as t_err:
            t_traj.migrate_doc(bad)
        with pytest.raises(r_traj.TrajectoryError) as r_err:
            r_traj.migrate_doc(bad)
        assert str(t_err.value) == str(r_err.value)


# -------------------------------------------------------------- indexing --
def _failed_twin():
    healthy = fixture_entry()
    failed = {k: v for k, v in healthy.items()
              if k not in ("error", "throughput")}
    failed.update(status="failed", error_msg="boom",
                  shape_buckets=healthy["throughput"]["shape_buckets"])
    return healthy, failed


def test_keys_index_and_latest_run_equal_reference():
    healthy, failed = _failed_twin()
    entries = [healthy, failed, fixture_entry(op="div"),
               fixture_entry(kernel="packed"),
               fixture_entry(throughput={"shape_buckets": [[128, 64],
                                                           [64, 128]]})]
    assert [t_traj.grid_key(e) for e in entries] == \
        [r_traj.grid_key(e) for e in entries]
    assert t_traj.grid_key(failed) == t_traj.grid_key(healthy)
    bad = {**fixture_entry(), "status": "failed", "error_msg": "x"}
    for grid in ([healthy, bad], [bad, healthy], entries):
        assert t_traj.index_grid({"grid": grid}) == \
            r_traj.index_grid({"grid": grid})
    doc = {"runs": [{"grid": [fixture_entry()], "created_unix": 1},
                    {"grid": [], "created_unix": 2},
                    {"grid": [fixture_entry()], "created_unix": 3},
                    {"grid": [], "created_unix": 4}]}
    for before in (None, 0, 1, 2, 3, 4, -1):
        assert t_traj.latest_grid_run(doc, before=before) == \
            r_traj.latest_grid_run(doc, before=before)
    assert t_traj.latest_grid_run(doc)["created_unix"] == 3
    assert t_traj.latest_grid_run({"runs": []}) is None


# ------------------------------------------------------------ the gate ----
def _bump(field, factor=None, add=None, row=0, where="error"):
    def make():
        base = fixture_run()
        cand = copy.deepcopy(base)
        sec = cand["grid"][row][where]
        sec[field] = sec[field] * factor if factor else sec[field] + add
        return base, cand, {}
    return make


def _identical():
    base = fixture_run()
    return base, copy.deepcopy(base), {}


def _failed():
    healthy, failed = _failed_twin()
    return fixture_run(entries=[healthy]), fixture_run(entries=[failed]), {}


def _slow_and_more_accurate():
    base, cand, _ = _bump("best_us", factor=1.06, where="throughput")()
    cand["grid"][2]["throughput"]["best_us"] *= 100   # interpret config
    cand["grid"][0]["error"]["are_pct"] = 0.0
    return base, cand, {}


def _threshold(pct):
    def make():
        base = fixture_run(entries=[fixture_entry()])
        cand = copy.deepcopy(base)
        cand["grid"][0]["throughput"]["best_us"] *= 1.2
        return base, cand, {"throughput_drop_pct": pct}
    return make


def _missing(strict):
    def make():
        base = fixture_run()
        cand = copy.deepcopy(base)
        del cand["grid"][0]
        return base, cand, {"strict_missing": strict}
    return make


def _new_and_fixed():
    base = fixture_run(entries=[
        {**fixture_entry(), "status": "failed", "error_msg": "was broken",
         "shape_buckets": [[65536], [65536]]}])
    cand = fixture_run(entries=[fixture_entry(),
                                fixture_entry(op="div", frac_out=12)])
    return base, cand, {}


def _new_and_broken():
    base = fixture_run(entries=[fixture_entry()])
    cand = fixture_run(entries=[fixture_entry(), {
        **fixture_entry(op="div"), "status": "failed", "error_msg": "boom"}])
    return base, cand, {}


def _unknown_stats():
    base = fixture_run(entries=[fixture_entry()])
    cand = copy.deepcopy(base)
    cand["grid"][0]["error"]["some_new_stat"] = 1e9
    del cand["grid"][0]["error"]["wce"]
    return base, cand, {}


GATE_CASES = {
    "identical": _identical,
    "exhaustive-worse": _bump("are_pct", add=1e-3),
    **{f"field-{f}": _bump(f, add=1e-3, row=0)
       for f in ("mred", "nmed", "pre_pct", "wce", "error_rate")},
    "sampled-within-rtol": _bump("are_pct", factor=1.01, row=1),
    "sampled-beyond-rtol": _bump("are_pct", factor=1.0605, row=1),
    "interpreter-slow": _bump("best_us", factor=100, row=2,
                              where="throughput"),
    "ref-slow-more-accurate": _slow_and_more_accurate,
    "threshold-default": _threshold(5.0),
    "threshold-30": _threshold(30.0),
    "missing": _missing(False),
    "missing-strict": _missing(True),
    "failed": _failed,
    "new-and-fixed": _new_and_fixed,
    "new-and-broken": _new_and_broken,
    "unknown-stats": _unknown_stats,
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_equals_reference(case):
    """Each class of ``tests/test_trajectory.py``'s gate cases, through
    both packages: the same findings, counts, verdict and report."""
    base, cand, th = GATE_CASES[case]()
    t = t_traj.diff_runs(base, cand, t_traj.Thresholds(**th),
                         baseline_label="b", candidate_label="c")
    r = r_traj.diff_runs(base, cand, r_traj.Thresholds(**th),
                         baseline_label="b", candidate_label="c")
    _same_report(t, r)
    assert t.ok == (case in ("identical", "sampled-within-rtol",
                             "interpreter-slow", "threshold-30", "missing",
                             "new-and-fixed", "unknown-stats"))


def test_module_is_pure_stdlib():
    tree = ast.parse(Path(t_traj.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert roots == {"__future__", "json", "os", "dataclasses"}
