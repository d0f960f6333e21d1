"""The BENCH trajectory: schema, migration, indexing and the regression gate.

Counterpart of ``repro.metrics.trajectory``, copied whole (the port imports
nothing of ``repro``): the same schemas, migration, keys and gate, so a
BENCH document reads the same in both packages. The port's tuner joins its
timings through it (:func:`repro_torch.tuning.frontier.bench_timings`). A
BENCH document is an append-only history of run records, each benchmark
invocation appending one, and a fresh run is diffed against it:

  * **schema** — ``simdive-bench/v2``. A run's ``grid`` section holds one
    entry per swept config; v2 adds the ``kernel`` and ``status`` fields
    (v1 grids were implicitly all-``elemwise``, all-ok) so the sweep can
    cover every registry op and record per-config failures without losing
    the rest of the sweep. :func:`migrate_doc` upgrades v1 documents in
    place; unknown fields are preserved verbatim (forward tolerance).
  * **indexing** — :func:`grid_key` maps an entry to its identity
    ``(kernel, op, width, coeff_bits, index_bits, backend, shape-bucket)``;
    two runs' entries compare iff their keys match, so throughput is always
    diffed like-for-like even when exact operand shapes drift (the buckets
    are the registry autotune cache's pow-2 buckets, as the timing harness
    records them).
  * **the gate** — :func:`diff_runs` classifies candidate-vs-baseline
    deltas per key:

      ``config-failed``          candidate recorded ``status: failed``
      ``error-regression``       an :class:`~repro_torch.metrics.ErrorStats`
                                 field worsened. Exhaustive and parity
                                 (``pallas-interpret``) configs are
                                 deterministic, so *any* worsening fails;
                                 sampled configs get ``sampled_error_rtol``
                                 headroom.
      ``throughput-regression``  ``ref``-backend ``best_us`` (best-of-iters
                                 wall-clock, the noise-robust statistic;
                                 the mean is reported but never gated)
                                 slowed by more than
                                 ``throughput_drop_pct`` percent.
                                 Interpreter timings are correctness
                                 artifacts and are never gated.
      ``config-missing``         baseline key absent from the candidate —
                                 reported separately from regressions (a
                                 ``--quick`` candidate legitimately covers
                                 a subset of a full baseline), escalated
                                 only under ``strict_missing``.
      ``config-new`` / ``config-fixed``  informational.

Pure stdlib on purpose: this module depends on neither torch nor numpy,
so the gate's verdict can never be skewed by the accelerator stack it is
judging.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

__all__ = [
    "SCHEMA_V1",
    "SCHEMA_V2",
    "ERROR_FIELDS",
    "TrajectoryError",
    "Thresholds",
    "Finding",
    "GateReport",
    "migrate_doc",
    "migrate_grid_entry",
    "load_trajectory",
    "grid_key",
    "index_grid",
    "latest_grid_run",
    "diff_runs",
]

SCHEMA_V1 = "simdive-bench/v1"
SCHEMA_V2 = "simdive-bench/v2"
_KNOWN_SCHEMAS = (SCHEMA_V1, SCHEMA_V2)

#: ErrorStats fields where *larger is worse*; the gate checks every one.
ERROR_FIELDS = ("are_pct", "mred", "nmed", "pre_pct", "wce", "error_rate")


class TrajectoryError(ValueError):
    """A BENCH document that cannot be interpreted as a trajectory."""


# ------------------------------------------------------------- schema ----
def migrate_grid_entry(entry: dict) -> dict:
    """v1 grid entry -> v2: the v1 sweep was all-elemwise and never
    recorded failures, so ``kernel``/``status`` backfill losslessly.
    Unknown fields ride along untouched."""
    out = dict(entry)
    out.setdefault("kernel", "elemwise")
    out.setdefault("status", "ok")
    return out


def migrate_doc(doc: dict) -> dict:
    """Return ``doc`` upgraded to :data:`SCHEMA_V2` (a new dict; the input
    is not mutated). v2 documents pass through with grid entries
    normalized, so loading is idempotent."""
    if not isinstance(doc, dict) or not isinstance(doc.get("runs"), list):
        raise TrajectoryError(
            "not a trajectory document (expected {'schema': ..., 'runs': [...]})")
    schema = doc.get("schema")
    if schema not in _KNOWN_SCHEMAS:
        raise TrajectoryError(
            f"unknown trajectory schema {schema!r} (known: {_KNOWN_SCHEMAS})")
    out = dict(doc)
    out["schema"] = SCHEMA_V2
    runs = []
    for run in doc["runs"]:
        if not isinstance(run, dict):
            raise TrajectoryError(f"malformed run record: {type(run).__name__}")
        r = dict(run)
        grid = r.get("grid", [])
        if not isinstance(grid, list):
            raise TrajectoryError("run 'grid' must be a list")
        r["grid"] = [migrate_grid_entry(e) for e in grid]
        runs.append(r)
    out["runs"] = runs
    return out


def load_trajectory(path: str, *, missing_ok: bool = True) -> dict:
    """Load + validate + migrate a BENCH file.

    A missing file yields an empty v2 document when ``missing_ok`` (the
    gate treats "no baseline yet" as vacuously passing); a file that exists
    but does not parse raises :class:`TrajectoryError` — corrupt history is
    loud here, the *writer*'s rescue path lives in
    the benchmark's writer.
    """
    if not os.path.exists(path):
        if missing_ok:
            return {"schema": SCHEMA_V2, "runs": []}
        raise TrajectoryError(f"no trajectory at {path}")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise TrajectoryError(f"unreadable trajectory {path}: {e}") from e
    return migrate_doc(doc)


# ------------------------------------------------------------ indexing ---
def grid_key(entry: dict) -> tuple:
    """The identity of one grid entry across runs.

    ``(kernel, op, width, coeff_bits, index_bits, backend, shape-buckets)``
    — everything that pins *what was measured*; everything else (stats,
    timings, n, status) is *the measurement*. The shape buckets come from
    the recorded throughput (pow-2, registry bucketing); a failed entry
    that never timed keys on its declared operand shapes instead, so a
    failure and its healthy twin still collide on the same key.
    """
    tp = entry.get("throughput") or {}
    buckets = tp.get("shape_buckets") or entry.get("shape_buckets") or []
    return (
        entry.get("kernel", "elemwise"),
        entry.get("op"),
        entry.get("width"),
        entry.get("coeff_bits"),
        entry.get("index_bits"),
        entry.get("backend"),
        tuple(tuple(int(d) for d in b) for b in buckets),
    )


def index_grid(run: dict) -> dict:
    """``grid_key -> entry`` for one run. On a key collision the *worst*
    entry wins (a failure must not be shadowed by a lucky duplicate)."""
    out: dict = {}
    for entry in run.get("grid", []):
        k = grid_key(entry)
        prev = out.get(k)
        if prev is None or (prev.get("status") == "ok"
                            and entry.get("status") != "ok"):
            out[k] = entry
    return out


def latest_grid_run(doc: dict, *, before: int | None = None) -> dict | None:
    """The most recent run carrying grid entries (``--only table2`` runs
    append grid-less records; the gate skips those). ``before`` bounds the
    search to run indices strictly below it — used to diff a trajectory's
    last run against its own history."""
    runs = doc.get("runs", [])
    hi = len(runs) if before is None else max(before, 0)
    for run in reversed(runs[:hi]):
        if run.get("grid"):
            return run
    return None


# ----------------------------------------------------------- the gate ----
@dataclass(frozen=True)
class Thresholds:
    """Per-class gate thresholds (the defaults are the gate's contract)."""
    #: max tolerated % increase of ref-backend best-of-iters wall-clock
    #: (``best_us``); assumes a quiet box — CI on shared runners passes a
    #: wider budget explicitly
    throughput_drop_pct: float = 5.0
    #: relative headroom for error stats on sampled (non-exhaustive,
    #: non-parity) configs; deterministic seeds make even these stable,
    #: but float reduction order may differ across hosts
    sampled_error_rtol: float = 0.02
    #: absolute float noise floor for "worsened at all" on exact configs
    exact_error_atol: float = 1e-9
    #: escalate config-missing from warning to failure
    strict_missing: bool = False


@dataclass(frozen=True)
class Finding:
    """One classified delta between baseline and candidate at one key."""
    severity: str       # 'fail' | 'warn' | 'info'
    kind: str           # e.g. 'error-regression'
    key: tuple          # grid_key of the config
    detail: str

    def render(self) -> str:
        kernel, op, width, cb, ib, backend, buckets = self.key
        shape = "x".join("·".join(str(d) for d in b) for b in buckets)
        cfg = f"{kernel}/{op}/{width}b/cb{cb}/ib{ib}/{backend}"
        if shape:
            cfg += f"/{shape}"
        mark = {"fail": "FAIL", "warn": "warn", "info": "info"}[self.severity]
        return f"[{mark}] {self.kind:22s} {cfg}: {self.detail}"


@dataclass
class GateReport:
    """The gate's verdict: every finding, rendered or machine-read."""
    findings: list = field(default_factory=list)
    compared: int = 0           # keys present in both runs
    baseline_label: str = ""
    candidate_label: str = ""

    @property
    def failures(self) -> list:
        return [f for f in self.findings if f.severity == "fail"]

    @property
    def ok(self) -> bool:
        return not self.failures

    def render(self) -> str:
        lines = [
            f"trajectory gate: {self.candidate_label} vs {self.baseline_label}",
            f"  {self.compared} config(s) compared, "
            f"{len(self.failures)} failure(s), "
            f"{sum(f.severity == 'warn' for f in self.findings)} warning(s)",
        ]
        lines += ["  " + f.render() for f in self.findings]
        lines.append("  verdict: " + ("PASS" if self.ok else "REGRESSION"))
        return "\n".join(lines)


def _fmt(v) -> str:
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def _check_errors(base: dict, cand: dict, th: Thresholds) -> list[str]:
    """Worsened ErrorStats fields of one config, as human-readable deltas."""
    be, ce = base.get("error") or {}, cand.get("error") or {}
    exact = bool(cand.get("exhaustive")) or cand.get("backend") == "pallas-interpret"
    deltas = []
    for f in ERROR_FIELDS:
        b, c = be.get(f), ce.get(f)
        if not isinstance(b, (int, float)) or not isinstance(c, (int, float)):
            continue                      # unknown/missing stat: tolerated
        allowed = th.exact_error_atol if exact else (
            abs(b) * th.sampled_error_rtol + th.exact_error_atol)
        if c - b > allowed:
            deltas.append(f"{f} {_fmt(b)} -> {_fmt(c)}"
                          + ("" if exact else f" (rtol {th.sampled_error_rtol})"))
    return deltas


def _check_throughput(base: dict, cand: dict, th: Thresholds) -> str | None:
    """>threshold% wall-clock slowdown on a ref config, or None.

    Gates on ``best_us`` — best-of-iters is the noise-robust wall-clock
    statistic (mean folds in scheduler jitter and is reported but never
    gated). The 5% default assumes a quiet, dedicated box; CI on shared
    runners should pass an explicit wider budget (see tier2.yml).
    """
    if cand.get("backend") != "ref":
        return None                       # interpreter timing: never gated
    bt, ct = base.get("throughput") or {}, cand.get("throughput") or {}
    b, c = bt.get("best_us", bt.get("mean_us")), \
        ct.get("best_us", ct.get("mean_us"))
    if not isinstance(b, (int, float)) or not isinstance(c, (int, float)) \
            or b <= 0:
        return None
    drop_pct = 100.0 * (c - b) / b
    if drop_pct > th.throughput_drop_pct:
        return (f"best_us {b:.0f} -> {c:.0f} "
                f"(+{drop_pct:.1f}% > {th.throughput_drop_pct:g}% budget)")
    return None


def diff_runs(baseline_run: dict, candidate_run: dict,
              thresholds: Thresholds | None = None, *,
              baseline_label: str = "baseline",
              candidate_label: str = "candidate") -> GateReport:
    """Classify every grid delta of ``candidate_run`` vs ``baseline_run``."""
    th = thresholds or Thresholds()
    base_ix = index_grid(baseline_run or {})
    cand_ix = index_grid(candidate_run or {})
    report = GateReport(baseline_label=baseline_label,
                        candidate_label=candidate_label)
    add = report.findings.append

    for key, base in sorted(base_ix.items(), key=lambda kv: repr(kv[0])):
        cand = cand_ix.get(key)
        if cand is None:
            add(Finding("fail" if th.strict_missing else "warn",
                        "config-missing", key,
                        "present in baseline, absent from candidate"))
            continue
        report.compared += 1
        if cand.get("status") != "ok":
            add(Finding("fail", "config-failed", key,
                        str(cand.get("error_msg", "no error recorded"))))
            continue
        if base.get("status") != "ok":
            add(Finding("info", "config-fixed", key,
                        "baseline had recorded a failure here"))
            continue
        deltas = _check_errors(base, cand, th)
        if deltas:
            add(Finding("fail", "error-regression", key, "; ".join(deltas)))
        slow = _check_throughput(base, cand, th)
        if slow:
            add(Finding("fail", "throughput-regression", key, slow))
    for key in sorted(set(cand_ix) - set(base_ix), key=repr):
        entry = cand_ix[key]
        if entry.get("status") != "ok":
            # a brand-new config that already broke is a failure, not news —
            # without this a baseline-less breakage would ride in as info
            add(Finding("fail", "config-failed", key,
                        str(entry.get("error_msg", "no error recorded"))
                        + " (no baseline entry)"))
        else:
            add(Finding("info", "config-new", key, "no baseline entry"))
    return report
