"""repro_torch.tuning — the accuracy-budget autotuner.

Counterpart of ``repro.tuning`` for what is ported so far:

  frontier.py     per-(op, width) accuracy/throughput frontier points:
                  analytic error stats (measure_error: exhaustive at width
                  8, exponent-pair stratified at 16), run through the
                  port's kernels on the card by default, joined with
                  measured best_us from the port's BENCH trajectory
                  (BENCH_simdive_torch.json, never the reference's file)
  select.py       select_config(op, error_budget=...) -> the cheapest
                  budget-meeting registry dispatch config; TuningPolicy,
                  the simdive-policy/v1 per-(op, layer) config set a
                  deployment ships with (ApproxConfig(policy=...),
                  ``launch.serve --policy``), read and written alike by
                  both packages

  sensitivity.py  per-layer end-metric profiling (profile_layers; ANN
                  accuracy: profile_ann, imaging PSNR/SSIM:
                  profile_imaging, a twin-training metric: profile_train)
                  and the greedy budget assignment
                  (greedy_assign[_verified]) -> a layer-scoped
                  TuningPolicy (assignment_policy)

Not ported: the reference's ``benchmarks/tune.py`` CLI, which stays with
the reference's benchmark folder.
"""
from .frontier import (
    FrontierPoint,
    bench_timings,
    build_frontier,
    default_bench_path,
    frontier_table,
    measure_error,
    pareto,
)
from .sensitivity import (
    SensitivityProfile,
    ann_policy_metric,
    ann_run_metric,
    assignment_policy,
    default_candidates,
    greedy_assign,
    greedy_assign_verified,
    imaging_run_metric,
    profile_ann,
    profile_imaging,
    profile_layers,
    profile_train,
    train_run_metric,
)
from .select import (
    POLICY_SCHEMA,
    BudgetError,
    PolicyEntry,
    TuningPolicy,
    build_policy,
    select_config,
)

__all__ = [
    "FrontierPoint",
    "bench_timings",
    "build_frontier",
    "default_bench_path",
    "frontier_table",
    "measure_error",
    "pareto",
    "POLICY_SCHEMA",
    "BudgetError",
    "PolicyEntry",
    "TuningPolicy",
    "build_policy",
    "select_config",
    "SensitivityProfile",
    "ann_policy_metric",
    "ann_run_metric",
    "assignment_policy",
    "default_candidates",
    "greedy_assign",
    "greedy_assign_verified",
    "imaging_run_metric",
    "profile_ann",
    "profile_imaging",
    "profile_layers",
    "profile_train",
    "train_run_metric",
]
