"""Per-layer sensitivity profiling: a *global* quality budget, spent
where it buys the least.

Counterpart of ``repro.tuning.sensitivity`` for what training needs:
perturb one layer at a time, record the end-metric degradation, then
assign per-layer configs greedily, cheapest-first — every layer starts at
the cheapest candidate and the worst-degrading layer is upgraded until the
summed predicted degradation fits the global budget. The result is a
:class:`~repro_torch.tuning.select.TuningPolicy` with one layer-scoped
entry per layer, runnable via ``ApproxConfig(policy=...)``, and a
:func:`repro_torch.train.ramp_schedule`'s input.

The machinery is generic: :func:`profile_layers` / :func:`greedy_assign`
take any ``run_metric(assignment) -> float`` (higher is better);
:func:`train_run_metric` / :func:`profile_train` build it from a short
exact-vs-approximate twin run on ``device`` (default the card).
Candidates are :class:`PolicyEntry`s with the port's default backend
``'auto'`` (the reference's: ``'ref'``). The reference's ANN glue waits
for the campaign's ``--ann`` (ROADMAP Queue A item 5) and its imaging
glue, which drives the reference's JAX benchmark pipeline, is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .select import BudgetError, PolicyEntry, TuningPolicy

__all__ = [
    "SensitivityProfile",
    "default_candidates",
    "profile_layers",
    "greedy_assign",
    "greedy_assign_verified",
    "assignment_policy",
    "train_run_metric",
    "profile_train",
]


def default_candidates(op: str = "matmul") -> tuple:
    """Cheapest-to-best default candidate ladder for ``op``.

    Order is the greedy's upgrade path: static cost ascending (fewer
    correction bits first, then the wider lane). Callers with a BENCH
    trajectory can rank by measured wall-clock instead and pass their own
    ladder.
    """
    return tuple(
        PolicyEntry(op=op, width=w, coeff_bits=cb)
        for w, cb in ((8, 0), (8, 2), (8, 4), (8, 6), (16, 6)))


@dataclass(frozen=True)
class SensitivityProfile:
    """The measured per-layer degradation table.

    ``baseline`` is the unperturbed end metric; ``table[layer][candidate]``
    the metric with *only* that layer running that candidate. Degradation
    is clamped at 0 — a layer that happens to score above baseline under
    approximation (it happens: approximation is noise) predicts no loss,
    not a gain the greedy would try to spend.
    """
    baseline: float
    layers: tuple
    candidates: tuple
    table: tuple     # tuple of (layer, tuple of (candidate, metric))

    def metric_at(self, layer: str, cand: PolicyEntry) -> float:
        return dict(dict(self.table)[layer])[cand]

    def degradation(self, layer: str, cand: PolicyEntry) -> float:
        return max(0.0, self.baseline - self.metric_at(layer, cand))

    def render(self) -> str:
        lines = [f"sensitivity (baseline metric {self.baseline:.4g})"]
        for layer in self.layers:
            cells = ", ".join(
                f"{c.width}b/cb{c.coeff_bits}: -{self.degradation(layer, c):.3g}"
                for c in self.candidates)
            lines.append(f"  {layer}: {cells}")
        return "\n".join(lines)


def profile_layers(run_metric, layers, candidates, *,
                   baseline: float | None = None) -> SensitivityProfile:
    """Measure every (layer, candidate) perturbation, one at a time.

    ``run_metric(assignment)`` evaluates the end metric with
    ``assignment`` mapping layer name -> :class:`PolicyEntry` (layers
    absent from the mapping run exactly). ``baseline`` defaults to
    ``run_metric({})``.
    """
    layers = tuple(layers)
    candidates = tuple(candidates)
    if baseline is None:
        baseline = float(run_metric({}))
    table = tuple(
        (layer, tuple((cand, float(run_metric({layer: cand})))
                      for cand in candidates))
        for layer in layers)
    return SensitivityProfile(baseline=baseline, layers=layers,
                              candidates=candidates, table=table)


def _ladders(profile: SensitivityProfile) -> dict:
    """Per-layer upgrade ladders: the candidate order, pruned to strictly
    decreasing measured degradation. Measured sensitivity is not always
    monotone in static cost (approximation error is noise at the end
    metric, and a candidate can be outright broken — e.g. a wide lane
    without x64), and an "upgrade" that doesn't measurably help would
    burn cost for nothing — so each ladder step is guaranteed to reduce
    that layer's predicted degradation."""
    ladder = {}
    for layer in profile.layers:
        steps = [profile.candidates[0]]
        for cand in profile.candidates[1:]:
            if profile.degradation(layer, cand) \
                    < profile.degradation(layer, steps[-1]):
                steps.append(cand)
        ladder[layer] = steps
    return ladder


def greedy_assign(profile: SensitivityProfile, budget: float) -> dict:
    """Cheapest-first assignment meeting a global degradation budget.

    Every layer starts at the *first* (cheapest) candidate; while the
    summed per-layer predicted degradation exceeds ``budget``, the layer
    currently predicting the largest degradation is upgraded one step.
    The prediction is first-order (per-layer degradations measured in
    isolation, summed) — callers should verify the final assignment
    end-to-end (:func:`greedy_assign_verified` does). Raises
    :class:`BudgetError` when even the best candidate everywhere predicts
    more degradation than the budget, naming the nearest achievable sum.
    """
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    ladder = _ladders(profile)
    level = {layer: 0 for layer in profile.layers}

    def deg(layer):
        return profile.degradation(layer, ladder[layer][level[layer]])

    floor = sum(profile.degradation(l, ladder[l][-1])
                for l in profile.layers)
    if floor > budget:
        raise BudgetError(
            f"global degradation budget {budget:g} is infeasible: even the "
            f"best candidate on every layer predicts {floor:.6g} total "
            f"degradation (nearest achievable); raise the budget or widen "
            f"the candidate ladder")
    while sum(deg(l) for l in profile.layers) > budget:
        upgradable = [l for l in profile.layers
                      if level[l] + 1 < len(ladder[l])]
        # floor check above guarantees progress is possible; pick the
        # worst offender that can still move
        worst = max(upgradable, key=deg)
        level[worst] += 1
    return {l: ladder[l][level[l]] for l in profile.layers}


def greedy_assign_verified(profile: SensitivityProfile, budget: float,
                           run_metric, *, trim: bool = True
                           ) -> tuple[dict, float]:
    """:func:`greedy_assign`, then *verify end-to-end* and upgrade until
    the measured metric actually clears ``baseline - budget``.

    The greedy's prediction is first-order (per-layer degradations
    measured in isolation, summed); layer interactions can push the real
    end metric below the floor the prediction cleared. This closes the
    loop: re-run ``run_metric`` on the full assignment and, while it
    falls short, upgrade the layer predicting the largest remaining
    degradation — measurements, not predictions, decide when to stop.

    ``trim`` then walks back down, least-sensitive layer first: any
    single-step downgrade that still *measures* at or above the floor is
    kept, so no layer holds correction bits the end metric provably does
    not need (this is where per-layer assignments genuinely diverge —
    a uniform config is what the trim refutes layer by layer).

    Returns ``(assignment, measured end metric)``; raises
    :class:`BudgetError` when even every layer at its best candidate
    measures below the floor (message carries the measured best).

    When the *prediction* already declares the budget infeasible, the
    measurement still gets the last word: per-layer degradations are not
    additive for every metric (PSNR against a bit-identical reference is
    the canonical offender), so the loop starts from the all-best
    assignment and lets ``run_metric`` decide — only a measured shortfall
    at all-best raises.
    """
    floor = profile.baseline - budget
    ladder = _ladders(profile)
    try:
        assignment = dict(greedy_assign(profile, budget))
    except BudgetError:
        assignment = {l: ladder[l][-1] for l in profile.layers}
    while True:
        measured = float(run_metric(assignment))
        if measured >= floor:
            break
        upgradable = [
            l for l in profile.layers
            if ladder[l].index(assignment[l]) + 1 < len(ladder[l])]
        if not upgradable:
            raise BudgetError(
                f"budget {budget:g} is infeasible end-to-end: every layer "
                f"at its best candidate still measures {measured:.6g} "
                f"(< floor {floor:.6g}); nearest achievable is "
                f"{measured:.6g}")
        worst = max(upgradable,
                    key=lambda l: profile.degradation(l, assignment[l]))
        assignment[worst] = ladder[worst][
            ladder[worst].index(assignment[worst]) + 1]
    if trim:
        for layer in sorted(profile.layers,
                            key=lambda l: profile.degradation(
                                l, assignment[l])):
            while ladder[layer].index(assignment[layer]) > 0:
                trial = dict(assignment)
                trial[layer] = ladder[layer][
                    ladder[layer].index(assignment[layer]) - 1]
                trial_measured = float(run_metric(trial))
                if trial_measured >= floor:
                    assignment, measured = trial, trial_measured
                else:
                    break
    return assignment, measured


def assignment_policy(assignment: dict, *, op: str,
                      meta: dict | None = None) -> TuningPolicy:
    """A per-layer assignment as a deployable :class:`TuningPolicy`."""
    entries = tuple(replace(cand, op=op, layer=layer)
                    for layer, cand in sorted(assignment.items()))
    return TuningPolicy(entries=entries,
                        meta=tuple(sorted((meta or {}).items())))


# ----------------------------------------------------------- training ----
def train_run_metric(cfg, shape, *, steps: int = 6, seed: int = 0,
                     lr: float = 1e-3, op: str = "matmul",
                     backward: str = "exact", device="cuda"):
    """``run_metric(assignment) -> -final_loss_delta_pct`` closure over a
    short exact-vs-approx twin run (:func:`repro_torch.train.train_twin`).

    Layers named in the assignment train with SIMDive matmuls under the
    assignment's per-layer entries (``policy_only`` dispatch — unnamed
    layers stay exact); the metric is the negated final-loss divergence
    percentage, so "higher is better" like every other glue and the
    empty assignment's baseline is exactly ``0.0`` (the twins are the
    same program). ``backward='approx'`` profiles sensitivity of the
    backward matmuls too. The twins train on ``device``. Lazily imports
    :mod:`repro_torch.train` — keeps tuning import-light and avoids a
    tuning <-> train import cycle.
    """
    from repro_torch.core.approx import ApproxConfig

    def run_metric(assignment):
        if not assignment:
            return 0.0    # identical twins by construction
        from repro_torch.train import train_twin
        policy = assignment_policy(assignment, op=op)
        acfg = ApproxConfig(mode="simdive", policy=policy,
                            policy_only=True, backward=backward)
        _, trace = train_twin(cfg, shape, steps=steps, approx=acfg,
                              seed=seed, lr=lr, device=device)
        return -trace.final_loss_delta_pct()

    return run_metric


def profile_train(cfg, shape, *, candidates=None, steps: int = 6,
                  seed: int = 0, lr: float = 1e-3, op: str = "matmul",
                  backward: str = "exact",
                  device="cuda") -> SensitivityProfile:
    """Per-layer training-loss sensitivity of a model config: each layer
    is perturbed alone (``policy_only``) for a ``steps``-step twin run,
    end metric = -final loss divergence %% (0 = no divergence).

    The result feeds :func:`greedy_assign` /
    :func:`greedy_assign_verified` exactly like the reference's ANN and
    imaging profiles — pass ``train_run_metric(...)`` (same kwargs) as the
    verified loop's measured metric, and a degradation budget in loss-%%
    points. Layer names are :func:`repro_torch.core.approx.layer_label`
    (``L0..L{n-1}``), matching the serving policies' convention, so one
    assignment can drive both training and serving dispatch.
    """
    from repro_torch.core.approx import layer_label

    candidates = tuple(candidates) if candidates is not None \
        else default_candidates(op)
    layers = tuple(layer_label(i) for i in range(cfg.n_layers))
    return profile_layers(
        train_run_metric(cfg, shape, steps=steps, seed=seed, lr=lr, op=op,
                         backward=backward, device=device),
        layers, candidates, baseline=0.0)
