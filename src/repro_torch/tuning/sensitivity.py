"""Per-layer sensitivity profiling: a *global* quality budget, spent
where it buys the least.

Counterpart of ``repro.tuning.sensitivity``: perturb one layer at a
time, record the end-metric degradation (classification accuracy for the
ANN path, PSNR/SSIM via :mod:`repro_torch.metrics.image` for the imaging
pipeline, the loss divergence of a twin run for training), then assign
per-layer configs greedily, cheapest-first — every layer starts at the
cheapest candidate and the worst-degrading layer is upgraded until the
summed predicted degradation fits the global budget. The result is a
:class:`~repro_torch.tuning.select.TuningPolicy` with one layer-scoped
entry per layer, runnable via ``ApproxConfig(policy=..., layer=...)``, and
a :func:`repro_torch.train.ramp_schedule`'s input.

The machinery is generic: :func:`profile_layers` / :func:`greedy_assign`
take any ``run_metric(assignment) -> float`` (higher is better). The glue
builds that closure on ``device`` (default the card): the ANN glue
(:func:`profile_ann` / :func:`ann_policy_metric`) from float MLP weights
through the same quantize + ``approx_matmul`` path the models use (the
``matmul_emul`` op: the ``logmatmul`` kernel on the card); the imaging
glue (:func:`profile_imaging`) over the Fig. 3/4 blend / Gaussian pipeline
of :mod:`repro_torch.apps.fig34_imaging` (each stage an ``elemwise`` op);
the training glue (:func:`profile_train`) from a short
exact-vs-approximate twin run. Candidates are :class:`PolicyEntry`s with
the port's default backend ``'auto'`` (the reference's: ``'ref'``);
``'ref'`` entries run the plain versions wherever the tensors lie.
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
    "ann_run_metric",
    "profile_ann",
    "ann_policy_metric",
    "imaging_run_metric",
    "profile_imaging",
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


# ---------------------------------------------------------------- ANN ----
def _ann_layer_names(ws) -> tuple:
    return tuple(f"fc{i}" for i in range(len(ws)))


def _ann_forward(ws, x, cfg_for_layer):
    """Float-weight MLP forward with per-layer ApproxConfig dispatch."""
    import torch

    from repro_torch.core.approx import approx_matmul

    act = x
    for i, w in enumerate(ws):
        act = approx_matmul(act, w, cfg_for_layer(i))
        if i < len(ws) - 1:
            act = torch.relu(act)
    return act


def _ann_inputs(ws, x, device):
    """The weights (float32) and inputs on ``device``."""
    import numpy as np
    import torch

    from repro_torch.apps.table4_ann import to_torch

    ws = to_torch(ws, device)
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, dtype=torch.float32).to(ws[0].device)
    return ws, x


def _accuracy(logits, y) -> float:
    from repro_torch.metrics import classification_accuracy

    return classification_accuracy(logits.cpu().numpy(), y)


def ann_run_metric(ws, x, y, *, device="cuda"):
    """``run_metric(assignment) -> accuracy %`` closure over one float MLP
    (a ``train_float``-style weight list, numpy or tensors): layers named
    in the assignment run the real quantize + SIMDive emulated matmul of
    :func:`repro_torch.core.approx.approx_matmul` on ``device``, the rest
    stay exact float."""
    from repro_torch.core.approx import EXACT, ApproxConfig
    from .select import port_backend

    ws, x = _ann_inputs(ws, x, device)
    names = _ann_layer_names(ws)

    def run_metric(assignment):
        def cfg_for_layer(i):
            cand = assignment.get(names[i])
            if cand is None:
                return EXACT
            return ApproxConfig(mode="simdive", width=cand.width,
                                coeff_bits=cand.coeff_bits,
                                index_bits=cand.index_bits,
                                backend=port_backend(cand.backend))
        return _accuracy(_ann_forward(ws, x, cfg_for_layer), y)

    return run_metric


def profile_ann(ws, x, y, *, candidates=None,
                baseline: float | None = None,
                device="cuda") -> SensitivityProfile:
    """Sensitivity of one float MLP to per-layer approximate matmuls,
    end metric = test accuracy (%), one perturbed layer at a time."""
    candidates = tuple(candidates) if candidates is not None \
        else default_candidates("matmul")
    return profile_layers(ann_run_metric(ws, x, y, device=device),
                          _ann_layer_names(ws), candidates,
                          baseline=baseline)


def ann_policy_metric(ws, x, y, policy: TuningPolicy, *,
                      op: str = "matmul", device="cuda") -> float:
    """End-to-end accuracy (%) of the MLP under ``policy`` — the
    verification run of a greedy assignment. Dispatch goes through
    ``ApproxConfig(policy=..., layer=...)``: each layer resolves its own
    entry, proving the policy path the deployment will use."""
    from repro_torch.core.approx import EXACT, ApproxConfig

    ws, x = _ann_inputs(ws, x, device)
    names = _ann_layer_names(ws)

    def cfg_for_layer(i):
        if policy.lookup(op, names[i]) is None:
            return EXACT
        return ApproxConfig(mode="simdive", policy=policy, layer=names[i])

    return _accuracy(_ann_forward(ws, x, cfg_for_layer), y)


# ------------------------------------------------------------ imaging ----
#: the imaging pipeline's approximable stages and the op each one runs
IMAGING_STAGES = (("blend-mul", "mul"), ("gauss-mul", "mul"),
                  ("gauss-div", "div"))


def imaging_run_metric(*, metric: str = "psnr", seed: int = 3,
                       device="cuda"):
    """``run_metric(assignment) -> PSNR dB | SSIM x100`` closure over the
    Fig. 3/4 blend + Gaussian pipeline
    (:mod:`repro_torch.apps.fig34_imaging`) on ``device``, measured
    against the accurate-arithmetic pipeline output via
    :mod:`repro_torch.metrics.image`.

    Stage names are :data:`IMAGING_STAGES`; stages absent from the
    assignment run accurate."""
    import numpy as np

    from repro_torch.apps.fig34_imaging import (
        FO, blend, exact_div, exact_mul, gaussian, synth_image)
    from repro_torch.core.device import require_device
    from repro_torch.metrics import psnr, ssim

    if metric not in ("psnr", "ssim"):
        raise ValueError(f"metric must be 'psnr' or 'ssim', got {metric!r}")
    dev = require_device(device)
    img1, img2 = synth_image(seed), synth_image(seed + 1)

    def stage_op(cand, op):
        bound = cand.bind()
        if op == "mul":
            return lambda a, b: bound(a, b, op="mul")
        return lambda a, b: bound(a, b, op="div", frac_out=FO)

    def pipeline(ops):
        blended = np.asarray(blend(img1, img2, ops["blend-mul"], dev),
                             np.uint32)
        return gaussian(blended, ops["gauss-mul"], ops["gauss-div"], dev)

    ref_out = pipeline({"blend-mul": exact_mul, "gauss-mul": exact_mul,
                        "gauss-div": exact_div})

    def run_metric(assignment):
        out = pipeline({name: (stage_op(assignment[name], op)
                               if name in assignment
                               else (exact_mul if op == "mul"
                                     else exact_div))
                        for name, op in IMAGING_STAGES})
        if metric == "psnr":
            return psnr(ref_out, out)
        return 100.0 * ssim(ref_out, out)

    return run_metric


def profile_imaging(*, candidates=None, metric: str = "psnr",
                    seed: int = 3, device="cuda") -> SensitivityProfile:
    """Sensitivity of the Fig. 3/4 pipeline stages, end metric = PSNR (dB)
    or SSIM (x100, so budgets share the 'points' scale) against the
    accurate-arithmetic pipeline (:func:`imaging_run_metric`).

    Stages: the blend multiplier, the Gaussian window multiplier and the
    Gaussian normalization divider (the paper's division use-case).

    Baseline convention: the reference is the accurate pipeline's own
    output, so the unperturbed baseline is the identity — 99 dB (the
    :func:`repro_torch.metrics.psnr` sentinel) or SSIM 100. State budgets
    against that cap (``budget = 99 - floor_db``), and prefer
    :func:`greedy_assign_verified` with :func:`imaging_run_metric`:
    per-stage PSNR degradations against an identity reference are *not*
    additive, so only the measured loop places assignments tightly. The
    profile also exposes infeasible stage configs outright — e.g. an
    8-bit divider lane cannot hold the Gaussian accumulator (values up
    to 255·273), a ~77 dB degradation pruned off the upgrade ladder
    automatically.
    """
    candidates = tuple(candidates) if candidates is not None \
        else tuple(replace(c, op="mul") for c in default_candidates("mul"))
    return profile_layers(
        imaging_run_metric(metric=metric, seed=seed, device=device),
        [s for s, _ in IMAGING_STAGES], candidates)


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
