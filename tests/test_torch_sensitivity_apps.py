"""Port vs reference: the tuner's application glue
(``repro_torch.tuning.sensitivity``'s ANN and imaging halves).

The same weights and images go through ``repro.tuning.sensitivity`` and the
port's. The ANN glue runs on the reference's trained 784-32-32-10 MLP
(float32, carried across) over 150 test images: ``profile_ann`` table for
table at every rung of ``default_candidates("matmul")`` — width 16 on the
emulated matmul's int64 sum —, ``ann_run_metric`` with every layer at one
rung, and ``ann_policy_metric`` of the policy a greedy assignment makes;
the port's candidates keep their ``'auto'`` backend (the plain versions on
CPU tensors), the reference's their ``'ref'``. The imaging glue runs the
reference's Fig. 3/4 pipeline at its own 256 x 256 (it takes no smaller
size): ``profile_imaging`` for both metrics and ``imaging_run_metric``
with every stage at one rung. Every value must be the reference's, exactly.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmarks import table4_ann as r_t4
from repro.tuning import sensitivity as r_sens
from repro_torch.tuning import sensitivity as t_sens

RUNGS = ((8, 0), (8, 2), (8, 4), (8, 6), (16, 6))
RUNG_IDS = [f"w{w}cb{c}" for w, c in RUNGS]


@pytest.fixture(scope="module")
def mlp():
    """The reference's trained 784-32-32-10 MLP (float32; 70 % on the
    test set) and the test set."""
    (xtr, ytr), (xte, yte) = r_t4.make_dataset(n_train=2000, n_test=150,
                                               seed=1)
    ws, _ = r_t4.train_float(xtr, ytr, hidden=(32, 32), steps=300, seed=0)
    return [np.asarray(w, np.float32) for w in ws], xte, yte


def _rows(profile):
    return [(layer, [(c.op, c.width, c.coeff_bits, c.index_bits, m)
                     for c, m in row]) for layer, row in profile.table]


def test_profile_ann_matches_reference(mlp):
    ws, x, y = mlp
    want = r_sens.profile_ann(ws, x, y)
    got = t_sens.profile_ann(ws, x, y, device="cpu")
    assert got.baseline == want.baseline > 50
    assert got.layers == want.layers == ("fc0", "fc1", "fc2")
    assert _rows(got) == _rows(want)
    assert all(c.backend == "auto" for c in got.candidates)
    # the rungs reach the end metric: some layer loses accuracy somewhere
    assert any(got.degradation(layer, c) > 0
               for layer in got.layers for c in got.candidates)


@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_ann_run_and_policy_metrics_match_reference(mlp, rung):
    """Every layer at one rung, through the closure and through the
    policy path (``ApproxConfig(policy=..., layer=...)``)."""
    ws, x, y = mlp
    width, cb = rung
    r_cand = replace(r_sens.default_candidates()[0], width=width,
                     coeff_bits=cb)
    t_cand = replace(t_sens.default_candidates()[0], width=width,
                     coeff_bits=cb)
    names = ("fc0", "fc1", "fc2")
    want = r_sens.ann_run_metric(ws, x, y)({n: r_cand for n in names})
    got = t_sens.ann_run_metric(ws, x, y, device="cpu")(
        {n: t_cand for n in names})
    assert got == want
    r_pol = r_sens.assignment_policy({n: r_cand for n in names[:2]},
                                     op="matmul")
    t_pol = t_sens.assignment_policy({n: t_cand for n in names[:2]},
                                     op="matmul")
    assert t_sens.ann_policy_metric(ws, x, y, t_pol, device="cpu") \
        == r_sens.ann_policy_metric(ws, x, y, r_pol)


def test_greedy_policy_over_the_ann_profile_matches_reference(mlp):
    """Profile, greedy assignment at a 1-point budget, policy, and its
    verification run — the chain phase 16 (d) runs on the card."""
    ws, x, y = mlp
    r_prof = r_sens.profile_ann(ws, x, y)
    t_prof = t_sens.profile_ann(ws, x, y, device="cpu")
    r_asg = r_sens.greedy_assign(r_prof, 1.0)
    t_asg = t_sens.greedy_assign(t_prof, 1.0)
    # the budget binds: some layer leaves the cheapest rung
    assert any(c != t_prof.candidates[0] for c in t_asg.values())
    assert {k: (c.width, c.coeff_bits) for k, c in t_asg.items()} \
        == {k: (c.width, c.coeff_bits) for k, c in r_asg.items()}
    t_pol = t_sens.assignment_policy(t_asg, op="matmul")
    assert t_sens.ann_policy_metric(ws, x, y, t_pol, device="cpu") \
        == r_sens.ann_policy_metric(
            ws, x, y, r_sens.assignment_policy(r_asg, op="matmul"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            t_sens.ann_policy_metric(ws, x, y, t_pol)


@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_profile_imaging_matches_reference(metric):
    want = r_sens.profile_imaging(metric=metric)
    got = t_sens.profile_imaging(metric=metric, device="cpu")
    assert got.baseline == want.baseline
    assert got.layers == want.layers == tuple(
        s for s, _ in t_sens.IMAGING_STAGES)
    assert _rows(got) == _rows(want)
    assert t_sens.IMAGING_STAGES == r_sens.IMAGING_STAGES
    if metric == "psnr":          # the infeasible 8-bit divider shows
        assert got.degradation("gauss-div", got.candidates[0]) > 70


@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_imaging_run_metric_matches_reference(rung):
    """Every stage at one rung at once, seed 4."""
    width, cb = rung
    r_cand = replace(r_sens.default_candidates("mul")[0], width=width,
                     coeff_bits=cb)
    t_cand = replace(t_sens.default_candidates("mul")[0], width=width,
                     coeff_bits=cb)
    names = [s for s, _ in t_sens.IMAGING_STAGES]
    want = r_sens.imaging_run_metric(seed=4)({n: r_cand for n in names})
    got = t_sens.imaging_run_metric(seed=4, device="cpu")(
        {n: t_cand for n in names})
    assert got == want
    with pytest.raises(ValueError, match="metric"):
        t_sens.imaging_run_metric(metric="mse", device="cpu")
