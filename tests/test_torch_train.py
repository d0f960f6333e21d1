"""Port vs reference: the training substrate and the trainer.

The optimizers, the cosine schedule and global-norm clipping on the same
trees (a ``None`` gradient leaf in the port counted as the reference's
zero array, ROADMAP R-8); ``compress_local``'s int8 payload bit for bit;
the data batches element for element; checkpoints written by the
reference restored in the port, and the port's own roundtrip, GC, latest
step and ignored ``.tmp`` directories; precision schedules' JSON read both
ways; ``greedy_assign`` on a fixed profile; ``train_twin``'s trace against
the reference's from the same init; bitwise resume across a rung
boundary; the CLI on the CPU and its refusal of ``--tp 2``.
"""
import json
import os
import time
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro.configs import get_config as r_get_config
from repro.configs.base import ShapeConfig as RShape
from repro.core.approx import ApproxConfig as RApprox
from repro.data import MemmapCorpus as RMemmap
from repro.data import make_source as r_make_source
from repro.models import build as r_build
from repro.optim import grad_compress as r_gc
from repro.optim import optimizers as r_opt
from repro.train import PrecisionSchedule as RSchedule
from repro.train import ramp_schedule as r_ramp
from repro.train import train_twin as r_train_twin
from repro.train import warmup_schedule as r_warmup
from repro.tuning import PolicyEntry as RPolicyEntry
from repro.tuning import TuningPolicy as RTuningPolicy
from repro.tuning import sensitivity as r_sens
from repro_torch import checkpoint as t_ckpt
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.tree import tree_leaves
from repro_torch.data import MemmapCorpus as TMemmap
from repro_torch.data import Prefetcher, torch_batch
from repro_torch.data import make_source as t_make_source
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import grad_compress as t_gc
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import PrecisionSchedule as TSchedule
from repro_torch.train import ramp_schedule as t_ramp
from repro_torch.train import train_twin as t_train_twin
from repro_torch.train import warmup_schedule as t_warmup
from repro_torch.tuning import PolicyEntry as TPolicyEntry
from repro_torch.tuning import TuningPolicy as TTuningPolicy
from repro_torch.tuning import sensitivity as t_sens

torch.set_num_threads(1)

ARCH = "smollm-360m"
# optimizer updates in float32 on both sides, the same formulas: measured
# within 2 ulps; bound 1e-6 relative (+ 1e-7 absolute near zero)
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "blk": {"norm": rng.normal(size=(6,)).astype(np.float32),
                    "wq": rng.normal(size=(3, 6, 5)).astype(np.float32)},
            "emb": rng.normal(size=(7, 6)).astype(np.float32)}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rtol=OPT_RTOL, atol=OPT_ATOL):
    flat_w = jax.tree.leaves(want)
    flat_g = tree_leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------ optimizers --
@pytest.mark.parametrize("name", ["adamw", "lion", "momentum"])
def test_optimizers_match_reference_with_none_grads_as_zero(name):
    """Three updates of each optimizer (clipping on: a norm above 1) from
    the same params and grads; the port's ``blk/wq`` gradient is ``None``
    where the reference's is zero, as R-8 leaves them. Params, moments,
    step and the metrics agree; the ``None`` leaf still decays."""
    lr = r_opt.cosine_schedule(1e-2, warmup=2, total=5)
    t_lr = t_opt.cosine_schedule(1e-2, warmup=2, total=5)
    kw = {"adamw": {}, "lion": {}, "momentum": {"clip_norm": 1.0}}[name]
    r_o = getattr(r_opt, name)(lr, **kw)
    t_o = getattr(t_opt, name)(t_lr, **kw)
    params = _tree(0)
    r_p, t_p = _j(params), _t(params)
    r_s, t_s = r_o.init(r_p), t_o.init(t_p)
    assert t_s["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in tree_leaves(t_s["mu"]))
    for i in range(3):
        g = _tree(10 + i)
        g["blk"]["wq"] = np.zeros_like(g["blk"]["wq"])
        r_g, t_g = _j(g), _t(g)
        t_g["blk"]["wq"] = None
        r_p, r_s, r_m = r_o.update(r_g, r_s, r_p)
        t_p, t_s, t_m = t_o.update(t_g, t_s, t_p)
        _close(t_p, r_p)
        _close(t_s["mu"], r_s["mu"])
        if "nu" in r_s:
            _close(t_s["nu"], r_s["nu"])
        assert int(t_s["step"]) == int(r_s["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(t_m[key]), float(r_m[key]),
                                       rtol=OPT_RTOL)
    if name != "momentum":
        # weight decay reached the gradient-free 3-D leaf
        assert not torch.equal(t_p["blk"]["wq"],
                               torch.from_numpy(params["blk"]["wq"]))


def test_cosine_schedule_and_clip_match_reference():
    r_lr = r_opt.cosine_schedule(3e-4, warmup=5, total=40)
    t_lr = t_opt.cosine_schedule(3e-4, warmup=5, total=40)
    for step in range(0, 45):
        got = t_lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(r_lr(step)),
                                   rtol=1e-6)
    g = _tree(3)
    for max_norm in (0.5, 1e3):
        r_c, r_n = r_opt.clip_by_global_norm(_j(g), max_norm)
        t_in = _t(g)
        t_in["blk"]["norm"] = None
        g0 = dict(g, blk=dict(g["blk"], norm=np.zeros(6, np.float32)))
        r_c, r_n = r_opt.clip_by_global_norm(_j(g0), max_norm)
        t_c, t_n = t_opt.clip_by_global_norm(t_in, max_norm)
        np.testing.assert_allclose(float(t_n), float(r_n), rtol=1e-6)
        assert t_c["blk"]["norm"] is None
        for key in ("w", "emb"):
            np.testing.assert_allclose(t_c[key].numpy(),
                                       np.asarray(r_c[key]), rtol=1e-6)


def test_compress_local_int8_payload_bit_for_bit():
    """``quantize_grad``'s int8 payload and scale equal the reference's
    bit for bit over three error-feedback steps (round half to even on
    both sides; ties included), the residuals to one float32 ulp; a
    ``None`` leaf quantizes its residual alone, as the reference's zero
    array does."""
    rng = np.random.default_rng(5)
    grads = [{"a": rng.normal(size=(64, 33)).astype(np.float32),
              "b": (rng.integers(-4, 5, (40,)) * 0.5).astype(np.float32),
              "c": rng.normal(size=(9,)).astype(np.float32)}
             for _ in range(3)]
    for g in grads:
        g["b"][:2] = [127.0, 0.5]           # scale 1: ties at .5 to even
    r_res = r_gc.zero_residual(_j(grads[0]))
    t_res = t_gc.zero_residual(_t(grads[0]))
    for i, g in enumerate(grads):
        gc = dict(g, c=np.zeros(9, np.float32) if i == 1 else g["c"])
        t_in = _t(g)
        if i == 1:
            t_in["c"] = None
        for k in ("a", "b", "c"):
            rq, rs, _ = r_gc.quantize_grad(jnp.asarray(gc[k]), r_res[k])
            tq, ts, _ = t_gc.quantize_grad(t_in[k], t_res[k])
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
            assert float(ts) == float(rs)
        r_out, r_res = r_gc.compress_local(_j(gc), r_res)
        t_out, t_res = t_gc.compress_local(t_in, t_res)
        _close(t_out, r_out, rtol=0, atol=0)
        _close(t_res, r_res, rtol=2 ** -23, atol=1e-12)


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "qwen2-vl-2b"])
def test_data_batches_equal_reference(arch, tmp_path):
    r_cfg, t_cfg = r_get_config(arch, smoke=True), \
        t_get_config(arch, smoke=True)
    r_src = r_make_source(r_cfg, RShape("t", 24, 4, "train"), seed=7)
    t_src = t_make_source(t_cfg, TShape("t", 24, 4, "train"), seed=7)
    for step, rank, size in ((0, 0, 1), (5, 1, 2), (123, 3, 4)):
        want = r_src.batch(step, rank, size)
        got = t_src.batch(step, rank, size)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    tb = torch_batch(t_src.batch(0), "cpu")
    assert tb["tokens"].dtype == torch.int64
    path = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    r_mm = RMemmap(str(path), 512, 24, 4, seed=3)
    t_mm = TMemmap(str(path), 512, 24, 4, seed=3)
    for step in (0, 9):
        for k, v in r_mm.batch(step).items():
            np.testing.assert_array_equal(t_mm.batch(step)[k], v)
    pf = Prefetcher(t_src, start_step=2)
    step, batch = pf.next()
    pf.close()
    assert step == 2
    np.testing.assert_array_equal(batch["tokens"],
                                  r_src.batch(2)["tokens"])


# ------------------------------------------------------------- checkpoint --
def _ref_tree():
    rng = np.random.default_rng(4)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b16": rng.normal(size=(5,)).astype(jnp.bfloat16)},
            "opt": {"step": np.int32(7),
                    "mu": [rng.normal(size=(2,)).astype(np.float32),
                           np.zeros((2, 2), np.float32)]}}


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    d = str(tmp_path / "ck")
    tree = _ref_tree()
    r_ckpt.save(d, 12, jax.tree.map(jnp.asarray, tree))
    os.makedirs(os.path.join(d, "step_000000099.tmp"))   # a crashed write
    assert t_ckpt.latest_step(d) == 12
    step, got = t_ckpt.restore(d)
    assert step == 12
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  tree["params"]["w"])
    assert got["params"]["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["b16"].to(torch.float32).numpy(),
        tree["params"]["b16"].astype(np.float32))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    assert isinstance(got["opt"]["mu"], list) and len(got["opt"]["mu"]) == 2
    np.testing.assert_array_equal(got["opt"]["mu"][0].numpy(),
                                  tree["opt"]["mu"][0])
    # and the port's own file has the reference's layout and key names
    d2 = str(tmp_path / "ck2")
    t_ckpt.save(d2, 12, got)
    with open(os.path.join(d, "step_000000012", "manifest.json")) as f:
        r_man = json.load(f)["arrays"]
    with open(os.path.join(d2, "step_000000012", "manifest.json")) as f:
        t_man = json.load(f)["arrays"]
    assert t_man == r_man
    with np.load(os.path.join(d2, "step_000000012", "arrays.npz")) as z:
        assert sorted(z.files) == sorted(r_man)
    _, back = r_ckpt.restore(d2)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  tree["params"]["w"])


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    d = str(tmp_path / "ck")
    assert t_ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(d)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": {"s": torch.tensor(3, dtype=torch.int32),
                  "h": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}}
    for step in (1, 2, 3, 4):
        t_ckpt.save_async(d, step, tree)
    t_ckpt.wait_pending()
    fresh = os.path.join(d, "step_000000009.tmp")
    stale = os.path.join(d, "step_000000008.tmp")
    os.makedirs(fresh)
    os.makedirs(stale)
    old = time.time() - 1000
    os.utime(stale, (old, old))
    assert t_ckpt.latest_step(d) == 4
    t_ckpt.gc_keep_last(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_000000003", "step_000000004",
                                     "step_000000009.tmp"]
    step, got = t_ckpt.restore(d, like={"a": torch.zeros(1, dtype=torch.float64),
                                        "n": {"s": torch.zeros(1),
                                              "h": torch.zeros(1)}})
    assert step == 4
    assert got["a"].dtype == torch.float64 and got["n"]["s"].dtype == \
        torch.float32
    step, got = t_ckpt.restore(d, step=3)
    for k, v in (("a", tree["a"]), ("s", tree["n"]["s"]),
                 ("h", tree["n"]["h"])):
        g = got[k] if k == "a" else got["n"][k]
        assert g.dtype == v.dtype and torch.equal(g, v), k


# --------------------------------------------------------------- schedule --
def _policies():
    r = RTuningPolicy(entries=(RPolicyEntry(op="matmul", width=8,
                                            coeff_bits=4, backend="auto"),))
    t = TTuningPolicy(entries=(TPolicyEntry(op="matmul", width=8,
                                            coeff_bits=4, backend="auto"),))
    return r, t


def test_schedule_json_read_both_ways(tmp_path):
    r_pol, t_pol = _policies()
    r_s = r_warmup(r_pol, warmup_steps=3, meta={"budget": 1.5})
    t_s = t_warmup(t_pol, warmup_steps=3, meta={"budget": 1.5})
    assert t_s.to_json() == r_s.to_json()
    assert TSchedule.from_json(r_s.to_json()) == t_s
    assert RSchedule.from_json(t_s.to_json()) == r_s
    path = str(tmp_path / "s.json")
    r_s.save(path)
    loaded = TSchedule.load(path)
    assert loaded.boundaries() == (0, 3)
    base = TApprox(mode="simdive", backward="approx")
    assert loaded.config_at(1, base).mode == "exact"
    assert loaded.config_at(3, base).policy == t_pol
    assert loaded.config_at(3, base).backward == "approx"
    assert loaded.render() == RSchedule.load(path).render()
    with pytest.raises(ValueError, match="step 0"):
        TSchedule(rungs=(t_s.rungs[1],))


def test_greedy_assign_and_ramp_on_a_fixed_profile():
    """The same measured table in both packages gives the same
    assignment, the same verified assignment and the same ramp schedule
    (candidates built with one backend name on both sides)."""
    def ladder(entry):
        return tuple(entry(op="matmul", width=w, coeff_bits=cb,
                           backend="ref")
                     for w, cb in ((8, 0), (8, 2), (8, 4), (8, 6), (16, 6)))

    r_c, t_c = ladder(RPolicyEntry), ladder(TPolicyEntry)
    layers = ("L0", "L1", "L2")
    metric = {"L0": (0.80, 0.90, 0.95, 0.97, 0.99),
              "L1": (0.98, 0.985, 0.99, 0.991, 0.99),
              "L2": (0.50, 0.70, 0.96, 0.95, 0.989)}

    def profile(mod, cands):
        return mod.SensitivityProfile(
            baseline=1.0, layers=layers, candidates=cands,
            table=tuple((l, tuple(zip(cands, metric[l]))) for l in layers))

    r_p, t_p = profile(r_sens, r_c), profile(t_sens, t_c)

    def key(assign):
        return {l: (e.width, e.coeff_bits) for l, e in assign.items()}

    for budget in (0.1, 0.06, 0.035):
        assert key(t_sens.greedy_assign(t_p, budget)) == \
            key(r_sens.greedy_assign(r_p, budget))

    def run_metric(assign):
        return 1.0 - sum(1.0 - dict(zip(t_c, metric[l]))[e]
                         for l, e in assign.items()) * 1.1

    def r_run_metric(assign):
        return run_metric({l: t_c[r_c.index(e)] for l, e in assign.items()})

    t_a, t_m = t_sens.greedy_assign_verified(t_p, 0.06, run_metric)
    r_a, r_m = r_sens.greedy_assign_verified(r_p, 0.06, r_run_metric)
    assert key(t_a) == key(r_a) and t_m == r_m
    with pytest.raises(t_sens.BudgetError, match="infeasible"):
        t_sens.greedy_assign(t_p, 0.001)
    t_ramp_s = t_ramp(t_a, start_step=2, every=2, order=["L2", "L0", "L1"])
    r_ramp_s = r_ramp(r_a, start_step=2, every=2, order=["L2", "L0", "L1"])
    assert t_ramp_s.to_json() == r_ramp_s.to_json()
    assert [r.label for r in t_ramp_s.rungs] == ["warmup", "+L2", "+L0",
                                                  "+L1"]


# -------------------------------------------------------------- the twins --
def _f32(arch=ARCH):
    return (replace(r_get_config(arch, smoke=True), dtype="float32"),
            replace(t_get_config(arch, smoke=True), dtype="float32"))


def test_train_twin_trace_matches_reference(monkeypatch):
    """Both packages' twins from the reference's init (the port's
    ``LM.init`` handed the same parameters) on their equal batches,
    2 steps, the approximate twin ``--approx simdive``: the exact twin's
    losses agree to float32 round-off; the approximate twin's carry the
    emulated linears' one-scale re-quantization noise
    (test_torch_loss.EMULATED_LOSS_TOL); the cosine and the drift agree to
    the same order."""
    r_cfg, t_cfg = _f32()
    _, r_tr = r_train_twin(r_cfg, RShape("t", 32, 2, "train"), steps=2,
                           approx=RApprox(mode="simdive"), seed=0)
    r_params = r_build(r_cfg).init(jax.random.PRNGKey(0))
    carried = params_from_reference(jax.tree.map(np.asarray, r_params),
                                    t_cfg)
    monkeypatch.setattr(t_model.LM, "init",
                        lambda self, seed=0: {k: v for k, v in
                                              carried.items()})
    _, t_tr = t_train_twin(t_cfg, TShape("t", 32, 2, "train"), steps=2,
                           approx=TApprox(mode="simdive"), seed=0,
                           device="cpu")
    assert t_tr.meta == r_tr.meta
    assert len(t_tr.records) == len(r_tr.records) == 2
    for got, want in zip(t_tr.records, r_tr.records):
        assert got["step"] == want["step"]
        assert abs(got["loss_exact"] - want["loss_exact"]) <= 1e-4
        assert abs(got["loss_approx"] - want["loss_approx"]) <= 1e-2
        assert abs(got["grad_cosine"] - want["grad_cosine"]) <= 2e-2
        assert abs(got["param_drift"] - want["param_drift"]) <= \
            0.25 * want["param_drift"]
    assert sorted(t_tr.as_dict()) == sorted(r_tr.as_dict())
    assert sorted(t_tr.summary()) == sorted(r_tr.summary())


def test_train_twin_exact_base_and_schedule():
    """An 'approximate' twin handed exact arithmetic tracks bit for bit;
    under a warmup schedule the rungs are recorded and the twins part at
    the switch; compression changes the drift, not the cosine."""
    _, t_cfg = _f32()
    shape = TShape("t", 16, 2, "train")
    exact_base = TApprox(mode="simdive", policy=TTuningPolicy(),
                         policy_only=True)
    _, tr = t_train_twin(t_cfg, shape, steps=2, approx=exact_base,
                         device="cpu")
    assert tr.max_abs_loss_delta() == 0.0 and tr.max_param_drift() == 0.0
    _, t_pol = _policies()
    _, tr = t_train_twin(t_cfg, shape, steps=3, device="cpu",
                         schedule=t_warmup(t_pol, warmup_steps=2))
    assert [r["rung"] for r in tr.records] == ["warmup", "warmup", "steady"]
    assert tr.records[1]["loss_delta"] == 0.0
    assert tr.records[2]["loss_delta"] != 0.0
    assert tr.meta["schedule_boundaries"] == [0, 2]
    _, plain = t_train_twin(t_cfg, shape, steps=2, device="cpu")
    _, comp = t_train_twin(t_cfg, shape, steps=2, device="cpu",
                           grad_compress=True)
    assert comp.records[-1]["param_drift"] != plain.records[-1]["param_drift"]
    assert comp.records[0]["grad_cosine"] == plain.records[0]["grad_cosine"]
    metric = t_sens.train_run_metric(t_cfg, shape, steps=2, device="cpu")
    assert metric({}) == 0.0


# ----------------------------------------------------------------- trainer --
def test_resume_is_bitwise_across_a_rung_boundary(tmp_path):
    """Kill after step 3 (checkpoints every 2 steps), resume: the resumed
    losses are ``==`` the straight run's from the checkpoint on, across
    the schedule's rung change at step 2 (two approximate rungs, w8 cb6
    then cb4, with the approximate backward); the switch is real."""
    _, cfg = _f32()
    cfg = cfg.with_approx(TApprox(mode="simdive", backward="approx"))
    shape = TShape("t", 16, 2, "train")
    pol = [TTuningPolicy(entries=(TPolicyEntry(op="matmul", width=8,
                                               coeff_bits=cb),))
           for cb in (6, 4)]
    from repro_torch.train import ScheduleRung
    sched = TSchedule(rungs=(ScheduleRung(0, pol[0], "cb6"),
                             ScheduleRung(2, pol[1], "cb4")))
    kw = dict(steps=4, save_every=2, seed=11, log_every=100,
              schedule=sched, device="cpu")
    d_full, d = str(tmp_path / "full"), str(tmp_path / "ck")
    _, full = t_train.train(cfg, shape, ckpt_dir=d_full, **kw)
    assert t_ckpt.latest_step(d_full) == 4
    _, head = t_train.train(cfg, shape, ckpt_dir=d, stop_after=3, **kw)
    assert head == full[:3]
    assert t_ckpt.latest_step(d) == 2
    _, tail = t_train.train(cfg, shape, ckpt_dir=d, **kw)
    assert tail == full[2:]
    _, one_rung = t_train.train(cfg, shape, ckpt_dir=None, stop_after=3,
                                **{**kw, "schedule": None})
    assert one_rung[:2] == full[:2] and one_rung[2] != full[2]
    # the checkpoint carries the optimizer state under the reference's keys
    _, tree = t_ckpt.restore(d_full)
    assert sorted(tree) == ["opt", "params"]
    assert sorted(tree["opt"]) == ["mu", "nu", "step"]
    assert int(tree["opt"]["step"]) == 4


def test_microbatch_and_grad_compress_steps():
    _, cfg = _f32()
    lm = t_model.build(cfg, device="cpu")
    # momentum is linear in the gradient: the two accumulations' round-off
    # stays round-off in the parameters (Adam's first step is sign(g))
    opt = t_opt.momentum(1e-3)
    params = lm.init(0)
    batch = torch_batch(t_make_source(cfg, TShape("t", 16, 4, "train"))
                        .batch(0), "cpu")
    p1, _, m1 = t_train.make_train_step(lm, opt)(params, opt.init(params),
                                                 batch)
    p2, _, m2 = t_train.make_train_step(lm, opt, microbatch=2)(
        params, opt.init(params), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    step = t_train.make_train_step(lm, opt, grad_compress=True)
    res = t_gc.zero_residual(params)
    _, _, res, m3 = step(params, opt.init(params), res, batch)
    assert float(m3["loss"]) == float(m1["loss"])
    assert any(bool(r.abs().sum() > 0) for r in tree_leaves(res))


def test_cli_on_cpu_and_tp_refused(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16"]
    t_train.main(args + ["--approx", "simdive", "--backward", "approx",
                         "--ckpt-dir", d, "--save-every", "1"])
    out = capsys.readouterr().out
    assert "[step     0] loss=" in out and "[step     1] loss=" in out
    assert t_ckpt.latest_step(d) == 2
    t_train.main(args + ["--ckpt-dir", d, "--steps", "3"])
    assert "[resume] step 2" in capsys.readouterr().out
    rep = str(tmp_path / "div.json")
    t_train.main(args + ["--twin", "--divergence-out", rep])
    out = capsys.readouterr().out
    assert "divergence over 2 steps" in out
    summary = json.loads(out.strip().splitlines()[-1])
    with open(rep) as f:
        assert json.load(f)["schema"] == "simdive-train-divergence/v1"
    assert summary["steps"] == 2
    with pytest.raises(SystemExit) as e:
        t_train.main(args + ["--twin", "--assert-grad-cosine", "1.5"])
    assert e.value.code == 1
    assert "DIVERGED" in capsys.readouterr().out
    # one process: no mesh is bound, and --tp trains unsharded, as the
    # reference does with one device (its mesh needs more than one)
    t_train.main(args + ["--tp", "2", "--steps", "1"])
    out = capsys.readouterr().out
    assert "# mesh: none bound (one process): --tp 2 trains unsharded" \
        in out and "[step     0] loss=" in out
    cfg, shape = t_get_config(ARCH, smoke=True), TShape("t", 16, 2, "train")
    _, tp2 = t_train.train(cfg, shape, steps=1, ckpt_dir=None, tp=2,
                           device="cpu")
    _, tp1 = t_train.train(cfg, shape, steps=1, ckpt_dir=None, device="cpu")
    assert tp2 == tp1
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        t_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    assert not torch.are_deterministic_algorithms_enabled()
