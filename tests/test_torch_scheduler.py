"""The continuous-batching scheduler (``launch.scheduler``) on the CPU.

The same drill in both packages: the reference's ``tests/test_serve.py``
drill (batch 2, prompt 16, 8 requests from ``default_rng(7)``, 4 tokens
each, shed_depth 3, recover_depth 1) without a policy, both models on the
same parameters (``params_from_reference``) in float32, where the point is
the algorithm and not bf16 rounding (as in ``test_torch_model.py``): the
event lists, the tokens each rung served and every request's tokens must
be equal. Then the reference's non-chaos scheduler tests, ported (the
chaos drills arm table faults, which wait for the fault subsystem), the
watchdog's handling of ``GuardTripped`` from a rung's prefill or step, a
guarded drill, and the one-cache pieces (``insert_cache`` against the
reference's ``_insert_impl``; ``adopt_cache``). On a GPU each rung's
prefill and step are CUDA graphs captured at warmup; ``chip_smoke.py``
holds that drill to the eager one there. Here both run eagerly.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core.approx import ApproxConfig as RApprox
from repro.launch import scheduler as r_sched
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels.registry import GuardTripped
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (Scheduler, ServeLevel, coarse_step,
                                          default_ladder)
from repro_torch.models import build
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import LM

torch.set_num_threads(1)

ARCH = "smollm-360m"
P, GEN = 16, 6


# ------------------------------------------------- the drill, both packages --
@lru_cache(maxsize=None)
def _both_drills(emulate: bool):
    """The reference's drill and the port's, run on the same parameters
    and prompts; returns both schedulers after ``run()``."""
    r_approx = RApprox(mode="simdive", use_in_softmax=True, emulate=emulate)
    t_approx = TApprox(mode="simdive", use_in_softmax=True, emulate=emulate)
    r_cfg = replace(r_get_config(ARCH, smoke=True),
                    dtype="float32").with_approx(r_approx)
    t_cfg = replace(t_get_config(ARCH, smoke=True),
                    dtype="float32").with_approx(t_approx)
    kw = dict(batch=2, prompt_len=P, max_seq=P + 4 + 2, shed_depth=3,
              recover_depth=1)
    rs = r_sched.Scheduler(r_cfg, levels=r_sched.default_ladder(r_approx),
                           seed=0, **kw)
    params = params_from_reference(jax.tree.map(np.asarray, rs.params),
                                   t_cfg)
    ts = Scheduler(t_cfg, params, levels=default_ladder(t_approx),
                   device="cpu", **kw)
    rng = np.random.default_rng(7)
    for _ in range(8):
        prompt = rng.integers(0, r_cfg.vocab_size, P, dtype=np.int32)
        rs.submit(prompt, max_new=4)
        ts.submit(prompt, max_new=4)
    assert rs.warmup() == ts.warmup() == 6
    return rs, rs.run(), ts, ts.run()


@pytest.mark.parametrize("emulate", [False, True],
                         ids=["divider", "emulate"])
def test_drill_equals_reference(emulate):
    rs, r_stats, ts, t_stats = _both_drills(emulate)
    assert [lv.name for lv in ts.levels] == [lv.name for lv in rs.levels] \
        == ["fine", "shed", "recovery"]
    assert t_stats["events"] == r_stats["events"]
    assert t_stats["tokens_per_level"] == r_stats["tokens_per_level"]
    assert {r.rid: r.tokens for r in ts.done} == \
        {r.rid: r.tokens for r in rs.done}
    assert {r.rid: r.levels for r in ts.done} == \
        {r.rid: r.levels for r in rs.done}
    drop = ("events", "tokens_per_level")
    assert {k: v for k, v in t_stats.items() if k not in drop} == \
        {k: v for k, v in r_stats.items() if k not in drop}
    assert t_stats["sheds"] >= 1 and t_stats["recovers"] >= 1


def test_ladder_matches_reference():
    for mode, emulate in (("simdive", False), ("simdive", True),
                          ("exact", True)):
        t = [(lv.name, lv.approx.mode, lv.approx.emulate,
              lv.approx.use_in_softmax)
             for lv in default_ladder(TApprox(mode=mode, emulate=emulate))]
        r = [(lv.name, lv.approx.mode, lv.approx.emulate,
              lv.approx.use_in_softmax)
             for lv in r_sched.default_ladder(RApprox(mode=mode,
                                                      emulate=emulate))]
        assert t == r
    shed = coarse_step(TApprox(mode="simdive", guard=True))
    assert shed.spec(16).coeff_bits == 0 and not shed.spec(16).round_output
    assert shed.guard


# ------------------------------------------------------ the port, alone --
def _scheduler(batch=2, requests=0, shed_depth=3, recover_depth=1, gen=4,
               guard=False, **kw):
    """The reference's ``_scheduler`` on the port, without a policy: the
    CLI's divider-softmax config (``serve --approx simdive``)."""
    approx = TApprox(mode="simdive", emulate=False, use_in_softmax=True,
                     guard=guard)
    cfg = t_get_config(ARCH, smoke=True).with_approx(approx)
    sched = Scheduler(cfg, levels=default_ladder(approx), batch=batch,
                      prompt_len=P, max_seq=P + gen + 2,
                      shed_depth=shed_depth, recover_depth=recover_depth,
                      seed=0, device="cpu", **kw)
    rng = np.random.default_rng(7)
    for _ in range(requests):
        sched.submit(rng.integers(0, cfg.vocab_size, P), max_new=gen)
    return cfg, sched


def test_scheduler_single_request_matches_generate():
    """One request through the scheduler == the plain batched generate
    (same level, same greedy tokens) — continuous batching must not change
    what is computed, only when."""
    cfg, sched = _scheduler(batch=2, requests=0, gen=GEN)
    lm = sched.lms[0]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, P)
    req = sched.submit(prompt, max_new=GEN)
    sched.warmup()
    stats = sched.run()
    assert stats["completed"] == 1
    assert stats["sheds"] == 0
    want = serve.generate(lm, sched.params, torch.from_numpy(prompt)[None],
                          sched.max_seq, GEN)[0]
    assert req.tokens == want.tolist()


def test_scheduler_batch_of_requests_matches_generate():
    """As many requests as slots, admitted by one prefill: each row's
    tokens equal generate's on the same prompts (the card's drill checks
    the same at full width)."""
    cfg, sched = _scheduler(batch=3, requests=0, shed_depth=100, gen=GEN)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, P))
    reqs = [sched.submit(p, max_new=GEN) for p in prompts]
    sched.warmup()
    sched.run()
    want = serve.generate(sched.lms[0], sched.params,
                          torch.from_numpy(prompts), sched.max_seq, GEN)
    assert [r.tokens for r in reqs] == want.tolist()
    assert sched.events[:3] == [(1, "admit", 0), (1, "admit", 1),
                                (1, "admit", 2)]


def test_scheduler_load_shed_drill():
    """Flood the queue past shed_depth, watch the scheduler swap to the
    coarser rung, drain, and recover — with every request completing."""
    _, sched = _scheduler(batch=2, requests=8, shed_depth=3,
                          recover_depth=1)
    assert sched.warmup() == 2 * len(sched.levels)
    stats = sched.run()
    assert stats["completed"] == 8
    assert stats["sheds"] >= 1
    assert stats["recovers"] >= 1
    kinds = [k for _, k, _ in stats["events"]]
    assert kinds.index("shed") < kinds.index("recover")
    assert stats["tokens_per_level"]["fine"] > 0
    assert stats["tokens_per_level"]["shed"] > 0
    total = sum(len(r.tokens) for r in sched.done)
    assert sum(stats["tokens_per_level"].values()) == total == \
        stats["tokens"]


def test_scheduler_validates_geometry():
    cfg, sched = _scheduler()
    with pytest.raises(ValueError, match="prompt length"):
        sched.submit(np.zeros(P + 1, np.int64), max_new=2)
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(np.zeros(P, np.int64), max_new=10_000)
    with pytest.raises(ValueError, match="recover_depth"):
        Scheduler(cfg, levels=sched.levels, batch=2, prompt_len=P,
                  max_seq=64, shed_depth=2, recover_depth=2, device="cpu")


def test_scheduler_refuses_zero_length_prompt_loudly():
    cfg, sched = _scheduler()
    with pytest.raises(ValueError, match="prompt_len must be positive"):
        Scheduler(cfg, levels=sched.levels, batch=2, prompt_len=0,
                  max_seq=64, shed_depth=3, recover_depth=1, device="cpu")
    with pytest.raises(ValueError, match="max_retries"):
        Scheduler(cfg, levels=sched.levels, batch=2, prompt_len=P,
                  max_seq=64, shed_depth=3, recover_depth=1,
                  max_retries=-1, device="cpu")


def test_scheduler_scrub_is_not_ported():
    """The table scrub needs the fault subsystem: asking for it raises
    instead of serving without it."""
    cfg, _ = _scheduler()
    with pytest.raises(NotImplementedError, match="A-6"):
        Scheduler(cfg, batch=2, prompt_len=P, shed_depth=3,
                  recover_depth=1, scrub_every=1, device="cpu")


def test_scheduler_runs_on_the_card_unless_asked():
    cfg, _ = _scheduler()
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is there")
    with pytest.raises(RuntimeError, match="is_available"):
        Scheduler(cfg, batch=2, prompt_len=P)


def test_scheduler_retire_during_active_shed():
    """A request retiring while the shed rung is active frees its slot for
    the next queued request at the current (shed) level, with every token
    attributed to the rung that produced it."""
    _, sched = _scheduler(batch=2, requests=8, shed_depth=2,
                          recover_depth=1, gen=3)
    sched.warmup()
    stats = sched.run()
    assert stats["completed"] == 8
    shed_tick = next(t for t, k, _ in stats["events"] if k == "shed")
    recover_tick = next(t for t, k, _ in stats["events"] if k == "recover")
    retire_ticks = [t for t, k, _ in stats["events"] if k == "retire"]
    assert any(shed_tick <= t < recover_tick for t in retire_ticks)
    assert stats["tokens_per_level"]["shed"] > 0
    total = sum(len(r.tokens) for r in sched.done)
    assert sum(stats["tokens_per_level"].values()) == total


def test_scheduler_all_slots_busy_queue_accounting():
    """With every slot occupied, admission leaves the queue intact — depth
    only drains as slots free — and nothing is double-admitted."""
    _, sched = _scheduler(batch=2, requests=6, shed_depth=100, gen=4)
    sched.warmup()
    sched.step()
    assert sum(r is not None for r in sched.slots) == 2
    assert len(sched.queue) == 4
    sched.step()
    assert len(sched.queue) == 4
    admits = [v for _, k, v in sched.events if k == "admit"]
    assert len(admits) == len(set(admits)) == 2
    stats = sched.run()
    assert stats["completed"] == 6
    assert len(set(r.rid for r in sched.done)) == 6


def test_scheduler_hysteresis_does_not_flap():
    """A queue between recover_depth and shed_depth never moves the level,
    and a shed is never undone on the adjacent tick."""
    _, sched = _scheduler(batch=2, requests=5, shed_depth=6,
                          recover_depth=1, gen=4)
    sched.warmup()
    stats = sched.run()
    assert stats["completed"] == 5
    assert stats["sheds"] == 0 and stats["recovers"] == 0
    _, sched2 = _scheduler(batch=2, requests=10, shed_depth=3,
                           recover_depth=1, gen=3)
    sched2.warmup()
    stats2 = sched2.run()
    moves = [(t, k) for t, k, _ in stats2["events"]
             if k in ("shed", "recover")]
    assert moves
    for (t1, k1), (t2, k2) in zip(moves, moves[1:]):
        if k1 != k2:
            assert t2 > t1 + 1, f"level flapped {k1}->{k2} on adjacent ticks"


def test_scheduler_tick_budget_times_out_and_retries():
    """A request overstaying tick_budget is quarantined (a timeout), backed
    off, and re-served or failed loudly — never left in its slot."""
    _, sched = _scheduler(batch=2, requests=2, shed_depth=100, gen=4,
                          tick_budget=1)
    sched.warmup()
    stats = sched.run()
    assert stats["timeouts"] >= 1
    assert stats["retries"] >= 1
    assert stats["completed"] + stats["failed"] == 2
    for req in sched.failed:
        assert req.failed and "budget" in req.fail_reason
        assert req.tokens == []


def test_scheduler_self_heal_off_keeps_legacy_shape():
    _, sched = _scheduler(batch=2, requests=2, gen=3, self_heal=False)
    assert [lv.name for lv in sched.levels] == ["fine", "shed"]
    sched.warmup()
    stats = sched.run()
    assert stats["completed"] == 2
    assert stats["quarantines"] == 0 and stats["guard_trips"] == 0


def test_recovery_rung_is_the_exact_base():
    _, sched = _scheduler(guard=True)
    fine, shed, rec = (lv.approx for lv in sched.levels)
    assert rec == replace(fine, mode="exact") and not rec.enabled
    assert shed.mode == "mitchell" and fine.mode == "simdive"
    assert fine.guard and shed.guard and rec.guard


# ------------------------------------------------------ guard + watchdog --
def _trip(name="decode_attention"):
    return GuardTripped(op=name, backend="cuda", width=16,
                        reason="|output| exceeds 9 (4x max |v|)", bad=1,
                        total=8)


@pytest.mark.parametrize("where", ["step", "prefill"])
def test_guard_trip_quarantines_and_reserves_on_recovery(where):
    """A rung's step or prefill raising GuardTripped (patched in): the
    scheduler counts the trip, bounces the requests it held, backs them
    off and re-serves them from scratch on the recovery rung."""
    _, sched = _scheduler(batch=2, requests=2, shed_depth=100, gen=4)
    sched.warmup()
    fns = list(sched.steps if where == "step" else sched.prefills)
    real, calls = fns[0], []

    def tripping(*args):
        calls.append(1)
        if len(calls) == 2 if where == "step" else len(calls) == 1:
            raise _trip()
        return real(*args)

    fns[0] = tripping
    if where == "step":
        sched.steps = tuple(fns)
    else:
        sched.prefills = tuple(fns)
    stats = sched.run()
    assert stats["guard_trips"] == 1
    assert stats["completed"] == 2 and stats["failed"] == 0
    assert stats["retries"] == 2
    # a step's trip quarantines the live slots; a prefill's bounces the
    # admission before it holds a slot
    assert stats["quarantines"] == (2 if where == "step" else 0)
    guard = [v for _, k, v in stats["events"] if k == "guard"]
    assert len(guard) == 1 and "decode_attention" in guard[0]
    for req in sched.done:
        assert req.retries == 1 and req.pinned_exact
        assert req.levels == ["recovery"] * req.max_new
        assert len(req.tokens) == req.max_new
    assert stats["tokens_per_level"]["recovery"] == 8
    kinds = [k for _, k, _ in stats["events"]]
    assert kinds.index("guard") < kinds.index("retry")


def test_guard_trip_with_no_retries_fails_loudly():
    _, sched = _scheduler(batch=2, requests=2, shed_depth=100, gen=4,
                          max_retries=0)
    sched.warmup()

    def tripping(*args):
        raise _trip()

    sched.steps = (tripping,) + sched.steps[1:]
    stats = sched.run()
    assert stats["failed"] == 2 and stats["completed"] == 0
    assert stats["quarantines"] == 2 and stats["retries"] == 0
    for req in sched.failed:
        assert req.tokens == [] and req.fail_reason.startswith("guard: ")


def test_non_finite_logits_are_quarantined():
    """The watchdog's logit check: a NaN row is never argmaxed into a
    completion; that request is retried on the recovery rung."""
    _, sched = _scheduler(batch=2, requests=2, shed_depth=100, gen=4)
    sched.warmup()
    real, calls = sched.steps[0], []

    def poisoned(*args):
        logits, cache = real(*args)
        calls.append(1)
        if len(calls) == 1:
            logits = logits.clone()
            logits[1] = float("nan")
        return logits, cache

    sched.steps = (poisoned,) + sched.steps[1:]
    stats = sched.run()
    assert stats["quarantines"] == 1 and stats["retries"] == 1
    assert stats["completed"] == 2 and stats["guard_trips"] == 0
    retried = [r for r in sched.done if r.retries]
    assert len(retried) == 1 and set(retried[0].levels) == {"recovery"}


def test_guarded_drill_equals_unguarded():
    """``ApproxConfig(guard=True)`` on every rung: every dispatch is
    checked (on the CPU, each call's output), nothing trips, and the drill
    is the unguarded one, event for event and token for token."""
    _, plain = _scheduler(batch=2, requests=6, shed_depth=3)
    _, guarded = _scheduler(batch=2, requests=6, shed_depth=3, guard=True)
    plain.params = guarded.params
    plain.warmup()
    guarded.warmup()
    a, b = plain.run(), guarded.run()
    assert b["guard_trips"] == 0 and b["sheds"] >= 1
    assert a == b
    assert [r.tokens for r in plain.done] == [r.tokens for r in guarded.done]


# -------------------------------------------------------- one cache --
def _caches(seed=0):
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(2, 4, 10, 1, 8)).astype(np.float32)
    pre = rng.normal(size=(2, 4, 6, 1, 8)).astype(np.float32)
    return full, pre


@pytest.mark.parametrize("slots", [[2, 0, 4, 4], [3, 1, 0, 2], [4] * 4,
                                   [1, -1, 7, 0]],
                         ids=["two-padding", "all", "none", "negative"])
def test_insert_cache_equals_reference_insert(slots):
    """The served insert writes in place and equals the reference's
    ``_insert_impl`` (padding rows dropped). A negative index is dropped
    by the port; the reference's scatter wraps it, so that case is held
    to a plain numpy model instead."""
    full, pre = _caches()
    t_full = {"k": torch.from_numpy(full.copy()),
              "v": torch.from_numpy(full.copy() + 1)}
    bufs = dict(t_full)
    got = serve.insert_cache(t_full, {"k": torch.from_numpy(pre),
                                      "v": torch.from_numpy(pre + 1)},
                             np.asarray(slots))
    assert all(got[k] is bufs[k] for k in bufs)
    want = full.copy()
    for j, s in enumerate(slots):
        if 0 <= s < full.shape[1]:
            want[:, s, :pre.shape[2]] = pre[:, j]
    np.testing.assert_array_equal(got["k"].numpy(), want)
    np.testing.assert_array_equal(got["v"].numpy(), want + 1)
    if min(slots) >= 0:
        ref = r_sched.Scheduler._insert_impl(
            None, {"k": jnp.asarray(full)}, {"k": jnp.asarray(pre)},
            jnp.asarray(slots, jnp.int32))
        np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))


def test_insert_cache_refuses_a_mismatch_loudly():
    full, pre = _caches()
    t_full = {"k": torch.from_numpy(full)}
    with pytest.raises(ValueError, match=r"\['k'\]"):
        serve.insert_cache(t_full, {"k": torch.from_numpy(pre[:, :3])},
                           [0, 1, 2, 3])
    with pytest.raises(ValueError, match="unmergeable"):
        serve.insert_cache(t_full, {"v": torch.from_numpy(pre)}, [0] * 4)
    with pytest.raises(ValueError, match=r"\['k'\]"):
        serve.insert_cache({"k": torch.from_numpy(pre)},
                           {"k": torch.from_numpy(full)}, [0] * 4)


def test_adopt_cache():
    """On the CPU a step takes any cache and adoption does nothing; a step
    for the card refuses a cache that is not its serving cache there,
    before touching a slot."""
    cfg, sched = _scheduler()
    step = serve.make_decode_step(sched.lms[0])
    assert step.adopt_cache(sched.cache) is sched.cache
    assert step.slot_cache(2, sched.max_seq) is None
    on_card = serve.DecodeStep(LM(cfg, torch.device("cuda")))
    with pytest.raises(ValueError, match="not this model's serving cache"):
        on_card.adopt_cache(build(cfg, device="cpu").empty_cache(2, 24))
    with pytest.raises(ValueError, match="serving cache"):
        on_card.adopt_cache({"k": torch.zeros(3)})
    assert on_card.slot_cache(2, 24) is None


def test_measure_decode_and_stats_on_cpu():
    _, sched = _scheduler(batch=2, requests=3, shed_depth=100, gen=3)
    sched.warmup()
    stats = sched.run()
    t = sched.measure_decode(iters=2)
    assert t.device == "cpu" and t.best_s > 0 and t.items == 2
    assert stats["tokens"] == 9 and stats["completed"] == 3
    assert stats["ticks"] == sched.tick_no and not stats["poisoned"]


def test_levels_accept_a_custom_ladder():
    cfg, _ = _scheduler()
    fine = TApprox(mode="simdive", emulate=False)
    sched = Scheduler(cfg, levels=(ServeLevel("fine", fine),
                                   ServeLevel("coarse", coarse_step(fine))),
                      batch=2, prompt_len=P, shed_depth=3, recover_depth=1,
                      device="cpu")
    assert [lv.name for lv in sched.levels] == ["fine", "coarse",
                                                "recovery"]
    assert sched.max_seq == 2 * P
