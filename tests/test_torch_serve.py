"""The served decode step and prefill (``launch.serve.make_decode_step``,
``make_prefill``) on the CPU.

On the GPU the step is a CUDA graph of ``serve.decode_body``, captured once
and replayed per token, and the prefill a CUDA graph of ``lm.prefill`` per
prompt shape; ``chip_smoke.py`` holds their tokens, logits and caches equal
to the eager ones there. A CPU has no CUDA graph: here the step is the
eager ``lm.decode_step``, the prefill the eager ``lm.prefill``, and the
body the step's graph captures runs eagerly with its position as a (B,)
tensor. The registry's bookkeeping that a capture needs (the autotune
generation, the launch accounting, no timing under capture) is plain
Python and is checked directly, and the capture machinery both share is
driven with a stand-in for the CUDA graph.
"""
import contextlib
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.launch import serve as r_serve
from repro_torch.core.simdive import SimdiveSpec
from repro_torch.kernels import registry
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch import serve
from repro_torch.models import build
from test_torch_model import (B, EMULATE_LOGIT_TOL, GEN, P, SIMDIVE_LOGIT_TOL,
                              _pair, _prompts, _reference_logits)

torch.set_num_threads(1)

ARCH = "smollm-360m"


def _smoke(emulate: bool):
    """The CLI's smoke model (bf16 activations), its params and prompts."""
    cfg = serve.serving_config(ARCH, smoke=True, approx="simdive",
                               emulate=emulate)
    lm = build(cfg, device="cpu")
    params = lm.init(0)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)))
    return lm, params, prompts


def test_decode_step_is_memoized():
    """One step per lm, as the reference's lru_cache: a fresh step per
    generate() would capture a graph per call."""
    lm, _, _ = _smoke(emulate=False)
    step = serve.make_decode_step(lm)
    assert step is serve.make_decode_step(lm)
    assert isinstance(step, serve.DecodeStep)
    assert serve.make_decode_step(build(lm.cfg, device="cpu")) is step


@pytest.mark.parametrize("emulate", [False, True],
                         ids=["divider", "emulate"])
def test_captured_body_with_device_positions_equals_scalar_loop(emulate):
    """What the graph captures, run eagerly for a whole generate with a
    (B,) position tensor on the device advanced in place: the scalar-pos
    eager loop's tokens and logits, bit for bit."""
    lm, params, prompts = _smoke(emulate)
    want_tok, want_logits = serve.generate(
        lm, params, prompts, P + GEN, GEN, decode_fn=lm.decode_step,
        return_logits=True)

    logits, cache = lm.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm.empty_cache(B, P + GEN), cache)
    pos = torch.full((B,), P, device=lm.device)
    tok = logits.argmax(-1)
    toks, all_logits = [tok], [logits]
    for _ in range(GEN - 1):
        logits, cache = serve.decode_body(lm, params, cache, tok, pos)
        pos += 1
        tok = logits.argmax(-1)
        toks.append(tok)
        all_logits.append(logits)
    assert torch.equal(torch.stack(toks, dim=1), want_tok)
    assert torch.equal(torch.stack(all_logits, dim=1).float(), want_logits)
    with pytest.raises(ValueError, match="integer tensor"):
        serve.decode_body(lm, params, cache, tok, P)


@pytest.mark.parametrize("emulate,tol", [(False, SIMDIVE_LOGIT_TOL),
                                         (True, EMULATE_LOGIT_TOL)],
                         ids=["divider", "emulate"])
def test_generate_default_step_equals_eager_and_reference(emulate, tol):
    """The default step (eager on the CPU) gives the eager loop's tokens and
    logits; its tokens are the reference's where its margin decides them."""
    r_cfg, r_lm, r_params, _, t_lm, t_params = _pair("simdive", emulate)
    prompts = _prompts(r_cfg.vocab_size)
    got_tok, got_logits = serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    eager_tok, eager_logits = serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        decode_fn=t_lm.decode_step, return_logits=True)
    assert torch.equal(got_tok, eager_tok)
    assert torch.equal(got_logits, eager_logits)

    want_tok = np.asarray(r_serve.generate(
        r_lm, r_params, jnp.asarray(prompts, jnp.int32), P + GEN, GEN))
    want_logits = _reference_logits(r_lm, r_params, prompts, GEN)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
    got_tok = got_tok.numpy()
    for b in range(B):
        for i in range(GEN):
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break                                    # prefixes diverged
    assert decided.mean() > 0.5


def test_cpu_step_is_eager_on_any_cache():
    lm, params, prompts = _smoke(emulate=False)
    step = serve.make_decode_step(lm)
    logits, cache = lm.prefill(params, {"tokens": prompts})
    tok = logits.argmax(-1)
    own = step.empty_cache(B, P + 2)
    assert own["k"].shape == lm.empty_cache(B, P + 2)["k"].shape
    assert not own["k"].any()
    a, _ = step(params, serve.merge_cache(own, cache), tok, P)
    b, _ = lm.decode_step(
        params, serve.merge_cache(lm.empty_cache(B, P + 2), cache), tok, P)
    assert torch.equal(a, b)


def test_merge_cache_writes_equal_shape_leaves_in_place():
    """Every merged leaf is the serving cache's own buffer, so a step that
    owns those buffers serves the merged cache."""
    lm, params, prompts = _smoke(emulate=False)
    _, cache = lm.prefill(params, {"tokens": prompts})
    for max_seq in (P, P + 3):
        full = lm.empty_cache(B, max_seq)
        merged = serve.merge_cache(full, cache)
        for key in full:
            assert merged[key] is full[key]
            assert torch.equal(merged[key][:, :, :P], cache[key])


def test_autotune_generation_advances_and_stales_a_capture():
    """clear / preload advance the generation, and a slot captured under an
    older generation, for another params object or with a leaf rebound is
    not replayed."""
    lm, params, _ = _smoke(emulate=False)
    tuned = registry.export_autotune_cache()
    g0 = registry.autotune_generation()
    registry.clear_autotune_cache()
    assert registry.autotune_generation() == g0 + 1
    registry.preload_autotune_cache(tuned)
    assert registry.autotune_generation() == g0 + 2
    registry.preload_autotune_cache([])
    assert registry.autotune_generation() == g0 + 3

    slot = serve._Slot(lm, B, P + GEN)
    assert not slot.captured_for(params)
    slot.graph = object()                 # as _capture leaves a slot
    slot.params, slot.leaves = params, serve._leaves(params)
    slot.generation = registry.autotune_generation()
    assert slot.captured_for(params)
    assert not slot.captured_for(dict(params))
    registry.clear_autotune_cache()
    registry.preload_autotune_cache(tuned)
    assert not slot.captured_for(params)
    slot.generation = registry.autotune_generation()
    assert slot.captured_for(params)
    old = params["final_norm"]["w"]
    params["final_norm"]["w"] = old.clone()
    try:
        assert not slot.captured_for(params)
    finally:
        params["final_norm"]["w"] = old
    assert slot.owns(dict(slot.cache))
    assert not slot.owns(lm.empty_cache(B, P + GEN))


def test_launch_accounting_across_capture_and_replay():
    """A capture counts its launches and gives them back; each replay adds
    them once: 31 replays of a 2-layer step count 62 decode_attention."""
    assert registry.launches_between({"a": 1, "b": 2},
                                     {"a": 4, "b": 2, "c": 1}) == \
        {"a": 3, "c": 1}
    assert registry.launches_between({"a": 5}, {"a": 5}) == {}
    registry.reset_launch_counts()
    try:
        before = registry.launch_counts()
        decode_attention_cuda.launches += 2   # what capturing 2 layers counts
        captured = registry.launches_between(before, registry.launch_counts())
        assert captured == {"decode_attention": 2}
        registry.add_launches(captured, -1)
        assert registry.launch_counts() == before
        for _ in range(GEN - 1):
            registry.add_launches(captured)
        assert registry.launch_counts()["decode_attention"] == 2 * (GEN - 1)
        registry.add_launches(captured, times=-(GEN - 1))
        assert not any(registry.launch_counts().values())
    finally:
        registry.reset_launch_counts()


def test_untimed_block_under_capture_raises(monkeypatch):
    """Under a capture a block that still needs timing raises instead of
    serving the default; with nothing to time the default is served and
    nothing is cached."""
    spec = SimdiveSpec(width=8, coeff_bits=6)
    entry = registry.get_op("matmul_emul", spec).entry
    assert len(entry.block_candidates) >= 2
    x = torch.ones((4, 64), dtype=torch.int32)
    w = torch.ones((64, 32), dtype=torch.int32)
    tensors, kw = (x, x, w, w), {"k_chunk": 0}
    tuned = registry.export_autotune_cache()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    try:
        registry.clear_autotune_cache()
        with pytest.raises(RuntimeError, match="CUDA graph is being captured"):
            registry._pick_block(entry, spec, "cuda", tensors, kw)
        monkeypatch.setenv("SIMDIVE_AUTOTUNE", "0")
        assert registry._pick_block(entry, spec, "cuda", tensors, kw) == \
            entry.default_block
        assert not registry.autotune_cache()
    finally:
        registry.clear_autotune_cache()
        registry.preload_autotune_cache(tuned)


def test_measure_generate_on_cpu_is_warm_synced_and_positive():
    """As tests/test_serve.py holds the reference's: warm-up first, then
    best-of-iters wall clock, the step timed on its own."""
    lm, params, prompts = _smoke(emulate=False)
    toks, e2e, step_t = serve.measure_generate(lm, params, prompts, P + GEN,
                                               GEN, iters=2)
    assert toks.shape == (B, GEN)
    for t in (e2e, step_t):
        assert t.warmup >= 1
        assert t.iters >= 2
        assert 0 < t.best_s <= t.mean_s
        assert t.device == "cpu"
    assert step_t.items_per_s > 0
    assert serve.make_decode_step(lm).captures == 0    # no graph on a CPU


# ---------------------------------------------------------------- prefill --
def test_prefill_is_memoized_and_eager_on_cpu():
    """One prefill per lm, as the decode step; on the CPU it is
    ``lm.prefill``, bit for bit, and captures nothing."""
    lm, params, prompts = _smoke(emulate=False)
    prefill = serve.make_prefill(lm)
    assert prefill is serve.make_prefill(lm)
    assert isinstance(prefill, serve.PrefillStep)
    assert serve.make_prefill(build(lm.cfg, device="cpu")) is prefill
    got_logits, got = prefill(params, {"tokens": prompts})
    want_logits, want = lm.prefill(params, {"tokens": prompts})
    assert torch.equal(got_logits, want_logits)
    assert got.keys() == want.keys() == {"k", "v"}
    for key in want:
        assert torch.equal(got[key], want[key])
    assert prefill.captures == 0


@pytest.mark.parametrize("emulate", [False, True],
                         ids=["divider", "emulate"])
def test_generate_default_prefill_equals_eager_prefill(emulate):
    """The default prefill (eager on the CPU) gives the all-eager
    generate's tokens and logits; that default generate gives the
    reference's tokens by the margin rule in
    test_generate_default_step_equals_eager_and_reference."""
    lm, params, prompts = _smoke(emulate)
    got = serve.generate(lm, params, prompts, P + GEN, GEN,
                         return_logits=True)
    want = serve.generate(lm, params, prompts, P + GEN, GEN,
                          prefill_fn=lm.prefill, decode_fn=lm.decode_step,
                          return_logits=True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on a host without a GPU: the
    capture runs the body as a real capture runs its Python, a replay
    only counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_capture(monkeypatch):
    """The capture calls of ``serve._Captured`` made to run on the CPU;
    yields a flag that reads True while a capture is open."""
    state = {"capturing": False}

    @contextlib.contextmanager
    def graph(g):
        assert isinstance(g, _FakeGraph)
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    tuned = registry.export_autotune_cache()
    registry.reset_launch_counts()
    try:
        yield state
    finally:
        registry.reset_launch_counts()
        registry.clear_autotune_cache()
        registry.preload_autotune_cache(tuned)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_shared_slot_recaptures_only_when_stale(fake_capture, kind):
    """The capture machinery both steps share, driven on the CPU: a slot
    captures on first use (one warm run, then the capture), replays while
    the params object, its leaves and the autotune generation stay, and
    captures again for a new params object, a swapped leaf or a new
    generation — and for nothing else."""
    lm, params, _ = _smoke(emulate=False)
    fn = serve._GraphFn(lm)
    slot = serve._Slot(lm, B, P + GEN) if kind == "decode" \
        else serve._PrefillSlot(lm, B, P)
    runs = []
    body = lambda: runs.append(fake_capture["capturing"]) or ("out", kind)

    def call(p, captures, bodies):
        assert fn._replay(slot, p, body) == ("out", kind)
        assert fn.captures == captures and len(runs) == bodies
        assert fn.capture_s is not None and fn.capture_s >= 0

    call(params, 1, 2)
    assert runs == [False, True]              # the warm run, then the capture
    call(params, 1, 2)
    assert slot.graph.replays == 2
    other = dict(params)
    call(other, 2, 4)
    call(other, 2, 4)
    call(params, 3, 6)
    old = params["final_norm"]["w"]
    params["final_norm"]["w"] = old.clone()
    try:
        call(params, 4, 8)
    finally:
        params["final_norm"]["w"] = old
    call(params, 5, 10)
    registry.preload_autotune_cache(registry.export_autotune_cache())
    call(params, 6, 12)
    registry.clear_autotune_cache()
    call(params, 7, 14)
    for _ in range(3):
        call(params, 7, 14)


def test_launch_accounting_across_prefill_capture_and_replay(fake_capture):
    """A prefill's capture counts its warm run's launches and gives back
    the capture's; each replay adds one eager prefill's launches: a
    2-layer prefill captured once and replayed 5 times counts 6 prefills'
    attention launches."""
    lm, params, _ = _smoke(emulate=False)
    fn = serve._GraphFn(lm)
    slot = serve._PrefillSlot(lm, B, P)

    def body():                     # what a 2-layer prefill's kernels count
        flash_attention_cuda.launches += 2
        return "out"

    fn._replay(slot, params, body)
    assert slot.launches == {"attention": 2}
    assert registry.launch_counts()["attention"] == 4   # warm run + replay
    for _ in range(4):
        fn._replay(slot, params, body)
    assert registry.launch_counts()["attention"] == 2 * 6
    assert sum(registry.launch_counts().values()) == 2 * 6
    assert fn.captures == 1 and slot.graph.replays == 5


def test_untimed_block_under_prefill_capture_raises(fake_capture):
    """A capture that meets a block still to be timed raises out of the
    served prefill: nothing is captured, no eager run takes its place, and
    the capture's launches are given back."""
    lm, params, _ = _smoke(emulate=False)
    spec = SimdiveSpec(width=8, coeff_bits=6)
    entry = registry.get_op("matmul_emul", spec).entry
    x = torch.ones((4, 64), dtype=torch.int32)
    w = torch.ones((64, 32), dtype=torch.int32)
    fn = serve._GraphFn(lm)
    slot = serve._PrefillSlot(lm, B, P)
    registry.clear_autotune_cache()

    def body():
        flash_attention_cuda.launches += 2
        if fake_capture["capturing"]:        # a bucket the warm run missed
            registry._pick_block(entry, spec, "cuda", (x, x, w, w),
                                 {"k_chunk": 0})
        return "out"

    with pytest.raises(RuntimeError, match="CUDA graph is being captured"):
        fn._replay(slot, params, body)
    assert slot.graph is None and fn.captures == 0
    assert registry.launch_counts()["attention"] == 2     # the warm run's
    assert not registry.autotune_cache()


def test_measure_prefill_on_cpu_is_warm_synced_and_positive():
    lm, params, prompts = _smoke(emulate=False)
    t = serve.measure_prefill(lm, params, prompts, iters=2)
    assert t.stats.warmup >= 1 and t.stats.iters == 2
    assert 0 < t.stats.best_s <= t.stats.mean_s
    assert t.stats.device == "cpu" and t.stats.items == B * P
    assert t.host_s > 0
    assert t.capture_s is None                 # no graph on a CPU


# ----------------------------------------------------------------- policy --
def _policy_entries(mod):
    """The reference's ``tests/test_serve.py`` policy, in either package."""
    return (mod.PolicyEntry(op="matmul", width=16, coeff_bits=8,
                            kernel="matmul"),
            mod.PolicyEntry(op="div", width=16, coeff_bits=8),
            mod.PolicyEntry(op="attention", width=16, coeff_bits=8,
                            frac_out=15))


#: a layer-scoped policy that splits the smoke model's two layers: layer 1
#: at the Mitchell divider with its own frac_out, the default entry leaving
#: frac_out unset (the config's 15 stands). 16-bit lanes: the logit
#: tolerance is the 16-bit divider's (an 8-bit operand moved by one unit
#: is a 2^-6 step, which round-off can take; the 8-bit divider itself is
#: held bit-equal in test_policy_divider_equals_reference)
SPLIT_ENTRIES = (
    dict(op="attention", width=16, coeff_bits=8, backend="auto"),
    dict(op="attention", width=16, coeff_bits=0, frac_out=12, backend="ref",
         layer="L1"),
)


def test_policy_roundtrip_into_serving_plan(tmp_path):
    """A policy file saved by the port resolves into the load-time plan
    in both packages: the same rows (ops, segments, widths, coeff_bits,
    index_bits, frac_out, source), each backend the port's own name."""
    from repro.configs import get_config as r_get_config
    from repro.core.approx import ApproxConfig as RApprox
    from repro.tuning.select import TuningPolicy as RPolicy
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core.approx import ApproxConfig as TApprox
    from repro_torch.tuning import select as t_select

    mm, div, att = _policy_entries(t_select)
    pol = t_select.TuningPolicy(
        entries=(mm, replace(div, backend="pallas"), att)
        + tuple(t_select.PolicyEntry(**e) for e in SPLIT_ENTRIES[1:]),
        meta=(("source", "test"),))
    path = tmp_path / "policy.json"
    pol.save(str(path))
    loaded = t_select.TuningPolicy.load(str(path))
    assert loaded == pol and len(loaded.distinct_configs()) == 4
    t_cfg = t_get_config(ARCH, smoke=True).with_approx(
        TApprox(mode="simdive", use_in_softmax=True, policy=loaded))
    r_cfg = r_get_config(ARCH, smoke=True).with_approx(
        RApprox(mode="simdive", use_in_softmax=True,
                policy=RPolicy.load(str(path))))
    plan, r_plan = (serve.resolve_serving_plan(t_cfg),
                    r_serve.resolve_serving_plan(r_cfg))

    def row(r):
        return (r.op, r.layer_lo, r.layer_hi, r.width, r.coeff_bits,
                r.index_bits, r.frac_out, r.source)

    assert [row(r) for r in plan] == [row(r) for r in r_plan]
    assert len(plan) == 6 and all(r.source == "policy" for r in plan)
    att = [r for r in plan if r.op == "attention"]
    assert [(r.width, r.coeff_bits, r.frac_out) for r in att] \
        == [(16, 8, 15), (16, 0, 12)]
    # the port's plan names its own backends: 'pallas' serves as 'cuda'
    assert [(r.op, r.backend) for r in plan] == [
        ("matmul", "auto"), ("div", "cuda"), ("attention", "auto"),
        ("matmul", "auto"), ("div", "cuda"), ("attention", "ref")]
    assert [r.backend for r in r_plan] == [
        "auto", "pallas", "auto", "auto", "pallas", "ref"]
    assert serve.render_plan(plan, t_cfg).splitlines()[0] == \
        "# serving plan: 2 layer segment(s), 6 resolved op config(s)"


def test_policy_matching_defaults_token_parity():
    """A policy pinning exactly the config's own defaults serves the
    policy-free tokens and logits, bit for bit: resolution, not
    behavior."""
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    lm0, params, prompts = _smoke(emulate=False)
    spec, _, frac = lm0.cfg.approx.resolve_attention()
    pol = TuningPolicy(entries=(PolicyEntry(
        op="attention", width=spec.width, coeff_bits=spec.coeff_bits,
        index_bits=spec.index_bits, frac_out=frac),))
    cfg1 = serve.serving_config(ARCH, smoke=True, policy=pol)
    assert cfg1.approx.mode == "simdive" and cfg1.approx.policy is pol
    lm1 = build(cfg1, device="cpu")
    got = serve.generate(lm1, params, prompts, P + GEN, GEN,
                         return_logits=True)
    want = serve.generate(lm0, params, prompts, P + GEN, GEN,
                          return_logits=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_layer_scoped_policy_splits_segments_and_matches_reference(tmp_path):
    """One JSON file served by both packages on the same parameters
    (float32): two layer segments, the port's logits within the divider's
    logit tolerance of the reference's and its greedy tokens equal where
    the reference's margin decides them; the split serves other logits
    than the uniform policy."""
    from dataclasses import replace

    import jax
    from repro.configs import get_config as r_get_config
    from repro.core.approx import ApproxConfig as RApprox
    from repro.core.approx import serving_segments as r_segments
    from repro.models import build as r_build
    from repro.tuning.select import TuningPolicy as RPolicy
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core.approx import ApproxConfig as TApprox
    from repro_torch.core.approx import serving_segments
    from repro_torch.models.convert import params_from_reference
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    path = str(tmp_path / "split.json")
    TuningPolicy(entries=tuple(PolicyEntry(**e)
                               for e in SPLIT_ENTRIES)).save(path)
    r_approx = RApprox(mode="simdive", use_in_softmax=True,
                       policy=RPolicy.load(path))
    t_approx = TApprox(mode="simdive", use_in_softmax=True,
                       policy=TuningPolicy.load(path))
    r_cfg = replace(r_get_config(ARCH, smoke=True),
                    dtype="float32").with_approx(r_approx)
    t_cfg = replace(t_get_config(ARCH, smoke=True),
                    dtype="float32").with_approx(t_approx)
    segs = serving_segments(t_approx, t_cfg.n_layers)
    assert [(lo, hi) for lo, hi, _ in segs] == [(0, 1), (1, t_cfg.n_layers)]
    assert [(lo, hi) for lo, hi, _ in segs] == \
        [(lo, hi) for lo, hi, _ in r_segments(r_approx, r_cfg.n_layers)]
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    t_lm = build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg, device="cpu")
    prompts = _prompts(r_cfg.vocab_size)
    want_tok = np.asarray(r_serve.generate(
        r_lm, r_params, jnp.asarray(prompts, jnp.int32), P + GEN, GEN))
    want_logits = _reference_logits(r_lm, r_params, prompts, GEN)
    got_tok, got_logits = serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    got_tok, got_logits = got_tok.numpy(), got_logits.numpy()
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * SIMDIVE_LOGIT_TOL
    for b in range(B):
        for i in range(GEN):
            np.testing.assert_allclose(got_logits[b, i], want_logits[b, i],
                                       rtol=0, atol=SIMDIVE_LOGIT_TOL)
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break
    assert decided.mean() > 0.5
    uniform = build(t_cfg.with_approx(replace(t_approx, policy=TuningPolicy(
        entries=(PolicyEntry(**SPLIT_ENTRIES[0]),)))), device="cpu")
    other = serve.generate(uniform, t_params, torch.from_numpy(prompts),
                           P + GEN, GEN, return_logits=True)[1]
    assert not np.array_equal(other.numpy(), got_logits)


def test_segment_tables_exist_before_the_capture(fake_capture):
    """Each segment's correction tables are made by the served prefill's
    warm run, never under its capture: a policy whose last segment reads
    a table nothing else has touched still finds it materialized when the
    capture starts (a graph holds table addresses), and the capture makes
    none."""
    from repro_torch.core.error_lut import materialized_tables
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    own = ("div", 16, 7, 4)                    # read by layer 1 alone
    pol = TuningPolicy(entries=(PolicyEntry(
        op="attention", width=16, coeff_bits=7, index_bits=4, layer="L1"),))
    lm0, params, prompts = _smoke(emulate=False)
    lm = build(serve.serving_config(ARCH, smoke=True, approx="simdive",
                                    policy=pol), device="cpu")

    def tables():
        return {k[:4] for k in materialized_tables()}

    assert own not in tables()
    seen = []

    def body():
        seen.append((fake_capture["capturing"], tables()))
        return lm.prefill(params, {"tokens": prompts})

    fn = serve._GraphFn(lm)
    fn._replay(serve._PrefillSlot(lm, B, P), params, body)
    (warm, before), (capturing, at_capture) = seen
    assert (warm, capturing) == (False, True)
    assert own not in before and own in at_capture
    assert tables() == at_capture and fn.captures == 1


def test_quantize_survives_policy_resolved_dispatch():
    """--quantize x --approx simdive --emulate under a policy: the int8
    weights feed the policy's 16-bit matmul lanes; finite logits, a
    plausible decode, and close to the quantized exact path."""
    from repro_torch.models.layers import QuantizedWeight
    from repro_torch.tuning import select as t_select

    pol = t_select.TuningPolicy(entries=_policy_entries(t_select))
    cfg = serve.serving_config(ARCH, smoke=True, emulate=True, policy=pol)
    lm = build(cfg, device="cpu")
    _, params, prompts = _smoke(emulate=False)
    qparams = serve.quantize_params(params)
    assert isinstance(qparams["stack"]["layers"]["wq"], QuantizedWeight)
    logits, _ = lm.prefill(qparams, {"tokens": prompts})
    assert bool(torch.isfinite(logits).all())
    toks = serve.generate(lm, qparams, prompts, P + GEN, GEN)
    assert toks.shape == (B, GEN)
    exact = build(serve.serving_config(ARCH, smoke=True), device="cpu")
    logits_e, _ = exact.prefill(qparams, {"tokens": prompts})
    rel = float((logits.float() - logits_e.float()).abs().mean()
                / (logits_e.float().abs().mean() + 1e-9))
    assert rel < 0.2


def test_quantize_refuses_narrow_lane_loudly():
    """A policy whose matmul lane cannot hold int8 magnitudes raises, with
    the reference's message, instead of truncating the weights."""
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    pol = TuningPolicy(entries=(PolicyEntry(op="matmul", width=4,
                                            coeff_bits=2, kernel="matmul"),))
    lm = build(serve.serving_config(ARCH, smoke=True, emulate=True,
                                    policy=pol), device="cpu")
    _, params, prompts = _smoke(emulate=False)
    with pytest.raises(ValueError, match="cannot hold int8"):
        lm.prefill(serve.quantize_params(params), {"tokens": prompts})


@pytest.mark.parametrize("width,coeff_bits,frac_out",
                         [(8, 0, 12), (8, 4, None), (16, 2, 12), (16, 6, 0)])
def test_policy_divider_equals_reference(width, coeff_bits, frac_out):
    """The attention divider at a policy entry's spec, on the same floats
    in both packages: the same quantized operands, the same integer
    divider, equal outputs (an unset or zero frac_out leaves the
    config's 15)."""
    from repro.core.approx import ApproxConfig as RApprox
    from repro.core.approx import attention_div as r_attention_div
    from repro.tuning import select as r_select
    from repro_torch.core.approx import ApproxConfig as TApprox
    from repro_torch.core.approx import attention_div
    from repro_torch.tuning import select as t_select

    rng = np.random.default_rng(width + coeff_bits)
    acc = (rng.standard_normal((2, 3, 50, 64)) * 3).astype(np.float32)
    l = rng.uniform(0.5, 40.0, (2, 3, 50)).astype(np.float32)
    kw = dict(op="attention", width=width, coeff_bits=coeff_bits,
              frac_out=frac_out, backend="ref", layer="L0")
    t_cfg = TApprox(mode="simdive", layer="L0", policy=t_select.TuningPolicy(
        entries=(t_select.PolicyEntry(**kw),)))
    r_cfg = RApprox(mode="simdive", layer="L0", policy=r_select.TuningPolicy(
        entries=(r_select.PolicyEntry(**kw),)))
    got = attention_div(torch.from_numpy(acc), torch.from_numpy(l), t_cfg)
    want = r_attention_div(jnp.asarray(acc), jnp.asarray(l), r_cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert t_cfg.resolve_attention()[2] == (frac_out or 15)
