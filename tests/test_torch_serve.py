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
