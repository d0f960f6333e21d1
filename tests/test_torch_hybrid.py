"""Port vs reference: the hybrid stack (``family hybrid``), zamba2-2.7b.

The Mamba2 half of ``models/ssm.py`` (the SSD chunk, the mix, the block)
is held to the reference's functions on numpy-seeded inputs; the smoke
model (4 Mamba2 layers in groups of 2, each group followed by the shared
attention block with its per-invocation LoRA on ``wq``) is served end to
end against the reference, both given the same parameters by
``params_from_reference``. The init's ``lora_b`` is zeros, which would add
exactly nothing to ``wq``: every comparison here replaces it, in both
trees, with a seeded non-zero draw (std r^-0.5), so that the merge is
exercised. The serving cache holds the recurrent carry and one K/V slab a
shared-block invocation: ``merge_cache`` walks it, the captured step
(driven with the stand-in CUDA graph) puts back the carry its warm run
moved, and the scheduler, ``insert_cache`` and ``adopt_cache`` refuse it,
as the reference's scheduler does. ``--quantize`` is refused before any
launch: the reference's prefill raises ``TypeError`` on the same tree.
"""
from dataclasses import asdict, replace
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core.approx import ApproxConfig as RApprox
from repro.launch import serve as r_serve
from repro.models import build as r_build
from repro.models import ssm as r_ssm
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels import get_op, launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.launch.scheduler import Scheduler
from repro_torch.models import build as t_build
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tr
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import LM
from test_torch_model import B, EMULATE_LOGIT_TOL, GEN, P, _prompts
from test_torch_serve import fake_capture  # noqa: F401  (a fixture)

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
# float32 Mamba2 mix / block: the same products summed in other orders
# (the einsum contractions, the cumsum, the conv's taps), through the gated
# norm; measured <= 6.0e-7 on outputs of magnitude ~2 (conv 3.6e-7, state
# 3.6e-7), bound ~10x
MIX_TOL = 5e-6
# the config's own bf16 activations: the projections' outputs and the mix
# output are bf16, so where the two sides' float32 sums straddle a bf16
# rounding point they part by one bf16 ulp: measured 6.1e-5 (one ulp of
# an output near 0.01) on outputs up to 2.2; bound one bf16 ulp (2^-8
# relative) of the largest output. The float32 state: measured 2.4e-7
BF16_MIX_REL_TOL = 2.0 ** -8
# the SSD chunk in float32, relative to its largest output: against the
# reference (measured <= 3.4e-7) and against itself in float64 (<= 1.4e-6
# at Tc 64), bound ~7x
SSD_REL_TOL = 1e-5
# the whole smoke stack in float32, prefill logits and cache leaves against
# the reference: measured <= 1.8e-6 (logits 1.3e-6, O(2) values), bound
# ~10x; the chunked prefill against the same tokens one decode step at a
# time: measured <= 1.3e-6
STACK_TOL = 2e-5
# divider-only serving: on top of that, round-off may move a 16-bit
# divider operand by one unit in a shared-block invocation (as
# test_torch_model's SIMDIVE_LOGIT_TOL, whose value this is)
SIMDIVE_LOGIT_TOL = 5e-4
# the mix's cases: (T, chunk, nonzero carry)
MIX_CASES = {"aligned": (32, 16, False), "ragged": (37, 16, False),
             "one token, nonzero carry": (1, 1, True)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _with_lora_b(tree, seed=11):
    """``tree`` (numpy leaves) with ``stack.lora_b`` a seeded normal draw
    of std r^-0.5, in place of the init's zeros."""
    lb = tree["stack"]["lora_b"]
    assert not lb.any()
    rng = np.random.default_rng(seed)
    new = (rng.standard_normal(lb.shape) * lb.shape[1] ** -0.5
           ).astype(np.float32)
    return {**tree, "stack": {**tree["stack"], "lora_b": new}}


@lru_cache(maxsize=None)
def _pair(mode="exact", emulate=False, dtype="float32", use_in_norm=False):
    """Both smoke models and their parameters (the reference's init, with
    the seeded ``lora_b``); built once per case for the module."""
    r_cfg = replace(r_get_config(ARCH, smoke=True), dtype=dtype)
    t_cfg = replace(t_get_config(ARCH, smoke=True), dtype=dtype)
    if mode != "exact":
        kw = dict(mode=mode, emulate=emulate, use_in_norm=use_in_norm)
        r_cfg = r_cfg.with_approx(RApprox(**kw))
        t_cfg = t_cfg.with_approx(TApprox(**kw))
    r_lm = r_build(r_cfg)
    tree = _with_lora_b(jax.tree.map(np.asarray, r_lm.init(
        jax.random.PRNGKey(0))))
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(tree, t_cfg, device="cpu")
    return (r_cfg, r_lm, jax.tree.map(jnp.asarray, tree), t_cfg, t_lm,
            t_params)


def _layer0():
    _, _, r_params, t_cfg, _, t_params = _pair()
    r_p = jax.tree.map(lambda a: a[0], r_params["stack"]["layers"])
    t_p = t_tr.layer_params(t_params["stack"]["layers"], 0)
    return r_p, t_p, t_cfg


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ------------------------------------------------------------- the config --
@pytest.mark.parametrize("smoke", [False, True])
def test_zamba2_config_equals_reference_field_for_field(smoke):
    r_cfg = asdict(r_get_config(ARCH, smoke=smoke))
    t_cfg = asdict(t_get_config(ARCH, smoke=smoke))
    r_approx, t_approx = r_cfg.pop("approx"), t_cfg.pop("approx")
    assert t_cfg == r_cfg
    assert (r_approx.pop("backend"), t_approx.pop("backend")) == ("ref", "auto")
    assert t_approx == r_approx
    assert (t_cfg["family"], t_cfg["ssm"]) == ("hybrid", "mamba2")


# ------------------------------------------------------------------ layers --
@pytest.mark.parametrize("Tc", [1, 16, 64])
def test_ssd_chunk_matches_reference_and_float64(Tc):
    """One chunk from a nonzero state, ``dt = softplus(normal)`` and
    ``A = -linspace(1, 16)``: the outputs and the new state against the
    reference's, and against the port's own chunk in float64."""
    rng = np.random.default_rng(Tc)
    Bs, H, N, Pd = 2, 4, 8, 16
    state = rng.standard_normal((Bs, H, N, Pd)).astype(np.float32)
    x = rng.standard_normal((Bs, Tc, H, Pd)).astype(np.float32)
    B_m, C_m = (rng.standard_normal((Bs, Tc, N)).astype(np.float32)
                for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((Bs, Tc, H)))
                  ).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    args = (state, x, B_m, C_m, dt, A)
    want = r_ssm._ssd_chunk(*map(jnp.asarray, args))
    got = t_ssm._ssd_chunk(*map(torch.from_numpy, args))
    f64 = t_ssm._ssd_chunk(*(torch.from_numpy(a).double() for a in args))
    for name, g, w, d in zip(("state", "y"), got, want, f64):
        w = _np(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert d.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=SSD_REL_TOL * np.abs(w).max(),
                                   err_msg=name)
        np.testing.assert_allclose(g.double().numpy(), d.numpy(), rtol=0,
                                   atol=SSD_REL_TOL * d.abs().max().item(),
                                   err_msg=name)
    assert not np.allclose(_np(want[0]), state)       # the state moved


def test_ssd_chunk_clamps_before_the_mask():
    """A decay so steep that ``c_t - c_s`` above the diagonal overflows
    ``exp``: the clamp at 0 comes before the mask, so no inf * 0 = NaN."""
    rng = np.random.default_rng(3)
    Tc, H = 16, 2
    state = torch.zeros((1, H, 4, 8))
    x = torch.from_numpy(rng.standard_normal((1, Tc, H, 8))
                         .astype(np.float32))
    Bm = torch.ones((1, Tc, 4))
    dt = torch.full((1, Tc, H), 10.0)
    A = torch.tensor([-16.0, -12.0])         # c_t - c_s up to 2,250 > 88
    s, y = t_ssm._ssd_chunk(state, x, Bm, Bm, dt, A)
    assert torch.isfinite(s).all() and torch.isfinite(y).all()


def _mix_inputs(case, D, N, H, Pd):
    T, chunk, carry = MIX_CASES[case]
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    conv = rng.standard_normal((B, t_ssm.CONV_K - 1, 2 * D + 2 * N))
    ssm = rng.standard_normal((B, H, N, Pd))
    if not carry:
        conv, ssm = conv * 0, ssm * 0
    return x, conv.astype(np.float32), ssm.astype(np.float32), chunk


@pytest.mark.parametrize("case", list(MIX_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_mix_matches_reference(case, dtype):
    """A T that fills its chunks, a ragged T (a tail of 5 padded with
    ``dt = 0`` steps) and one token from a nonzero carry (a decode step's
    chunk of one): the output, the new conv window and the new state,
    against the reference's, at float32 and at bf16 activations (the
    projections multiply in the block's dtype; the recurrence stays
    float32)."""
    r_p, t_p, cfg = _layer0()
    D, N, Pd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    H = 2 * D // Pd
    x, conv, ssm, chunk = _mix_inputs(case, D, N, H, Pd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = r_ssm.mamba2_mix(r_p, jnp.asarray(x, jdt), jnp.asarray(conv, jdt),
                            jnp.asarray(ssm), N, Pd, chunk)
    got = t_ssm.mamba2_mix(t_p, torch.from_numpy(x).to(tdt),
                           torch.from_numpy(conv).to(tdt),
                           torch.from_numpy(ssm), N, Pd, chunk)
    for name, g, w in zip(("y", "conv", "ssm"), got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert tuple(g.shape) == w.shape, name
        w = _np(w)
        tol = MIX_TOL
        if dtype == "bfloat16" and name != "ssm":
            tol = BF16_MIX_REL_TOL * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
    # the new conv window is the last CONV_K - 1 rows of (carry, x's)
    assert got[1].shape == (B, t_ssm.CONV_K - 1, 2 * D + 2 * N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_block_and_empty_carry_shapes_and_dtypes(dtype):
    """The carry's conv window takes the activation dtype, its state stays
    float32, as the reference's; the block returns a new carry, never the
    one it read, and on float32 the reference's values."""
    r_p, t_p, cfg = _layer0()
    D, N, Pd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    carry = t_ssm.mamba2_empty_carry(B, D, N, Pd, dtype, torch.device("cpu"))
    r_carry = r_ssm.mamba2_empty_carry(
        B, D, N, Pd, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    assert carry.keys() == r_carry.keys()
    for k, a in carry.items():
        assert tuple(a.shape) == r_carry[k].shape and not a.any(), k
        assert str(a.dtype).split(".")[-1] == str(r_carry[k].dtype), k
    x, conv, ssm, _ = _mix_inputs("one token, nonzero carry", D, N,
                                  2 * D // Pd, Pd)
    x = np.repeat(x, 9, axis=1)
    carry = {"conv": torch.from_numpy(conv).to(dtype),
             "ssm": torch.from_numpy(ssm)}
    y, new = t_ssm.mamba2_block(t_p, torch.from_numpy(x).to(dtype), carry,
                                N, Pd, cfg.ssm_chunk)
    assert y.dtype == dtype and y.shape == (B, 9, D)
    assert new["conv"].dtype == dtype and new["ssm"].dtype == torch.float32
    assert all(new[k] is not carry[k] for k in carry)
    assert all(new[k].shape == carry[k].shape for k in carry)
    if dtype == torch.float32:
        want_y, want = r_ssm.mamba2_block(
            r_p, jnp.asarray(x), {"conv": jnp.asarray(conv),
                                  "ssm": jnp.asarray(ssm)}, N, Pd,
            cfg.ssm_chunk)
        np.testing.assert_allclose(y.numpy(), _np(want_y), rtol=0,
                                   atol=MIX_TOL)
        for k in carry:
            np.testing.assert_allclose(new[k].numpy(), _np(want[k]), rtol=0,
                                       atol=MIX_TOL, err_msg=k)


# --------------------------------------------------------------- the stack --
@pytest.mark.parametrize("mode", ["exact", "simdive"])
def test_hybrid_prefill_matches_reference(mode):
    """The hybrid ``stack_prefill`` through ``LM.prefill`` (a ragged tail:
    16 + 5 tokens in chunks of 16): the logits and every cache leaf —
    ``k`` / ``v`` (one slab an invocation), the conv windows and the
    states — against the reference's, with the seeded ``lora_b`` merged
    into ``wq``; and the merge takes effect."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair(mode)
    T = t_cfg.ssm_chunk + 5
    toks = np.random.default_rng(4).integers(0, t_cfg.vocab_size, (B, T))
    logits, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(toks)})
    r_logits, r_cache = r_lm.prefill(r_params, {"tokens": jnp.asarray(toks)})
    tol = STACK_TOL if mode == "exact" else SIMDIVE_LOGIT_TOL
    np.testing.assert_allclose(logits.numpy(), _np(r_logits), rtol=0,
                               atol=tol)
    paths = [p for p, _ in t_serve.cache_leaves(cache)]
    assert paths == [("ssm", "conv"), ("ssm", "ssm"), ("k",), ("v",)]
    n_inv = t_cfg.n_layers // t_cfg.hybrid_period
    assert cache["k"].shape == (n_inv, B, T, t_cfg.n_kv_heads, t_cfg.d_head)
    for path, a in t_serve.cache_leaves(cache):
        want = _leaf(r_cache, path)
        assert tuple(a.shape) == want.shape, path
        np.testing.assert_allclose(a.numpy(), _np(want), rtol=0, atol=tol,
                                   err_msg=str(path))
    zero = {**t_params, "stack": {**t_params["stack"],
                                  "lora_b": t_params["stack"]["lora_b"] * 0}}
    plain, _ = t_lm.prefill(zero, {"tokens": torch.from_numpy(toks)})
    assert (plain - logits).abs().max() > 100 * tol


def test_chunked_prefill_equals_token_by_token_decode():
    """The prefill over 16 + 5 tokens against the same tokens fed one at a
    time through the decode step from a zero cache (each Mamba2 layer a
    chunk of one token, each invocation one K/V slot): the last logits
    and every cache leaf."""
    *_, t_cfg, t_lm, t_params = _pair()
    T = t_cfg.ssm_chunk + 5
    toks = np.random.default_rng(5).integers(0, t_cfg.vocab_size, (B, T))
    logits, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(toks)})
    stepped = t_lm.empty_cache(B, T)
    for i in range(T):
        step_logits, out = t_lm.decode_step(
            t_params, stepped, torch.from_numpy(toks[:, i]), i)
        assert out is stepped
    np.testing.assert_allclose(step_logits.numpy(), logits.numpy(), rtol=0,
                               atol=STACK_TOL)
    for (path, a), (_, b) in zip(t_serve.cache_leaves(cache),
                                 t_serve.cache_leaves(stepped)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=STACK_TOL, err_msg=str(path))


def _reference_run(r_lm, r_params, prompts):
    """The reference's generate loop: its tokens and each step's logits."""
    pj = jnp.asarray(prompts, jnp.int32)
    logits, cache = r_lm.prefill(r_params, {"tokens": pj})
    cache = r_serve.merge_cache(r_lm.empty_cache(B, P + GEN), cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, out = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, cache = r_lm.decode_step(r_params, cache, tok,
                                         jnp.int32(P + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        out.append(np.asarray(logits))
    return np.stack(toks, 1), np.stack(out, 1)


@pytest.mark.parametrize("emulate,tol", [(False, SIMDIVE_LOGIT_TOL),
                                         (True, EMULATE_LOGIT_TOL)],
                         ids=["divider-only", "emulate"])
def test_generate_matches_reference_token_for_token(emulate, tol):
    """``--approx simdive``, divider-only and ``--emulate`` (every linear
    of the Mamba2 layers and the shared block on the SIMDive matmul): the
    port's ``generate`` gives the reference's greedy tokens, every one,
    and its logits within the tolerance; and the approximation takes
    effect (against exact serving / the divider-only run)."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair("simdive", emulate)
    prompts = _prompts(t_cfg.vocab_size)
    want_tok, want_logits = _reference_run(r_lm, r_params, prompts)
    got_tok, got_logits = t_serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0,
                               atol=tol)
    base = _pair("simdive") if emulate else _pair("exact")
    base_logits = t_serve.generate(base[4], base[5],
                                   torch.from_numpy(prompts), P + GEN, GEN,
                                   return_logits=True)[1]
    assert (base_logits[:, 0] - got_logits[:, 0]).abs().max() > \
        10 * (SIMDIVE_LOGIT_TOL if emulate else 1e-4)


def test_emulated_linears_are_the_six_of_each_block(monkeypatch):
    """One emulated prefill sends each Mamba2 layer's six linears (wz, wx,
    wb, wc, wdt, out_proj) and each shared-block invocation's six (q with
    its merged LoRA, k, v, o, the gelu MLP's two) through the SIMDive
    matmul, all on the block's activation dtype (bf16 here): 6 x 4 + 6 x
    2 = 36 on the smoke model, 360 at full width."""
    from repro_torch.core import approx as t_approx

    seen = []
    real = t_approx.approx_matmul

    def spy(x, w, cfg):
        seen.append((tuple(w.shape), x.dtype))
        return real(x, w, cfg)

    monkeypatch.setattr("repro_torch.models.layers.approx_matmul", spy)
    cfg = t_serve.serving_config(ARCH, smoke=True, approx="simdive",
                                 emulate=True)
    lm = t_build(cfg, device="cpu")
    lm.prefill(lm.init(0), {"tokens": torch.from_numpy(
        _prompts(cfg.vocab_size))})
    D, N, Pd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    HD, bf16 = cfg.n_heads * cfg.d_head, torch.bfloat16
    mamba = [((D, 2 * D), bf16), ((D, 2 * D), bf16), ((D, N), bf16),
             ((D, N), bf16), ((D, 2 * D // Pd), bf16), ((2 * D, D), bf16)]
    shared = [((D, HD), bf16)] * 3 + [((HD, D), bf16), ((D, cfg.d_ff), bf16),
                                      ((cfg.d_ff, D), bf16)]
    group = mamba * cfg.hybrid_period + shared
    assert seen == group * (cfg.n_layers // cfg.hybrid_period)
    full = t_get_config(ARCH)
    assert (6 * full.n_layers + 6 * (full.n_layers // full.hybrid_period)
            == 360)


def test_use_in_norm_reaches_the_shared_block_alone(monkeypatch):
    """``use_in_norm``: the shared block's two norms take
    ``approx_rmsnorm`` (one ``sqrt`` dispatch each, an invocation); the
    Mamba2 block norm and its gated norm stay the exact ``rmsnorm``, as
    in the reference."""
    from repro_torch.core import approx as ta

    ops = []

    def counting(op, *args, **kw):
        ops.append(op)
        return get_op(op, *args, **kw)

    monkeypatch.setattr(ta, "get_op", counting)
    *_, t_cfg, t_lm, t_params = _pair("simdive", use_in_norm=True)
    t_lm.prefill(t_params, {"tokens": torch.from_numpy(
        _prompts(t_cfg.vocab_size))})
    assert ops.count("sqrt") == 2 * (t_cfg.n_layers // t_cfg.hybrid_period)


# --------------------------------------------------------------- refusals --
def test_quantize_is_refused_where_the_reference_prefill_raises():
    """The reference's int8 tree makes its prefill raise ``TypeError``
    (``QuantizedWeight + la @ lb``); the port refuses the same request
    before any launch: ``quantize_params`` on a hybrid tree, the shared
    block's merge on an int8 ``wq``, and the CLI before any parameter."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair("simdive")
    q = r_serve.quantize_params(r_params)
    assert hasattr(q["stack"]["shared"]["wq"], "q")
    with pytest.raises(TypeError):
        r_lm.prefill(q, {"tokens": jnp.asarray(_prompts(t_cfg.vocab_size))})
    with pytest.raises(NotImplementedError, match="LoRA delta"):
        t_serve.quantize_params(t_params)
    ported = params_from_reference(jax.tree.map(np.asarray, q), t_cfg)
    with pytest.raises(NotImplementedError, match="int8 wq"):
        t_lm.prefill(ported, {"tokens": torch.from_numpy(
            _prompts(t_cfg.vocab_size))})
    with pytest.raises(NotImplementedError, match="--quantize"):
        t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--approx", "simdive", "--quantize"])
    assert not any(launch_counts().values())


def test_hybrid_config_checks_refuse_by_name():
    """``family hybrid`` is built only as the reference's stack: Mamba2
    groups of ``hybrid_period > 0`` layers, a whole number of them."""
    base = t_get_config(ARCH, smoke=True)
    for kw, name in ((dict(ssm="rwkv6"), "hybrid ssm 'rwkv6'"),
                     (dict(hybrid_period=0), "hybrid_period 0"),
                     (dict(n_layers=5), "n_layers 5 not a multiple")):
        with pytest.raises(NotImplementedError, match=name):
            t_build(replace(base, **kw), device="cpu").init(0)


def test_merge_cache_and_the_scheduler_helpers_on_the_hybrid_cache():
    """The prefill's cache merges into the serving cache in its own
    buffers: the carry leaves whole, K/V at the front of their seq axis
    (axis 2), the rest of it zero; a drifted leaf raises with its path;
    ``insert_cache``, ``adopt_cache`` and the scheduler refuse the
    recurrent cache, as the reference's scheduler refuses the family."""
    r_cfg, _, _, t_cfg, t_lm, t_params = _pair()
    _, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(
        _prompts(t_cfg.vocab_size))})
    full = t_lm.empty_cache(B, P + GEN)
    merged = t_serve.merge_cache(full, cache)
    leaves = dict(t_serve.cache_leaves(merged))
    for path, buf in t_serve.cache_leaves(full):
        assert leaves[path] is buf
        src = _leaf(cache, path)
        if path[0] == "ssm":
            assert torch.equal(buf, src), path
        else:
            assert torch.equal(buf[:, :, :P], src), path
            assert not buf[:, :, P:].any(), path
    drift = {**cache, "ssm": {**cache["ssm"],
                              "conv": cache["ssm"]["conv"][..., 1:]}}
    with pytest.raises(ValueError,
                       match=r"unmergeable cache leaf \['ssm'\]\['conv'\]"):
        t_serve.merge_cache(t_lm.empty_cache(B, P), drift)
    with pytest.raises(ValueError, match="recurrent cache"):
        t_serve.insert_cache(full, cache, [0, 1])
    with pytest.raises(ValueError, match="recurrent cache"):
        t_serve.make_decode_step(t_lm).adopt_cache(full)
    with pytest.raises(ValueError, match="family 'hybrid'"):
        Scheduler(t_cfg, device="cpu")
    from repro.launch.scheduler import Scheduler as RScheduler
    with pytest.raises(ValueError, match="family 'hybrid'"):
        RScheduler(r_cfg)


def test_captured_step_moves_the_carry_once(fake_capture):
    """The step's graph body under the capture machinery on the CPU (the
    stand-in graph runs the capture's Python, a replay only counts): the
    carry leaves — and only they, not K/V — are what the warm run's move
    is put back for, so the call equals one eager step in every leaf, in
    the slot's own buffers."""
    *_, t_cfg, t_lm, t_params = _pair("simdive")
    logits, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(
        _prompts(t_cfg.vocab_size))})
    tok = logits.argmax(-1)
    slot = t_serve._Slot(t_lm, B, P + GEN)
    t_serve.merge_cache(slot.cache, cache)
    assert [id(t) for t in slot.advanced()] == \
        [id(slot.cache["ssm"]["conv"]), id(slot.cache["ssm"]["ssm"])]
    want_logits, want = t_lm.decode_step(
        t_params, t_serve.merge_cache(t_lm.empty_cache(B, P + GEN), cache),
        tok, P)
    slot.tok.copy_(tok)
    slot.pos.fill_(P)
    fn = t_serve._GraphFn(t_lm)
    got_logits, out = fn._replay(slot, t_params, lambda: t_serve.decode_body(
        t_lm, t_params, slot.cache, slot.tok, slot.pos))
    assert fn.captures == 1 and slot.graph.replays == 1
    assert torch.equal(got_logits, want_logits)
    for (path, a), (_, b) in zip(t_serve.cache_leaves(out),
                                 t_serve.cache_leaves(want)):
        assert torch.equal(a, b), path
    for (_, a), (_, b) in zip(t_serve.cache_leaves(out),
                              t_serve.cache_leaves(slot.cache)):
        assert a is b


def test_zamba2_serve_cli_on_cpu(capsys, monkeypatch):
    """``serve --arch zamba2-2.7b --smoke --device cpu``, divider-only and
    ``--emulate``; ``--scheduler`` and ``--chaos`` refuse the family with
    the reference's ``ValueError``, and so does the reference's CLI; no
    kernel launches on the CPU."""
    from repro.launch.serve import main as r_main

    base = ["--arch", ARCH, "--smoke", "--approx", "simdive", "--batch",
            "2", "--prompt-len", "8", "--gen", "3"]
    for extra in ([], ["--emulate"]):
        t_serve.main(base + ["--device", "cpu"] + extra)
        assert "generated (2, 3) on cpu" in capsys.readouterr().out
    for drill in (["--scheduler"], ["--chaos"]):
        with pytest.raises(ValueError, match="attention-family cache, got "
                                             "family 'hybrid'"):
            t_serve.main(base + ["--device", "cpu"] + drill)
        monkeypatch.setattr("sys.argv", ["serve"] + base + drill)
        with pytest.raises(ValueError, match="family 'hybrid'"):
            r_main()
    assert not any(launch_counts().values())


# --------------------------------------------------------------- the tree --
def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_meta_init_at_full_width_has_the_reference_tree():
    """``LM.init`` on the meta device at zamba2-2.7b's full width: exactly
    the leaf paths and shapes of the reference's ``jax.eval_shape`` of its
    init, 2,398,421,920 parameters (9.59 GB in float32); the serving
    cache at batch 4 and 544 slots."""
    cfg = t_get_config(ARCH)
    lm = LM(cfg, torch.device("meta"))
    own = lm.init(torch.Generator())
    shapes = jax.eval_shape(r_build(r_get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: tuple(t.shape) for path, t in _flat(own)}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 2_398_421_920
    cache = {p: t.numel() * t.element_size()
             for p, t in t_serve.cache_leaves(lm.empty_cache(4, 544))}
    assert cache == {("ssm", "conv"): 54 * 4 * 3 * 5248 * 2,
                     ("ssm", "ssm"): 54 * 4 * 80 * 64 * 64 * 4,
                     ("k",): 6 * 4 * 544 * 32 * 80 * 2,
                     ("v",): 6 * 4 * 544 * 32 * 80 * 2}


def test_hybrid_init_distributions_match_reference():
    """The port's own init: the constants equal (unit gains and ``D``,
    zero biases and ``lora_b``, ``A_log = log(linspace(1, 16, H))``),
    every uniform leaf inside the reference's limit and reaching 90 % of
    it, with a spread within 15 % of the reference's."""
    r_cfg, r_lm, _, t_cfg, t_lm, _ = _pair()
    own = dict(_flat(t_lm.init(torch.Generator().manual_seed(3))))
    ref = dict(_flat(jax.tree.map(np.asarray,
                                  r_lm.init(jax.random.PRNGKey(0)))))
    assert own.keys() == ref.keys()
    leaves = [(("stack", "layers") + p, init)
              for p, _, init in t_tr._layer_leaves(t_cfg)]
    leaves += [(("stack",) + p, init)
               for p, _, init in t_tr.hybrid_leaves(t_cfg)]
    assert {p for p, _ in leaves} == {p for p in own if p[0] == "stack"}
    for path, init in leaves:
        got, want = own[path].numpy(), ref[path]
        if not isinstance(init, int):       # "ones", "zeros", A_log's
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=0,
                                       err_msg=str(path))
            continue
        lim = init ** -0.5
        for name, a in (("port", got), ("reference", want)):
            top = float(np.abs(a).max())
            assert 0.9 * lim <= top <= lim * (1 + 1e-6), (path, name, top)
        assert abs(got.std() / want.std() - 1) < 0.15, path


def test_params_from_reference_carries_and_refuses_hybrid_trees():
    """The reference's hybrid tree carries over (the shared block and the
    LoRA pairs under ``stack``); a leaf missing, extra or of another
    shape is refused with its path, and an attention config does not take
    the tree."""
    _, _, r_params, t_cfg, _, t_params = _pair()
    tree = jax.tree.map(np.asarray, r_params)
    assert torch.equal(t_params["stack"]["lora_b"],
                       torch.tensor(tree["stack"]["lora_b"]))
    stack = tree["stack"]
    drop = {k: v for k, v in stack.items() if k != "lora_a"}
    with pytest.raises(ValueError, match=r"missing \[\('stack', 'lora_a'\)\]"):
        params_from_reference({**tree, "stack": drop}, t_cfg)
    extra = {**stack, "lora_c": stack["lora_a"]}
    with pytest.raises(ValueError, match=r"unexpected \[\('stack', "
                                         r"'lora_c'\)\]"):
        params_from_reference({**tree, "stack": extra}, t_cfg)
    bad = {**stack, "shared": {**stack["shared"],
                               "wq": stack["shared"]["wq"][:, :-1]}}
    with pytest.raises(ValueError, match="leaf stack/shared/wq: shape"):
        params_from_reference({**tree, "stack": bad}, t_cfg)
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(tree, t_get_config("smollm-360m", smoke=True))
