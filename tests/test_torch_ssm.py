"""Port vs reference: the rwkv6 stack (``models/ssm.py``), rwkv6-1.6b.

The WKV chunk, the time mix, the channel mix and the block are held to the
reference's functions on numpy-seeded inputs; the smoke model is served
end to end against the reference with the helpers of ``test_torch_model``
(float32, the same init carried over by ``params_from_reference``), and
once at the config's own bf16 activations. The serving cache is the
recurrent carry, a nested dict with no seq axis: ``merge_cache`` walks it,
the captured step (driven here with the stand-in CUDA graph) updates it in
place, and the scheduler, which needs a per-slot seq axis, refuses it as
the reference's does.
"""
from dataclasses import asdict

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
from repro.tuning.select import TuningPolicy as RPolicy
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.launch.scheduler import Scheduler
from repro_torch.models import build as t_build
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import QuantizedWeight
from repro_torch.models.model import LM
from repro_torch.tuning import PolicyEntry, TuningPolicy
from test_torch_model import (B, EMULATE_LOGIT_TOL, EXACT_LOGIT_TOL, GEN, P,
                              RWKV6_LINEARS, SIMDIVE_LOGIT_TOL,
                              _check_generate, _pair, _prompts,
                              _reference_logits)
from test_torch_serve import fake_capture  # noqa: F401  (a fixture)

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
# float32 WKV: both sides take log / cumsum / exp of the same float32
# decays and sum the same products in other orders (einsum contractions,
# cumsum); measured <= 1.5e-6 of the output's largest magnitude at Tc 64
# (state 7e-7), bound ~6x that, relative to that magnitude
WKV_REL_TOL = 1e-5
# a time / channel mix or a block on float32 activations: the WKV's
# round-off plus the linears' (the same products in another order), taken
# through an RMSNorm and the gates; measured <= 1.9e-6 (the time mix's
# state; its output 3.6e-7, a block's 4.5e-7), bound ~10x
MIX_TOL = 2e-5
# the chunked prefill against the same tokens one at a time through the
# decode step (chunks of 1): the same recurrence in another grouping of
# float32 sums; measured <= 3.8e-6 on the smoke state, 1.3e-6 on logits,
# bound ~5x
CHUNK_VS_STEP_TOL = 2e-5
# the config's own bf16 activations: both sides round the embeddings, the
# residual stream, the norms' outputs and the output projection's inputs
# to bf16, so where the two sides' float32 values straddle a bf16 rounding
# point they part by one bf16 ulp (2^-8 relative), which two layers and
# the head carry into the logits, themselves rounded to bf16: measured
# 0.015625, one bf16 ulp of a logit in [2, 4) (the largest is 2.16);
# bound 4 such ulps
BF16_LOGIT_TOL = 4 * 2.0 ** -6
# the WKV's partial chunks: a tail of T % Tc tokens padded to a whole chunk
TIME_MIX_T, TIME_MIX_CHUNK = 37, 16


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _layer0(arch=ARCH):
    """Layer 0's parameters of the smoke model in both packages (the same
    values, float32)."""
    _, _, r_params, _, _, t_params = _pair("exact", arch=arch)
    r_p = jax.tree.map(lambda a: a[0], r_params["stack"]["layers"])
    t_p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
               else v[0]) for k, v in t_params["stack"]["layers"].items()}
    return r_p, t_p


# ------------------------------------------------------------- the config --
@pytest.mark.parametrize("smoke", [False, True])
def test_rwkv6_config_equals_reference_field_for_field(smoke):
    r_cfg = asdict(r_get_config(ARCH, smoke=smoke))
    t_cfg = asdict(t_get_config(ARCH, smoke=smoke))
    r_approx, t_approx = r_cfg.pop("approx"), t_cfg.pop("approx")
    assert t_cfg == r_cfg
    assert (r_approx.pop("backend"), t_approx.pop("backend")) == ("ref", "auto")
    assert t_approx == r_approx
    assert t_cfg["family"] == "ssm" and t_cfg["ssm"] == "rwkv6"


# ------------------------------------------------------------------ layers --
@pytest.mark.parametrize("Tc", [1, 16, 64])
def test_wkv_chunk_matches_reference(Tc):
    """One chunk from a nonzero state, decays spread over (0.19, 0.9975)
    (``exp(-exp(u))``, u in (-6, 0.5)): the outputs and the new state."""
    rng = np.random.default_rng(Tc)
    H, dk = 4, 16
    state = rng.standard_normal((B, H, dk, dk)).astype(np.float32)
    r, k, v = (rng.standard_normal((B, Tc, H, dk)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, 0.5, (B, Tc, H, dk)))
               ).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, (H, dk)).astype(np.float32)
    args = (state, r, k, v, w, u)
    want = r_ssm._wkv_chunk(*map(jnp.asarray, args))
    got = t_ssm._wkv_chunk(*map(torch.from_numpy, args))
    for name, g, ww in zip(("state", "y"), got, want):
        ww = _np(ww)
        assert g.dtype == torch.float32 and g.shape == ww.shape, name
        np.testing.assert_allclose(g.numpy(), ww, rtol=0,
                                   atol=WKV_REL_TOL * np.abs(ww).max(),
                                   err_msg=name)
    assert not np.allclose(_np(want[0]), state)       # the state moved


def _mix_inputs(rng, T, D, H):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    x_prev = rng.standard_normal((B, D)).astype(np.float32)
    state = rng.standard_normal((B, H, D // H, D // H)).astype(np.float32)
    return x, x_prev, state


def test_time_mix_pads_the_last_chunk_and_matches_reference():
    """A nonzero token shift and state, and T = 37 in chunks of 16: two
    whole chunks and a tail of 5 padded with identity steps. The output,
    the new token shift and the new state, against the reference's; and
    the tail's padding leaves the state where whole chunks of 37 put it."""
    r_p, t_p = _layer0()
    cfg = t_get_config(ARCH, smoke=True)
    H = cfg.d_model // cfg.d_head
    x, x_prev, state = _mix_inputs(np.random.default_rng(1), TIME_MIX_T,
                                   cfg.d_model, H)
    want = r_ssm.rwkv6_time_mix(r_p, jnp.asarray(x), jnp.asarray(x_prev),
                                jnp.asarray(state), H, TIME_MIX_CHUNK)
    got = t_ssm.rwkv6_time_mix(t_p, torch.from_numpy(x),
                               torch.from_numpy(x_prev),
                               torch.from_numpy(state), H, TIME_MIX_CHUNK)
    for name, g, ww in zip(("y", "x_prev", "state"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(ww), rtol=0, atol=MIX_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[1].numpy(), x[:, -1])
    whole = t_ssm.rwkv6_time_mix(t_p, torch.from_numpy(x),
                                 torch.from_numpy(x_prev),
                                 torch.from_numpy(state), H, TIME_MIX_T)
    for g, ww in zip(got, whole):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=0,
                                   atol=CHUNK_VS_STEP_TOL)


def test_channel_mix_matches_reference():
    r_p, t_p = _layer0()
    cfg = t_get_config(ARCH, smoke=True)
    x, x_prev, _ = _mix_inputs(np.random.default_rng(2), 9, cfg.d_model, 4)
    want = r_ssm.rwkv6_channel_mix(r_p, jnp.asarray(x), jnp.asarray(x_prev))
    got = t_ssm.rwkv6_channel_mix(t_p, torch.from_numpy(x),
                                  torch.from_numpy(x_prev))
    for name, g, ww in zip(("y", "x_prev"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(ww), rtol=0, atol=MIX_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_and_empty_carry_shapes_and_dtypes(dtype):
    """The carry's token shifts take the activation dtype, its state stays
    float32, as the reference's; the block returns a new carry (never the
    one it read) and, on float32 activations, the reference's values."""
    r_p, t_p = _layer0()
    cfg = t_get_config(ARCH, smoke=True)
    D, H = cfg.d_model, cfg.d_model // cfg.d_head
    carry = t_ssm.rwkv6_empty_carry(B, D, H, dtype, torch.device("cpu"))
    r_carry = r_ssm.rwkv6_empty_carry(
        B, D, H, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    assert carry.keys() == r_carry.keys()
    for k, a in carry.items():
        assert tuple(a.shape) == r_carry[k].shape and not a.any(), k
        assert str(a.dtype).split(".")[-1] == str(r_carry[k].dtype), k
    x, x_prev, state = _mix_inputs(np.random.default_rng(3), 11, D, H)
    carry = {"att_x": torch.from_numpy(x_prev).to(dtype),
             "ffn_x": torch.from_numpy(-x_prev).to(dtype),
             "state": torch.from_numpy(state)}
    y, new = t_ssm.rwkv6_block(t_p, torch.from_numpy(x).to(dtype), carry, H,
                               cfg.ssm_chunk)
    assert y.dtype == dtype and y.shape == (B, 11, D)
    assert new["att_x"].dtype == new["ffn_x"].dtype == dtype
    assert new["state"].dtype == torch.float32
    assert all(new[k] is not carry[k] for k in carry)
    assert all(tuple(new[k].shape) == tuple(carry[k].shape) for k in carry)
    if dtype == torch.float32:
        want_y, want = r_ssm.rwkv6_block(
            r_p, jnp.asarray(x), jax.tree.map(lambda t: jnp.asarray(
                t.numpy()), carry), H, cfg.ssm_chunk)
        np.testing.assert_allclose(y.numpy(), _np(want_y), rtol=0,
                                   atol=MIX_TOL)
        for k in carry:
            np.testing.assert_allclose(new[k].numpy(), _np(want[k]), rtol=0,
                                       atol=MIX_TOL, err_msg=k)


def test_chunked_prefill_equals_token_by_token_decode():
    """The prefill's recurrent cache (chunks of 16 over 16 + 5 tokens: a
    padded tail) and last logits against the same tokens fed one at a time
    through the decode step from a zero cache; and both against the
    reference's prefill."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair("exact", arch=ARCH)
    T = t_cfg.ssm_chunk + 5
    toks = np.random.default_rng(4).integers(0, t_cfg.vocab_size, (B, T))
    logits, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(toks)})
    step_cache = t_lm.empty_cache(B, T)
    for i in range(T):
        step_logits, out = t_lm.decode_step(
            t_params, step_cache, torch.from_numpy(toks[:, i]), i)
        assert out is step_cache
    np.testing.assert_allclose(step_logits.numpy(), logits.numpy(), rtol=0,
                               atol=CHUNK_VS_STEP_TOL)
    r_logits, r_cache = r_lm.prefill(r_params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), _np(r_logits), rtol=0,
                               atol=EXACT_LOGIT_TOL)
    for k, a in cache["ssm"].items():
        np.testing.assert_allclose(step_cache["ssm"][k].numpy(), a.numpy(),
                                   rtol=0, atol=CHUNK_VS_STEP_TOL, err_msg=k)
        np.testing.assert_allclose(a.numpy(), _np(r_cache["ssm"][k]), rtol=0,
                                   atol=MIX_TOL, err_msg=k)


# --------------------------------------------------- the model, end to end --
@pytest.mark.parametrize("mode,quantize", [("exact", False),
                                           ("simdive", False),
                                           ("simdive", True)])
def test_rwkv6_smoke_generate_matches_reference(mode, quantize):
    """Exact, ``--approx simdive`` and ``--quantize`` (the reference's int8
    weights, dequantized): the reference's logits and decided tokens."""
    _check_generate(mode, EXACT_LOGIT_TOL, quantize=quantize, arch=ARCH)


def test_rwkv6_simdive_is_exact_serving_with_no_simdive_op(monkeypatch):
    """No softmax and a plain sigmoid gate: ``--approx simdive`` without
    ``--emulate`` dispatches no SIMDive op, and its logits are exact
    serving's, bit for bit."""
    from repro_torch.core import approx as t_approx
    from repro_torch.models import layers as t_layers

    ops = []

    def counting(op, *args, **kw):
        ops.append(op)
        raise AssertionError(f"a SIMDive op dispatched: {op}")

    monkeypatch.setattr(t_approx, "get_op", counting)
    monkeypatch.setattr(t_layers, "get_op", counting)
    prompts = torch.from_numpy(_prompts(t_get_config(ARCH, True).vocab_size))
    runs = {}
    for mode in ("exact", "simdive"):
        *_, t_cfg, t_lm, t_params = _pair(mode, arch=ARCH)
        runs[mode] = t_serve.generate(t_lm, t_params, prompts, P + GEN, GEN,
                                      return_logits=True)
    assert not ops
    assert torch.equal(runs["simdive"][0], runs["exact"][0])
    assert torch.equal(runs["simdive"][1], runs["exact"][1])
    assert not any(launch_counts().values())


@pytest.mark.parametrize("mode,quantize", [("simdive", False),
                                           ("mitchell", False),
                                           ("simdive", True)])
def test_rwkv6_smoke_generate_emulated_matches_reference(mode, quantize):
    """``--emulate [--quantize]``: the eight linears of each layer on the
    SIMDive matmul, seven of them on float32 activations; every linear,
    fed the same float32 activations, equal to the reference's to
    round-off (``_check_linears``)."""
    _check_generate(mode, EMULATE_LOGIT_TOL, emulate=True, quantize=quantize,
                    arch=ARCH)


def test_rwkv6_linears_are_the_eight_and_f32_where_the_reference_is(
        monkeypatch):
    """One emulated prefill sends each layer's eight linears through the
    SIMDive matmul: the time mix's r / k / v / g and the channel mix's
    three on float32 activations (the token-shift mix is float32), the
    output projection on the activation dtype, bf16 here."""
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
    D, Fd = cfg.d_model, cfg.d_ff
    f32, bf16 = torch.float32, torch.bfloat16
    layer = [((D, D), f32)] * 4 + [((D, D), bf16), ((D, Fd), f32),
                                   ((D, D), f32), ((Fd, D), f32)]
    assert seen == layer * cfg.n_layers
    assert len(layer) == len(RWKV6_LINEARS)


def _bf16_pair():
    r_cfg = r_get_config(ARCH, smoke=True)
    t_cfg = t_get_config(ARCH, smoke=True)
    assert r_cfg.dtype == t_cfg.dtype == "bfloat16"
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg, device="cpu")
    return r_lm, r_params, t_lm, t_params


def test_rwkv6_bf16_generate_matches_reference():
    """The config's own bf16 activations (the served dtype): the linears
    but ``wo`` still multiply in float32, the residual stream and the
    token shifts are bf16. Logits within BF16_LOGIT_TOL of the
    reference's, decided tokens equal, the carry's dtypes the
    reference's."""
    r_lm, r_params, t_lm, t_params = _bf16_pair()
    prompts = _prompts(t_lm.cfg.vocab_size)
    want_logits = _reference_logits(r_lm, r_params, prompts, GEN)
    want_tok = np.asarray(r_serve.generate(
        r_lm, r_params, jnp.asarray(prompts, jnp.int32), P + GEN, GEN))
    got_tok, got_logits = t_serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    got_tok, got_logits = got_tok.numpy(), got_logits.numpy()
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    rows = np.abs(got_logits - want_logits).max(-1)
    # as _check_generate: a row within its own difference of the
    # reference's in every logit decides the token where the margin
    # exceeds twice that difference
    decided = (top2[..., 1] - top2[..., 0]) > 2 * np.minimum(
        rows, BF16_LOGIT_TOL)
    for b in range(B):
        for i in range(GEN):
            np.testing.assert_allclose(got_logits[b, i], want_logits[b, i],
                                       rtol=0, atol=BF16_LOGIT_TOL)
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break
    assert decided.mean() > 0.5
    _, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(prompts)})
    _, r_cache = r_lm.prefill(r_params, {"tokens": jnp.asarray(prompts)})
    for k, a in cache["ssm"].items():
        assert str(a.dtype).split(".")[-1] == str(r_cache["ssm"][k].dtype)


def test_use_in_norm_and_policy_segments_change_nothing_as_in_reference():
    """The rwkv6 stack's norms are the exact ``rmsnorm`` under
    ``use_in_norm``, and it runs ``cfg.approx`` whole, with no layer
    label, as the reference does: ``use_in_norm`` leaves the logits at
    the reference's (exact serving's, bit for bit), and a policy whose
    layer-1 matmul entry would split the stack into two segments serves
    its global entry on every layer in both packages."""
    _check_generate("simdive", SIMDIVE_LOGIT_TOL, arch=ARCH, use_in_norm=True)
    prompts = _prompts(t_get_config(ARCH, True).vocab_size)
    pt = torch.from_numpy(prompts)

    def port_logits(t_cfg, t_lm, t_params):
        return t_serve.generate(t_lm, t_params, pt, P + GEN, GEN,
                                return_logits=True)[1]

    assert torch.equal(port_logits(*_pair("simdive", arch=ARCH,
                                          use_in_norm=True)[3:]),
                       port_logits(*_pair("exact", arch=ARCH)[3:]))

    entries = (dict(op="matmul", width=8, coeff_bits=6),
               dict(op="matmul", width=8, coeff_bits=2, layer="L1"))
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair("exact", arch=ARCH)
    got, want = {}, {}
    for name, es in (("split", entries), ("global", entries[:1])):
        t_pol = TuningPolicy(entries=tuple(PolicyEntry(**e) for e in es))
        r_pol = RPolicy.from_json(t_pol.to_json())
        t_c = t_cfg.with_approx(TApprox(mode="simdive", policy=t_pol))
        r_c = r_cfg.with_approx(RApprox(mode="simdive", policy=r_pol))
        got[name] = port_logits(t_c, t_build(t_c, device="cpu"), t_params)
        want[name] = _reference_logits(r_build(r_c), r_params, prompts, GEN)
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=EMULATE_LOGIT_TOL)
    assert torch.equal(got["split"], got["global"])
    np.testing.assert_array_equal(want["split"], want["global"])
    assert not torch.equal(got["split"], port_logits(t_cfg, t_lm, t_params))


# --------------------------------------------------------------- the tree --
def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_meta_init_at_full_width_has_the_reference_tree():
    """``LM.init`` on the meta device at rwkv6-1.6b's full width: exactly
    the leaf paths and shapes of the reference's ``jax.eval_shape`` of its
    init, 1,599,719,424 parameters."""
    cfg = t_get_config(ARCH)
    own = LM(cfg, torch.device("meta")).init(torch.Generator())
    r_lm = r_build(r_get_config(ARCH))
    shapes = jax.eval_shape(r_lm.init, jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: tuple(t.shape) for path, t in _flat(own)}
    assert got == want
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for _, t in _flat(own))
    assert sum(int(np.prod(s)) for s in got.values()) == 1_599_719_424


def test_rwkv6_init_distributions_match_reference():
    """The port's own init draws each leaf as the reference does: the
    constants equal (unit gains, ``mu_base`` 0.5, ``w0`` -6), every
    uniform leaf inside the same limit as the reference's and reaching
    90 % of it, with a spread within 15 % of the reference's."""
    _, _, r_params, t_cfg, t_lm, _ = _pair("exact", arch=ARCH)
    own = dict(_flat(t_lm.init(torch.Generator().manual_seed(3))))
    ref = dict(_flat(jax.tree.map(np.asarray, r_params)))
    assert own.keys() == ref.keys()
    D = t_cfg.d_model
    leaves = {("stack", "layers") + path: init for path, _, init in
              t_ssm.rwkv6_leaves(D, D // t_cfg.d_head, t_cfg.d_ff)}
    for path, init in leaves.items():
        got, want = own[path].numpy(), ref[path]
        if init == "ones" or (isinstance(init, tuple) and init[0] == "full"):
            np.testing.assert_array_equal(got, want, err_msg=str(path))
            continue
        lim = init[1] if isinstance(init, tuple) else init ** -0.5
        for name, a in (("port", got), ("reference", want)):
            top = float(np.abs(a).max())
            assert 0.9 * lim <= top <= lim * (1 + 1e-6), (path, name, top)
        assert abs(got.std() / want.std() - 1) < 0.15, path


def test_params_from_reference_carries_and_refuses_rwkv6_trees():
    """The reference's rwkv6 tree carries over, its int8 linears as
    ``QuantizedWeight``s (the eight linears and the head; the LoRA and mu
    leaves stay float); a leaf missing, extra or of another shape is
    refused with its path."""
    _, _, r_params, t_cfg, _, _ = _pair("exact", arch=ARCH)
    tree = jax.tree.map(np.asarray, r_params)
    layers = tree["stack"]["layers"]
    drop = {k: v for k, v in layers.items() if k != "u_bonus"}
    with pytest.raises(ValueError, match=r"missing \[\('stack', 'layers', "
                                         r"'u_bonus'\)\]"):
        params_from_reference({**tree, "stack": {"layers": drop}}, t_cfg)
    extra = {**layers, "ln0": {"w": layers["ln1"]["w"]}}
    with pytest.raises(ValueError, match=r"unexpected \[\('stack', "
                                         r"'layers', 'ln0', 'w'\)\]"):
        params_from_reference({**tree, "stack": {"layers": extra}}, t_cfg)
    bad = {**layers, "ln_x": {"w": layers["ln_x"]["w"][:, :-1]}}
    with pytest.raises(ValueError, match="leaf stack/layers/ln_x/w: shape"):
        params_from_reference({**tree, "stack": {"layers": bad}}, t_cfg)
    # an attention config does not take the rwkv6 tree, nor the reverse
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(tree, t_get_config("smollm-360m", smoke=True))
    q = r_serve.quantize_params(r_params)
    ported = params_from_reference(jax.tree.map(np.asarray, q), t_cfg)
    layers = ported["stack"]["layers"]
    for name in RWKV6_LINEARS:
        assert isinstance(layers[name], QuantizedWeight), name
        assert layers[name].q.dtype == torch.int8
    assert isinstance(ported["head"], QuantizedWeight)
    for name in ("mu", "ts_a", "ts_b", "wd_a", "wd_b", "u_bonus", "cm_mu"):
        assert layers[name].dtype == torch.float32, name
    local = t_serve.quantize_params(params_from_reference(tree, t_cfg))
    assert {p for p, v in _flat(local) if isinstance(v, QuantizedWeight)} \
        == {p for p, v in _flat(ported) if isinstance(v, QuantizedWeight)}


# ------------------------------------------------------------ the serving --
def test_merge_cache_walks_the_recurrent_cache_in_place():
    """The prefill's carry merges into the serving cache leaf for leaf, in
    the serving cache's own buffers (the step writes them in place); a
    drifted leaf raises with its path, a drifted tree with its keys."""
    *_, t_cfg, t_lm, t_params = _pair("exact", arch=ARCH)
    _, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(
        _prompts(t_cfg.vocab_size))})
    full = t_lm.empty_cache(B, P + GEN)
    merged = t_serve.merge_cache(full, cache)
    leaves = dict(t_serve.cache_leaves(merged))
    assert list(leaves) == [("ssm", "att_x"), ("ssm", "ffn_x"),
                            ("ssm", "state")]
    for path, buf in t_serve.cache_leaves(full):
        assert leaves[path] is buf
        assert torch.equal(buf, cache[path[0]][path[1]])
    H = t_cfg.d_model // t_cfg.d_head
    assert leaves[("ssm", "state")].shape == (t_cfg.n_layers, B, H,
                                              t_cfg.d_head, t_cfg.d_head)
    with pytest.raises(ValueError,
                       match=r"unmergeable cache leaf \['ssm'\]\['att_x'\]"):
        t_serve.merge_cache(t_lm.empty_cache(B + 1, P), cache)
    drift = {"ssm": {**cache["ssm"], "state": cache["ssm"]["state"][..., 1:]}}
    with pytest.raises(ValueError,
                       match=r"unmergeable cache leaf \['ssm'\]\['state'\]"):
        t_serve.merge_cache(t_lm.empty_cache(B, P), drift)
    short = {"ssm": {k: v for k, v in cache["ssm"].items() if k != "ffn_x"}}
    with pytest.raises(ValueError, match=r"at \['ssm'\].*do not match"):
        t_serve.merge_cache(t_lm.empty_cache(B, P), short)
    kv = _pair("exact")[4].empty_cache(B, P)
    with pytest.raises(ValueError, match="do not match"):
        t_serve.merge_cache(kv, cache)
    # the scheduler's helpers serve the attention family alone
    with pytest.raises(ValueError, match="recurrent cache"):
        t_serve.insert_cache(full, cache, [0, 1])
    with pytest.raises(ValueError, match="recurrent cache"):
        t_serve.make_decode_step(t_lm).adopt_cache(full)


def test_captured_step_updates_the_recurrent_cache_once(fake_capture):
    """The body the step's graph captures, run under the capture machinery
    on the CPU (the stand-in graph runs the capture's Python, a replay
    only counts): the warm run's move of the state is put back, so the
    call equals one eager step — its logits, and every cache leaf, written
    in the slot's own buffers. The slot owns its tree leaf by leaf; the
    served step zeroes its nested cache."""
    *_, t_cfg, t_lm, t_params = _pair("simdive", arch=ARCH)
    logits, cache = t_lm.prefill(t_params, {"tokens": torch.from_numpy(
        _prompts(t_cfg.vocab_size))})
    tok = logits.argmax(-1)
    slot = t_serve._Slot(t_lm, B, P + GEN)
    t_serve.merge_cache(slot.cache, cache)
    assert slot.owns(t_serve._copy_tree(slot.cache))
    swapped = t_serve._copy_tree(slot.cache)
    swapped["ssm"]["state"] = swapped["ssm"]["state"].clone()
    assert not slot.owns(swapped) and not slot.owns(cache)
    assert [id(t) for t in slot.advanced()] == \
        [id(t) for _, t in t_serve.cache_leaves(slot.cache)]
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
    # without the put-back the capture would have moved the state twice
    twice, _ = t_lm.decode_step(
        t_params, {"ssm": {k: v.clone() for k, v in want["ssm"].items()}},
        tok, P)
    assert not torch.equal(twice, want_logits)
    step = t_serve.DecodeStep(t_lm)
    zeroed = step.empty_cache(B, P + GEN)
    assert not any(t.any() for _, t in t_serve.cache_leaves(zeroed))


def test_rwkv6_serve_cli_on_cpu_and_refused_drills(capsys, monkeypatch):
    """``serve --arch rwkv6-1.6b --smoke --device cpu`` with and without
    ``--emulate``; ``--scheduler`` and ``--chaos`` refuse the family with
    the reference's ``ValueError``, and so does the reference's CLI."""
    from repro.launch.serve import main as r_main

    base = ["--arch", ARCH, "--smoke", "--approx", "simdive", "--batch",
            "2", "--prompt-len", "8", "--gen", "3"]
    for extra in ([], ["--emulate"], ["--emulate", "--quantize"]):
        t_serve.main(base + ["--device", "cpu"] + extra)
        assert "generated (2, 3) on cpu" in capsys.readouterr().out
    for drill in (["--scheduler"], ["--chaos"]):
        with pytest.raises(ValueError, match="attention-family cache, got "
                                             "family 'ssm'"):
            t_serve.main(base + ["--device", "cpu"] + drill)
        with pytest.raises(ValueError, match="attention-family cache, got "
                                             "family 'ssm'"):
            monkeypatch.setattr("sys.argv", ["serve"] + base + drill)
            r_main()
    with pytest.raises(ValueError, match="family 'ssm'"):
        Scheduler(t_get_config(ARCH, smoke=True), device="cpu")
    assert not any(launch_counts().values())
