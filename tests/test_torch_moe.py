"""Port vs reference: the MoE block (``models/moe.py``) and the MoE family.

The block: ``_dispatch`` bit-equal to the reference's in float32 — under
drops, in the decode regime (one group, capacity 1) and under top-k ties,
which ``jax.lax.top_k`` breaks to the lower index —, its invariants
property-tested as the reference's own tests do, and ``moe_ffn``'s output
and aux loss against ``_moe_ffn_jnp`` / ``moe_ffn`` (grouped and global,
with and without the shared expert, exact and with the emulated SIMDive
linears). The family: mixtral-8x7b and llama4-scout at their smoke sizes
served end to end against the reference with the helpers of
``test_torch_model``, and mixtral's sliding-window ring wrapping in the
decode. ``init_stack`` fills each stacked leaf in place; a dense
config's init stays what a ``torch.stack`` of per-layer draws gives.
"""
from dataclasses import asdict, replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core.approx import ApproxConfig as RApprox
from repro.launch import serve as r_serve
from repro.models import moe as r_moe
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from test_torch_model import (EMULATE_LOGIT_TOL, EXACT_LOGIT_TOL,
                              SIMDIVE_LOGIT_TOL, _check_generate, _pair)

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

torch.set_num_threads(1)

MOE_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
# float32 moe_ffn against the reference's: both sum the same products of
# O(1) values in another order (the expert and router matmuls, a softmax)
FFN_TOL = 2e-5
# the emulated linears of the served smoke models. The port against
# itself with its embeddings moved by one float32 ulp already differs by
# 0.057 on llama4-scout under --approx mitchell --emulate (every 8-bit
# re-quantization of its shared expert's and attention's activations that
# the ulp moves across a rounding boundary is a step of 1/255 of the row's
# scale, carried through the cache into later steps), so the reference,
# which rounds differently, may too: measured 0.058 there, bound 2.5x the
# port's own spread. Each linear is still held to float32 round-off on
# identical inputs (test_torch_model._check_linears), and EMULATE_LOGIT_TOL
# keeps holding the dense family.
MOE_EMULATE_LOGIT_TOL = 0.15


def _probs(rng, G, Tg, E, ties=0):
    """Router probabilities (float32 numpy) of normal logits; with ``ties``
    a token's logits repeat in runs of ``ties`` columns, so that at
    ``ties = k + 1`` the k-th and (k+1)-th largest probabilities tie."""
    logits = rng.standard_normal((G, Tg, E)).astype(np.float32)
    if ties:
        logits = logits[..., np.arange(E) // ties * ties]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _both_dispatch(xt, probs, k, cf):
    want = r_moe._dispatch(jnp.asarray(xt), jnp.asarray(probs), k, cf)
    got = t_moe._dispatch(torch.from_numpy(xt), torch.from_numpy(probs), k,
                          cf)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


# (G, Tg, E, k, capacity factor): drops at Tg 32 (cf 0.1 and 1.25), the
# decode regime (one group of a batch's 4 tokens at cf 4.0: llama4's E 16
# k 1 -> C 1, mixtral's E 8 k 2 -> C 4), the smoke models' groups
DISPATCH_GRID = [(2, 32, 8, 2, 0.1), (2, 32, 8, 2, 1.25),
                 (3, 32, 16, 1, 1.25), (1, 4, 16, 1, 4.0),
                 (1, 4, 8, 2, 4.0), (2, 16, 4, 2, 4.0), (2, 16, 4, 1, 4.0),
                 (1, 64, 16, 1, 4.0)]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("G,Tg,E,k,cf", DISPATCH_GRID)
def test_dispatch_bit_equal_to_reference(G, Tg, E, k, cf, ties):
    rng = np.random.default_rng(G * 1000 + Tg * 10 + E + k)
    xt = rng.standard_normal((G, Tg, 8)).astype(np.float32)
    probs = _probs(rng, G, Tg, E, ties=ties and k + 1)
    if ties:
        # most tokens' k-th pick ties with the expert after it
        srt = -np.sort(-probs, axis=-1)
        assert (srt[..., k - 1] == srt[..., k]).mean() > 0.5
    want, got = _both_dispatch(xt, probs, k, cf)
    names = ("buf", "dst", "gates", "gi", "gate_idx")
    for name, w, g in zip(names, want, got):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    C = got[0].shape[2]
    assert C == max(int(cf * Tg * k / E), 1)
    dropped = int((got[1] == E * C).sum())
    if cf == 0.1:
        assert C == 1 and dropped > 0
    if C >= Tg:
        assert dropped == 0        # an expert holds every token of a group


def test_dispatch_decode_regime_drops_the_later_row():
    """llama4's decode step: one group of the batch's 4 rows, E 16, top-1,
    C = int(4.0 * 4 / 16) = 1. Rows 0 and 2 pick expert 5: row 2, later in
    token order, is dropped (overflow slot, zero gate) — bit-equal to the
    reference."""
    probs = np.full((1, 4, 16), 0.02, np.float32)
    for row, e in enumerate((5, 9, 5, 1)):
        probs[0, row, e] = 0.7
    xt = np.arange(32, dtype=np.float32).reshape(1, 4, 8)
    want, got = _both_dispatch(xt, probs, 1, 4.0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    buf, dst, gates = got[:3]
    assert buf.shape == (1, 16, 1, 8)
    assert dst.tolist() == [[5, 9, 16, 1]]
    assert gates[0, :, 0].tolist() == [1.0, 1.0, 0.0, 1.0]
    np.testing.assert_array_equal(buf[0, 5, 0], xt[0, 0])


def test_dispatch_ties_go_to_the_lower_index():
    """[.1, .3, .3, .3, 0, .3, .2, .1] top-2 is [1, 2] in lax.top_k (four
    tied 0.3s), and so in the port."""
    probs = np.array([[[.1, .3, .3, .3, 0, .3, .2, .1]]], np.float32)
    xt = np.ones((1, 1, 4), np.float32)
    want, got = _both_dispatch(xt, probs, 2, 4.0)
    assert want[4].tolist() == [[[1, 2]]]
    np.testing.assert_array_equal(got[4], want[4])


@settings(deadline=None, max_examples=25)
@given(tg=st.integers(2, 16), e=st.integers(2, 8), k=st.integers(1, 2),
       cf=st.floats(0.25, 4.0), seed=st.integers(0, 2 ** 16),
       ties=st.booleans())
def test_dispatch_invariants(tg, e, k, cf, seed, ties):
    """The reference's property (tests/test_moe_dispatch.py): every kept
    token occupies a unique slot of its expert, at most C an expert, the
    dropped ones point at the overflow slot with a zero gate — and the
    port's dispatch equals the reference's on each example."""
    k = min(k, e)
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((2, tg, 8)).astype(np.float32)
    probs = _probs(rng, 2, tg, e, ties=ties and k + 1)
    want, (buf, dst, gates, gi, gate_idx) = _both_dispatch(xt, probs, k, cf)
    C = buf.shape[2]
    assert dst.max() <= e * C
    for g in range(dst.shape[0]):
        kept = dst[g][dst[g] < e * C]
        assert len(set(kept.tolist())) == len(kept), "slot collision"
        assert np.bincount(kept // C, minlength=e).max() <= C
        # each kept slot holds its token's activations
        flat = buf[g].reshape(e * C, -1)
        for j in np.flatnonzero(dst[g] < e * C):
            np.testing.assert_array_equal(flat[dst[g][j]], xt[g, j // k])
    assert (gates[..., 0][dst == e * C] == 0).all()
    for w, g in zip(want, (buf, dst, gates, gi, gate_idx)):
        np.testing.assert_array_equal(g, w)


def _ffn_params(shared, D=16, Fd=32, E=4, seed=0):
    """One numpy-seeded MoE block (float32) for both packages."""
    p = r_moe.init_moe(jax.random.PRNGKey(seed), D, Fd, E, shared,
                       jnp.float32)
    np_p = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(torch.from_numpy, np_p)


@pytest.mark.parametrize("approx", ["exact", "simdive", "emulate"])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("k,cf,S", [(2, 1.25, 8), (1, 0.5, 8), (2, 4.0, 1)],
                         ids=["top2", "top1-drops", "decode"])
def test_moe_ffn_matches_reference(k, cf, S, shared, grouped, approx):
    """out and aux of the port's ``moe_ffn`` against the reference's
    ``_moe_ffn_jnp`` (and its public ``moe_ffn``, which takes it without a
    mesh): prefill-like groups with and without drops and a decode step's
    one token a row; the shared expert through ``dense`` (under
    ``emulate`` the SIMDive linears: each rounds its activations to 8 bits
    from float32 values the two packages compute alike to round-off)."""
    r_p, t_p = _ffn_params(shared)
    x = np.random.default_rng(S * 10 + k).standard_normal(
        (2, S, 16)).astype(np.float32)
    kw = {} if approx == "exact" else dict(mode="simdive",
                                           emulate=approx == "emulate")
    r_ap, t_ap = RApprox(**kw), TApprox(**kw)
    want, want_aux = r_moe._moe_ffn_jnp(
        jnp.asarray(x), r_p, top_k=k, capacity_factor=cf, approx=r_ap,
        grouped=grouped)
    got, got_aux = t_moe.moe_ffn(torch.from_numpy(x), t_p, top_k=k,
                                 capacity_factor=cf, approx=t_ap,
                                 grouped=grouped)
    assert got.shape == x.shape and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    if grouped:
        pub, pub_aux = r_moe.moe_ffn(jnp.asarray(x), r_p, top_k=k,
                                     capacity_factor=cf, approx=r_ap)
        np.testing.assert_array_equal(np.asarray(pub), np.asarray(want))
        assert float(pub_aux) == float(want_aux)
    if approx == "emulate" and shared:
        # the shared expert's linears are emulated: not the exact result
        exact, _ = t_moe.moe_ffn(torch.from_numpy(x), t_p, top_k=k,
                                 capacity_factor=cf, grouped=grouped)
        assert float((exact - got).abs().max()) > 10 * FFN_TOL


def test_moe_ffn_router_ties_match_reference():
    """A router whose columns repeat in pairs: every token's top-k
    boundary is a tie, resolved to the lower expert in both packages."""
    r_p, t_p = _ffn_params(0, E=8, seed=3)
    router = np.asarray(r_p["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    r_p = {**r_p, "router": jnp.asarray(router)}
    t_p = {**t_p, "router": torch.from_numpy(router)}
    x = np.random.default_rng(4).standard_normal((2, 8, 16)).astype(
        np.float32)
    seen = []
    orig = t_moe._dispatch

    def spy(xt, probs, k, cf):
        seen.append(probs)
        return orig(xt, probs, k, cf)

    t_moe._dispatch = spy
    try:
        got, got_aux = t_moe.moe_ffn(torch.from_numpy(x), t_p, top_k=1,
                                     capacity_factor=4.0)
    finally:
        t_moe._dispatch = orig
    probs = seen[0]
    assert torch.equal(probs[..., 0::2], probs[..., 1::2])
    want, want_aux = r_moe.moe_ffn(jnp.asarray(x), r_p, top_k=1,
                                   capacity_factor=4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_init_moe_distributions_match_reference():
    want = jax.tree.map(np.asarray, r_moe.init_moe(
        jax.random.PRNGKey(0), 64, 128, 8, 1, jnp.float32))
    got = t_moe.init_moe(torch.Generator().manual_seed(0), 64, 128, 8, 1,
                         torch.float32, "cpu")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0])
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        g = flat_g[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        lim = (128 if key[-1].key == "w2" else 64) ** -0.5
        for a in (g, w):
            assert lim * 0.95 < np.abs(a).max() <= lim, key
        assert abs(g.std() / w.std() - 1) < 0.05, key


def _parent_init_stack(gen, cfg):
    """The stacking the port had before MoE: each layer's tree drawn whole
    (``torch.rand(shape) * (2 * lim) - lim``, unit norms, zero biases, in
    this order), then ``torch.stack``."""
    H, KV, dh, D, Fd = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                        cfg.d_model, cfg.d_ff)

    def uni(shape, fan_in):
        lim = fan_in ** -0.5
        return torch.rand(shape, generator=gen) * (2 * lim) - lim

    def norm():
        p = {"w": torch.ones(D)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros(D)
        return p

    layers = []
    for _ in range(cfg.n_layers):
        p = {"ln_attn": norm(), "wq": uni((D, H * dh), D),
             "wk": uni((D, KV * dh), D), "wv": uni((D, KV * dh), D),
             "wo": uni((H * dh, D), H * dh), "ln_mlp": norm()}
        if cfg.qkv_bias:
            p.update(bq=torch.zeros(H * dh), bk=torch.zeros(KV * dh),
                     bv=torch.zeros(KV * dh))
        if cfg.qk_norm:
            p.update(q_norm={"w": torch.ones(dh)}, k_norm={"w": torch.ones(dh)})
        p["mlp"] = {"w1": uni((D, Fd), D), "w2": uni((Fd, D), Fd),
                    "w3": uni((D, Fd), D)}
        layers.append(p)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    return {"layers": stack(layers)}


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "stablelm-1.6b",
                                  "qwen2.5-14b"])
def test_init_stack_of_dense_configs_unchanged(arch):
    """Filling each stacked leaf layer by layer gives, bit for bit and in
    the same key order, what stacking whole per-layer trees gave."""
    cfg = t_get_config(arch, smoke=True)
    want = _parent_init_stack(torch.Generator().manual_seed(5), cfg)
    got = transformer.init_stack(torch.Generator().manual_seed(5), cfg,
                                 torch.float32, "cpu")

    def flat(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, path + (k,))
            else:
                yield path + (k,), v

    w, g = list(flat(want)), list(flat(got))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert torch.equal(a, b), path


# -------------------------------------------------- the served smoke models --
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode,tol", [("exact", EXACT_LOGIT_TOL),
                                      ("simdive", SIMDIVE_LOGIT_TOL),
                                      ("mitchell", SIMDIVE_LOGIT_TOL)])
def test_moe_smoke_generate_matches_reference(mode, tol, arch):
    _check_generate(mode, tol, arch=arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode,quantize", [("simdive", False),
                                           ("mitchell", False),
                                           ("simdive", True)])
def test_moe_smoke_generate_emulated_matches_reference(mode, quantize, arch):
    """--emulate [--quantize]: the attention's linears and llama4's shared
    expert on the SIMDive matmul (the routed experts stay exact and every
    ``moe`` leaf float under ``quantize_params``, as in the reference)."""
    assert MOE_EMULATE_LOGIT_TOL > EMULATE_LOGIT_TOL
    _check_generate(mode, MOE_EMULATE_LOGIT_TOL, emulate=True,
                    quantize=quantize, arch=arch)


def test_moe_quantize_leaves_every_moe_leaf_float():
    *_, t_cfg, _, t_params = _pair("simdive", True, True,
                                   "llama4-scout-17b-a16e")
    layers = t_params["stack"]["layers"]
    assert layers["wq"].q.dtype == torch.int8
    for leaf in (layers["moe"]["w1"], layers["moe"]["router"],
                 layers["moe"]["shared"]["w2"]):
        assert torch.is_tensor(leaf) and leaf.dtype == torch.float32


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_equal_reference_field_for_field(arch, smoke):
    r_cfg = asdict(r_get_config(arch, smoke=smoke))
    t_cfg = asdict(t_get_config(arch, smoke=smoke))
    r_approx, t_approx = r_cfg.pop("approx"), t_cfg.pop("approx")
    assert t_cfg == r_cfg
    assert (r_approx.pop("backend"), t_approx.pop("backend")) == ("ref", "auto")
    assert t_approx == r_approx
    assert t_cfg["family"] == "moe" and t_cfg["n_experts"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_distributions_and_tree_match_reference(arch):
    from test_torch_model import test_init_distributions_and_tree_match_reference
    test_init_distributions_and_tree_match_reference(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_from_reference_refuses_drifted_trees(arch):
    """The MoE leaves are required and shaped: a dropped ``moe/shared``,
    a shared expert the config lacks, a dense block's ``mlp`` in place of
    ``moe``, a wrong expert count."""
    from test_torch_model import test_params_from_reference_refuses_drifted_trees
    test_params_from_reference_refuses_drifted_trees(arch)
    _, _, r_params, t_cfg, _, _ = _pair("exact", arch=arch)
    tree = jax.tree.map(np.asarray, r_params)
    layers = tree["stack"]["layers"]
    moe = layers["moe"]
    params_from_reference(tree, t_cfg)

    def with_moe(new):
        return {**tree, "stack": {"layers": {**layers, "moe": new}}}

    if t_cfg.n_shared_experts:
        short = with_moe({k: v for k, v in moe.items() if k != "shared"})
        with pytest.raises(ValueError, match="missing.*'shared'"):
            params_from_reference(short, t_cfg)
        with pytest.raises(ValueError, match="unexpected.*'shared'"):
            params_from_reference(tree, replace(t_cfg, n_shared_experts=0))
    else:
        extra = with_moe({**moe, "shared": {"w1": moe["w1"][:, 0]}})
        with pytest.raises(ValueError, match="unexpected.*'shared'"):
            params_from_reference(extra, t_cfg)
    L, E, D, Fd = (t_cfg.n_layers, t_cfg.n_experts, t_cfg.d_model,
                   t_cfg.d_ff)
    dense = {**{k: v for k, v in layers.items() if k != "moe"},
             "mlp": {"w1": np.zeros((L, D, Fd), np.float32),
                     "w2": np.zeros((L, Fd, D), np.float32),
                     "w3": np.zeros((L, D, Fd), np.float32)}}
    with pytest.raises(ValueError, match="missing.*'moe'"):
        params_from_reference({**tree, "stack": {"layers": dense}}, t_cfg)
    with pytest.raises(ValueError, match="unexpected.*'moe'"):
        params_from_reference(tree, replace(t_cfg, family="dense"))
    wrong = with_moe({**moe, "w1": moe["w1"][:, :E - 1]})
    with pytest.raises(ValueError, match="leaf stack/layers/moe/w1: shape"):
        params_from_reference(wrong, t_cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_cli_on_cpu(arch, capsys):
    """``serve --arch <moe arch> --smoke --device cpu``: a batched generate
    (its plan names no kernel for the routed experts) and the
    ``--scheduler`` drill."""
    t_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--emulate", "--batch", "2", "--prompt-len",
                  "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
    plan = [ln for ln in out.splitlines() if ln.startswith("#   ")]
    assert [ln.split()[2] for ln in plan] == ["matmul", "div", "attention"]
    assert "# routed experts: exact batched matmuls" in out
    t_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3", "--scheduler", "--requests", "5", "--shed-depth",
                  "3"])
    out = capsys.readouterr().out
    assert "# scheduler: warmed 6 executable(s) across 3 level(s)" in out
    assert "# drill: 5 request(s) in" in out
    assert "sheds=1 recovers=1" in out
    assert not any(launch_counts().values())


def test_mixtral_ring_wrap_matches_reference_step_by_step():
    """mixtral smoke, prompt 40, 16 tokens: the serving cache keeps the
    window's 48 slots, so the decode steps at positions 48-54 overwrite
    slots 0-6 (``ring_full``) and attend over the last 48 positions. Every step's logits equal the reference's, each side
    fed the same tokens (the reference's greedy ones)."""
    arch, P, GEN, Bw = "mixtral-8x7b", 40, 16, 2
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair("exact", arch=arch)
    assert t_cfg.sliding_window == 48 < P + GEN
    prompts = np.random.default_rng(11).integers(0, t_cfg.vocab_size,
                                                 (Bw, P))
    logits, cache = r_lm.prefill(r_params,
                                 {"tokens": jnp.asarray(prompts, jnp.int32)})
    cache = r_serve.merge_cache(r_lm.empty_cache(Bw, P + GEN), cache)
    t_logits, t_cache = t_lm.prefill(t_params,
                                     {"tokens": torch.from_numpy(prompts)})
    t_cache = t_serve.merge_cache(t_lm.empty_cache(Bw, P + GEN), t_cache)
    assert t_cache["k"].shape[2] == 48
    for i in range(GEN):
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                                   rtol=0, atol=EXACT_LOGIT_TOL,
                                   err_msg=f"step {i}")
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        if i == GEN - 1:
            break
        logits, cache = r_lm.decode_step(r_params, cache, tok,
                                         jnp.int32(P + i))
        t_logits, t_cache = t_lm.decode_step(
            t_params, t_cache, torch.from_numpy(np.asarray(tok, np.int64)),
            P + i)
    # the ring wrapped: the steps at positions 48..54 wrote slots 0..6, so
    # slot 6 holds position 54's key, not the prompt's position 6
    _, fresh = t_lm.prefill(t_params, {"tokens": torch.from_numpy(prompts)})
    assert not torch.equal(t_cache["k"][:, :, 6], fresh["k"][:, :, 6])
    assert torch.equal(t_cache["k"][:, :, 7], fresh["k"][:, :, 7])
    np.testing.assert_allclose(t_cache["k"].numpy(), np.asarray(cache["k"]),
                               rtol=0, atol=EXACT_LOGIT_TOL)
