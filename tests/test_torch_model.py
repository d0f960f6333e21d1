"""Port vs reference: the dense family's smoke models served end to end.

smollm-360m, qwen3-4b (qk-norm), qwen2.5-14b (qkv bias) and stablelm-1.6b
(LayerNorm with bias, qkv bias, partial rotary) at their smoke sizes.

Both models get the *same* random init (the reference's, carried over by
``params_from_reference``) and the same numpy-seeded prompts, in float32
(``dataclasses.replace(cfg, dtype="float32")``: the point is the algorithm,
not bf16 rounding). Prefill logits and every decode step's logits are
compared; greedy tokens are compared only where the reference's top-2 logit
margin exceeds twice the logit tolerance — random-init logits have
near-ties that float round-off may flip either way.
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
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels import get_op, launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.models import build as t_build
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

ARCH = "smollm-360m"
ARCHS = ("smollm-360m", "qwen3-4b", "qwen2.5-14b", "stablelm-1.6b")
B, P, GEN = 2, 16, 6
# float32 end to end, two layers: both sides sum the same products in
# different orders; logits are O(1), a few hundred ulps of head-room
EXACT_LOGIT_TOL = 1e-4
# simdive: on top of that, round-off may move a 16-bit divider operand by
# one unit (2^-14 relative on one attention output element, see
# test_torch_flash_attention.APPROX_TOL), which two layers and the head
# carry into the logits; measured 6e-5, bound 8x that
SIMDIVE_LOGIT_TOL = 5e-4
# emulated SIMDive linears (ApproxConfig.emulate): the integer core is
# bit-equal, so logits agree to float32 round-off (measured <= 2e-6) —
# except where that round-off moves one rounded 8-bit activation magnitude
# by one unit, a step of 1/255 of the row's scale that the later layers
# carry into the logits: measured 2.1e-2 (one step in one logit row), bound
# 2.5x that. Most (b, step) logit rows must still agree to round-off.
EMULATE_LOGIT_TOL = 5e-2
EMULATE_ROUNDOFF_TOL = 1e-5


@lru_cache(maxsize=None)
def _pair(mode, emulate=False, quantize=False, arch=ARCH, use_in_norm=False):
    """Both models of ``arch`` and their (shared, never mutated) parameters
    for ``mode`` (with the emulated linears, the reference's int8 weights
    and the approximate norms when asked); built once per case for the
    whole module."""
    r_cfg = replace(r_get_config(arch, smoke=True), dtype="float32")
    t_cfg = replace(t_get_config(arch, smoke=True), dtype="float32")
    if mode != "exact":
        kw = dict(mode=mode, emulate=emulate, use_in_norm=use_in_norm)
        r_cfg = r_cfg.with_approx(RApprox(**kw))
        t_cfg = t_cfg.with_approx(TApprox(**kw))
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    if quantize:
        r_params = r_serve.quantize_params(r_params)
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg, device="cpu")
    return r_cfg, r_lm, r_params, t_cfg, t_lm, t_params


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, P))


def _reference_logits(r_lm, r_params, prompts, gen):
    """The reference's generate loop, keeping each step's logits."""
    pj = jnp.asarray(prompts, jnp.int32)
    logits, cache = r_lm.prefill(r_params, {"tokens": pj})
    cache = r_serve.merge_cache(r_lm.empty_cache(B, P + gen), cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [np.asarray(logits)]
    for i in range(gen - 1):
        logits, cache = r_lm.decode_step(r_params, cache, tok,
                                         jnp.int32(P + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)                         # (B, gen, V)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,tol", [("exact", EXACT_LOGIT_TOL),
                                      ("simdive", SIMDIVE_LOGIT_TOL),
                                      ("mitchell", SIMDIVE_LOGIT_TOL)])
def test_smoke_generate_matches_reference(mode, tol, arch):
    _check_generate(mode, tol, arch=arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,quantize", [("simdive", False),
                                           ("mitchell", False),
                                           ("simdive", True)])
def test_smoke_generate_emulated_matches_reference(mode, quantize, arch):
    """--emulate [--quantize]: every linear through the SIMDive matmul; with
    the reference's int8 weights carried over by params_from_reference."""
    _check_generate(mode, EMULATE_LOGIT_TOL, emulate=True, quantize=quantize,
                    arch=arch)


@pytest.mark.parametrize("arch", ["qwen3-4b", "stablelm-1.6b"])
def test_use_in_norm_leaves_qk_norm_and_layernorm_exact(arch, monkeypatch):
    """``use_in_norm=True``: only the block RMSNorms take the log-domain
    ``approx_rmsnorm`` (one ``sqrt`` dispatch each); qwen3-4b's q / k norms
    and every LayerNorm of stablelm-1.6b stay exact, as in the reference,
    and the logits equal the reference's with the same flag within the
    divider-only tolerance (the block norms are bit-equal, R-4)."""
    from repro_torch.core import approx as ta

    ops = []

    def counting(op, *args, **kw):
        ops.append(op)
        return get_op(op, *args, **kw)

    monkeypatch.setattr(ta, "get_op", counting)
    *_, t_cfg, t_lm, t_params = _pair("simdive", arch=arch, use_in_norm=True)
    prompts = torch.from_numpy(_prompts(t_cfg.vocab_size))
    t_lm.prefill(t_params, {"tokens": prompts})
    rms = t_cfg.norm == "rmsnorm"
    assert ops.count("sqrt") == (2 * t_cfg.n_layers if rms else 0), ops
    assert (t_cfg.qk_norm, t_cfg.norm) in ((True, "rmsnorm"),
                                           (False, "layernorm"))
    _check_generate("simdive", SIMDIVE_LOGIT_TOL, arch=arch, use_in_norm=True)


_GAINS = {"ln_attn", "ln_mlp", "final_norm", "q_norm", "k_norm"}


def _perturbed(tree, t_cfg):
    """``tree`` (numpy leaves) with every bias numpy-seeded normal and
    every norm gain 1 + normal/4, for both packages: the reference's init
    (zero biases, unit gains) cannot show a bias or gain dropped."""
    rng = np.random.default_rng(7)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("b", "bq", "bk", "bv"):
            return rng.standard_normal(node.shape).astype(np.float32)
        if path[-1] == "w" and path[-2] in _GAINS:
            return (1 + rng.standard_normal(node.shape) / 4
                    ).astype(np.float32)
        return node

    new = walk(tree)
    return (jax.tree.map(jnp.asarray, new),
            params_from_reference(new, t_cfg, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_biases_and_norm_gains_match_reference(arch):
    """qkv biases, LayerNorm biases and every norm gain (qk-norm's
    included) away from their init values, the same in both packages:
    the logits and greedy tokens match the reference's, and differ from
    the unperturbed model's."""
    _check_generate("exact", EXACT_LOGIT_TOL, arch=arch, perturb=True)


def _check_generate(mode, tol, emulate=False, quantize=False, arch=ARCH,
                    use_in_norm=False, perturb=False):
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair(
        mode, emulate, quantize, arch, use_in_norm)
    if perturb:
        plain = t_params
        r_params, t_params = _perturbed(jax.tree.map(np.asarray, r_params),
                                        t_cfg)
    if quantize:
        layers = t_params["stack"]["layers"]
        w = layers["wq" if "wq" in layers else "wr"]
        assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
    prompts = _prompts(r_cfg.vocab_size)
    want_tok = np.asarray(r_serve.generate(
        r_lm, r_params, jnp.asarray(prompts, jnp.int32), P + GEN, GEN))
    want_logits = _reference_logits(r_lm, r_params, prompts, GEN)
    np.testing.assert_array_equal(want_logits.argmax(-1), want_tok)

    got_tok, got_logits = t_serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    got_tok, got_logits = got_tok.numpy(), got_logits.numpy()
    assert got_tok.shape == (B, GEN) and got_logits.shape == want_logits.shape
    assert np.isfinite(got_logits).all()

    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    rows = np.abs(got_logits - want_logits).max(-1)       # (B, gen)
    # a row within tol differs from the reference's by rows[b, i] <= tol
    # in every logit, so where the reference's top-2 margin exceeds twice
    # that, the greedy tokens must agree (the untied heads' smaller logits
    # leave fewer margins above twice tol itself)
    decided = (top2[..., 1] - top2[..., 0]) > 2 * np.minimum(rows, tol)
    for b in range(B):
        for i in range(GEN):
            # logits are comparable while both runs decoded the same prefix
            np.testing.assert_allclose(got_logits[b, i], want_logits[b, i],
                                       rtol=0, atol=tol)
            if decided[b, i]:
                assert got_tok[b, i] == want_tok[b, i], (b, i)
            if got_tok[b, i] != want_tok[b, i]:
                break                                    # prefixes diverged
    # the margin rule must not have emptied the token check
    assert decided.mean() > 0.5
    if emulate:
        # the integer core is bit-equal: every emulated linear, fed the
        # same activations, gives the reference's output to round-off
        _check_linears(r_cfg, r_params, t_cfg, t_params)
    if emulate and arch in (ARCH, "rwkv6-1.6b"):
        # and so most of smollm's logit rows agree to round-off (rwkv6's,
        # which has no divider, all of them). On the other smoke models f32
        # round-off moves a 16-bit attention divider output by one unit in
        # their first layer, which an 8-bit re-quantization turns into a
        # step carried into every later row
        assert (rows <= EMULATE_ROUNDOFF_TOL).mean() >= 0.5
    if perturb:
        plain_logits = t_serve.generate(
            t_lm, plain, torch.from_numpy(prompts), P + GEN, GEN,
            return_logits=True)[1].numpy()
        assert np.abs(plain_logits[:, 0] - got_logits[:, 0]).max() > \
            10 * tol
    if mode != "exact" and (emulate or t_cfg.family != "ssm"):
        # the approximation takes effect: against exact serving, and the
        # emulated linears against the divider-only run of the same mode
        # (the rwkv6 stack has no softmax: its divider-only run is exact
        # serving, which test_torch_ssm holds)
        base = _pair(mode, arch=arch) if emulate \
            else _pair("exact", arch=arch)
        base_logits = t_serve.generate(
            base[4], base[5], torch.from_numpy(prompts), P + GEN, GEN,
            return_logits=True)[1].numpy()
        assert np.abs(base_logits[:, 0] - got_logits[:, 0]).max() > \
            10 * (SIMDIVE_LOGIT_TOL if emulate else tol)


RWKV6_LINEARS = ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wr", "cm_wv")


def _dense_linears(layers):
    """The linears a layer sends through ``dense``: the attention's four
    and the MLP's three — an MoE block's shared expert's, or none (its
    routed experts and router are plain matmuls); an rwkv6 layer's eight
    (the time mix's five, the channel mix's three)."""
    if "wr" in layers:
        return {name: layers[name] for name in RWKV6_LINEARS}
    ffn = layers["mlp"] if "mlp" in layers \
        else layers["moe"].get("shared", {})
    return {**{name: layers[name] for name in ("wq", "wk", "wv", "wo")},
            **{name: ffn[name] for name in ("w1", "w3", "w2") if name in ffn}}


def _check_linears(r_cfg, r_params, t_cfg, t_params):
    """Each layer's linears (:func:`_dense_linears`) through both packages'
    ``dense`` under the configs' approximation, on the same numpy-seeded
    activations (float or int8 weights alike), equal to
    EMULATE_ROUNDOFF_TOL."""
    from repro.models.layers import dense as r_dense
    from repro_torch.models.layers import dense as t_dense

    rng = np.random.default_rng(5)
    r_lin, t_lin = (_dense_linears(p["stack"]["layers"])
                    for p in (r_params, t_params))
    assert list(r_lin) == list(t_lin)
    for name in t_lin:
        r_w, t_w = r_lin[name], t_lin[name]
        for i in range(r_cfg.n_layers):
            r_wi = jax.tree.map(lambda a: a[i], r_w)
            x = rng.standard_normal((B * P, t_w.shape[-2])).astype(np.float32)
            want = np.asarray(r_dense(jnp.asarray(x), r_wi, r_cfg.approx))
            got = t_dense(torch.from_numpy(x), t_w[i], t_cfg.approx).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=EMULATE_ROUNDOFF_TOL,
                                       err_msg=f"{name} layer {i}")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_for_field(arch, smoke):
    """The port's own copy of each config, full and smoke, equals the
    reference's field for field. ``approx`` is compared field for field too,
    but for its ``backend``, whose default names the port's registry
    ('auto'), not the reference's ('ref')."""
    r_cfg = asdict(r_get_config(arch, smoke=smoke))
    t_cfg = asdict(t_get_config(arch, smoke=smoke))
    r_approx, t_approx = r_cfg.pop("approx"), t_cfg.pop("approx")
    assert t_cfg == r_cfg
    assert (r_approx.pop("backend"), t_approx.pop("backend")) == ("ref", "auto")
    assert t_approx == r_approx


@pytest.mark.parametrize("arch", ARCHS)
def test_init_distributions_and_tree_match_reference(arch):
    """Own init: the reference's tree, shapes and distributions (the random
    streams differ, so moments are compared, not values)."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, _ = _pair("exact", arch=arch)
    own = t_lm.init(torch.Generator().manual_seed(3))
    flat_r = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(r_params)[0]}

    def flat(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{path}['{k}']")
            else:
                yield f"{path}['{k}']", v

    flat_t = dict(flat(own))
    assert set(flat_t) == set(flat_r)
    for name, leaf in flat_t.items():
        ref = np.asarray(flat_r[name])
        assert tuple(leaf.shape) == ref.shape, name
        assert leaf.dtype == torch.float32
        # same spread (std within 10%: thousands of samples per leaf)
        if ref.std() > 0:
            assert abs(float(leaf.std()) / ref.std() - 1) < 0.1, name
            assert abs(float(leaf.max()) / ref.max() - 1) < 0.25, name
        else:
            np.testing.assert_array_equal(leaf.numpy(), ref)
    again = t_lm.init(3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(sorted(flat(t_lm.init(3))), sorted(flat(again))))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_refuses_drifted_trees(arch):
    _, _, r_params, t_cfg, _, _ = _pair("exact", arch=arch)
    tree = jax.tree.map(np.asarray, r_params)
    params_from_reference(tree, t_cfg)               # the tree as it is
    # each feature's leaves: required under it, refused without it
    layers = tree["stack"]["layers"]
    for on, leaf in ((t_cfg.qkv_bias, "bq"), (t_cfg.qk_norm, "k_norm"),
                     (t_cfg.norm == "layernorm", "ln_mlp")):
        if not on:
            continue
        if leaf == "ln_mlp":
            drop = {**layers, leaf: {"w": layers[leaf]["w"]}}
            off = dict(norm="rmsnorm")
        else:
            drop = {k: v for k, v in layers.items() if k != leaf}
            off = {"bq": dict(qkv_bias=False), "k_norm": dict(qk_norm=False)
                   }[leaf]
        short = {**tree, "stack": {"layers": drop}}
        with pytest.raises(ValueError, match="missing"):
            params_from_reference(short, t_cfg)
        if leaf != "ln_mlp":
            with pytest.raises(ValueError, match="unexpected"):
                params_from_reference(tree, replace(t_cfg, **off))
    if t_cfg.qkv_bias:
        bad = {**tree, "stack": {"layers": {**layers,
                                            "bk": layers["bk"][:, :-1]}}}
        with pytest.raises(ValueError, match="leaf stack/layers/bk: shape"):
            params_from_reference(bad, t_cfg)
    # a leaf the config does not have: the head of a tied model
    extra = "head" if t_cfg.tie_embeddings else "head_bias"
    bad = {**tree, extra: np.zeros((1, 4, 4), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        params_from_reference(bad, t_cfg)
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(short, t_cfg)
    wrong = {**tree, "embed": tree["embed"][:, :-1]}
    with pytest.raises(ValueError, match="leaf embed: shape"):
        params_from_reference(wrong, t_cfg)


def test_merge_cache_embeds_and_raises_on_drift():
    *_, t_cfg, t_lm, t_params = _pair("exact")
    prompts = torch.from_numpy(_prompts(t_cfg.vocab_size))
    _, cache = t_lm.prefill(t_params, {"tokens": prompts})
    assert cache["k"].shape == (t_cfg.n_layers, B, P, t_cfg.n_kv_heads,
                                t_cfg.d_head)
    full = t_serve.merge_cache(t_lm.empty_cache(B, P + 4), cache)
    assert full["k"].shape[2] == P + 4
    assert torch.equal(full["k"][:, :, :P], cache["k"])
    assert not full["v"][:, :, P:].any()
    same = t_serve.merge_cache(t_lm.empty_cache(B, P), cache)
    assert torch.equal(same["v"], cache["v"])
    with pytest.raises(ValueError, match=r"unmergeable cache leaf \['k'\]"):
        t_serve.merge_cache(t_lm.empty_cache(B, P - 1), cache)
    with pytest.raises(ValueError, match=r"unmergeable cache leaf \['k'\]"):
        t_serve.merge_cache(t_lm.empty_cache(B + 1, P + 4), cache)
    with pytest.raises(ValueError, match="do not match"):
        t_serve.merge_cache(t_lm.empty_cache(B, P + 4), {"k": cache["k"]})


@pytest.mark.parametrize("mode", ["exact", "simdive"])
def test_scalar_and_per_row_decode_positions_agree(mode):
    *_, t_cfg, t_lm, t_params = _pair(mode)
    prompts = torch.from_numpy(_prompts(t_cfg.vocab_size, seed=1))
    logits, cache = t_lm.prefill(t_params, {"tokens": prompts})
    tok = logits.argmax(-1)

    def fresh():
        return t_serve.merge_cache(t_lm.empty_cache(B, P + 2),
                                   {k: v.clone() for k, v in cache.items()})

    a_logits, a_cache = t_lm.decode_step(t_params, fresh(), tok, P)
    b_logits, b_cache = t_lm.decode_step(t_params, fresh(), tok,
                                         torch.full((B,), P))
    assert torch.equal(a_logits, b_logits)
    assert torch.equal(a_cache["k"], b_cache["k"])
    assert a_cache["k"][:, :, P].abs().sum() > 0          # token written
    # per-row depths: row 1 one step behind row 0 — each row must equal a
    # scalar-position step at its own depth
    pos = torch.tensor([P, P - 1])
    c_logits, _ = t_lm.decode_step(t_params, fresh(), tok, pos)
    d_logits, _ = t_lm.decode_step(t_params, fresh(), tok, P - 1)
    assert torch.equal(c_logits[0], a_logits[0])
    np.testing.assert_allclose(c_logits[1].numpy(), d_logits[1].numpy(),
                               rtol=0, atol=EXACT_LOGIT_TOL)


def test_serving_plan_and_cli_on_cpu(capsys, tmp_path):
    cfg = t_serve.serving_config(ARCH, smoke=True, approx="simdive")
    plan = t_serve.resolve_serving_plan(cfg)
    assert [(r.op, r.width, r.coeff_bits, r.frac_out, r.backend)
            for r in plan] == [("matmul", 8, 6, None, "auto"),
                               ("div", 16, 6, 15, "auto"),
                               ("attention", 16, 6, 15, "auto")]
    r_cfg = r_get_config(ARCH, smoke=True).with_approx(
        RApprox(mode="simdive", emulate=False))
    r_plan = r_serve.resolve_serving_plan(r_cfg)
    assert [(r.op, r.width, r.coeff_bits, r.index_bits, r.frac_out)
            for r in plan] == [(r.op, r.width, r.coeff_bits, r.index_bits,
                                r.frac_out) for r in r_plan]
    assert t_serve.resolve_serving_plan(t_get_config(ARCH, smoke=True)) == ()
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3"])
    out = capsys.readouterr().out
    assert "serving plan: 1 layer segment(s)" in out
    assert "generated (2, 3) on cpu" in out
    # --emulate --quantize serve too: every linear emulated, int8 weights
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--emulate", "--quantize", "--batch", "2",
                  "--prompt-len", "8", "--gen", "3"])
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    assert t_serve.serving_config(ARCH, approx="simdive",
                                  emulate=True).approx.emulate
    # on the CPU nothing launched a kernel
    assert launch_counts() == {"attention": 0, "attention_pipelined": 0,
                               "attention_pipelined_w32": 0,
                               "attention_w32": 0, "decode_attention": 0,
                               "decode_attention_w32": 0, "elemwise": 0,
                               "elemwise_w32": 0, "matmul": 0,
                               "matmul_pipelined": 0, "packed": 0,
                               "sqrt": 0, "sqrt_w32": 0}
    # --scheduler runs the load-shed drill (launch.scheduler) and prints
    # the reference's drill lines; --chaos (faults/) runs it under the
    # armed table fault; --policy (tuning/select.py) serves a
    # simdive-policy/v1 file, turning the default --approx exact into
    # simdive
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3", "--scheduler", "--requests", "5", "--shed-depth",
                  "3"])
    out = capsys.readouterr().out
    assert "# scheduler: warmed 6 executable(s) across 3 level(s)" in out
    assert "# drill: 5 request(s) in" in out
    assert "sheds=1 recovers=1" in out
    assert "# watchdog: guard_trips=0 quarantines=0" in out
    assert "decode step" in out
    assert launch_counts()["decode_attention"] == 0
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3", "--chaos", "--requests", "4", "--shed-depth", "100"])
    out = capsys.readouterr().out
    assert "# chaos: armed FaultSpec(site='table', bit=20, kind='stuck1'" \
        in out
    assert "# drill: 4 request(s) in" in out
    assert "# chaos: PASS" in out
    assert "quarantines=0" not in out
    assert launch_counts()["decode_attention"] == 0
    from repro_torch.tuning import PolicyEntry, TuningPolicy

    policy = tmp_path / "p.json"
    TuningPolicy(entries=(
        PolicyEntry(op="attention", width=16, coeff_bits=8, frac_out=15),
        PolicyEntry(op="attention", width=8, coeff_bits=2, frac_out=12,
                    backend="ref", layer="L1"))).save(str(policy))
    t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--policy",
                  str(policy), "--batch", "2", "--prompt-len", "8", "--gen",
                  "3"])
    out = capsys.readouterr().out
    assert f"# policy: {policy} (2 entries, 2 distinct dispatch config(s))" \
        in out
    assert "serving plan: 2 layer segment(s), 6 resolved op config(s)" in out
    assert "L0 attention 16b/cb8/ib3/q15 auto [policy]" in out
    assert "L1 attention 8b/cb2/ib3/q12 ref [policy]" in out
    assert "generated (2, 3) on cpu" in out
    assert launch_counts()["decode_attention"] == 0
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", ARCH, "--device", "cpu", "--policy"])


def test_unported_paths_raise_instead_of_serving_something_else():
    from repro_torch.core.approx import approx_matmul, approx_matmul_int8
    from repro_torch.models.layers import QuantizedWeight, dense

    # dense with emulate no longer raises: it serves the SIMDive linear
    # (within the multiplier's ~1 % error here), float and int8 weights
    # alike, and the plain matmul when inactive
    x, w = torch.ones(2, 4), torch.full((4, 4), 0.5)
    cfg = TApprox(mode="simdive")
    assert torch.equal(dense(x, w, cfg), approx_matmul(x, w, cfg))
    assert torch.allclose(dense(x, w, cfg), x @ w, rtol=2e-2)
    q = QuantizedWeight(q=torch.full((4, 4), 127, dtype=torch.int8),
                        scale=torch.full((1, 4), 0.5 / 127))
    assert torch.equal(dense(x, q, cfg),
                       approx_matmul_int8(x, q.q, q.scale, cfg))
    assert torch.allclose(dense(x, q, cfg), x @ w, rtol=2e-2)
    assert torch.allclose(dense(x, q), x @ w)
    # the approximate backward runs (training): both gradients come back,
    # not the straight-through ones
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    dense(xg, wg, TApprox(mode="simdive", backward="approx")).sum() \
        .backward()
    assert xg.grad is not None and wg.grad is not None
    assert torch.isfinite(xg.grad).all() and torch.isfinite(wg.grad).all()
    assert torch.allclose(wg.grad, x.T @ torch.ones(2, 4), rtol=2e-2)
    with pytest.raises(KeyError, match="ported so far"):
        t_get_config("zamba3-7b")
    # M-RoPE and the gelu MLP are ported (the modality-stub families):
    # those configs build, with the tree their features need
    for kw in (dict(mrope=True), dict(act="gelu")):
        cfg = replace(t_get_config(ARCH, smoke=True), **kw)
        params = t_build(cfg, device="cpu").init(0)
        assert ("w3" in params["stack"]["layers"]["mlp"]) == \
            (cfg.act == "swiglu")
    # a feature still unported raises before any parameter is made: a
    # hybrid family that is not the reference's Mamba2 stack (here no ssm
    # and no hybrid_period), experts outside the MoE family (the rwkv6
    # stack's too), and an activation or position embedding the reference
    # does not have
    for kw, name in ((dict(family="hybrid"), "hybrid ssm ''"),
                     (dict(family="ssm", n_experts=4), "n_experts"),
                     (dict(act="relu"), "act relu"),
                     (dict(pos_emb="alibi"), "pos_emb alibi")):
        cfg = replace(t_get_config(ARCH, smoke=True), **kw)
        with pytest.raises(NotImplementedError, match=name):
            t_build(cfg, device="cpu").init(0)


@pytest.mark.parametrize("arch", ARCHS[1:] + ("zamba2-2.7b",))
def test_serve_cli_new_archs_on_cpu(arch, capsys):
    """``serve --arch <arch> --smoke --device cpu``, a batched generate and
    the ``--scheduler`` drill, for each architecture a later slice added;
    the hybrid zamba2-2.7b's drill is refused with the reference's
    ``ValueError`` (its recurrent cache has no per-slot seq axis)."""
    t_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3"])
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    drill = ["--arch", arch, "--smoke", "--device", "cpu", "--approx",
             "simdive", "--batch", "2", "--prompt-len", "8", "--gen", "3",
             "--scheduler", "--requests", "5", "--shed-depth", "3"]
    if t_get_config(arch).family == "hybrid":
        with pytest.raises(ValueError, match="family 'hybrid'"):
            t_serve.main(drill)
        assert not any(launch_counts().values())
        return
    t_serve.main(drill)
    out = capsys.readouterr().out
    assert "# scheduler: warmed 6 executable(s) across 3 level(s)" in out
    assert "# drill: 5 request(s) in" in out
    assert "sheds=1 recovers=1" in out
    assert not any(launch_counts().values())
