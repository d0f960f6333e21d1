"""Port vs reference: the modality-stub families, qwen2-vl-2b and
musicgen-medium.

qwen2-vl-2b: M-RoPE (``rope_tables`` on ``(B,S,3)`` positions, each
frequency section driven by its own coordinate) and the vision stub
(precomputed patch embeddings merged position-aligned at ``patch_mask``).
musicgen-medium: the gelu MLP (tanh form, no gate), sinusoidal positions
added at the embedding, and 4 codebooks (embeddings summed, one head a
codebook, ``(B,C)`` tokens a step).

The layers are held to the reference's functions on numpy-seeded inputs;
the smoke models are served end to end against the reference with the
helpers of ``test_torch_model`` (float32, the same init carried over by
``params_from_reference``). The reference's ``generate`` takes ``(B,P)``
prompts alone, so a codebook generate is held to a greedy loop built from
the reference's ``prefill``, ``merge_cache`` and ``decode_step``.
"""
from dataclasses import asdict, replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as r_get_config
from repro.launch import serve as r_serve
from repro.models import build as r_build
from repro.models import layers as r_layers
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as t_serve
from repro_torch.launch.scheduler import Scheduler
from repro_torch.models import build as t_build
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import QuantizedWeight
from test_torch_model import (B, EMULATE_LOGIT_TOL, EXACT_LOGIT_TOL, GEN, P,
                              SIMDIVE_LOGIT_TOL, _check_generate,
                              _check_linears, _pair)
from test_torch_serve import fake_capture  # noqa: F401  (a fixture)

torch.set_num_threads(1)

VLM, AUDIO = "qwen2-vl-2b", "musicgen-medium"
ARCHS = (VLM, AUDIO)
# float32 RoPE tables: both sides take cos / sin of the same float32
# angles, up to an ulp of theta ** (-i / half) apart; angles reach ~40
# here, so an ulp of the angle is ~4e-6
ROPE_TOL = 2e-5
# float32 gelu MLP: the same products summed in another order
MLP_TOL = 2e-6


# ------------------------------------------------------------- the configs --
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_modality_configs_equal_reference_field_for_field(arch, smoke):
    r_cfg = asdict(r_get_config(arch, smoke=smoke))
    t_cfg = asdict(t_get_config(arch, smoke=smoke))
    r_approx, t_approx = r_cfg.pop("approx"), t_cfg.pop("approx")
    assert t_cfg == r_cfg
    assert (r_approx.pop("backend"), t_approx.pop("backend")) == ("ref", "auto")
    assert t_approx == r_approx
    assert t_cfg["family"] == {VLM: "vlm", AUDIO: "audio"}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_modality_init_distributions_and_tree_match_reference(arch):
    """The reference's tree: ``embed`` and ``head`` one table a codebook,
    a gelu MLP with ``w1`` and ``w2`` alone."""
    from test_torch_model import \
        test_init_distributions_and_tree_match_reference as check
    check(arch)
    *_, t_cfg, t_lm, _ = _pair("exact", arch=arch)
    own = t_lm.init(0)
    C = max(t_cfg.n_codebooks, 1)
    assert own["embed"].shape == (C, t_cfg.vocab_size, t_cfg.d_model)
    assert own["head"].shape == (C, t_cfg.d_model, t_cfg.vocab_size)
    mlp = own["stack"]["layers"]["mlp"]
    assert sorted(mlp) == (["w1", "w2"] if t_cfg.act == "gelu"
                           else ["w1", "w2", "w3"])


@pytest.mark.parametrize("arch", ARCHS)
def test_modality_params_from_reference_refuses_drifted_trees(arch):
    from test_torch_model import \
        test_params_from_reference_refuses_drifted_trees as check
    check(arch)
    _, _, r_params, t_cfg, _, _ = _pair("exact", arch=arch)
    tree = jax.tree.map(np.asarray, r_params)
    layers = tree["stack"]["layers"]
    mlp = layers["mlp"]
    if t_cfg.act == "gelu":
        # a gate the gelu MLP does not have; the gated config misses it
        gated = {**tree, "stack": {"layers": {**layers, "mlp": {
            **mlp, "w3": np.zeros_like(mlp["w1"])}}}}
        with pytest.raises(ValueError, match="unexpected.*'w3'"):
            params_from_reference(gated, t_cfg)
        with pytest.raises(ValueError, match="missing.*'w3'"):
            params_from_reference(tree, replace(t_cfg, act="swiglu"))
    if t_cfg.n_codebooks:
        # one table where the config has a codebook each, and back
        for leaf in ("embed", "head"):
            one = {**tree, leaf: tree[leaf][:1]}
            with pytest.raises(ValueError, match=f"leaf {leaf}: shape"):
                params_from_reference(one, t_cfg)
        with pytest.raises(ValueError, match="leaf embed: shape"):
            params_from_reference(tree, replace(t_cfg, n_codebooks=0))


# ------------------------------------------------------------------ layers --
def _grid_positions(batch, seq, grid_h, grid_w, start=0):
    """Qwen2-VL's M-RoPE positions (numpy ``(batch, seq, 3)``) for
    ``start`` text slots, a ``grid_h x grid_w`` image (t = start, h =
    start + row, w = start + col), then text continuing at one past the
    image's largest coordinate on all three."""
    n_img = grid_h * grid_w
    pos = np.zeros((seq, 3), np.int64)
    pos[:start] = np.arange(start)[:, None]
    rows, cols = np.divmod(np.arange(n_img), grid_w)
    pos[start:start + n_img] = np.stack(
        [np.zeros(n_img, np.int64), rows, cols], -1) + start
    nxt = start + max(grid_h, grid_w)
    pos[start + n_img:] = (nxt + np.arange(seq - start - n_img))[:, None]
    return np.broadcast_to(pos, (batch, seq, 3)).copy()


@pytest.mark.parametrize("dh_rot,sections,theta", [
    (32, (6, 5, 5), 10000.0),          # qwen2-vl smoke
    (128, (16, 24, 24), 1e6),          # qwen2-vl-2b
    (20, None, 10000.0),               # the default split, (4, 3, 3)
])
def test_rope_tables_mrope_match_reference(dh_rot, sections, theta):
    """``(B,S,3)`` positions whose t, h and w differ (an image grid after
    two text slots, random rows besides): each frequency section takes
    its own coordinate, as the reference's ``take_along_axis`` does."""
    rng = np.random.default_rng(3)
    pos = np.concatenate([_grid_positions(1, 24, 3, 5, start=2),
                          rng.integers(0, 40, (2, 24, 3))])
    assert (pos[..., 0] != pos[..., 1]).any() and \
        (pos[..., 1] != pos[..., 2]).any()
    want = r_layers.rope_tables(jnp.asarray(pos, jnp.int32), dh_rot, theta,
                                sections)
    got = t_layers.rope_tables(torch.from_numpy(pos), dh_rot, theta,
                               sections)
    for w, g in zip(want, got):
        assert g.shape == (3, 24, dh_rot // 2) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ROPE_TOL)
    # each section reads its own coordinate: moving only h moves only h's
    secs = sections or (4, 3, 3)
    moved = pos.copy()
    moved[..., 1] += 7
    cos2 = t_layers.rope_tables(torch.from_numpy(moved), dh_rot, theta,
                                sections)[0]
    changed = (cos2 != got[0]).any(dim=(0, 1)).numpy()
    lo, hi = secs[0], secs[0] + secs[1]
    assert not changed[:lo].any() and not changed[hi:].any()
    assert changed[lo:hi].all()


def test_rope_tables_mrope_equal_coordinates_is_plain_rope():
    """The decode step's M-RoPE positions (one position on all three
    coordinates) give plain RoPE's tables bit for bit; bad sections and
    positions of another rank raise."""
    pos = torch.arange(12).reshape(2, 6) * 5
    plain = t_layers.rope_tables(pos, 32, 1e6)
    mrope = t_layers.rope_tables(pos[..., None].expand(2, 6, 3), 32, 1e6,
                                 (6, 5, 5))
    assert all(torch.equal(a, b) for a, b in zip(plain, mrope))
    with pytest.raises(ValueError, match="do not split 16"):
        t_layers.rope_tables(pos[..., None].expand(2, 6, 3), 32, 1e6,
                             (6, 5, 4))
    with pytest.raises(ValueError, match="over 3 position coordinates"):
        t_layers.rope_tables(pos[..., None].expand(2, 6, 3), 32, 1e6,
                             (4, 4, 4, 4))
    with pytest.raises(ValueError, match=r"\(B,S\) or \(B,S,3\)"):
        t_layers.rope_tables(pos[0], 32, 1e6)


def test_mlp_gelu_matches_reference():
    """The gelu MLP (no gate) against the reference's in float32, and its
    activation the tanh form: ``jax.nn.gelu``'s default, not the erf form
    ``F.gelu`` defaults to."""
    rng = np.random.default_rng(4)
    D, Fd = 48, 96
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    p = {"w1": rng.standard_normal((D, Fd)).astype(np.float32) / D ** 0.5,
         "w2": rng.standard_normal((Fd, D)).astype(np.float32) / Fd ** 0.5}
    want = np.asarray(r_layers.mlp(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p), "gelu"))
    got = t_layers.mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                             for k, v in p.items()}, "gelu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MLP_TOL)
    h = torch.from_numpy(x) @ torch.from_numpy(p["w1"])
    assert float((F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max()) \
        > 100 * MLP_TOL
    with pytest.raises(ValueError, match="unknown activation 'relu'"):
        t_layers.mlp(torch.from_numpy(x), p, "relu")


def test_gelu_bf16_rounding_against_jax():
    """The bfloat16 activation on every normal bfloat16 input below 1e4 in
    magnitude, as the ``mlp`` docstring states it: torch rounds the tanh
    form once, JAX after each of its ops — one ulp of the result apart
    above x = -0.57 (but for inputs so small that a result is subnormal
    or flushed), at most 0.0156 anywhere."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < 1e4)
          & ((np.abs(x) >= 2.0 ** -126) | (x == 0))]
    want = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = F.gelu(torch.from_numpy(x).to(torch.bfloat16),
                 approximate="tanh").float().numpy()
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 2.0 ** -6
    assert 0 < (diff > 0).sum() <= 0.05 * x.size
    top = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 7)
    upper = (x > -0.57) & (np.abs(x) >= 2.0 ** -124)
    assert (diff[upper] <= ulp[upper]).all()


def _embed_pair(arch, **over):
    """bfloat16 (the served activation dtype) models of ``arch``'s smoke
    config with ``over`` applied, sharing the reference's init."""
    r_cfg = replace(r_get_config(arch, smoke=True), **over)
    t_cfg = replace(t_get_config(arch, smoke=True), **over)
    r_lm, t_lm = r_build(r_cfg), t_build(t_cfg, device="cpu")
    r_params = r_lm.init(jax.random.PRNGKey(1))
    return r_lm, r_params, t_lm, params_from_reference(
        jax.tree.map(np.asarray, r_params), t_cfg)


def test_embed_codebooks_and_sin_positions_match_reference():
    """musicgen's embedding in bfloat16: the 4 codebooks' embeddings
    summed in the reference's order, bit for bit; with the sinusoidal
    table added (computed in float32, cast, added), within one bfloat16
    ulp of each element where sin / cos round differently."""
    rng = np.random.default_rng(5)
    r_lm, r_params, t_lm, t_params = _embed_pair(AUDIO, pos_emb="rope")
    tokens = rng.integers(0, 128, (2, 9, 4))
    want = np.asarray(r_lm._embed(r_params, {"tokens": jnp.asarray(
        tokens, jnp.int32)}).astype(jnp.float32))
    got = t_lm._embed(t_params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 96)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # not a single codebook's, nor a float32 sum rounded once
    emb = t_params["embed"]
    f32_sum = sum(emb[c][torch.from_numpy(tokens[..., c])] for c in range(4))
    assert not torch.equal(got, f32_sum.to(torch.bfloat16))

    r_lm, r_params, t_lm, t_params = _embed_pair(AUDIO)
    pos = rng.integers(0, 600, (2, 9))
    for batch_pos in (None, pos):
        kw = {} if batch_pos is None else {"positions": batch_pos}
        want = np.asarray(r_lm._embed(r_params, {
            "tokens": jnp.asarray(tokens, jnp.int32),
            **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()}}
        ).astype(jnp.float32))
        got = t_lm._embed(t_params, {
            "tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in kw.items()}}).float()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -60)))
                      - 7)
        assert (np.abs(got.numpy() - want) <= ulp).all()
        assert (got.numpy() == want).mean() > 0.99


def test_embed_vision_stub_merge_is_position_aligned():
    """qwen2-vl's patch merge in bfloat16, bit for bit with the
    reference's, for a mask that starts at slot 3 and runs past the
    patches: patch ``s`` lands at slot ``s`` (not the first patch at the
    first masked slot), masked slots past the patches take zeros, the
    others keep their token embeddings."""
    rng = np.random.default_rng(6)
    r_lm, r_params, t_lm, t_params = _embed_pair(VLM)
    S, n_p = 12, 8
    tokens = rng.integers(0, 512, (2, S))
    pe = rng.standard_normal((2, n_p, 96)).astype(np.float32)
    mask = np.zeros((2, S), bool)
    mask[0, 3:10] = True
    mask[1, [2, 5, 6]] = True
    want = np.asarray(r_lm._embed(r_params, {
        "tokens": jnp.asarray(tokens, jnp.int32),
        "patch_embeds": jnp.asarray(pe), "patch_mask": jnp.asarray(mask)}
    ).astype(jnp.float32))
    got = t_lm._embed(t_params, {
        "tokens": torch.from_numpy(tokens), "patch_embeds":
        torch.from_numpy(pe), "patch_mask": torch.from_numpy(mask)})
    np.testing.assert_array_equal(got.float().numpy(), want)
    pe_bf = torch.from_numpy(pe).to(torch.bfloat16)
    plain = t_lm._embed(t_params, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(got[0, 3], pe_bf[0, 3])
    assert torch.equal(got[1, 2], pe_bf[1, 2])
    assert not got[0, 8:10].any()
    assert torch.equal(got[~torch.from_numpy(mask)],
                       plain[~torch.from_numpy(mask)])


# ------------------------------------------------------ the served models --
@pytest.mark.parametrize("mode,tol", [("exact", EXACT_LOGIT_TOL),
                                      ("simdive", SIMDIVE_LOGIT_TOL),
                                      ("mitchell", SIMDIVE_LOGIT_TOL)])
def test_qwen2_vl_smoke_generate_matches_reference(mode, tol):
    """The text path: ``(B,P)`` positions, plain RoPE through the M-RoPE
    config, as the reference's ``generate`` serves it."""
    _check_generate(mode, tol, arch=VLM)


@pytest.mark.parametrize("quantize", [False, True])
def test_qwen2_vl_smoke_generate_emulated_matches_reference(quantize):
    _check_generate("simdive", EMULATE_LOGIT_TOL, emulate=True,
                    quantize=quantize, arch=VLM)


def _reference_codebook_loop(r_lm, r_params, prompts, gen):
    """Greedy decode from the reference's ``prefill``, ``merge_cache`` and
    ``decode_step``: tokens (B, gen, C) and logits (B, gen, C, V)."""
    logits, cache = r_lm.prefill(r_params, {"tokens": jnp.asarray(
        prompts, jnp.int32)})
    cache = r_serve.merge_cache(r_lm.empty_cache(B, P + gen), cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, out = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(gen - 1):
        logits, cache = r_lm.decode_step(r_params, cache, tok,
                                         jnp.int32(P + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        out.append(np.asarray(logits))
    return np.stack(toks, axis=1), np.stack(out, axis=1)


def _check_codebook_generate(mode, tol, emulate=False, quantize=False):
    """musicgen's smoke model: ``generate`` on ``(B,P,C)`` prompts against
    :func:`_reference_codebook_loop`, as ``_check_generate`` holds the
    text models (every codebook's logits within ``tol`` while the
    prefixes agree, tokens equal where the margin decides them)."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair(
        mode, emulate, quantize, AUDIO)
    C, V = t_cfg.n_codebooks, t_cfg.vocab_size
    if quantize:
        head = t_params["head"]
        assert isinstance(head, QuantizedWeight)
        assert head.q.shape == (C, t_cfg.d_model, V)
        assert head.scale.shape == (C, 1, V)
    prompts = np.random.default_rng(0).integers(0, V, (B, P, C))
    want_tok, want_logits = _reference_codebook_loop(r_lm, r_params,
                                                     prompts, GEN)
    got_tok, got_logits = t_serve.generate(
        t_lm, t_params, torch.from_numpy(prompts), P + GEN, GEN,
        return_logits=True)
    got_tok, got_logits = got_tok.numpy(), got_logits.numpy()
    assert got_tok.shape == (B, GEN, C)
    assert got_logits.shape == want_logits.shape == (B, GEN, C, V)
    assert np.isfinite(got_logits).all()
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    rows = np.abs(got_logits - want_logits).max(-1)       # (B, gen, C)
    decided = (top2[..., 1] - top2[..., 0]) > 2 * np.minimum(rows, tol)
    for b in range(B):
        for i in range(GEN):
            np.testing.assert_allclose(got_logits[b, i], want_logits[b, i],
                                       rtol=0, atol=tol)
            ok = decided[b, i]
            assert (got_tok[b, i][ok] == want_tok[b, i][ok]).all(), (b, i)
            if (got_tok[b, i] != want_tok[b, i]).any():
                break                                    # prefixes diverged
    assert decided.mean() > 0.5
    if emulate:
        _check_linears(r_cfg, r_params, t_cfg, t_params)
    if mode != "exact":
        base = _pair(mode, arch=AUDIO) if emulate else _pair("exact",
                                                             arch=AUDIO)
        base_logits = t_serve.generate(
            base[4], base[5], torch.from_numpy(prompts), P + GEN, GEN,
            return_logits=True)[1].numpy()
        assert np.abs(base_logits[:, 0] - got_logits[:, 0]).max() > \
            10 * (SIMDIVE_LOGIT_TOL if emulate else tol)


@pytest.mark.parametrize("mode,tol", [("exact", EXACT_LOGIT_TOL),
                                      ("simdive", SIMDIVE_LOGIT_TOL),
                                      ("mitchell", SIMDIVE_LOGIT_TOL)])
def test_musicgen_smoke_generate_matches_reference(mode, tol):
    _check_codebook_generate(mode, tol)


@pytest.mark.parametrize("quantize", [False, True])
def test_musicgen_smoke_generate_emulated_matches_reference(quantize):
    """--emulate [--quantize]: the attention's four linears and the gelu
    MLP's two on the SIMDive matmul; the codebook heads stay exact, and
    under ``quantize_params`` the ``(C,D,V)`` head is int8, sliced a
    codebook at a time."""
    _check_codebook_generate("simdive", EMULATE_LOGIT_TOL, emulate=True,
                             quantize=quantize)


@pytest.mark.parametrize("mode,tol", [("exact", EXACT_LOGIT_TOL),
                                      ("simdive", SIMDIVE_LOGIT_TOL)])
def test_vision_stub_prefill_and_decode_match_reference(mode, tol):
    """A vision-stub prompt: 6 patch embeddings (a 2 x 3 grid) at slots
    0-5 and Qwen2-VL's M-RoPE positions (image t 0, h row, w col; text
    from 3 on all three), through both packages' ``prefill``; then decode
    steps from the merged cache at ``P + i``, the reference's positions.
    The same prefill with ``(B,P)`` arange positions differs: the
    sections are not ignored."""
    r_cfg, r_lm, r_params, t_cfg, t_lm, t_params = _pair(mode, arch=VLM)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, t_cfg.vocab_size, (B, P))
    pe = rng.standard_normal((B, 6, t_cfg.d_model)).astype(np.float32)
    mask = np.zeros((B, P), bool)
    mask[:, :6] = True
    pos = _grid_positions(B, P, 2, 3)
    assert pos[0, 5].tolist() == [0, 1, 2] and pos[0, 6].tolist() == [3] * 3
    batch = dict(tokens=tokens, patch_embeds=pe, patch_mask=mask,
                 positions=pos)
    want, r_cache = r_lm.prefill(r_params, {
        k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype)
        for k, v in batch.items()})
    got, t_cache = t_lm.prefill(t_params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(t_cache["k"].numpy(),
                               np.asarray(r_cache["k"]), rtol=0, atol=tol)
    flat, _ = t_lm.prefill(t_params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()
                                      if k != "positions"})
    assert float((flat - got).abs().max()) > 10 * tol
    r_cache = r_serve.merge_cache(r_lm.empty_cache(B, P + 3), r_cache)
    t_cache = t_serve.merge_cache(t_lm.empty_cache(B, P + 3), t_cache)
    r_tok = jnp.argmax(want, -1).astype(jnp.int32)
    t_tok = torch.from_numpy(np.asarray(r_tok).astype(np.int64))
    for i in range(3):
        want, r_cache = r_lm.decode_step(r_params, r_cache, r_tok,
                                         jnp.int32(P + i))
        got, t_cache = t_lm.decode_step(t_params, t_cache, t_tok, P + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol, err_msg=f"step {i}")
        r_tok = jnp.argmax(want, -1).astype(jnp.int32)
        t_tok = torch.from_numpy(np.asarray(r_tok).astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_scalar_and_per_row_decode_positions_agree_modality(arch):
    """A ``(B,)`` position tensor — what the captured step reads — gives
    the scalar position's step bit for bit: broadcast to ``(B,1,3)`` under
    M-RoPE, added as a sinusoid with ``(B,C)`` codebook tokens."""
    *_, t_cfg, t_lm, t_params = _pair("simdive", arch=arch)
    C = t_cfg.n_codebooks
    shape = (B, P, C) if C else (B, P)
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, t_cfg.vocab_size, shape))
    logits, cache = t_lm.prefill(t_params, {"tokens": prompts})
    tok = logits.argmax(-1)
    assert tok.shape == ((B, C) if C else (B,))

    def fresh():
        return t_serve.merge_cache(t_lm.empty_cache(B, P + 2),
                                   {k: v.clone() for k, v in cache.items()})

    a_logits, a_cache = t_lm.decode_step(t_params, fresh(), tok, P)
    b_logits, b_cache = t_serve.decode_body(t_lm, t_params, fresh(), tok,
                                            torch.full((B,), P))
    assert torch.equal(a_logits, b_logits)
    assert torch.equal(a_cache["k"], b_cache["k"])
    assert a_logits.shape == ((B, C, t_cfg.vocab_size) if C
                              else (B, t_cfg.vocab_size))


def test_codebook_slots_capture_the_step_and_prefill(fake_capture):
    """The captured graphs' buffers take codebook shapes: the step's token
    buffer is (B, C), the prefill's prompt buffer (B, P, C), and the
    body the step's graph captures, run under the capture machinery on
    the CPU, gives the eager step's logits."""
    *_, t_cfg, t_lm, t_params = _pair("simdive", arch=AUDIO)
    C = t_cfg.n_codebooks
    prompts = torch.from_numpy(np.random.default_rng(10).integers(
        0, t_cfg.vocab_size, (B, P, C)))
    pre = t_serve._PrefillSlot(t_lm, B, P, C)
    assert pre.tokens.shape == (B, P, C)
    fn = t_serve._GraphFn(t_lm)
    pre.tokens.copy_(prompts)
    logits, cache = fn._replay(pre, t_params, lambda: t_lm.prefill(
        t_params, {"tokens": pre.tokens}))
    slot = t_serve._Slot(t_lm, B, P + 2)
    assert slot.tok.shape == (B, C) and slot.pos.shape == (B,)
    t_serve.merge_cache(slot.cache, cache)
    want, _ = t_lm.decode_step(t_params, t_serve.merge_cache(
        t_lm.empty_cache(B, P + 2), cache), logits.argmax(-1), P)
    slot.tok.copy_(logits.argmax(-1))
    slot.pos.fill_(P)
    got, _ = fn._replay(slot, t_params, lambda: t_serve.decode_body(
        t_lm, t_params, slot.cache, slot.tok, slot.pos))
    assert torch.equal(got, want) and fn.captures == 2


# -------------------------------------------------------------- the CLI --
def test_qwen2_vl_serve_cli_on_cpu(capsys):
    """``serve --arch qwen2-vl-2b --smoke --device cpu``: a batched
    generate and the ``--scheduler`` drill, the text path of a dense
    config."""
    t_serve.main(["--arch", VLM, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3"])
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    t_serve.main(["--arch", VLM, "--smoke", "--device", "cpu", "--approx",
                  "simdive", "--batch", "2", "--prompt-len", "8", "--gen",
                  "3", "--scheduler", "--requests", "5", "--shed-depth",
                  "3"])
    out = capsys.readouterr().out
    assert "# scheduler: warmed 6 executable(s) across 3 level(s)" in out
    assert "# drill: 5 request(s) in" in out
    assert "sheds=1 recovers=1" in out
    assert not any(launch_counts().values())


def test_cli_and_scheduler_refuse_codebook_configs(monkeypatch):
    """The reference's CLI draws (B, P) prompts and its scheduler
    flattens each to (P,): a codebook config is refused by both, before
    any parameter is made."""
    from repro_torch.models.model import LM

    def no_init(*a, **k):
        raise AssertionError("parameters were made")

    monkeypatch.setattr(LM, "init", no_init)
    for extra in ([], ["--scheduler"]):
        with pytest.raises(NotImplementedError, match="codebook"):
            t_serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu",
                          "--approx", "simdive", *extra])
    with pytest.raises(NotImplementedError, match="codebook"):
        Scheduler(t_get_config(AUDIO, smoke=True), device="cpu")
