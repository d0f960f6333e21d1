"""Port vs reference: the training loss, the training stack and their
gradients.

``mean_xent`` with and without a mask; ``LM.train_loss``, ``LM.logits``
and every gradient leaf against ``jax.value_and_grad(lm.train_loss)`` on
all ten smoke configurations (MoE's aux loss, musicgen's codebooks, the
vision stub's batch, the recurrent and hybrid stacks), under ``EXACT`` and
``--approx simdive`` (emulated linears, straight-through gradients);
``backward='approx'`` is held the same way in
``test_torch_train_grads.py``, with this file's helpers. Both models get
the reference's random init (``params_from_reference``) and the same
numpy-seeded batch (each package's own ``SyntheticLM``, equal element for
element), in float32.

R-8 (ROADMAP): under the SIMDive divider no gradient reaches the
attention branch upstream of the finalize (its quotient comes out of
integer lanes): the reference's gradient there is exactly zero, the
port's ``None``. Also: the training attention never reaches the
forward-only attention kernel, which refuses inputs that require grad.
"""
from dataclasses import replace
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import ShapeConfig as RShape
from repro.core.approx import ApproxConfig as RApprox
from repro.data import make_source as r_make_source
from repro.models import build as r_build
from repro.models import loss as r_loss
from repro_torch.configs import ARCHS, get_config as t_get_config
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.tree import value_and_grad
from repro_torch.data import torch_batch
from repro_torch.models import build as t_build
from repro_torch.models import layers as t_layers
from repro_torch.models import loss as t_loss
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

B, S = 2, 32
MODES = {"exact": {}, "ste": {"mode": "simdive"},
         "approx_backward": {"mode": "simdive", "backward": "approx"}}
# EXACT, float32 end to end: both sides add the same products in other
# orders. Measured over the ten configs: loss within 4.8e-7, every
# gradient leaf within 8.3e-6 of its own largest |g| (zamba2's A_log,
# through the SSD chunks' exp / cumsum), logits within 1e-5. Bounds:
EXACT_LOSS_TOL = 1e-5
EXACT_GRAD_TOL = 1e-4          # of each leaf's largest |g|
EXACT_LOGIT_TOL = 1e-4
# the emulated linears (STE and backward='approx'): the integer cores are
# bit-equal (held product by product in test_torch_logmatmul.py), but each
# linear quantizes its input with ONE scale over the whole (B*S, K)
# activation, so an f32 round-off step in that input's largest element
# moves the scale and with it many 8-bit magnitudes by one unit: every
# logit row then differs by ~2e-2 (measured on smollm-360m), and every
# later layer and the gradients carry it. Measured over the ten configs
# (2.2-3.3x the largest measured):
EMULATED_LOSS_TOL = 1e-2       # measured 3.15e-3 (smollm-360m)
EMULATED_LOGIT_TOL = 1e-1      # measured 0.0458 (smollm-360m)
# a gradient leaf's L2 error over its L2 norm: measured 0.050 (zamba2's
# A_log, backward='approx': the SSD recurrence carries the flipped steps;
# <= 0.012 on every other config and leaf)
EMULATED_LEAF_TOL = 0.15
# 1 - the global cosine of the two gradient trees: measured 3.6e-4
# (zamba2, backward='approx'; <= 4.3e-5 elsewhere)
EMULATED_COSINE_TOL = 1e-3


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@lru_cache(maxsize=None)
def _run(arch, mode):
    """Loss, logits and gradients of both packages on one batch."""
    kw = MODES[mode]
    r_cfg = replace(r_get_config(arch, smoke=True), dtype="float32")
    t_cfg = replace(t_get_config(arch, smoke=True), dtype="float32")
    if kw:
        r_cfg = r_cfg.with_approx(RApprox(**kw))
        t_cfg = t_cfg.with_approx(TApprox(**kw))
    r_lm = r_build(r_cfg)
    r_params = r_lm.init(jax.random.PRNGKey(0))
    t_lm = t_build(t_cfg, device="cpu")
    t_params = params_from_reference(jax.tree.map(np.asarray, r_params),
                                     t_cfg)
    nb = r_make_source(r_cfg, RShape("t", S, B, "train"), seed=1).batch(0)
    r_batch = {k: jnp.asarray(v) for k, v in nb.items()}
    t_batch = torch_batch(nb, "cpu")
    # one compile for both (the reference's compile is most of a case)
    (r_l, r_g), r_logits = jax.jit(lambda p, b: (
        jax.value_and_grad(r_lm.train_loss)(p, b), r_lm.logits(p, b)))(
            r_params, r_batch)
    t_l, t_g = value_and_grad(t_lm.train_loss)(t_params, t_batch)
    with torch.no_grad():
        t_logits = t_lm.logits(t_params, t_batch)
    return (float(r_l), np.asarray(r_logits),
            dict(_flat(jax.tree.map(np.asarray, r_g))),
            float(t_l), t_logits.numpy(), dict(_flat(t_g)))


# ------------------------------------------------------------------- loss --
@pytest.mark.parametrize("masked", [False, True])
def test_mean_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7))
    mask = (rng.random((2, 7)) < 0.6) if masked else None
    want = r_loss.mean_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = t_loss.mean_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_tok = t_loss.xent(torch.from_numpy(logits).to(torch.bfloat16),
                          torch.from_numpy(labels))
    assert per_tok.dtype == torch.float32 and per_tok.shape == (2, 7)
    # an all-zero mask divides by max(0, 1): a zero loss, as the reference
    zero = np.zeros((2, 7), bool)
    assert float(t_loss.mean_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(zero))) == 0.0


def check_against_reference(arch, mode):
    """Loss, logits and every gradient leaf of ``arch`` under ``mode``
    within this file's tolerances; a leaf the port gives no gradient
    (``None``) is one the reference's gradient is exactly zero at, and a
    zero leaf of the reference's is ``None`` or zero in the port (zamba2's
    ``lora_a`` is zero in both under ``EXACT``: ``lora_b`` starts at
    zero)."""
    r_l, r_logits, r_g, t_l, t_logits, t_g = _run(arch, mode)
    assert set(r_g) == set(t_g)
    none = {k for k, g in t_g.items() if g is None}
    zero = {k for k, g in r_g.items() if not np.any(g)}
    assert none <= zero
    for k in zero - none:
        assert not torch.any(t_g[k]), k
    if mode == "exact":
        assert not none
        assert abs(t_l - r_l) <= EXACT_LOSS_TOL
        np.testing.assert_allclose(t_logits, r_logits, rtol=0,
                                   atol=EXACT_LOGIT_TOL)
        for k, want in r_g.items():
            got = t_g[k].numpy()
            assert np.abs(got - want).max() <= \
                EXACT_GRAD_TOL * np.abs(want).max(), k
        return
    assert abs(t_l - r_l) <= EMULATED_LOSS_TOL
    np.testing.assert_allclose(t_logits, r_logits, rtol=0,
                               atol=EMULATED_LOGIT_TOL)
    dot = n_got = n_want = 0.0
    for k, want in r_g.items():
        if k in none:
            continue
        got = t_g[k].numpy().astype(np.float64)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= EMULATED_LEAF_TOL, (k, err)
        dot += float(np.sum(got * want))
        n_got += float(np.sum(got * got))
        n_want += float(np.sum(want.astype(np.float64) ** 2))
    assert 1 - dot / np.sqrt(n_got * n_want) <= EMULATED_COSINE_TOL


@pytest.mark.parametrize("mode", ["exact", "ste"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_logits_and_grads_match_reference(arch, mode):
    check_against_reference(arch, mode)


def check_r8(arch, mode, against_exact=True):
    """ROADMAP R-8, pinned: with the SIMDive divider on, the q / k / v
    projections (and the attention norm) get no gradient — zero in the
    reference, ``None`` here — while (``against_exact``) the exact model's
    are nonzero; the output projection, downstream of the divider, gets
    one in both."""
    prefix = "stack/shared/" if arch == "zamba2-2.7b" else "stack/layers/"
    _, _, r_g, _, _, t_g = _run(arch, mode)
    for name in ("wq", "wk", "wv", "ln_attn/w"):
        assert t_g[prefix + name] is None
        assert not np.any(r_g[prefix + name])
    assert np.any(r_g[prefix + "wo"]) and t_g[prefix + "wo"] is not None
    if not against_exact:
        return
    _, _, r_g, _, _, t_g = _run(arch, "exact")
    for name in ("wq", "wk", "wv"):
        assert np.any(r_g[prefix + name])
        assert torch.count_nonzero(t_g[prefix + name]) > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b"])
def test_r8_divider_cuts_the_attention_branch_gradients(arch):
    check_r8(arch, "ste")


# -------------------------------------------------------------- attention --
def test_training_attention_never_reaches_the_forward_only_kernel(
        monkeypatch):
    """The training stack takes the chunked path whatever the attention
    op resolves to: with every attention resolved to ``cuda``, a served
    prefill (under ``no_grad``) reaches the kernel's route and the
    training loss never does, with gradients everywhere."""
    calls = []
    monkeypatch.setattr(t_layers, "resolve_backend", lambda b, *t: "cuda")
    monkeypatch.setattr(t_layers, "_flash_attention_kernel",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or torch.zeros_like(a[0]))
    cfg = replace(t_get_config("smollm-360m", smoke=True), dtype="float32")
    lm = t_build(cfg, device="cpu")
    params = lm.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    lm.prefill(params, {"tokens": toks})
    assert len(calls) == cfg.n_layers
    loss, grads = value_and_grad(lm.train_loss)(
        params, {"tokens": toks, "labels": toks.roll(-1, 1)})
    assert torch.isfinite(loss)
    assert all(g is not None for _, g in _flat(grads))
    assert len(calls) == cfg.n_layers
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 1, 2, 16, generator=g)
    k = torch.randn(1, 8, 1, 16, generator=g)
    v = torch.randn(1, 8, 1, 16, generator=g)
    want = t_layers.chunked_attention(q, k, v)
    monkeypatch.undo()
    assert torch.equal(t_layers.flash_attention(q, k, v), want)


def test_attention_kernel_refuses_inputs_that_require_grad():
    """The attention op resolved to ``cuda`` — its kernel's wrapper, both
    schedules — refuses q / k / v that require grad (the kernel has no
    backward) and names the training path; under ``no_grad`` it goes on
    to its other checks (here: the tensors lie on the CPU)."""
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(2, 8, 64, requires_grad=True)
    kv = torch.zeros(2, 8, 64)
    for block in (fa.DEFAULT_BLOCK, (*fa.DEFAULT_BLOCK, 2)):
        with pytest.raises(RuntimeError, match="chunked_attention"):
            fa.flash_attention_cuda(q, kv, kv, block=block)
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention_cuda(kv, kv, q, block=block)
        with torch.no_grad(), pytest.raises(ValueError,
                                            match="not on a CUDA device"):
            fa.flash_attention_cuda(q, kv, kv, block=block)


def test_remat_changes_no_number():
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); the loss and gradients are the same
    bits either way."""
    cfg = replace(t_get_config("qwen3-4b", smoke=True), dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    params = t_build(cfg, device="cpu").init(0)
    out = []
    for remat in (True, False):
        lm = t_build(replace(cfg, remat=remat), device="cpu")
        out.append(value_and_grad(lm.train_loss)(params, batch))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for (k, a), (_, b) in zip(_flat(g1), _flat(g2)):
        assert torch.equal(a, b), k
