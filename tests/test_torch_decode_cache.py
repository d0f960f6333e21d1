"""``models.layers.decode_attention`` (the write-then-attend oracle) in the
port, against the reference's, and the port's ``decode_attention_append``
held to it as ``tests/test_decode_cache.py`` holds the reference's.

Inputs are drawn with numpy from fixed seeds and go through both
packages on the CPU in float32. ``decode_attention`` against the
reference: 2e-5 (``tests/test_decode_cache.py``'s tolerance; both
compute the same float32 einsums and softmax, in their own order); the
append form against the oracle: the same. Under the SIMDive divider
both finalize on the same integer lanes, so the outputs agree to the
divider's output step (2^-15 of the row's scale at the width-16
attention divider's 15 fraction bits) where a float32 round-off moves
an operand across a lane edge.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx import ApproxConfig as RApprox
from repro.models.layers import decode_attention as r_decode_attention
from repro_torch.core.approx import ApproxConfig
from repro_torch.models.layers import (
    decode_attention,
    decode_attention_append,
)

torch.set_num_threads(1)

TOL = 2e-5
DIV_STEP = 2.0 ** -15


def _draw(seed, B, Smax, KVH, G, dh):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (n(B, KVH, G, dh), n(B, Smax, KVH, dh), n(B, Smax, KVH, dh),
            n(B, 1, KVH, dh), n(B, 1, KVH, dh))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("pos,window", [(0, 0), (1, 0), (5, 0), (14, 0),
                                        (3, 4), (7, 4), (15, 4)])
def test_decode_attention_matches_reference(pos, window):
    q, kc, vc, _, _ = _draw(pos + 7 * window, 2, 16, 3, 2, 8)
    want = r_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.int32(pos), window=window)
    got = decode_attention(*_t(q, kc, vc), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_decode_attention_per_row_positions_match_reference():
    q, kc, vc, _, _ = _draw(3, 3, 16, 2, 2, 8)
    pos = np.array([0, 6, 15], np.int32)
    want = r_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(pos))
    got = decode_attention(*_t(q, kc, vc), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_decode_attention_on_the_divider_matches_reference():
    q, kc, vc, _, _ = _draw(11, 2, 16, 2, 3, 8)
    want = np.asarray(r_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(9),
        approx=RApprox(mode="simdive")))
    got = decode_attention(*_t(q, kc, vc), 9,
                           approx=ApproxConfig(mode="simdive")).numpy()
    exact = decode_attention(*_t(q, kc, vc), 9).numpy()
    assert not np.allclose(got, exact, atol=1e-6)   # the divider ran
    scale = np.abs(vc).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=DIV_STEP * scale)


def _write(cache, new, slot):
    out = cache.copy()
    out[:, slot] = new[:, 0]
    return out


@pytest.mark.parametrize("pos", [0, 1, 5, 14])
def test_append_matches_write_then_attend_linear(pos):
    q, kc, vc, kn, vn = _draw(pos, 2, 16, 3, 2, 8)
    ref = decode_attention(*_t(q, _write(kc, kn, pos), _write(vc, vn, pos)),
                           pos)
    out = decode_attention_append(*_t(q, kc, vc, kn, vn), pos, pos)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos", [3, 7, 15])
def test_append_windowed_linear(pos):
    """A linear cache larger than the attention window."""
    W = 4
    q, kc, vc, kn, vn = _draw(100 + pos, 1, 16, 2, 1, 4)
    ref = decode_attention(*_t(q, _write(kc, kn, pos), _write(vc, vn, pos)),
                           pos, window=W)
    out = decode_attention_append(*_t(q, kc, vc, kn, vn), pos, pos,
                                  window=W)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos", [2, 7, 8, 13, 21])
def test_append_ring_matches_the_oracle_over_the_live_window(pos):
    """A ring cache (Smax == window) as a real decode leaves it, token t at
    slot t % Smax: the append form against the oracle over the ring with
    the new token written (every slot live once the ring has wrapped)."""
    B, Smax, KVH, G, dh = 1, 8, 1, 1, 4
    rng = np.random.default_rng(pos)
    tk = rng.standard_normal((pos + 1, dh)).astype(np.float32)
    tv = rng.standard_normal((pos + 1, dh)).astype(np.float32)
    kc = np.zeros((B, Smax, KVH, dh), np.float32)
    vc = np.zeros((B, Smax, KVH, dh), np.float32)
    for t in range(pos):
        kc[0, t % Smax, 0] = tk[t]
        vc[0, t % Smax, 0] = tv[t]
    kn, vn = tk[pos][None, None, None], tv[pos][None, None, None]
    q = rng.standard_normal((B, KVH, G, dh)).astype(np.float32)
    slot = pos % Smax
    out = decode_attention_append(*_t(q, kc, vc, kn, vn), pos, slot,
                                  ring_full=True)
    # the oracle: the ring with the new token in its slot; before the
    # ring wraps, the live slots are [0, pos], after it all of them
    live = min(pos, Smax - 1)
    ref = decode_attention(*_t(q, _write(kc, kn, slot), _write(vc, vn, slot)),
                           live if pos < Smax else Smax - 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
