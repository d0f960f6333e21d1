"""Attention-free sequence mixer: RWKV6 (Finch).

Counterpart of the rwkv6 half of ``repro.models.ssm`` (the Mamba2 half,
which the hybrid zamba2 stack needs, is not ported). The WKV recurrence is
chunked as in the reference: the sequence is cut into chunks of ``Tc``
tokens, each chunk a small dense ``O(Tc^2)`` problem, and the ``(B, H, dk,
dk)`` float32 state carries from one chunk to the next, here in a Python
loop where the reference runs ``lax.scan`` (``jax.checkpoint`` has no
counterpart: serving takes no gradient). A decode step is a chunk of one
token through the same arithmetic.

The r / k / v / g / output projections and the channel mix's three linears
go through :func:`~repro_torch.models.layers.dense`, so ``--emulate`` runs
them on the SIMDive ``logmatmul`` kernel; every one but the output
projection multiplies float32 activations (the token-shift mix is float32,
and ``dense`` multiplies in the input's dtype). The token-shift and decay
LoRA paths stay exact, as in the reference: they feed ``exp(-exp(.))``,
where a log-domain error would compound across the recurrence. No softmax
and no divider: ``--approx simdive`` alone runs no SIMDive kernel here
(the channel mix's gate is a plain sigmoid, whatever the reference's module
docstring says).

Every function takes its device from its inputs and reads nothing on the
host, so a prefill and a decode step run inside captured CUDA graphs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig
from .layers import EXACT, dense, rmsnorm

LORA_R = 32          # token-shift ddlerp low-rank
DECAY_LORA_R = 64    # data-dependent decay low-rank


def rwkv6_leaves(d_model, n_heads, d_ff):
    """One RWKV6 layer's leaves ``(path, shape, init)`` in the order of the
    reference's ``init_rwkv6``: ``init`` is a fan-in (uniform(+-fan_in^-0.5);
    the LoRA ``ts_b`` / ``wd_b`` draw at +-R^-0.5, their rank's), ``"ones"``
    (norm gains), ``("limit", 0.5)`` (uniform(+-0.5): the token-shift mus and
    the bonus) or ``("full", value)`` (``mu_base`` 0.5, the decay base
    ``w0`` -6)."""
    D, dk = d_model, d_model // n_heads
    half = ("limit", 0.5)
    return [
        (("ln1", "w"), (D,), "ones"),
        (("ln2", "w"), (D,), "ones"),
        (("mu_base",), (D,), ("full", 0.5)),
        (("mu",), (5, D), half),
        (("ts_a",), (D, 5 * LORA_R), D),
        (("ts_b",), (5, LORA_R, D), LORA_R),
        (("wr",), (D, D), D),
        (("wk",), (D, D), D),
        (("wv",), (D, D), D),
        (("wg",), (D, D), D),
        (("wo",), (D, D), D),
        (("w0",), (D,), ("full", -6.0)),
        (("wd_a",), (D, DECAY_LORA_R), D),
        (("wd_b",), (DECAY_LORA_R, D), DECAY_LORA_R),
        (("u_bonus",), (n_heads, dk), half),
        (("ln_x", "w"), (D,), "ones"),
        (("cm_mu",), (2, D), half),
        (("cm_wk",), (D, d_ff), D),
        (("cm_wv",), (d_ff, D), d_ff),
        (("cm_wr",), (D, D), D),
    ]


def _wkv_chunk(state, r, k, v, w, u):
    """One chunk of the WKV recurrence, O(Tc^2) intra-chunk, in float32
    (float64 when the state is float64: a reference for its round-off).

    state: (B,H,dk,dv); r,k,w: (B,Tc,H,dk); v: (B,Tc,H,dv); u: (H,dk).
    Decay convention (RWKV6):
      y_t = sum_{s<t} (r_t ⊙ prod_{s<τ<t} w_τ)·k_s v_s + (r_t ⊙ u ⊙ k_t) v_t
      S_{t+1} = diag(w_t) S_t + k_t v_t^T
    in the reference's log / cumsum / exp form, at every Tc (a decode
    step's Tc = 1 included): ``exp(log w)`` is not ``w`` bit for bit, and
    a step recurrence ``w * S + k v^T`` drifts from the reference over a
    model's layers and steps. Returns ``(state', y (B,Tc,H,dv))``.
    """
    Tc = k.shape[1]
    dt = torch.promote_types(state.dtype, torch.float32)
    rf, kf, vf = r.to(dt), k.to(dt), v.to(dt)
    lw = torch.log(torch.clamp(w.to(dt), 1e-38, 1.0))
    c = torch.cumsum(lw, dim=1)                      # inclusive Σ_{τ<=t} lw
    # state contribution: r_t ⊙ prod_{τ<t} w_τ = r_t ⊙ exp(c_{t-1})
    c_prev = c - lw                                  # Σ_{τ<t}
    y_state = torch.einsum("bthd,bhdv->bthv", rf * torch.exp(c_prev), state)
    # intra-chunk: D[t,s,d] = exp(c_{t-1,d} - c_{s,d}) for s < t; the
    # pairwise differences are <= 0 there (masked elsewhere), so no overflow
    diff = c_prev[:, :, None] - c[:, None]           # (B,Tc,Tc,H,dk)
    t = torch.arange(Tc, device=k.device)
    mask = t[:, None] > t[None, :]
    dec = torch.exp(torch.clamp(diff, max=0.0)) * mask[None, :, :, None, None]
    scores = torch.einsum("bthd,btshd,bshd->bths", rf, dec, kf)
    y_intra = torch.einsum("bths,bshv->bthv", scores, vf)
    # current-token bonus
    ru = rf * u[None, None].to(dt)
    y_bonus = torch.einsum("bthd,bthd->bth", ru, kf)[..., None] * vf
    y = y_state + y_intra + y_bonus
    # state update: S' = diag(prod w) S + Σ_s (prod_{τ>s} w_τ) k_s v_s^T
    tot = c[:, -1]                                   # (B,H,dk)
    k_dec = kf * torch.exp(tot[:, None] - c)
    state_new = torch.exp(tot)[..., None] * state + torch.einsum(
        "bthd,bthv->bhdv", k_dec, vf)
    return state_new, y


def _token_shift(x, x_prev):
    """``x`` in float32 and its shift difference ``sx`` = (the previous
    token, ``x_prev`` before the first) - ``x``."""
    xf = x.to(torch.float32)
    xs = torch.cat([x_prev[:, None].to(torch.float32), xf[:, :-1]], 1)
    return xf, xs - xf


def rwkv6_time_mix(p, x, x_prev, state, n_heads, chunk=64,
                   approx: ApproxConfig = EXACT):
    """x: (B,T,D). x_prev: (B,D) last token of the previous segment.
    state: (B,H,dk,dk) float32. Returns ``(y (B,T,D) in x's dtype, new
    x_prev (B,D), new state)``.

    The r / k / v / g projections take the float32 mixed inputs, the
    output projection ``x``'s dtype. A tail that does not fill the last
    chunk is padded with identity steps (w = 1, k = 0), as in the
    reference.
    """
    B, T, D = x.shape
    H = n_heads
    dk = D // H
    f32 = torch.float32
    xf, sx = _token_shift(x, x_prev)
    # ddlerp: 5 mixed inputs (r,k,v,w,g)
    base = xf + sx * p["mu_base"].to(f32)
    ts = torch.tanh(base @ p["ts_a"].to(f32)).reshape(B, T, 5, LORA_R)
    off = torch.einsum("btnr,nrd->nbtd", ts, p["ts_b"].to(f32))
    mix = xf[None] + sx[None] * (p["mu"].to(f32)[:, None, None] + off)
    xr, xk, xv, xw, xg = mix
    r = dense(xr, p["wr"], approx).reshape(B, T, H, dk)
    k = dense(xk, p["wk"], approx).reshape(B, T, H, dk)
    v = dense(xv, p["wv"], approx).reshape(B, T, H, dk)
    g = dense(xg, p["wg"], approx)
    dec_raw = p["w0"].to(f32) + torch.tanh(
        xw @ p["wd_a"].to(f32)) @ p["wd_b"].to(f32)
    w = torch.exp(-torch.exp(dec_raw)).reshape(B, T, H, dk)   # (0,1)

    Tc = min(chunk, T)
    pad = (-T) % Tc
    if pad:
        # identity-padded tail: w=1 (no decay), k=0 (no contribution)
        zpad = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, zpad), F.pad(k, zpad), F.pad(v, zpad)
        w = F.pad(w, zpad, value=1.0)
    s = state.to(f32)
    ys = []
    for lo in range(0, T + pad, Tc):
        s, y = _wkv_chunk(s, r[:, lo:lo + Tc], k[:, lo:lo + Tc],
                          v[:, lo:lo + Tc], w[:, lo:lo + Tc], p["u_bonus"])
        ys.append(y)
    y = torch.cat(ys, 1).reshape(B, T + pad, D)[:, :T]
    y = rmsnorm(y, p["ln_x"]["w"])                       # per-channel norm
    y = y * F.silu(g)
    out = dense(y.to(x.dtype), p["wo"], approx)
    return out, xf[:, -1].to(x.dtype), s


def rwkv6_channel_mix(p, x, x_prev, approx: ApproxConfig = EXACT):
    """x: (B,T,D), x_prev: (B,D). Returns ``(y (B,T,D), new x_prev)``, both
    in x's dtype; the three linears take float32 inputs."""
    xf, sx = _token_shift(x, x_prev)
    mu = p["cm_mu"].to(torch.float32)
    xk = xf + sx * mu[0]
    xr = xf + sx * mu[1]
    kk = torch.square(torch.relu(dense(xk, p["cm_wk"], approx)))
    rr = torch.sigmoid(dense(xr, p["cm_wr"], approx))
    out = rr * dense(kk, p["cm_wv"], approx)
    return out.to(x.dtype), xf[:, -1].to(x.dtype)


def rwkv6_block(p, x, carry, n_heads, chunk=64, approx: ApproxConfig = EXACT):
    """carry = dict(att_x, ffn_x, state). x: (B,T,D). Returns ``(x', new
    carry)``; the carry's tensors are new, never ``carry``'s own. Both
    norms are the exact ``rmsnorm`` (eps 1e-6) under any ``use_in_norm``,
    as in the reference."""
    h = rmsnorm(x, p["ln1"]["w"])
    att, ax, st = rwkv6_time_mix(p, h, carry["att_x"], carry["state"],
                                 n_heads, chunk, approx)
    x = x + att
    h = rmsnorm(x, p["ln2"]["w"])
    ffn, fx = rwkv6_channel_mix(p, h, carry["ffn_x"], approx)
    x = x + ffn
    return x, {"att_x": ax, "ffn_x": fx, "state": st}


def rwkv6_empty_carry(batch, d_model, n_heads, dtype, device):
    """Zero token shifts in ``dtype`` and a zero float32 state."""
    dk = d_model // n_heads
    return {
        "att_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "ffn_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads, dk, dk), dtype=torch.float32,
                             device=device),
    }
