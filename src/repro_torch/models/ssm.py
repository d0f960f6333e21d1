"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD).

Counterpart of ``repro.models.ssm``. Both recurrences are chunked as in the
reference: the sequence is cut into chunks of ``Tc`` tokens, each chunk a
small dense ``O(Tc^2)`` problem, and the float32 state (RWKV6's ``(B, H,
dk, dk)``, Mamba2's ``(B, H, N, P)``) carries from one chunk to the next,
here in a Python loop where the reference runs ``lax.scan``
(``jax.checkpoint`` has no counterpart: serving takes no gradient). A
decode step is a chunk of one token through the same arithmetic.

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

Mamba2 (the hybrid zamba2 stack's backbone): the in-projections ``wz | wx
| wb | wc | wdt`` and ``out_proj`` go through ``dense`` in the block's
activation dtype (bf16 when served), their outputs cast to float32; the
depthwise causal conv, the SSD recurrence, ``softplus(dt + dt_bias)``,
``A = -exp(A_log)`` and the gated ``rmsnorm(y * silu(z))`` stay exact
float32, as in the reference. Its gated norm is the plain ``rmsnorm``, not
``apply_norm``, so ``use_in_norm`` does not reach it (nor the block norm).

Every function takes its device from its inputs and reads nothing on the
host, so a prefill and a decode step run inside captured CUDA graphs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig
from repro_torch.launch.sharding import (
    all_gather,
    copy_to,
    rank_in,
    scatter_to,
)
from .layers import EXACT, QuantizedWeight, dense, rmsnorm

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


def _cols(w, full: int, axis: str):
    """``(split, lo, n)`` of a column-parallel linear on a bound mesh:
    ``dense``'s ``split`` (None where the weight is whole), this rank's
    first output column and its count, read from the weight's width."""
    n = (w.q if isinstance(w, QuantizedWeight) else w).shape[-1]
    if n == full:
        return None, 0, full
    return ("col", axis), rank_in(axis) * n, n


def _mine(t, split):
    """This rank's slice of the last dim of ``t``, whole on every rank (a
    replicated parameter or activation) — with the gradient summed over
    the ranks, which each use a slice of their own (``scatter_to``) —,
    or ``t`` unsplit."""
    return t if split is None else scatter_to(t, t.ndim - 1, split[1])


def _row(split):
    """The row-parallel ``split`` that pairs with a column ``split``."""
    return None if split is None else ("row", split[1])


def _norm(y, w, split, eps=1e-6):
    """``rmsnorm`` over all channels of ``y`` (``w`` its whole gains): on a
    bound mesh where ``y`` holds this rank's channels (``split``), over
    the whole ``y`` gathered, then this rank's channels — the unsplit
    norm bit for bit, as the SIMDive linear after it needs (one float32
    ulp there can move an operand across a quantization level)."""
    if split is None:
        return rmsnorm(y, w, eps)
    return _mine(rmsnorm(all_gather(y, split[1], -1), w, eps), split)


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

    On a bound mesh whose model ranks split ``wr`` / ``wk`` / ``wv`` /
    ``wg`` by columns (their heads; ``u_bonus`` and ``state`` are this
    rank's heads too) the WKV runs on this rank's heads, the decay is
    computed whole (its LoRA is replicated) and cut to them, the norm
    runs over all D channels (:func:`_norm`) and ``wo`` is row-parallel.
    ``x`` and ``x_prev`` are whole on every rank.
    """
    B, T, D = x.shape
    dk = D // n_heads
    split, _, n = _cols(p["wr"], D, "heads")
    H = n // dk
    f32 = torch.float32
    xf, sx = _token_shift(x, x_prev)
    # ddlerp: 5 mixed inputs (r,k,v,w,g)
    base = xf + sx * p["mu_base"].to(f32)
    ts = torch.tanh(base @ p["ts_a"].to(f32)).reshape(B, T, 5, LORA_R)
    off = torch.einsum("btnr,nrd->nbtd", ts, p["ts_b"].to(f32))
    mix = xf[None] + sx[None] * (p["mu"].to(f32)[:, None, None] + off)
    xr, xk, xv, xw, xg = mix
    r = dense(xr, p["wr"], approx, split).reshape(B, T, H, dk)
    k = dense(xk, p["wk"], approx, split).reshape(B, T, H, dk)
    v = dense(xv, p["wv"], approx, split).reshape(B, T, H, dk)
    g = dense(xg, p["wg"], approx, split)
    dec_raw = p["w0"].to(f32) + torch.tanh(
        xw @ p["wd_a"].to(f32)) @ p["wd_b"].to(f32)
    w = _mine(torch.exp(-torch.exp(dec_raw)), split).reshape(
        B, T, H, dk)                                         # (0,1)

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
    y = torch.cat(ys, 1).reshape(B, T + pad, n)[:, :T]
    y = _norm(y, p["ln_x"]["w"], split)                  # per-channel norm
    y = y * F.silu(g)
    out = dense(y.to(x.dtype), p["wo"], approx, _row(split))
    return out, xf[:, -1].to(x.dtype), s


def rwkv6_channel_mix(p, x, x_prev, approx: ApproxConfig = EXACT,
                      d_ff: int | None = None):
    """x: (B,T,D), x_prev: (B,D). Returns ``(y (B,T,D), new x_prev)``, both
    in x's dtype; the three linears take float32 inputs.

    On a bound mesh (``d_ff`` the whole hidden width) all three linears
    are column-parallel, as the reference's specs place them (``cm_wv``'s
    name matches the ``wv`` rule): the hidden activation is gathered
    before ``cm_wv`` (whose input gradient the column-parallel linear
    already sums over the ranks), and the output, this rank's channels of
    ``rr * (kk @ cm_wv)``, after it."""
    D = x.shape[-1]
    xf, sx = _token_shift(x, x_prev)
    mu = p["cm_mu"].to(torch.float32)
    xk = xf + sx * mu[0]
    xr = xf + sx * mu[1]
    ff = _cols(p["cm_wk"], d_ff or p["cm_wk"].shape[-1], "ff")[0]
    kk = torch.square(torch.relu(dense(xk, p["cm_wk"], approx, ff)))
    if ff is not None:
        kk = all_gather(kk, "ff", -1)
    rsplit = _cols(p["cm_wr"], D, "ff")[0]
    rr = torch.sigmoid(dense(xr, p["cm_wr"], approx, rsplit))
    out = rr * dense(kk, p["cm_wv"], approx, rsplit)
    if rsplit is not None:
        out = all_gather(out, "ff", -1)
    return out.to(x.dtype), xf[:, -1].to(x.dtype)


def rwkv6_block(p, x, carry, n_heads, chunk=64, approx: ApproxConfig = EXACT,
                d_ff: int | None = None):
    """carry = dict(att_x, ffn_x, state). x: (B,T,D). Returns ``(x', new
    carry)``; the carry's tensors are new, never ``carry``'s own. Both
    norms are the exact ``rmsnorm`` (eps 1e-6) under any ``use_in_norm``,
    as in the reference. On a bound mesh ``state`` is this rank's heads
    and ``d_ff`` the channel mix's whole hidden width."""
    h = rmsnorm(x, p["ln1"]["w"])
    att, ax, st = rwkv6_time_mix(p, h, carry["att_x"], carry["state"],
                                 n_heads, chunk, approx)
    x = x + att
    h = rmsnorm(x, p["ln2"]["w"])
    ffn, fx = rwkv6_channel_mix(p, h, carry["ffn_x"], approx, d_ff)
    x = x + ffn
    return x, {"att_x": ax, "ffn_x": fx, "state": st}


def rwkv6_empty_carry(batch, d_model, n_heads, dtype, device,
                      local_heads: int | None = None):
    """Zero token shifts in ``dtype`` and a zero float32 state
    (``local_heads`` of its heads: a rank's on a mesh)."""
    dk = d_model // n_heads
    return {
        "att_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "ffn_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, local_heads or n_heads, dk, dk),
                             dtype=torch.float32, device=device),
    }


# ================================================================== Mamba2 =
CONV_K = 4


def mamba2_leaves(d_model, d_state, head_dim):
    """One Mamba2 layer's leaves ``(path, shape, init)`` in the order of the
    reference's ``init_mamba2`` (``d_inner = 2 * d_model``, ``H = d_inner /
    head_dim`` heads): the in-projections z | x | B | C | dt at fan-in
    ``d_model`` and ``out_proj`` at ``d_inner``, the conv taps at
    uniform(+-CONV_K^-0.5), a zero conv bias and ``dt_bias``, unit norms and
    skip ``D``, and ``A_log = log(linspace(1, 16, H))``
    (``("loglinspace", (1.0, 16.0))``). The reference draws ``wb`` and
    ``out_proj`` from one key; the port's streams differ anyway (see
    ``init_stack``), so each is its own draw at its distribution."""
    D, N = d_model, d_state
    d_inner = 2 * D
    H = d_inner // head_dim
    return [
        (("norm", "w"), (D,), "ones"),
        (("wz",), (D, d_inner), D),
        (("wx",), (D, d_inner), D),
        (("wb",), (D, N), D),
        (("wc",), (D, N), D),
        (("wdt",), (D, H), D),
        (("conv_x",), (CONV_K, d_inner), CONV_K),
        (("conv_b",), (CONV_K, N), CONV_K),
        (("conv_c",), (CONV_K, N), CONV_K),
        (("conv_bias",), (d_inner + 2 * N,), "zeros"),
        (("A_log",), (H,), ("loglinspace", (1.0, 16.0))),
        (("D",), (H,), "ones"),
        (("dt_bias",), (H,), "zeros"),
        (("out_norm", "w"), (d_inner,), "ones"),
        (("out_proj",), (d_inner, D), d_inner),
    ]


def _ssd_chunk(state, x, B_m, C_m, dt, A):
    """One chunk of the SSD recurrence, in float32 (float64 when the state
    is float64: a reference for its round-off).

    state: (B,H,N,P); x: (B,Tc,H,P); B_m / C_m: (B,Tc,N); dt: (B,Tc,H); A:
    (H,) negative. With the log decay ``c_t`` = the inclusive cumsum of
    ``dt * A``:
      y_t = exp(c_t) C_t . S_0 + sum_{s<=t} exp(c_t - c_s) (C_t . B_s) dt_s x_s
      S'  = exp(c_T) S_0 + sum_s exp(c_T - c_s) dt_s B_s x_s^T
    Returns ``(state', y (B,Tc,H,P))``.
    """
    ft = torch.promote_types(state.dtype, torch.float32)
    x, B_m, C_m, dt, A = (t.to(ft) for t in (x, B_m, C_m, dt, A))
    c = torch.cumsum(dt * A, dim=1)                  # (B,Tc,H), inclusive
    # inter-chunk: S_0's coefficient at step t is prod_{tau<=t} a = exp(c_t)
    y_inter = torch.einsum("btn,bhnp->bthp", C_m, state) \
        * torch.exp(c)[..., None]
    # intra-chunk: dec[t,s] = exp(c_t - c_s) for s <= t. The difference is
    # clamped at 0 before the exp, as the reference does, and only then
    # masked: above the diagonal it is positive and its exp may be inf,
    # and inf * 0 is NaN
    Tc = x.shape[1]
    t = torch.arange(Tc, device=x.device)
    mask = t[:, None] >= t[None, :]
    dec = torch.exp(torch.clamp(c[:, :, None] - c[:, None], max=0.0)) \
        * mask[None, :, :, None]                     # (B,Tc,Tc,H)
    cb = torch.einsum("btn,bsn->bts", C_m, B_m)
    # the reference's 4-operand einsum bts,btsh,bsh,bshp->bthp: the (b, t,
    # s, h) weight first, then one contraction with x over s (materialised
    # as written it is (B,Tc,Tc,H,P), 1.34 GB a chunk at zamba2's width)
    w = cb[..., None] * dec * dt[:, None]
    y_intra = torch.einsum("btsh,bshp->bthp", w, x)
    # state update
    tot = c[:, -1]                                   # (B,H)
    k_dec = torch.exp(tot[:, None] - c) * dt         # (B,Tc,H)
    state_new = torch.exp(tot)[:, :, None, None] * state + torch.einsum(
        "bsn,bshp->bhnp", B_m, k_dec[..., None] * x)
    return state_new, y_inter + y_intra


def _causal_conv(seq, w, bias):
    """Depthwise causal conv of float32 ``seq`` (B, CONV_K-1+T, C), which
    already has CONV_K-1 left context rows, with taps ``w`` (CONV_K, C):
    the terms summed in float32 from tap 0 on, as the reference's Python
    ``sum`` (whose ``0 + term 0`` is term 0), then ``silu(out + bias)``."""
    T = seq.shape[1] - (CONV_K - 1)
    wf = w.to(torch.float32)
    out = seq[:, :T] * wf[0]
    for i in range(1, CONV_K):
        out = out + seq[:, i:i + T] * wf[i]
    return F.silu(out + bias)


def mamba2_mix(p, x, conv_state, ssm_state, d_state, head_dim, chunk=128,
               approx: ApproxConfig = EXACT):
    """x: (B,T,D). conv_state: (B,CONV_K-1,d_inner+2N) in the cache dtype;
    ssm_state: (B,H,N,P) float32. Returns ``(y (B,T,D) in x's dtype, new
    conv_state in x's dtype, new ssm_state)``.

    The projections multiply in x's dtype; a tail that does not fill the
    last chunk is padded with identity steps (``dt = 0``: decay 1, no
    input), as in the reference. ``softplus`` is ``logaddexp(v, 0)``, the
    reference's form.

    On a bound mesh whose model ranks split ``wz`` / ``wx`` / ``wdt`` by
    columns (and ``conv_x`` by channel): the SSD runs on this rank's
    heads, ``B`` / ``C`` (replicated) whole, the conv state holds this
    rank's x channels and all of B and C (``(B, CONV_K-1, d_inner / tp +
    2N)``), the gated norm's sum of squares is added over the ranks and
    ``out_proj`` is row-parallel.
    """
    B, T, D = x.shape
    d_inner = 2 * D
    N = d_state
    split, _, n = _cols(p["wz"], d_inner, "ssm_heads")
    H = n // head_dim
    f32 = torch.float32
    z = dense(x, p["wz"], approx, split).to(f32)
    xbc = torch.cat([dense(x, p["wx"], approx, split).to(f32),
                     dense(x, p["wb"], approx).to(f32),
                     dense(x, p["wc"], approx).to(f32)], dim=-1)
    dt_raw = dense(x, p["wdt"], approx, split).to(f32)
    seq = torch.cat([conv_state.to(f32), xbc], dim=1)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    bias = p["conv_bias"]
    if split is not None:
        bias = torch.cat([_mine(bias[:d_inner], split), bias[d_inner:]])
    xbc_c = _causal_conv(seq, conv_w, bias.to(f32))
    xs, B_m, C_m = torch.split(xbc_c, [n, N, N], dim=-1)
    if split is not None:
        # B and C, whole on every rank, meet this rank's heads alone
        B_m, C_m = copy_to(B_m, split[1]), copy_to(C_m, split[1])
    xs = xs.reshape(B, T, H, head_dim)
    v = dt_raw + _mine(p["dt_bias"], split).to(f32)
    dt = torch.logaddexp(v, v.new_zeros(()))                 # (B,T,H)
    A = -torch.exp(_mine(p["A_log"], split).to(f32))

    Tc = min(chunk, T)
    pad = (-T) % Tc
    xp, Bp, Cp, dtp = xs, B_m, C_m, dt
    if pad:
        # identity-padded tail: dt=0 => decay 1 and zero input contribution
        xp = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bp, Cp, dtp = (F.pad(t, (0, 0, 0, pad)) for t in (B_m, C_m, dt))
    s = ssm_state.to(f32)
    ys = []
    for lo in range(0, T + pad, Tc):
        hi = lo + Tc
        s, y = _ssd_chunk(s, xp[:, lo:hi], Bp[:, lo:hi], Cp[:, lo:hi],
                          dtp[:, lo:hi], A)
        ys.append(y)
    y = torch.cat(ys, 1).reshape(B, T + pad, n)[:, :T]
    # the skip term: D repeated over each head's head_dim channels (a
    # broadcast; the elementwise products are the reference's)
    y = y + (xs * _mine(p["D"], split).to(f32)[:, None]).reshape(B, T, n)
    y = _norm(y * F.silu(z), p["out_norm"]["w"], split)
    out = dense(y.to(x.dtype), p["out_proj"], approx, _row(split))
    new_conv = seq[:, -(CONV_K - 1):].to(x.dtype)
    return out, new_conv, s


def mamba2_block(p, x, carry, d_state, head_dim, chunk=128,
                 approx: ApproxConfig = EXACT):
    """carry = dict(conv, ssm). x: (B,T,D). Returns ``(x', new carry)``;
    the carry's tensors are new, never ``carry``'s own. The block norm is
    the exact ``rmsnorm`` (eps 1e-6) under any ``use_in_norm``, as in the
    reference."""
    h = rmsnorm(x, p["norm"]["w"])
    y, conv, ssm = mamba2_mix(p, h, carry["conv"], carry["ssm"], d_state,
                              head_dim, chunk, approx)
    return x + y, {"conv": conv, "ssm": ssm}


def mamba2_empty_carry(batch, d_model, d_state, head_dim, dtype, device,
                       local_inner: int | None = None):
    """A zero conv window in ``dtype`` and a zero float32 state
    (``local_inner`` of the inner channels and their heads: a rank's on a
    mesh)."""
    d_inner = local_inner or 2 * d_model
    H = d_inner // head_dim
    return {
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, d_state, head_dim),
                           dtype=torch.float32, device=device),
    }
