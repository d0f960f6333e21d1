"""Model building blocks: norms, RoPE, attention, the MLP.

Counterpart of ``repro.models.layers`` for the dense attention family.
Tensor layouts are the reference's: ``q (B,Sq,KVH,G,dh)``,
``k, v (B,Skv,KVH,dh)``, decode caches ``(B,Smax,KVH,dh)``.

Attention has two routes, as in the reference. When the resolved backend
of the logical ``'attention'`` op is ``cuda`` the whole attention is one
launch of a kernel, divider included: the flash kernel for the prefill,
the ``decode_attention`` kernel for a decode step. Otherwise plain tensor
ops run (chunked online softmax for the prefill), with only the final
``acc / l`` — the paper's division use-case — routed through
:func:`repro_torch.core.approx.attention_div`. Training always takes the
chunked path (:func:`chunked_attention`): the kernels are forward-only,
as the reference's Pallas kernel is.

Every matmul goes through :func:`dense`, which understands plain float
weights, :class:`QuantizedWeight` (int8 + per-output-channel scale) and
the SIMDive emulation of ``ApproxConfig.emulate`` — on the card, every
emulated linear is one launch of the ``logmatmul`` kernel. RMSNorm is
exact, or with ``ApproxConfig.use_in_norm`` the log-domain
:func:`repro_torch.core.approx.approx_rmsnorm` (on the card one ``sqrt``
and one ``elemwise`` launch a norm); LayerNorm (with bias) is always
exact, as in the reference. RoPE takes ``(B,S)`` positions, or ``(B,S,3)``
(t, h, w) for M-RoPE; the MLP is swiglu or gelu (tanh form).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.approx import (
    ApproxConfig,
    approx_matmul,
    approx_matmul_int8,
    approx_rmsnorm,
    attention_div,
)
from repro_torch.kernels.decode_attention import decode_attention_acc
from repro_torch.kernels.registry import get_op, resolve_backend

EXACT = ApproxConfig()


# ---------------------------------------------------------------- weights --
@dataclass
class QuantizedWeight:
    """int8 sign-magnitude-compatible weight + per-output-channel scale."""
    q: torch.Tensor          # (..., K, N) int8
    scale: torch.Tensor      # (..., 1, N) float32

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, idx):
        """Slice the leading (stacked layer) axis of both fields."""
        return QuantizedWeight(q=self.q[idx], scale=self.scale[idx])


def uniform_(t: torch.Tensor, fan_in, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with uniform(+-fan_in^-0.5) from ``gen``: the
    values of ``torch.rand(t.shape) * (2 * lim) - lim``, with no copy."""
    lim = fan_in ** -0.5
    return t.uniform_(0, 1, generator=gen).mul_(2 * lim).sub_(lim)


def nest(flat: dict) -> dict:
    """``{path tuple: leaf}`` -> the nested parameter dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel int8. The reduction is over the input
    (second-to-last) dim, so stacked (L, K, N) weights keep their layer
    axis."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp(min=1e-30) / 127.0
    q = (w / scale).round().clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(q=q, scale=scale.to(torch.float32))


class _SplitLinear(torch.autograd.Function):
    """A plain (float) linear whose weight a mesh splits over the logical
    axis ``axis``: ``'col'`` (output dim; ``x`` replicated over the axis)
    or ``'row'`` (input dim; ``x`` split too). Where the ranks' partial
    sums are added — a row-parallel forward, a column-parallel input
    gradient — each rank's part is a float32 product and the parts are
    summed in float32, then rounded once to the activation dtype, as the
    unsplit product rounds its float32 accumulator once. Everything else
    is the activation-dtype matmul of the unsplit linear.

    ``seq`` (sequence parallelism; ``x`` (B,S,K)): a column-parallel
    linear takes the whole sequence (``full``, or gathered here) and
    reduce-scatters its input gradient's partial sums to this rank's
    rows; a row-parallel one reduce-scatters its output's and gathers its
    output gradient."""

    @staticmethod
    def forward(ctx, x, w, kind, axis, seq=False, full=None):
        from repro_torch.core.approx import _seq_whole
        from repro_torch.launch.sharding import all_reduce, reduce_scatter

        ctx.kind, ctx.axis, ctx.w_dtype, ctx.seq = kind, axis, w.dtype, seq
        w = w.to(x.dtype)               # the unsplit linear's cast weight
        if kind == "col":
            x = _seq_whole(x, axis, seq, full)
        ctx.save_for_backward(x, w)
        if kind == "col":
            return x @ w
        y = x.to(torch.float32) @ w.to(torch.float32)
        y = reduce_scatter(y, axis, 1) if seq else all_reduce(y, axis)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.approx import _seq_whole
        from repro_torch.launch.sharding import all_reduce, reduce_scatter

        x, w = ctx.saved_tensors
        if ctx.kind == "col":
            gx = g.to(torch.float32) @ w.to(torch.float32).T
            gx = reduce_scatter(gx, ctx.axis, 1) if ctx.seq \
                else all_reduce(gx, ctx.axis)
            gx = gx.to(x.dtype)
        else:
            g = _seq_whole(g.contiguous(), ctx.axis, ctx.seq)
            gx = g @ w.T
        # the weight gradient as autograd takes the unsplit one: the rows
        # folded, one mm
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw.to(ctx.w_dtype), None, None, None, None


def dense(x: torch.Tensor, w, approx: ApproxConfig = EXACT,
          split: tuple | None = None,
          full: torch.Tensor | None = None) -> torch.Tensor:
    """Matmul with quantized-weight and SIMDive-emulation support.

    A :class:`QuantizedWeight` under active emulation feeds its int8
    magnitudes straight into the emulated matmul
    (:func:`approx_matmul_int8`); inactive, it is dequantized. A float
    weight under active emulation runs :func:`approx_matmul`; otherwise
    the plain matmul in the activation dtype.

    ``split``: on a bound mesh, ``(kind, axis)`` — ``w`` is this rank's
    shard of a weight split over the logical ``axis``, by output columns
    (``'col'``: ``x`` replicated over the axis, the output split) or by
    input rows (``'row'``: ``x`` split, the output replicated). The result
    is this rank's part of the unsplit linear's (:class:`_SplitLinear`,
    :func:`approx_matmul`). ``(kind, axis, "seq")``: sequence
    parallelism, the axis's ranks also holding slices of the sequence
    (dim 1 of a (B,S,K) ``x``): a column-parallel ``x`` is this rank's
    slice (``full`` the whole sequence where the caller gathered it for
    several linears), a row-parallel output comes back as this rank's
    slice.
    """
    active = approx.enabled and approx.use_in_linear and approx.emulate \
        and approx.active_for("matmul")
    seq = split is not None and len(split) > 2
    if isinstance(w, QuantizedWeight):
        if split is None:
            if active:
                return approx_matmul_int8(x, w.q, w.scale, approx)
            return x @ (w.q.to(x.dtype) * w.scale.to(x.dtype))
        if active:
            raise NotImplementedError(
                "a split int8 QuantizedWeight under --emulate: its SIMDive "
                "product has no K-split form (the served int8 weights on a "
                "mesh run dequantized)")
        # this rank's dequantized shard, then the float split linear
        w = w.q.to(x.dtype) * w.scale.to(x.dtype)
    if active:
        kw = {"seq": True, "full": full} if seq else {}
        return approx_matmul(x, w.to(torch.float32), approx,
                             *(split[:2] if split else ()), **kw).to(x.dtype)
    if split is not None:
        from repro_torch.launch.sharding import group

        if group(split[1]) is not None:
            return _SplitLinear.apply(x, w, split[0], split[1], seq, full)
    return x @ w.to(x.dtype)


# ------------------------------------------------------------------ norms --
def rmsnorm(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * inv * w.to(torch.float32)).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def apply_norm(x, p, kind, eps=1e-6, approx: ApproxConfig = EXACT):
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    if approx.enabled and approx.use_in_norm:
        return approx_rmsnorm(x, p["w"], eps, approx)
    return rmsnorm(x, p["w"], eps)


# ------------------------------------------------------------------- rope --
def rope_tables(positions: torch.Tensor, dh_rot: int, theta: float,
                mrope_sections=None):
    """cos/sin tables, each (B,S,half). positions: (B,S) int, or (B,S,3)
    for M-RoPE (t, h, w).

    M-RoPE (Qwen2-VL): the ``dh_rot/2`` frequency slots are split into
    ``mrope_sections`` groups in order, each driven by its own position
    coordinate; without sections the split is ``(half//3 + half%3,
    half//3, half//3)``. Sections that do not add up to ``half``, or more
    sections than coordinates, raise ``ValueError``. The coordinates are
    picked with slices, so no host data reaches the card (the captured
    decode step builds its tables this way)."""
    half = dh_rot // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half)
    pos = positions.to(torch.float32)
    if positions.ndim == 3:
        secs = tuple(mrope_sections or (half // 3 + half % 3, half // 3,
                                        half // 3))
        if sum(secs) != half or len(secs) > positions.shape[-1]:
            raise ValueError(f"M-RoPE sections {secs} do not split {half} "
                             f"frequency slots over {positions.shape[-1]} "
                             "position coordinates")
        pos = torch.cat([pos[..., i:i + 1].expand(*pos.shape[:2], n)
                         for i, n in enumerate(secs)], dim=-1)  # (B,S,half)
        ang = pos * inv
    elif positions.ndim == 2:
        ang = pos[..., None] * inv
    else:
        raise ValueError(f"positions must be (B,S) or (B,S,3), got "
                         f"{tuple(positions.shape)}")
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rot_dims):
    """Rotate the first ``rot_dims`` features of x (B,S,H,dh)."""
    if rot_dims == 0:
        return x
    xr, xp = x[..., :rot_dims], x[..., rot_dims:]
    half = rot_dims // 2
    x1, x2 = xr[..., :half], xr[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rot, xp], dim=-1) if xp.shape[-1] else rot


# -------------------------------------------------------------- attention --
def _divider_on(approx: ApproxConfig) -> bool:
    """Whether an attention kernel's finalize runs the SIMDive divider."""
    return (approx.enabled and approx.use_in_softmax
            and approx.active_for("attention"))


def _finalize(acc, l, approx: ApproxConfig):
    """acc / l — softmax normalization; SIMDive divider when enabled (the
    logical ``'attention'`` op, policy-tunable per layer)."""
    if approx.enabled and approx.use_in_softmax:
        return attention_div(acc, l, approx)
    return acc / l[..., None]


def _flash_attention_kernel(q, k, v, *, causal, window, approx: ApproxConfig,
                            q_offset, spec, backend):
    """Serve attention from the registry's CUDA kernel.

    GQA bookkeeping: q flattens to the kernel's (BH, S, dh) contract with
    ``bh = (b * KVH + kvh) * G + g``; k, v flatten to (B * KVH, S, dh) and
    the kernel reads kv head ``bh // G`` (``kv_group=G``) instead of a
    materialised repeat.
    """
    B, Sq, KVH, G, dh = q.shape
    Skv = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KVH * G, Sq, dh)
    kf = k.permute(0, 2, 1, 3).reshape(B * KVH, Skv, dh)
    vf = v.permute(0, 2, 1, 3).reshape(B * KVH, Skv, dh)
    _, _, frac_out = approx.resolve_attention()
    out = get_op("attention", spec, backend, guard=approx.guard)(
        qf, kf, vf, causal=causal, window=window,
        approx_div=_divider_on(approx), frac_out=frac_out,
        q_offset=q_offset, kv_group=G)
    out = out.reshape(B, KVH, G, Sq, dh).permute(0, 3, 1, 2, 4)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, q_chunk=1024,
                    kv_chunk=1024, approx: ApproxConfig = EXACT,
                    q_offset=0):
    """Online-softmax attention. q: (B,Sq,KVH,G,dh); k,v: (B,Skv,KVH,dh).

    Returns (B,Sq,KVH,G,dh). ``window`` > 0 = sliding-window attention;
    ``q_offset`` shifts absolute q positions.

    Backend routing: ``approx.resolve('attention')`` (policy entry first,
    then ``approx.backend``) decides who serves the whole attention — when
    it resolves to ``cuda`` for these tensors the flash kernel does;
    otherwise :func:`chunked_attention`, with only the finalize divider
    approximated. The kernel has no backward: it refuses q / k / v that
    require grad (with grad mode on).
    """
    spec, backend = approx.resolve("attention", approx.div_width)
    if resolve_backend(backend, q, k, v) == "cuda":
        return _flash_attention_kernel(
            q, k, v, causal=causal, window=window, approx=approx,
            q_offset=q_offset, spec=spec, backend=backend)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk,
                             approx=approx, q_offset=q_offset)


def chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024,
                      kv_chunk=1024, approx: ApproxConfig = EXACT,
                      q_offset=0):
    """The differentiable online-softmax attention of
    :func:`flash_attention` (same arguments and layouts): plain tensor ops
    over (q chunk, kv chunk) tiles, with only the finalize ``acc / l`` on
    the SIMDive divider (:func:`attention_div`, on the card one
    ``elemwise`` launch a q chunk). Training takes this path whatever
    backend the config resolves, as the reference's ``stack_train`` takes
    its jnp scan. The divider's quotient comes out of integer lanes, so no
    gradient flows through an approximated finalize, as none does in the
    reference (ROADMAP R-8)."""
    B, Sq, KVH, G, dh = q.shape
    Skv = k.shape[1]
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    scale = dh ** -0.5
    f32 = torch.float32
    neg_inf = float("-inf")
    outs = []
    for q_lo in range(0, Sq, qc):
        qb = q[:, q_lo:q_lo + qc].to(f32)              # (B,nq,KVH,G,dh)
        nq = qb.shape[1]
        qpos = q_lo + q_offset + torch.arange(nq, device=q.device)[:, None]
        m = torch.full((B, KVH, G, nq), neg_inf, dtype=f32, device=q.device)
        l = torch.zeros((B, KVH, G, nq), dtype=f32, device=q.device)
        acc = torch.zeros((B, KVH, G, nq, dh), dtype=f32, device=q.device)
        for k_lo in range(0, Skv, kc):
            k_hi = min(k_lo + kc, Skv) - 1
            # chunks no row of this q chunk can see leave the carry as is
            if causal and k_lo > q_lo + q_offset + nq - 1:
                continue
            if window and k_hi <= q_lo + q_offset - window:
                continue
            kb = k[:, k_lo:k_lo + kc]
            vb = v[:, k_lo:k_lo + kc]
            s = torch.einsum("bqkgd,btkd->bkgqt", qb, kb.to(f32)) * scale
            kpos = k_lo + torch.arange(kb.shape[1], device=q.device)[None, :]
            ok = torch.ones_like(qpos + kpos, dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            s = torch.where(ok, s, torch.full_like(s, neg_inf))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (no valid kv yet): keep m finite
            m_new = torch.where(torch.isfinite(m_new), m_new,
                                torch.zeros_like(m_new))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vb.dtype).to(f32),
                              vb.to(f32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = _finalize(acc, l.clamp(min=1e-30), approx)  # (B,KVH,G,nq,dh)
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window=0,
                     approx: ApproxConfig = EXACT):
    """Single-token attention against a cache that already holds the token
    (the reference's write-then-attend form, the oracle
    :func:`decode_attention_append` is held to).

    q: (B,KVH,G,dh); caches: (B,Smax,KVH,dh); ``pos``: an int, or a (B,)
    tensor of per-row positions — the index of the token being generated
    (cache entries past ``pos`` are masked; for ring caches Smax ==
    window and everything is valid). Plain tensor ops in float32, the
    finalize on :func:`attention_div` (its SIMDive divider where
    ``approx`` asks for it)."""
    B, Smax, KVH, dh = k_cache.shape
    f32 = torch.float32
    s = torch.einsum("bkgd,btkd->bkgt", q.to(f32), k_cache.to(f32)) \
        * dh ** -0.5
    idx = torch.arange(Smax, device=q.device)[None, None, None, :]
    p4 = pos.reshape(-1, 1, 1, 1) if torch.is_tensor(pos) and pos.ndim \
        else int(pos)
    valid = idx <= p4
    if window and Smax > window:
        valid = valid & (idx > p4 - window)
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    return _finalize(acc, l, approx).to(q.dtype)


def decode_attention_append(q, k_cache, v_cache, k_new, v_new, pos, slot, *,
                            ring_full=False, window=0,
                            approx: ApproxConfig = EXACT):
    """Single-token attention over a *read-only* cache plus the new token.

    The cache is not rewritten here — the caller writes only the
    ``(B,1,KVH,dh)`` new-token slab into the stacked buffer — and the new
    token's self-attention term is folded in analytically (online-softmax
    combine).

    q: (B,KVH,G,dh); caches: (B,Smax,KVH,dh); k_new/v_new: (B,1,KVH,dh);
    ``pos``/``slot``: int scalar, or (B,) tensors for per-row positions
    (continuous batching); ``slot`` is the slot the new token will occupy
    (its stale cache entry is masked out of the past scores).

    Backend routing, as in :func:`flash_attention`: when
    ``approx.resolve('attention')`` resolves to ``cuda`` for these tensors
    one launch of the ``decode_attention`` kernel serves the whole
    function, finalize included; otherwise the plain body below, with the
    finalize routed through :func:`attention_div`.
    """
    spec, backend, frac_out = approx.resolve_attention()
    if resolve_backend(backend, q, k_cache, v_cache, k_new, v_new) == "cuda":
        op = get_op("decode_attention", spec, backend, guard=approx.guard)
        return op(
            q, k_cache, v_cache, k_new, v_new, pos=pos, slot=slot,
            ring_full=ring_full, window=window,
            approx_div=_divider_on(approx), frac_out=frac_out)
    acc, l = decode_attention_acc(q, k_cache, v_cache, k_new, v_new, pos,
                                  slot, ring_full=ring_full, window=window)
    return _finalize(acc, l, approx).to(q.dtype)


# -------------------------------------------------------------------- mlp --
def mlp(x, p, act, approx: ApproxConfig = EXACT, split: bool = False,
        seq: bool = False):
    """Gated (swiglu) or plain-gelu MLP; weights may be QuantizedWeight.

    gelu is the tanh form, as ``jax.nn.gelu``'s default
    (``approximate=True``), taken on the ``dense`` output in the
    activation dtype, as the reference takes it. In float32 the two agree
    to round-off. In bfloat16 they round differently: torch evaluates the
    formula in float32 with float32 constants and rounds once, while JAX
    rounds each of its eight ops to bfloat16 with its constants rounded
    too (sqrt(2/pi) to 0.796875, 0.044715 to 0.044677734375), and XLA on
    the CPU flushes subnormal results to zero. Over every normal bfloat16
    input below 1e4 in magnitude, 1,012 of 35,644 results differ: by one
    bfloat16 ulp of the result above x = -0.57 (the largest difference,
    0.0156, is one ulp at x = 2.08), by up to 0.003 in the negative tail
    below it, where ``1 + tanh`` cancels, and where the result is
    subnormal.

    ``split``: on a bound mesh, the hidden dim is split over the logical
    axis ``"ff"`` — ``w1`` / ``w3`` are this rank's columns, ``w2`` its
    rows; the hidden activation stays split and ``w2``'s partial sums are
    added (:func:`dense`). ``seq``: sequence parallelism, ``x`` this
    rank's slice of the sequence: gathered once for ``w1`` and ``w3``,
    ``w2``'s sums reduce-scattered back to the slice (a whole MLP runs on
    the slice as it is).
    """
    col, row = (("col", "ff"), ("row", "ff")) if split else (None, None)
    full = None
    if split and seq:
        from repro_torch.launch.sharding import _gather

        col, row = col + ("seq",), row + ("seq",)
        full = _gather(x, "ff", 1)
    if act == "swiglu":
        h = F.silu(dense(x, p["w1"], approx, col, full)) \
            * dense(x, p["w3"], approx, col, full)
    elif act == "gelu":
        h = F.gelu(dense(x, p["w1"], approx, col, full), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return dense(h, p["w2"], approx, row)
