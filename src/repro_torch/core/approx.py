"""Model-facing approximate math: the SIMDive divider inside attention,
softmax and the norm, and the emulated SIMDive linears.

Counterpart of ``repro.core.approx``: :class:`ApproxConfig` with its
policy resolution, the layer-segment helper, :func:`attention_div`, the
emulated approximate linears — :func:`quantize_sign_magnitude`,
:func:`approx_matmul` (straight-through exact gradients) and
:func:`approx_matmul_int8` (pre-quantized int8 weights) — and the
divider's other uses, :func:`approx_softmax` and :func:`approx_rmsnorm`
(straight-through exact gradients). With ``backward='approx'`` (training)
both gradient products of an emulated linear run the forward's quantize +
SIMDive matmul too.

Every approximate op dispatches through the kernel registry
(:func:`repro_torch.kernels.registry.get_op`). ``ApproxConfig.backend``
defaults to ``'auto'`` here (the reference defaults to its oracle): tensors
on the card go through the CUDA kernels, tensors on the CPU through the
plain versions.

``ApproxConfig.mode``:
  'exact'    — plain float ops (baseline),
  'mitchell' — uncorrected log arithmetic (paper's Mitchell baseline),
  'simdive'  — corrected + rounded (the paper's contribution).

``ApproxConfig.policy`` is any hashable object with ``.lookup(op, layer)``
returning ``width / coeff_bits / index_bits / backend`` (and optionally
``frac_out``) attributes, or None — a
:class:`repro_torch.tuning.TuningPolicy` loaded from a
``simdive-policy/v1`` file is one; layer-scoped entries resolve first. An
entry's backend is an interchange name (the reference's: ``auto``,
``ref``, ``pallas``...), mapped to the port's registry backend by
:func:`repro_torch.tuning.select.port_backend` (``pallas`` -> ``cuda``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.kernels.registry import get_op
from .mitchell import (
    check_width,
    from_lanes,
    lane_max_float,
    lanes_to_float,
    to_lanes,
)
from .simdive import SimdiveSpec

__all__ = [
    "ApproxConfig",
    "quantize_sign_magnitude",
    "approx_matmul",
    "approx_matmul_int8",
    "approx_softmax",
    "approx_rmsnorm",
    "rsqrt_operand",
    "attention_div",
    "layer_label",
    "serving_segments",
]


@dataclass(frozen=True)
class ApproxConfig:
    mode: str = "exact"            # exact | mitchell | simdive
    width: int = 8                 # multiplier lane width
    div_width: int = 16            # divider lane width
    coeff_bits: int = 6
    index_bits: int = 3
    frac_out: int = 15             # divider fixed-point output bits
    k_chunk: int = 128             # matmul K-chunk (emulated linears)
    emulate: bool = True           # bit-exact SIMDive emulation in linears
    backend: str = "auto"          # kernel backend: 'auto' | 'ref' | 'cuda'
    use_in_linear: bool = True
    use_in_softmax: bool = True
    use_in_norm: bool = False
    policy: object | None = None   # .lookup(op, layer) provider
    layer: str | None = None       # layer label for policy lookup
    # approximate ONLY where the policy carries a matching entry; call
    # sites whose lookup misses run exact
    policy_only: bool = False
    backward: str = "exact"        # exact (STE) | approx: the linears'
    #                                gradient products on SIMDive too
    # guarded dispatch: every get_op of this config checks its outputs
    # and raises registry.GuardTripped on a violation. Off by default: a
    # guard reads outputs back to the host, and a CUDA graph's replays are
    # never checked (the scheduler's watchdog covers served graphs)
    guard: bool = False

    def __post_init__(self):
        if self.backward not in ("exact", "approx"):
            raise ValueError(f"backward must be 'exact' or 'approx', "
                             f"got {self.backward!r}")

    @property
    def enabled(self) -> bool:
        return self.mode != "exact"

    def active_for(self, op: str) -> bool:
        """Whether approximation applies to logical ``op`` at this layer."""
        if not self.enabled:
            return False
        if not self.policy_only:
            return True
        return (self.policy is not None
                and self.policy.lookup(op, self.layer) is not None)

    def spec(self, width: int | None = None) -> SimdiveSpec:
        w = self.width if width is None else width
        if self.mode == "mitchell":
            return SimdiveSpec(width=w, coeff_bits=0,
                               index_bits=self.index_bits, round_output=False)
        return SimdiveSpec(width=w, coeff_bits=self.coeff_bits,
                           index_bits=self.index_bits, round_output=True)

    def resolve(self, op: str, width: int | None = None
                ) -> tuple[SimdiveSpec, str]:
        """(spec, backend) serving logical ``op`` on this config's layer:
        a matching policy entry overrides the config's own knobs wholesale,
        its backend name mapped onto the port's registry backend."""
        entry = self.policy.lookup(op, self.layer) \
            if self.policy is not None else None
        if entry is None:
            return self.spec(width), self.backend
        from repro_torch.tuning.select import port_backend

        spec = SimdiveSpec(width=entry.width, coeff_bits=entry.coeff_bits,
                           index_bits=entry.index_bits)
        backend = getattr(entry, "backend", None)
        return spec, (port_backend(backend) if backend else self.backend)

    def resolve_attention(self) -> tuple[SimdiveSpec, str, int]:
        """(spec, backend, frac_out) serving the attention softmax divider."""
        spec, backend = self.resolve("attention", self.div_width)
        entry = self.policy.lookup("attention", self.layer) \
            if self.policy is not None else None
        frac = self.frac_out
        if entry is not None and getattr(entry, "frac_out", None):
            frac = int(entry.frac_out)
        return spec, backend, frac


EXACT = ApproxConfig()


def layer_label(i: int) -> str:
    """Canonical policy label of transformer layer ``i`` (``'L0'``...)."""
    return f"L{i}"


def _resolution_sig(cfg: ApproxConfig) -> tuple:
    """Everything policy resolution can change for one layer, hashable."""
    spec_a, backend_a, frac = cfg.resolve_attention()
    return (cfg.resolve("matmul"), cfg.resolve("div", cfg.div_width),
            spec_a, backend_a, frac,
            tuple(cfg.active_for(op)
                  for op in ("matmul", "div", "attention")))


def serving_segments(approx: ApproxConfig, n_layers: int
                     ) -> tuple[tuple[int, int, ApproxConfig], ...]:
    """Contiguous layer runs with identical policy resolution.

    Returns ``((lo, hi, cfg), ...)`` covering ``[0, n_layers)``; each
    ``cfg`` carries ``layer=layer_label(lo)``. Without a policy this is a
    single segment carrying the original config.
    """
    if n_layers <= 0:
        return ((0, max(n_layers, 0), approx),)
    if approx.policy is None or not approx.enabled:
        return ((0, n_layers, approx),)
    cfgs = [replace(approx, layer=layer_label(i)) for i in range(n_layers)]
    sigs = [_resolution_sig(c) for c in cfgs]
    segments, lo = [], 0
    for i in range(1, n_layers):
        if sigs[i] != sigs[i - 1]:
            segments.append((lo, i, cfgs[lo]))
            lo = i
    segments.append((lo, n_layers, cfgs[lo]))
    return tuple(segments)


def attention_div(acc: torch.Tensor, l: torch.Tensor,
                  cfg: ApproxConfig) -> torch.Tensor:
    """Softmax normalization ``acc / l[..., None]`` on the SIMDive divider,
    resolved as the logical ``'attention'`` op (policy-tunable per layer).

    Same per-row shared-exponent quantization as the flash kernel's
    finalize (:func:`repro_torch.kernels.flash_attention.softmax_div`), done
    here in plain tensor ops around one ``elemwise`` 'div' dispatch — on
    the card, one launch of the elemwise kernel. ``acc`` is signed float32
    (..., dh); ``l`` is (...,) > 0.
    """
    from repro_torch.kernels.flash_attention import softmax_div_quantize

    if not cfg.active_for("attention"):
        return acc / l.clamp(min=1e-30)[..., None]
    spec, backend, frac_out = cfg.resolve_attention()
    qn, qd = softmax_div_quantize(acc, l, spec.width)
    div = get_op("elemwise", spec, backend=backend, guard=cfg.guard)
    quot = div(to_lanes(qn, spec.width),
               to_lanes(qd.expand_as(qn), spec.width),
               op="div", frac_out=frac_out)
    out = lanes_to_float(quot) * (2.0 ** -frac_out)
    return torch.where(acc < 0, -out, out)


def _fixed_point_operands(num: torch.Tensor, den: torch.Tensor,
                          width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-scale float32 ``num >= 0`` and ``den > 0`` into ``width``-bit
    lanes. Widths 8 and 16: one power of two shared by the whole call,
    ``2^(width - 2 - floor(log2 top))`` with ``top`` the larger of both
    maxima, so the larger side fills the lane. Width 32, as the
    reference's: the fixed scale 2^16 and no shared exponent. Both clip at
    :func:`lane_max_float`. Returns the lanes of the width's dtype
    ``(qn, qd)``.

    ``floor(log2 top)`` is read from ``top``'s exponent field on the
    device, exactly (no host read: the call can be captured in a CUDA
    graph). The reference takes the floor of a float32 ``log2``, which can
    land on the other side of ``k`` for ``top`` at or next to ``2^k``;
    there the two scales differ by a factor of two.
    """
    check_width(width)
    lim = lane_max_float(width)
    if width > 16:
        sc = 2.0 ** 16
    else:
        top = torch.maximum(num.amax(), den.amax()).clamp(min=1e-30)
        _, e = torch.frexp(top)                  # top = m * 2^e, m in [.5, 1)
        sc = torch.ldexp(torch.ones_like(top), (width - 1) - e)
    qn = torch.round(num * sc).clamp(0.0, lim).to(torch.int64)
    qd = torch.round(den * sc).clamp(1.0, lim).to(torch.int64)
    return to_lanes(qn, width), to_lanes(qd, width)


def _fixed_point_div(num: torch.Tensor, den: torch.Tensor,
                     cfg: ApproxConfig) -> torch.Tensor:
    """Approximate ``num / den`` (float32, both >= 0, den > 0) on the
    SIMDive divider, resolved as the logical ``'div'`` op at ``div_width``:
    both operands block-scaled into the lane by
    :func:`_fixed_point_operands` (the scale cancels in the quotient), one
    elemwise 'div' dispatch.
    """
    spec, backend = cfg.resolve("div", cfg.div_width)
    qn, qd = _fixed_point_operands(num, den, spec.width)
    div = get_op("elemwise", spec, backend=backend, guard=cfg.guard)
    q = div(qn, qd, op="div", frac_out=cfg.frac_out)
    return lanes_to_float(q) / float(2 ** cfg.frac_out)


def _approx_softmax_impl(x, axis, cfg: ApproxConfig):
    if not cfg.enabled or not cfg.use_in_softmax \
            or not cfg.active_for("div"):
        return torch.softmax(x, dim=axis)
    m = x.amax(dim=axis, keepdim=True).detach()
    e = (x - m).to(torch.float32).exp()
    s = e.sum(dim=axis, keepdim=True)
    return _fixed_point_div(e, s.expand_as(e), cfg).to(x.dtype)


class _ApproxSoftmax(torch.autograd.Function):
    """SIMDive forward, straight-through backward: the exact softmax
    Jacobian at the approximate output (the reference's ``custom_vjp``
    pair ``_approx_softmax_fwd`` / ``_approx_softmax_bwd``)."""

    @staticmethod
    def forward(ctx, x, axis, cfg):
        p = _approx_softmax_impl(x, axis, cfg)
        ctx.axis = axis
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        pg = p.to(torch.float32) * g.to(torch.float32)
        gx = pg - p * pg.sum(dim=ctx.axis, keepdim=True)
        return gx.to(g.dtype), None, None


def approx_softmax(x: torch.Tensor, axis: int,
                   cfg: ApproxConfig) -> torch.Tensor:
    """Softmax whose normalization division is a SIMDive divider
    (:func:`_fixed_point_div`: one elemwise 'div' dispatch, on the card
    one launch of the elemwise kernel); exact where ``cfg`` does not
    approximate the softmax. Exact gradients (STE)."""
    return _ApproxSoftmax.apply(x, axis, cfg)


def rsqrt_operand(ms: torch.Tensor, eps: float, width: int) -> torch.Tensor:
    """The sqrt operand of :func:`approx_rmsnorm`'s rsqrt, as lanes of the
    width's dtype: ``qm = clip(round((ms + eps) * 2^32), 1, lane max)``
    for the float32 mean squares ``ms``. At ``div_width`` 32 the lane
    holds the whole range, so the norm normalizes (at 16 it clips: R-4)."""
    check_width(width)
    qm = torch.round((ms + eps) * 2.0 ** 32).clamp(1.0, lane_max_float(width))
    return to_lanes(qm.to(torch.int64), width)


def _approx_rmsnorm_impl(x, gamma, eps, cfg: ApproxConfig):
    ms = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    if not cfg.enabled or not cfg.use_in_norm or not cfg.active_for("div"):
        inv = torch.rsqrt(ms + eps)
    else:
        # rsqrt in the log domain: sqrt is L >> 1, then one SIMDive divide
        #   qm = m * 2^32, clipped to the lane;  r = sqrt(qm) = sqrt(m) * 2^16
        #   q  = (2^31 / r) * 2^16 = rsqrt(m) * 2^31
        spec, backend = cfg.resolve("div", cfg.div_width)
        qm = rsqrt_operand(ms, eps, spec.width)
        sqrt = get_op("sqrt", spec, backend=backend, guard=cfg.guard)
        r = from_lanes(sqrt(qm)).clamp(min=1)
        div = get_op("elemwise", spec, backend=backend, guard=cfg.guard)
        q = div(torch.full_like(r, 1 << 31), r, op="div", frac_out=16)
        inv = lanes_to_float(q) * 2.0 ** -31
    return (x.to(torch.float32) * inv * gamma.to(torch.float32)).to(x.dtype)


class _ApproxRMSNorm(torch.autograd.Function):
    """Log-domain forward, straight-through backward: the exact RMSNorm
    gradient (the reference's ``_approx_rmsnorm_fwd`` /
    ``_approx_rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, eps, cfg):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return _approx_rmsnorm_impl(x, gamma, eps, cfg)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        xf, gf, gg = (t.to(torch.float32) for t in (x, g, gamma))
        d = x.shape[-1]
        inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xn = xf * inv
        gxn = gf * gg
        gx = inv * (gxn - xn * (gxn * xn).mean(dim=-1, keepdim=True))
        ggamma = (gf * xn).reshape(-1, d).sum(dim=0)
        return gx.to(x.dtype), ggamma.to(gamma.dtype), None, None


def approx_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                   cfg: ApproxConfig) -> torch.Tensor:
    """RMSNorm with a log-domain rsqrt + divide denominator (beyond the
    paper): one ``sqrt`` and one elemwise 'div' dispatch a call, on the
    card one launch of each kernel (``csrc/elemwise.cu``). Exact where
    ``cfg`` does not approximate the norm. Exact gradients (STE).

    Mirrors the reference bit for bit, its defect included (ROADMAP R-4):
    ``qm`` is clipped to ``lane_max_float(div_width)``, so at the default
    16-bit lane any mean square above 2^-16 gives the same ``qm`` and the
    "rsqrt" is a constant (1.5 for unit-scale rows); and the numerator
    ``2^31`` lies outside a 16-bit lane. The port does not fix either on
    its own side.
    """
    return _ApproxRMSNorm.apply(x, gamma, eps, cfg)


# ---------------------------------------------------- emulated linears --
def quantize_sign_magnitude(x: torch.Tensor, width: int, axis=None,
                            over=()):
    """Symmetric sign-magnitude quantization to ``width``-bit magnitudes.

    Returns (mag int32 in [0, 2^width - 1], sign int32 in {-1, +1},
    scale). ``axis`` selects per-axis scales (kept dims); None = global.
    ``over`` names the logical mesh axes over which ``x`` is one shard of
    a larger tensor (the reduced dims split among their ranks): the
    maxima are then the ``all_reduce`` MAX of the local ones, the scale of
    the whole tensor, as the reference's global arrays have it (a no-op
    unbound, :mod:`repro_torch.launch.sharding`).
    The magnitudes are int32 rather than the reference's uint32 (PyTorch's
    uint32 lacks the arithmetic; the values are the same). Dtypes follow
    the reference: the scale stays in ``x``'s dtype (the reference's
    weak-typed ``1e-30`` and ``qmax`` do not widen a bf16 ``x``), and
    ``|x| / scale`` is rounded in it.
    """
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    if over:
        from repro_torch.launch.sharding import all_reduce_max

        amax = all_reduce_max(amax, over)
    qmax = float(2 ** width - 1)
    scale = amax.clamp(min=1e-30) / qmax
    mag = (ax / scale).round().clamp(0, qmax).to(torch.int32)
    sign = torch.where(x < 0, -1, 1).to(torch.int32)
    return mag, sign, scale


def _matmul_active(cfg: ApproxConfig) -> bool:
    return cfg.enabled and cfg.use_in_linear and cfg.active_for("matmul")


def _approx_matmul_fwd_impl(x, w, cfg: ApproxConfig, x_over=(), w_over=(),
                            k_sum=None, scatter=False):
    """The emulated product ``x @ w``: ``x`` one global scale, ``w`` one
    scale a column, ``matmul_emul``, rescale. On a mesh, ``x_over`` /
    ``w_over`` name the logical axes whose ranks hold the rest of ``x`` /
    of ``w``'s columns (their scales are the whole tensor's), and
    ``k_sum`` the axis over which K is split: its ranks' int64 partial
    sums are added (``all_reduce``) before the one rescale, so the result
    is the unsplit product's bit for bit. ``scatter`` (sequence
    parallelism, ``x`` (B,S,K)): the partial sums are reduce-scattered
    over dim 1 instead, the result this rank's rows of the sequence."""
    if not _matmul_active(cfg):
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    spec, backend = cfg.resolve("matmul")
    qx, sx, scx = quantize_sign_magnitude(x2, spec.width, over=x_over)
    qw, sw, scw = quantize_sign_magnitude(w, spec.width, axis=0, over=w_over)
    mm = get_op("matmul_emul", spec, backend=backend, guard=cfg.guard)
    acc = mm(qx, sx, qw, sw, k_chunk=cfg.k_chunk)
    if k_sum is not None:
        from repro_torch.launch.sharding import all_reduce, reduce_scatter

        if scatter:
            acc = reduce_scatter(acc.view(*lead, acc.shape[-1]), k_sum, 1)
            lead = acc.shape[:-1]
        else:
            acc = all_reduce(acc, k_sum)
    out = acc.to(torch.float32) * (scx * scw)
    return out.reshape(*lead, w.shape[1]).to(x.dtype)


# Which logical axes hold the rest of each operand of a split linear's
# three products (the forward, gx = g @ w^T, gw = x^T @ g), by the
# weight's split: None (replicated), "col" (its output dim split over the
# axis ``a``), "row" (its input dim split over ``a``). Rows of x and g are
# always split over "batch". Each entry: (x_over, w_over, k_sum) of one
# _approx_matmul_fwd_impl call. gw's K (the rows) stays split over
# "batch": the data ranks' float gradients are summed by the step.
def _split_plan(split, a):
    b = ("batch",)
    if split == "col":
        return {"fwd": (b, (), None), "gx": (b + (a,), (a,), a),
                "gw": (b, b, None)}
    if split == "row":
        return {"fwd": (b + (a,), (a,), a), "gx": (b, (), None),
                "gw": (b + (a,), b, None)}
    return {"fwd": (b, (), None), "gx": (b, (), None), "gw": (b, b, None)}


def _seq_whole(x, axis: str, seq: bool, full=None):
    """Sequence parallelism's whole-sequence operand: ``full`` where the
    caller gathered it, else ``x`` (B,S_loc,...) gathered over ``axis``'s
    ranks along dim 1 (counted, no gradient); ``x`` without ``seq``."""
    if not seq:
        return x
    if full is not None:
        return full
    from repro_torch.launch.sharding import _gather

    return _gather(x, axis, 1)


class _ApproxMatmul(torch.autograd.Function):
    """SIMDive forward; straight-through exact backward, or with
    ``backward='approx'`` both gradient products on the SIMDive matmul (the
    reference's ``custom_vjp`` pair ``_approx_matmul_fwd`` /
    ``_approx_matmul_bwd``). ``split`` / ``axis``: the weight's split on a
    mesh (:func:`_split_plan`); a column-parallel linear's input gradient
    is summed over ``axis`` here (integer partial sums under
    ``backward='approx'``), so no region function sums it again.

    ``seq`` (sequence parallelism; ``x`` (B,S,K), the model ranks of
    ``axis`` holding the sequence's slices): a column-parallel linear
    takes the whole sequence (``full``, or gathered here) and
    reduce-scatters its input gradient's partial sums to this rank's
    rows; a row-parallel one reduce-scatters its output's partial sums
    and gathers its output gradient. Integer partial sums are
    reduce-scattered before the one rescale, so each product stays the
    unsplit one's rows bit for bit."""

    @staticmethod
    def forward(ctx, x, w, cfg, split, axis, seq=False, full=None):
        ctx.cfg, ctx.plan = cfg, _split_plan(split, axis)
        ctx.split, ctx.axis = split, axis
        ctx.seq = seq and split in ("col", "row")
        if ctx.seq and split == "col":
            x = _seq_whole(x, axis, True, full)
        ctx.save_for_backward(x, w)
        return _approx_matmul_fwd_impl(x, w, cfg, *ctx.plan["fwd"],
                                       scatter=ctx.seq and split == "row")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg, plan = ctx.cfg, ctx.plan
        col_seq = ctx.seq and ctx.split == "col"
        if ctx.seq and ctx.split == "row":
            g = _seq_whole(g.contiguous(), ctx.axis, True)
        if cfg.backward == "approx" and _matmul_active(cfg):
            # both products through the forward's own quantize + matmul_emul
            # dispatch, in float32: gx = g @ w^T (g one global scale, w^T
            # per column), gw = x^T @ g (x^T one global scale, g per column)
            gf = g.to(torch.float32)
            gx = _approx_matmul_fwd_impl(gf, w.to(torch.float32).T, cfg,
                                         *plan["gx"], scatter=col_seq)
            x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
            gw = _approx_matmul_fwd_impl(x2.T, gf.reshape(-1, gf.shape[-1]),
                                         cfg, *plan["gw"])
            return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None, \
                None
        dt = torch.promote_types(g.dtype, w.dtype)
        gx = torch.einsum("...n,kn->...k", g.to(dt), w.to(dt))
        if ctx.split == "col":
            from repro_torch.launch.sharding import all_reduce, reduce_scatter

            gx = reduce_scatter(gx, ctx.axis, 1) if col_seq \
                else all_reduce(gx.contiguous(), ctx.axis)
        gx = gx.to(x.dtype)
        dt = torch.promote_types(x.dtype, g.dtype)
        gw = torch.einsum("...k,...n->kn", x.to(dt), g.to(dt)).to(w.dtype)
        return gx, gw, None, None, None, None, None


def approx_matmul(x: torch.Tensor, w: torch.Tensor,
                  cfg: ApproxConfig, split: str | None = None,
                  axis: str = "ff", seq: bool = False,
                  full: torch.Tensor | None = None) -> torch.Tensor:
    """Float-in/out matmul with SIMDive products; exact grads (STE), or
    with ``cfg.backward == 'approx'`` SIMDive gradient products.

    ``x`` (..., K) and ``w`` (K, N) are quantized per call (``x`` with one
    global scale, ``w`` per output channel), multiplied on the
    ``matmul_emul`` op and rescaled, as in the reference. The approximate
    backward makes two more such products a call, at new shapes: ``gx``
    (M, N) x (N, K) and ``gw`` (K, M) x (M, N), M the rows of ``x`` — on
    the card two more ``logmatmul`` launches.

    On a bound mesh (:mod:`repro_torch.launch.sharding`) ``x`` is this
    rank's rows of the batch and ``w`` this rank's shard: ``split`` None
    (replicated), ``'col'`` (output dim split over the logical ``axis``,
    ``x`` replicated over it) or ``'row'`` (input dim split, ``x`` split
    too). Every scale is then the whole tensor's (``all_reduce`` MAX) and
    K-split integer sums are added before the rescale, so the forward and,
    over the split axis, both gradient products equal the unsplit
    linear's bit for bit. ``seq`` / ``full``: sequence parallelism
    (:class:`_ApproxMatmul`), ``x`` this rank's slice of the sequence
    (``full`` the whole, gathered by the caller for several linears).
    """
    return _ApproxMatmul.apply(x, w, cfg, split, axis, seq, full)


def approx_matmul_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       cfg: ApproxConfig) -> torch.Tensor:
    """SIMDive matmul against *pre-quantized* int8 weights ``q`` (K, N)
    with per-output-channel ``scale`` (1, N): the stored magnitudes feed
    the emulated matmul directly, the weight's own scale rides through.
    Inference only (no gradient). Raises when the resolved lane is
    narrower than the stored 8-bit magnitudes.
    """
    if not cfg.active_for("matmul"):
        wf = q.to(torch.float32) * scale.to(torch.float32)
        return (x.to(torch.float32) @ wf).to(x.dtype)
    spec, backend = cfg.resolve("matmul")
    if spec.width < 8:
        raise ValueError(
            f"approx+quantize: resolved matmul lane width {spec.width} "
            "cannot hold int8 weight magnitudes (<=127 needs width >= 8); "
            "widen the policy's matmul entry or serve unquantized")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    qx, sx, scx = quantize_sign_magnitude(x2, spec.width)
    qi = q.to(torch.int32)
    qw = qi.abs()
    sw = torch.where(qi < 0, -1, 1).to(torch.int32)
    mm = get_op("matmul_emul", spec, backend=backend, guard=cfg.guard)
    acc = mm(qx, sx, qw, sw, k_chunk=cfg.k_chunk)
    out = acc.to(torch.float32) * (scx * scale.to(torch.float32))
    return out.reshape(*lead, q.shape[-1]).to(x.dtype)
