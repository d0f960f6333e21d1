"""Model-facing approximate math: the SIMDive divider inside attention.

Counterpart of ``repro.core.approx`` for the serving slices ported so
far: :class:`ApproxConfig` with its policy resolution, the layer-segment
helper, :func:`attention_div`, and the emulated approximate linears —
:func:`quantize_sign_magnitude`, :func:`approx_matmul` (straight-through
exact gradients) and :func:`approx_matmul_int8` (pre-quantized int8
weights). ``approx_softmax``, ``approx_rmsnorm`` and the approximate
backward (``backward='approx'``, training) are not ported yet.

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
from .mitchell import check_width, from_lanes
from .simdive import SimdiveSpec

__all__ = [
    "ApproxConfig",
    "quantize_sign_magnitude",
    "approx_matmul",
    "approx_matmul_int8",
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
    backward: str = "exact"        # exact | approx (training; not ported)
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
    check_width(spec.width)
    qn, qd = softmax_div_quantize(acc, l, spec.width)
    div = get_op("elemwise", spec, backend=backend, guard=cfg.guard)
    # width <= 16: the operands fit int32, whose bits are the uint32 lanes
    quot = div(qn.to(torch.int32).view(torch.uint32),
               qd.expand_as(qn).to(torch.int32).view(torch.uint32),
               op="div", frac_out=frac_out)
    out = from_lanes(quot).to(torch.float32) * (2.0 ** -frac_out)
    return torch.where(acc < 0, -out, out)


# ---------------------------------------------------- emulated linears --
def quantize_sign_magnitude(x: torch.Tensor, width: int, axis=None):
    """Symmetric sign-magnitude quantization to ``width``-bit magnitudes.

    Returns (mag int32 in [0, 2^width - 1], sign int32 in {-1, +1},
    scale). ``axis`` selects per-axis scales (kept dims); None = global.
    The magnitudes are int32 rather than the reference's uint32 (PyTorch's
    uint32 lacks the arithmetic; the values are the same). Dtypes follow
    the reference: the scale stays in ``x``'s dtype (the reference's
    weak-typed ``1e-30`` and ``qmax`` do not widen a bf16 ``x``), and
    ``|x| / scale`` is rounded in it.
    """
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    qmax = float(2 ** width - 1)
    scale = amax.clamp(min=1e-30) / qmax
    mag = (ax / scale).round().clamp(0, qmax).to(torch.int32)
    sign = torch.where(x < 0, -1, 1).to(torch.int32)
    return mag, sign, scale


def _matmul_active(cfg: ApproxConfig) -> bool:
    return cfg.enabled and cfg.use_in_linear and cfg.active_for("matmul")


def _approx_matmul_fwd_impl(x, w, cfg: ApproxConfig):
    if not _matmul_active(cfg):
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    spec, backend = cfg.resolve("matmul")
    qx, sx, scx = quantize_sign_magnitude(x2, spec.width)
    qw, sw, scw = quantize_sign_magnitude(w, spec.width, axis=0)
    mm = get_op("matmul_emul", spec, backend=backend, guard=cfg.guard)
    acc = mm(qx, sx, qw, sw, k_chunk=cfg.k_chunk)
    out = acc.to(torch.float32) * (scx * scw)
    return out.reshape(*lead, w.shape[1]).to(x.dtype)


class _ApproxMatmul(torch.autograd.Function):
    """SIMDive forward, straight-through exact backward (the reference's
    ``custom_vjp`` pair ``_approx_matmul_fwd`` / ``_approx_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w)
        return _approx_matmul_fwd_impl(x, w, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        if cfg.backward == "approx" and _matmul_active(cfg):
            raise NotImplementedError(
                "backward='approx' (approximate backward matmuls, training) "
                "is not ported yet")
        dt = torch.promote_types(g.dtype, w.dtype)
        gx = torch.einsum("...n,kn->...k", g.to(dt), w.to(dt)).to(x.dtype)
        dt = torch.promote_types(x.dtype, g.dtype)
        gw = torch.einsum("...k,...n->kn", x.to(dt), g.to(dt)).to(w.dtype)
        return gx, gw, None


def approx_matmul(x: torch.Tensor, w: torch.Tensor,
                  cfg: ApproxConfig) -> torch.Tensor:
    """Float-in/out matmul with SIMDive products; exact grads (STE).

    ``x`` (..., K) and ``w`` (K, N) are quantized per call (``x`` with one
    global scale, ``w`` per output channel), multiplied on the
    ``matmul_emul`` op and rescaled, as in the reference.
    """
    return _ApproxMatmul.apply(x, w, cfg)


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
