"""Model-facing approximate math: the SIMDive divider inside attention.

Counterpart of ``repro.core.approx`` for the serving slice ported so far:
:class:`ApproxConfig` with its policy resolution, the layer-segment helper
and :func:`attention_div`. The approximate linears (``approx_matmul*``),
``approx_softmax`` and ``approx_rmsnorm`` are not ported yet; with
``emulate`` off — the serving default — the linears are plain matmuls.

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
``frac_out``) attributes, or None; layer-scoped entries resolve first.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.kernels.registry import get_op
from .mitchell import check_width, from_lanes
from .simdive import SimdiveSpec

__all__ = [
    "ApproxConfig",
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
    guard: bool = False            # guarded dispatch (not ported)

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
        a matching policy entry overrides the config's own knobs wholesale."""
        entry = self.policy.lookup(op, self.layer) \
            if self.policy is not None else None
        if entry is None:
            return self.spec(width), self.backend
        spec = SimdiveSpec(width=entry.width, coeff_bits=entry.coeff_bits,
                           index_bits=entry.index_bits)
        return spec, (getattr(entry, "backend", None) or self.backend)

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
    div = get_op("elemwise", spec, backend=backend)
    # width <= 16: the operands fit int32, whose bits are the uint32 lanes
    quot = div(qn.to(torch.int32).view(torch.uint32),
               qd.expand_as(qn).to(torch.int32).view(torch.uint32),
               op="div", frac_out=frac_out)
    out = from_lanes(quot).to(torch.float32) * (2.0 ** -frac_out)
    return torch.where(acc < 0, -out, out)
