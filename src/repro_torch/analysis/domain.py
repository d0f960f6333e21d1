"""Abstract values, findings, and trace-case declarations for widthcheck.

Counterpart of ``repro.analysis.domain``. The domain is **interval x
possible-bits**:

* every tensor is summarized by one abstract value (the per-element range
  is what overflow/shift safety cares about; element positions are not),
* integer values carry exact Python-int bounds ``[lo, hi]`` plus a
  *possible-bits* mask ``bits`` (a bit is set iff some element of some
  concretization may have it set) — valid only while ``lo >= 0``,
* float values carry ``[lo, hi]`` as Python floats, possibly infinite;
  the float side is deliberately loose (the integer datapath is the
  verification target) but clamps/constants stay exact, which is exactly
  what the quantizer clips feeding the lanes need.

**Logical dtypes.** The port computes every lane on an ``int64`` carrier
(:mod:`repro_torch.core.mitchell`). An abstract value's ``dtype`` is the
numpy dtype the value stands for on the case's *bus* — ``uint32`` /
``int32`` lanes at widths 8 and 16, ``uint64`` / ``int64`` at width 32 —
so the rules are checked against the word the CUDA kernel computes on,
not against the carrier. A ``weak`` value is a constant (a scalar, a
``full_like``, a table) that takes the type of what it meets.

Soundness convention: every transfer function may over-approximate, never
under-approximate. When a rule fires, the result is widened to the dtype's
full range so one root cause yields one finding, not a cascade.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["AbsVal", "ArgSpec", "TraceCase", "Finding", "CaseReport",
           "from_concrete", "top", "join", "RULES", "np_dtype"]

#: every widthcheck rule name, with the one-line contract it enforces
RULES = {
    "overflow": "no integer add/sub/mul/sum/dot exceeds its bus dtype",
    "shift-range": "every shift amount is statically in [0, bus bits - 1]",
    "lane-overlap": "integer OR operands have disjoint possible-bits masks "
                    "(packed-lane / bit-field isolation)",
    "signedness": "no conversion crosses a signedness boundary with a "
                  "possibly-out-of-range value, and no comparison, right "
                  "shift, division or float conversion reads a 64-bit bus "
                  "value that may reach 2^63 off the signed carrier",
    "lane-domain": "operands entering the log datapath fit the declared "
                   "lane width (require_range contracts)",
    "gather-bounds": "1-D table gather indices are statically in range",
    "bus": "every case declares the lane word its kernel computes on "
           "(the reference's x64 requirement)",
}

_TORCH_TO_NP = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    # simdive-lint: allow(unguarded-uint64): dtype tags mapped to numpy, no uint64 arithmetic
    torch.uint16: np.uint16, torch.uint32: np.uint32, torch.uint64: np.uint64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.bfloat16: np.float32,
}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (bfloat16 reads as float32:
    the float side is loose anyway)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP[dtype])
    return np.dtype(dtype)


def _int_info(dtype):
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return 0, 1
    ii = np.iinfo(dt)
    return int(ii.min), int(ii.max)


def _mask_for(hi: int) -> int:
    """Contiguous possible-bits mask covering [0, hi]."""
    return (1 << max(int(hi), 0).bit_length()) - 1


@dataclass(frozen=True)
class AbsVal:
    """One abstract tensor value: logical dtype + shape + interval (+ bits
    mask)."""
    dtype: Any                    # numpy dtype (the bus-level meaning)
    shape: tuple
    lo: Any                       # int (int dtypes) or float (may be +-inf)
    hi: Any
    bits: int | None = None      # possible-bits mask; ints with lo >= 0 only
    #: deferred unsigned-underflow evidence: ((key_a, key_b), rule, msg,
    #: eqn_str, src). A guarded ``where(a >= b, a - b, _)``, a clamp at 0
    #: or a cast to the signed work type clears it; any other consumption
    #: turns it into a finding.
    pending: tuple | None = None
    weak: bool = False            # a constant: takes its partner's type

    # ---------------------------------------------------------- helpers --
    @property
    def kind(self) -> str:
        return np.dtype(self.dtype).kind       # 'u' 'i' 'b' 'f'

    @property
    def is_int(self) -> bool:
        return self.kind in ("u", "i", "b")

    @property
    def nbits(self) -> int:
        return 8 * np.dtype(self.dtype).itemsize

    def norm(self) -> "AbsVal":
        """Re-establish invariants: interval inside dtype range, bits mask
        consistent with the interval (ints), bits dropped when lo < 0."""
        if not self.is_int:
            return self
        dlo, dhi = _int_info(self.dtype)
        lo = max(int(self.lo), dlo)
        hi = min(int(self.hi), dhi)
        if hi < lo:                            # empty => collapse, stay sound
            lo, hi = dlo, dhi
        bits = self.bits
        if lo < 0:
            bits = None
        else:
            m = _mask_for(hi)
            bits = m if bits is None else (bits & m)
            hi = min(hi, bits)                 # hi can never exceed the mask
            if hi < lo:
                lo = hi if hi >= 0 else lo
        return AbsVal(self.dtype, self.shape, lo, hi, bits, self.pending,
                      self.weak)

    def with_shape(self, shape: tuple) -> "AbsVal":
        return AbsVal(self.dtype, tuple(shape), self.lo, self.hi, self.bits,
                      self.pending, self.weak)

    def fits(self) -> bool:
        """Interval inside the dtype's representable range?"""
        if not self.is_int:
            return True
        dlo, dhi = _int_info(self.dtype)
        return self.lo >= dlo and self.hi <= dhi

    def describe(self) -> str:
        if self.is_int:
            s = f"[{self.lo}, {self.hi}]"
            if self.bits is not None:
                s += f" bits=0x{self.bits:x}"
            return s
        return f"[{self.lo:g}, {self.hi:g}]"


def top(dtype, shape) -> AbsVal:
    """The full range of ``dtype`` — the sound fallback."""
    dt = np_dtype(dtype)
    if dt.kind in ("u", "i", "b"):
        lo, hi = _int_info(dt)
        return AbsVal(dt, tuple(shape), lo, hi,
                      _mask_for(hi) if lo >= 0 or dt.kind == "b" else None
                      ).norm()
    return AbsVal(dt, tuple(shape), -math.inf, math.inf, None)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        # simdive-lint: allow(unguarded-uint64): dtype tags mapped to numpy, no uint64 arithmetic
        elif x.dtype in (torch.uint32, torch.uint64, torch.uint16):
            wide = x.view({torch.uint32: torch.int32,
                           # simdive-lint: allow(unguarded-uint64): dtype tags mapped to numpy, no uint64 arithmetic
                           torch.uint64: torch.int64,
                           torch.uint16: torch.int16}[x.dtype]).numpy()
            return wide.view(np_dtype(x.dtype))
        return x.numpy()
    return np.asarray(x)


def from_concrete(x) -> AbsVal:
    """Exact abstract value of a concrete tensor/array/scalar (graph
    constants: correction tables, masks, clip limits — their real
    min/max/bit-OR)."""
    arr = _as_numpy(x)
    if arr.size == 0:
        return top(arr.dtype, arr.shape)
    if arr.dtype.kind in ("u", "i", "b"):
        lo = int(arr.min())
        hi = int(arr.max())
        bits = None
        if lo >= 0:
            bits = 0
            for v in np.unique(arr.ravel()):
                bits |= int(v)
        return AbsVal(arr.dtype, arr.shape, lo, hi, bits).norm()
    fin = arr[np.isfinite(arr)] if arr.dtype.kind == "f" else arr
    if arr.dtype.kind == "f" and fin.size != arr.size:
        return top(arr.dtype, arr.shape)
    return AbsVal(arr.dtype, arr.shape, float(arr.min()), float(arr.max()))


def join(a: AbsVal, b: AbsVal) -> AbsVal:
    """Least upper bound (select/concat/loop-carry union)."""
    pend = a.pending or b.pending       # never silently drop evidence
    weak = a.weak and b.weak
    if not a.is_int:
        return AbsVal(a.dtype, a.shape, min(a.lo, b.lo), max(a.hi, b.hi),
                      None, pend, weak)
    bits = None
    if a.bits is not None and b.bits is not None:
        bits = a.bits | b.bits
    return AbsVal(a.dtype, a.shape, min(a.lo, b.lo), max(a.hi, b.hi),
                  bits, pend, weak).norm()


# ------------------------------------------------------------- declarations --
@dataclass(frozen=True)
class ArgSpec:
    """Declared abstract operand of a trace case (shape + torch dtype +
    range). An ``int64`` operand is a carrier: it reads as the case bus's
    unsigned lane type when ``lo >= 0``, else as its signed work type."""
    shape: tuple
    dtype: Any                    # torch dtype
    lo: int | float = 0
    hi: int | float = 0

    def absval(self, bus=None) -> AbsVal:
        dt = np_dtype(self.dtype)
        if dt == np.int64 and bus is not None:
            u, s = bus_types(bus)
            dt = u if self.lo >= 0 else s
        if dt.kind in ("u", "i", "b"):
            return AbsVal(dt, tuple(self.shape), int(self.lo), int(self.hi),
                          _mask_for(int(self.hi)) if self.lo >= 0 else None
                          ).norm()
        return AbsVal(dt, tuple(self.shape), float(self.lo), float(self.hi))


def bus_types(bus) -> tuple:
    """(unsigned lane dtype, signed work dtype) of a case bus: the lanes
    are 32-bit on a 32-bit bus and on the int64 accumulator of the wide
    matmul (its lanes are widths 8 / 16), 64-bit on the width-32 bus."""
    b = np_dtype(bus)
    if b == np.uint64:
        return np.dtype(np.uint64), np.dtype(np.int64)
    if b == np.int64:
        return np.dtype(np.uint32), np.dtype(np.int64)
    return np.dtype(np.uint32), np.dtype(np.int32)


@dataclass(frozen=True)
class TraceCase:
    """One (op config, traced function, operand domain) verification unit.

    Registered ops declare these via ``register_op(analysis=...)``; the
    callable receives a width and returns a list of TraceCases (or a
    skip-reason string). ``fn`` must be a pure traceable function of the
    ArgSpec operands — the plain integer stages the kernels mirror, not
    the kernel wrappers. ``bus`` is the lane word the CUDA kernel computes
    # simdive-lint: allow(unguarded-uint64): dtype tags mapped to numpy, no uint64 arithmetic
    on: ``torch.uint32`` at widths 8 and 16, ``torch.uint64`` at width 32,
    ``torch.int32`` for the int32 matmul accumulator and ``torch.int64``
    for the wide (int64-sum) form.
    """
    label: str                   # e.g. "elemwise/div w8 cb6 fo8"
    fn: Callable
    args: tuple                  # tuple[ArgSpec, ...]
    bus: Any = torch.uint32
    note: str = ""               # shown in the report next to the verdict
    #: the op's configuration (op / width / coeff_bits / frac_out / K):
    #: what ``chip_smoke.py`` runs the case's kernel at
    params: dict = field(default_factory=dict, compare=False)

    @property
    def requires_x64(self) -> bool:
        """The reference's name for a 64-bit bus."""
        return np_dtype(self.bus).itemsize == 8


@dataclass(frozen=True)
class Finding:
    """One verified-unsafe (or lint) diagnostic, source-located."""
    rule: str
    ctx: str                     # trace-case label / lint file context
    message: str
    eqn: str = ""                # offending aten node (op form)
    source: str = ""             # file:line of the traced source

    def render(self) -> str:
        loc = f"  [{self.source}]" if self.source else ""
        eq = f"\n      {self.eqn}" if self.eqn else ""
        return f"{self.rule}: {self.ctx}: {self.message}{loc}{eq}"

    def sort_key(self):
        return (self.ctx, self.rule, self.source, self.message)


@dataclass
class CaseReport:
    """Findings + bookkeeping for one TraceCase."""
    label: str
    findings: list = field(default_factory=list)
    assumed: list = field(default_factory=list)   # contract-verified scopes
    unknown_prims: list = field(default_factory=list)
    requires_x64: bool = False
    note: str = ""
    bus: str = "uint32"

    @property
    def ok(self) -> bool:
        return not self.findings
