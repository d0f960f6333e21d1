"""SEU emulation hooks for the SIMDive datapath (one flag, one place).

Counterpart of ``repro.faults.inject``; the same fault model, the same
:class:`FaultSpec` and the same messages:

  ``table``   a flipped bit in a correction-coefficient LUT
              (configuration memory). Hook: ``core.error_lut.build_table``
              applies the fault to a copy of the pristine cached build.
              Always **persistent**, until scrubbed or disarmed
              (:mod:`repro_torch.faults.scrub`).
  ``log``     an upset bit on the log-stage output register
              ``L = (k << F) | x_fp``. Hook: ``kernels.datapath.lod_log``
              and, on the card, ``simdive::lod_log`` in
              ``csrc/simdive_datapath.cuh``.
  ``pack``    an upset bit on the packed output bus where 2w-bit lane
              results interleave into uint32 words. Hook:
              ``kernels.datapath.lane_repack`` and, on the card, the
              output words of ``csrc/packed_simd.cu``.

Lane faults are **persistent** (every element) or **transient** (a
seeded per-element strike pattern at ``rate``, a hash of the lane value
itself, so every backend strikes the same elements).

**Arming.** The reference resolves its hooks when JAX traces, so its
:func:`set_faults` clears JAX's caches. Here nothing is traced: the CUDA
kernels read their tables by pointer from device memory, and CUDA graphs
hold those pointers. So :func:`set_faults` instead

  (a) rewrites every materialized table tensor in place
      (``core.error_lut.refresh_tables``: ``copy_`` on the current
      stream, the same tensor objects before, during and after), and
  (b) writes the lane specs into the kernels' fault register
      (``kernels.build.write_fault_register``),

and bumps nothing that makes a graph capture again: a graph captured
disarmed sees an arming on its next replay, and is pristine again after
the disarm. Disarmed, every host hook returns its input unchanged, and
the kernels pay one uniform branch on a zero count.

This module imports nothing of ``repro_torch`` at module scope:
``core.error_lut`` and ``kernels.datapath`` import *it*.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "FaultSpec",
    "MAX_LANE_FAULTS",
    "active_faults",
    "apply_lane_faults",
    "apply_table_faults",
    "fault_injection",
    "faults_enabled",
    "lane_register",
    "set_faults",
]

_SITES = ("table", "log", "pack")
_KINDS = ("flip", "stuck0", "stuck1")
_PERSISTENCE = ("persistent", "transient")
_MASK32 = 0xFFFFFFFF

#: lane specs the kernels' fault register holds (``kMaxLaneFaults`` in
#: ``csrc/simdive_datapath.cuh``)
MAX_LANE_FAULTS = 8
# register codes, as in csrc/simdive_datapath.cuh
_SITE_CODE = {"log": 1, "pack": 2}
_KIND_CODE = {"flip": 0, "stuck0": 1, "stuck1": 2}
_HEADER_WORDS, _SPEC_WORDS = 4, 8


@dataclass(frozen=True)
class FaultSpec:
    """One injected upset. Frozen + hashable so arming states compare.

    site         'table' | 'log' | 'pack' — where the upset lands.
    bit          upset bit position within the 32-bit entry / lane word.
    kind         'flip' (XOR) | 'stuck0' (AND-NOT) | 'stuck1' (OR).
    persistence  'persistent' | 'transient'. Table upsets are
                 configuration memory and must be persistent.
    op           table site only: 'mul' | 'div' restricts the upset to
                 one op's table; None hits both.
    width        restrict to one lane width (None = any width).
    index        table site only: the upset entry (None = every entry,
                 i.e. a stuck output bit on the whole LUT column).
    rate         transient only: per-element strike probability.
    seed         transient only: strike-pattern seed.
    """

    site: str
    bit: int
    kind: str = "flip"
    persistence: str = "persistent"
    op: str | None = None
    width: int | None = None
    index: int | None = None
    rate: float = 1e-3
    seed: int = 0

    def __post_init__(self):
        if self.site not in _SITES:
            raise ValueError(f"site must be one of {_SITES}, got {self.site!r}")
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.persistence not in _PERSISTENCE:
            raise ValueError(
                f"persistence must be one of {_PERSISTENCE}, "
                f"got {self.persistence!r}")
        if not 0 <= int(self.bit) < 32:
            raise ValueError(f"bit must be in [0, 32), got {self.bit}")
        if self.op not in (None, "mul", "div"):
            raise ValueError(f"op must be None | 'mul' | 'div', got {self.op!r}")
        if self.site != "table":
            if self.op is not None:
                raise ValueError("op targets correction tables; "
                                 f"meaningless for site={self.site!r}")
            if self.index is not None:
                raise ValueError("index targets correction-table entries; "
                                 f"meaningless for site={self.site!r}")
        else:
            if self.persistence != "persistent":
                raise ValueError(
                    "table upsets are configuration memory: persistent "
                    "until scrubbed — 'transient' is not a table fault")
            if self.index is not None and int(self.index) < 0:
                raise ValueError(f"index must be >= 0, got {self.index}")
        if self.width is not None and self.width not in (8, 16, 32):
            raise ValueError(f"width must be None | 8 | 16 | 32, "
                             f"got {self.width}")
        if self.persistence == "transient" and not 0.0 < self.rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1], got {self.rate}")


_ACTIVE: tuple[FaultSpec, ...] = ()


def active_faults() -> tuple[FaultSpec, ...]:
    """The currently armed fault set (empty tuple when disarmed)."""
    return _ACTIVE


def faults_enabled() -> bool:
    """True when at least one fault is armed. Every hook checks this
    first so the disarmed path costs one tuple-truthiness test."""
    return bool(_ACTIVE)


def _strike_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), _MASK32)


def _seed_word(seed: int) -> int:
    return (seed * 0x9E3779B9 + 0x6A09E667) & _MASK32


def lane_register(specs=None) -> np.ndarray:
    """The kernels' fault register for ``specs`` (default: the armed set),
    as the uint32 words of ``simdive::FaultRegister``: a header (the
    number of lane specs, padding), then :data:`MAX_LANE_FAULTS` specs of
    (site, width or 0 for any, kind, bit mask, transient, strike
    threshold, seed word, padding), the lane specs in arming order, the
    rest zero."""
    specs = _ACTIVE if specs is None else tuple(specs)
    lanes = [s for s in specs if s.site != "table"]
    if len(lanes) > MAX_LANE_FAULTS:
        raise ValueError(
            f"{len(lanes)} lane fault specs armed at once; the kernels' "
            f"fault register holds {MAX_LANE_FAULTS}")
    reg = np.zeros(_HEADER_WORDS + _SPEC_WORDS * MAX_LANE_FAULTS, np.uint32)
    reg[0] = len(lanes)
    for i, s in enumerate(lanes):
        transient = s.persistence == "transient"
        o = _HEADER_WORDS + _SPEC_WORDS * i
        reg[o:o + 7] = (
            _SITE_CODE[s.site], s.width or 0, _KIND_CODE[s.kind],
            1 << int(s.bit), int(transient),
            _strike_threshold(s.rate) if transient else 0,
            _seed_word(int(s.seed)) if transient else 0)
    return reg


def _arm() -> None:
    from repro_torch.core.error_lut import refresh_tables
    from repro_torch.kernels.build import write_fault_register

    refresh_tables()
    write_fault_register()


def set_faults(specs=()) -> None:
    """Arm exactly ``specs`` (empty = disarm).

    Every materialized table tensor is rewritten in place and the
    kernels' fault register is written, both on the current stream, so
    the arming lands between the work queued before and after it — CUDA
    graphs included, without a capture. Nothing is armed when a spec is
    not a :class:`FaultSpec`, when more than :data:`MAX_LANE_FAULTS` lane
    specs are asked for, when a CUDA graph is being captured, or when a
    table fault cannot reach a materialized table (an ``index`` past its
    end): each raises with the previous arming still in place.
    """
    global _ACTIVE
    specs = tuple(specs)
    for s in specs:
        if not isinstance(s, FaultSpec):
            raise TypeError(f"expected FaultSpec, got {type(s).__name__}")
    if specs == _ACTIVE:
        return
    lane_register(specs)                  # raises on too many lane specs
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "set_faults while a CUDA graph is being captured: arm before "
            "the capture or after it, never inside")
    prev, _ACTIVE = _ACTIVE, specs
    try:
        _arm()
    except BaseException:
        _ACTIVE = prev
        _arm()
        raise


@contextmanager
def fault_injection(*specs: FaultSpec):
    """Arm ``specs`` for the dynamic extent, restoring the previous
    arming (usually: disarmed) on exit — exception-safe."""
    prev = _ACTIVE
    set_faults(specs)
    try:
        yield
    finally:
        set_faults(prev)


# ------------------------------------------------------------ table site --
def apply_table_faults(tab: np.ndarray, *, op: str, width: int) -> np.ndarray:
    """Upset a host-side int32 correction table. Returns the input object
    itself when no armed fault matches (preserving the cache identity of
    the pristine table); otherwise a corrupted copy — the cached original
    is never mutated."""
    out = None
    for s in _ACTIVE:
        if s.site != "table":
            continue
        if s.op is not None and s.op != op:
            continue
        if s.width is not None and s.width != width:
            continue
        if out is None:
            out = np.array(tab, dtype=np.int32, copy=True)
        if s.index is not None and s.index >= out.size:
            raise ValueError(
                f"fault index {s.index} out of range for the {op} table's "
                f"{out.size} entries (index_bits too small?)")
        u = out.view(np.uint32)
        m = np.uint32(1 << s.bit)
        sel = slice(None) if s.index is None else s.index
        if s.kind == "flip":
            u[sel] ^= m
        elif s.kind == "stuck1":
            u[sel] |= m
        else:  # stuck0
            u[sel] &= ~m
    return tab if out is None else out


# ------------------------------------------------------------- lane sites --
def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for carrier values ``h < 2^32``, in two 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _strike(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Deterministic per-element strike pattern for transient faults: the
    reference's murmur-style avalanche of the lane value, thresholded at
    ``rate``, with its uint32 multiplies and shifts wrapped mod 2^32 on
    the int64 carrier — the same bits as the reference's and the
    kernels'."""
    h = (x & _MASK32) ^ _seed_word(seed)
    h = _mul32(h, 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h < _strike_threshold(rate)


def apply_lane_faults(x: torch.Tensor, *, site: str,
                      width: int) -> torch.Tensor:
    """Upset lane words at a datapath stage ('log' or 'pack'). ``x`` is an
    int64 carrier of uint32 values; results stay in [0, 2^32), so a fault
    at bit 31 gives the uint32 value. Returns ``x`` untouched when no
    armed fault matches."""
    for s in _ACTIVE:
        if s.site != site:
            continue
        if s.width is not None and s.width != width:
            continue
        m = 1 << s.bit
        if s.kind == "flip":
            y = x ^ m
        elif s.kind == "stuck1":
            y = x | m
        else:  # stuck0
            y = x & ~m
        if s.persistence == "transient":
            x = torch.where(_strike(x, s.rate, s.seed), y, x)
        else:
            x = y
    return x
