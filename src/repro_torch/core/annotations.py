"""Width-contract annotations consumed by the static analyzer.

Counterpart of ``repro.core.annotations``. The bit-width verifier
(:mod:`repro_torch.analysis.widthcheck`) propagates a non-relational
interval x possible-bits domain through aten graphs. One datapath fact is
*relational* and so invisible to that domain: the Mitchell log packing
``L = (k << F) | x_fp`` is disjoint only because ``x_fp = frac << (F - k)``
and ``frac < 2^(k+1)`` share the same ``k``. These annotations bridge the
gap with checked contracts:

* :func:`require_range` declares a precondition. The analyzer *verifies*
  the incoming abstract interval against it (an out-of-domain operand is a
  finding there) and may open a scope in which named rules are assumed
  (``assume=...``) until the matching :func:`ensure_range`.
* :func:`ensure_range` declares a postcondition and closes the scope. The
  analyzer *refines* the abstract value to it; the postcondition itself is
  backed by the bit-parity tests against the reference and listed as an
  "assumed contract" in every report.

Outside analyzer tracing both functions return ``x`` itself and dispatch
nothing, so CUDA graph captures and launch counts never see them. While
:func:`analysis_tracing` is active they call the identity custom op
``repro_torch::range_contract``, which ``make_fx`` records as a node.

The same switch turns the carrier helpers of :mod:`repro_torch.core.mitchell`
(``wrap_bus``, ``wrap_int32``, ``wrap_signed``, ``to_lanes``,
``lanes_to_float``) into ``repro_torch::carrier_cast`` nodes: each one is the
port's rendition of a dtype conversion of the reference (``astype``), and
the analyzer checks it as one (:func:`carrier_cast`).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = [
    "analysis_tracing",
    "tracing_active",
    "require_range",
    "ensure_range",
    "carrier_cast",
    "CAST_DTYPES",
]

_ACTIVE = False

#: carrier_cast targets -> the dtype of the tensor the helper returns
CAST_DTYPES = {
    "uint32": torch.int64,          # wrap_bus, widths <= 16
    "uint64": torch.int64,          # wrap_bus, width 32
    "int32": torch.int64,           # wrap_int32 / wrap_signed, widths <= 16
    "int64": torch.int64,           # wrap_signed, width 32
    "lanes32": torch.uint32,        # to_lanes, widths <= 16
    # simdive-lint: allow(unguarded-uint64): the dtype to_lanes returns at width 32, a tag only
    "lanes64": torch.uint64,        # to_lanes, width 32
    "float32": torch.float32,       # lanes_to_float
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@torch.library.custom_op("repro_torch::range_contract", mutates_args=())
def _range_contract(x: torch.Tensor, phase: str, lo: str, hi: str, bits: str,
                    what: str, assume: str) -> torch.Tensor:
    return x.clone()


@_range_contract.register_fake
def _(x, phase, lo, hi, bits, what, assume):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::carrier_cast", mutates_args=())
def _carrier_cast(x: torch.Tensor, to: str) -> torch.Tensor:
    # only ever traced; the eager form exists so a real-mode trace still
    # runs: the helper's own arithmetic, which this op stands for
    from . import mitchell as m

    with _inactive():
        if to in ("uint32", "uint64"):
            return m.wrap_bus(x, 16 if to == "uint32" else 32).clone()
        if to == "int32":
            return m.wrap_int32(x)
        if to == "int64":
            return x.clone()
        if to.startswith("lanes"):
            return m.to_lanes(x, 16 if to == "lanes32" else 32).clone()
        return m.lanes_to_float(x, getattr(torch, to))


@_carrier_cast.register_fake
def _(x, to):
    return torch.empty(x.shape, dtype=CAST_DTYPES[to], device=x.device)


@contextmanager
def _inactive():
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = False
    try:
        yield
    finally:
        _ACTIVE = prev


def tracing_active() -> bool:
    """True while the analyzer is tracing (annotations emit their op
    instead of being identity no-ops)."""
    return _ACTIVE


@contextmanager
def analysis_tracing():
    """Arm the annotations for one analyzer trace (widthcheck-internal)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = True
    try:
        yield
    finally:
        _ACTIVE = prev


def _num(v) -> str:
    return "" if v is None else str(int(v))


def require_range(x, *, hi: int, lo: int = 0, what: str = "",
                  assume: tuple = ()):
    """Checked precondition: the analyzer flags ``x`` unless its abstract
    interval is provably inside ``[lo, hi]``, then refines it to the
    declared range (so one caller bug yields one finding, not a cascade).
    ``assume`` names analyzer rules suppressed until the matching
    :func:`ensure_range` — the contract-verified region."""
    if not _ACTIVE:
        return x
    return _range_contract(x, "require", _num(lo), _num(hi), "", str(what),
                           ",".join(assume))


def ensure_range(x, *, hi: int, lo: int = 0, bits: int | None = None,
                 what: str = ""):
    """Declared postcondition: refines the abstract value to ``[lo, hi]``
    (and possible-bits mask ``bits``) and closes the innermost
    :func:`require_range` scope. Backed by the bit-parity tests, reported
    as an assumed contract — see the module docstring."""
    if not _ACTIVE:
        return x
    return _range_contract(x, "ensure", _num(lo), _num(hi), _num(bits),
                           str(what), "")


def carrier_cast(x, to: str):
    """While tracing: the carrier helper's conversion as one node
    (``to`` is a key of :data:`CAST_DTYPES`). Callers check
    :func:`tracing_active` first; outside tracing they run their own
    arithmetic and never reach this."""
    return _carrier_cast(x, to)
