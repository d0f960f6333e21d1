"""Fault injection & resilience measurement for the SIMDive datapath.

Counterpart of ``repro.faults``: SIMDive's correction terms live in FPGA
configuration memory (LUTs), so a deployed soft multiplier-divider faces
soft errors (SEU bit flips in correction tables and datapath registers)
on top of its designed approximation. This package emulates that fault
class through the port's datapath — the plain versions and every CUDA
kernel alike — and measures what survives:

  inject.py    FaultSpec + arm / disarm: stuck-at / bit-flip, persistent
               / transient, on correction-table entries, log-stage lane
               bits and packed-lane repack words. Arming rewrites the
               materialized tables in place and writes the kernels'
               fault register; disarmed, bit-identical.
  scrub.py     Correction-table integrity scrub: reads back every
               materialized copy of a table and diffs it against the
               pristine build.
  campaign.py  Fault-site sweeps per (op, width, coeff_bits) reporting
               error amplification (ARE / WCE delta, non-finite rate) and
               whether the guard or the scrub caught each site.
               ``python -m repro_torch.faults.campaign`` is the CLI.

Only the injection layer is imported eagerly; ``scrub`` and ``campaign``
pull in the tables and the kernels and are imported explicitly.
"""
from .inject import (  # noqa: F401
    FaultSpec,
    active_faults,
    apply_lane_faults,
    apply_table_faults,
    fault_injection,
    faults_enabled,
    set_faults,
)

__all__ = [
    "FaultSpec",
    "active_faults",
    "apply_lane_faults",
    "apply_table_faults",
    "fault_injection",
    "faults_enabled",
    "set_faults",
]
