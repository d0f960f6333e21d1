"""Correction-table integrity scrub — configuration-memory scrubbing.

Counterpart of ``repro.faults.scrub``. FPGA deployments counter SEUs in
configuration memory by *scrubbing*: reading frames back and comparing
them against the golden bitstream. The SIMDive analogue: the correction
tables are the design's configuration memory, and a persistent table
upset corrupts quotients while keeping them finite and in-lane, so output
guards and non-finite-logit watchdogs cannot see it. Detection has to
read the memory back.

Here that memory is every materialized copy of a table — the int64
tensors the plain versions gather from and the int32 tensors the CUDA
kernels (and the CUDA graphs that hold their addresses) read on the card
(``core.error_lut.materialized_tables``) — plus the host table
``build_table`` serves, each diffed against the pristine build
(``build_table_clean``). An arming through ``set_faults`` rewrites all of
them alike, so the findings equal the reference's; a copy corrupted
behind ``set_faults``'s back is flagged as well.

:class:`repro_torch.launch.scheduler.Scheduler` runs this scrub every
``scrub_every`` ticks over the table identities its ladder's configs
resolve to, quarantining in-flight work when corruption is found.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.error_lut import (build_table, build_table_clean,
                                        materialized_tables)

__all__ = [
    "ScrubFinding",
    "config_table_identities",
    "scrub_tables",
]


@dataclass(frozen=True)
class ScrubFinding:
    """One corrupted correction table found by a scrub pass."""

    op: str
    width: int
    coeff_bits: int
    index_bits: int
    entries: int   # corrupted table entries
    bits: int      # total upset bits across those entries

    def __str__(self):  # log-line friendly
        return (f"{self.op} w{self.width} cb{self.coeff_bits} "
                f"ib{self.index_bits}: {self.bits} bit(s) upset across "
                f"{self.entries} entr{'y' if self.entries == 1 else 'ies'}")


def config_table_identities(cfg, n_layers: int = 0
                            ) -> tuple[tuple[str, int, int, int], ...]:
    """Correction-table identities ``(op, width, coeff_bits, index_bits)``
    an ApproxConfig's dispatch can read.

    Covers the three resolution paths (matmul -> 'mul' table, generic
    divider and attention divider -> 'div' tables). With a policy and
    ``n_layers > 0`` the union is taken over every layer label, so a
    heterogeneous per-layer policy contributes each rung's tables.
    Exact mode touches no tables.
    """
    if not getattr(cfg, "enabled", False):
        return ()
    cfgs = [cfg]
    if getattr(cfg, "policy", None) is not None and n_layers > 0:
        from repro_torch.core.approx import layer_label

        cfgs = [replace(cfg, layer=layer_label(i)) for i in range(n_layers)]
    seen: set = set()
    out: list[tuple[str, int, int, int]] = []
    for c in cfgs:
        idents = []
        if c.use_in_linear:
            spec, _ = c.resolve("matmul")
            idents.append(("mul", spec.width, spec.coeff_bits, spec.index_bits))
        spec, _ = c.resolve("div", c.div_width)
        idents.append(("div", spec.width, spec.coeff_bits, spec.index_bits))
        spec, _, _ = c.resolve_attention()
        idents.append(("div", spec.width, spec.coeff_bits, spec.index_bits))
        for t in idents:
            if t not in seen:
                seen.add(t)
                out.append(t)
    return tuple(out)


def _live_copies(identities) -> dict[tuple, list[np.ndarray]]:
    """Each identity's host table and every materialized tensor copy of
    it, read back as int32 (device tensors through one copy to the host)."""
    copies = {ident: [build_table(*ident)] for ident in identities}
    for (op, width, cb, ib, _, _), t in materialized_tables().items():
        live = copies.get((op, width, cb, ib))
        if live is not None:
            live.append(t.cpu().numpy().astype(np.int32))
    return copies


def scrub_tables(identities) -> tuple[ScrubFinding, ...]:
    """Read back every live copy of each identified table and diff it
    against the pristine build. Returns a finding per corrupted table
    (empty = clean pass); where copies disagree, the finding counts the
    entries and bits that differ in any of them."""
    identities = tuple(identities)
    copies = _live_copies(identities)
    findings = []
    for ident in identities:
        clean = build_table_clean(*ident).view(np.uint32)
        diff = np.zeros_like(clean)
        for copy in copies[ident]:
            diff |= copy.view(np.uint32) ^ clean
        if diff.any():
            op, width, coeff_bits, index_bits = ident
            findings.append(ScrubFinding(
                op=op, width=width, coeff_bits=coeff_bits,
                index_bits=index_bits,
                entries=int((diff != 0).sum()),
                bits=int(np.unpackbits(diff.view(np.uint8)).sum()),
            ))
    return tuple(findings)
