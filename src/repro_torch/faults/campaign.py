"""SEU resilience campaign: sweep fault sites, measure amplification.

Counterpart of ``repro.faults.campaign``. Fault *injection*
(:mod:`repro_torch.faults.inject`) answers "what changes"; this module
answers the robustness questions an FPGA deployment would ask about
configuration-memory upsets:

  * **How much does each fault hurt?** Per-site error amplification of
    the elemwise datapath through :mod:`repro_torch.metrics` — ARE% / WCE
    delta of the faulted op against the exact reference, relative to the
    same op clean, plus the changed-output and non-finite rates.
  * **Would the serving stack notice?** Each site records whether the
    eager output guard (``get_op(..., guard=True)``) trips and whether
    the table scrub (:mod:`repro_torch.faults.scrub`) flags it.

Every function takes ``device`` (default ``'cuda'``): on the card the
``auto`` dispatch runs the CUDA kernels — ``csrc/elemwise.cu`` and, for
the pack site, ``csrc/packed_simd.cu``, both reading the armed tables and
fault register —; ``device='cpu'`` runs the plain versions, the pack site
through ``packed_simd.packed_word_op`` (the kernel body as a plain
function, the counterpart of the reference's ``pallas-interpret``
backend: ``packed_ref`` repacks without the pack hook, as the
reference's does). A CUDA device on a host without one raises.

``--ann`` (:func:`ann_accuracy_drop`) adds Table 4's classifier: the
784-100-10 MLP of :mod:`repro_torch.apps.table4_ann`, trained in float on
``device`` and run in 8-bit fixed point on ``matmul_int`` (on the card the
``logmatmul`` kernel, which reads the armed table and fault register),
clean and under a stuck-1 at bit 20 of the width-8 mul table.

CLI::

    PYTHONPATH=src python -m repro_torch.faults.campaign --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.faults.campaign --out report.json
    PYTHONPATH=src python -m repro_torch.faults.campaign --ann [--widths 8] \
        [--device cpu]

``--smoke`` flips one correction-table bit per op, requires the campaign
to detect it (scrub + changed outputs) and disarming to restore
bit-identical results; exits nonzero on any violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch.core.device import require_device
from repro_torch.core.error_lut import build_table, build_table_clean
from repro_torch.core.mitchell import from_lanes
from repro_torch.core.simd_pack import pack
from repro_torch.core.simdive import SimdiveSpec
from repro_torch.faults.inject import FaultSpec, fault_injection
from repro_torch.faults.scrub import scrub_tables
from repro_torch.kernels import datapath as dp
from repro_torch.kernels.packed_simd import packed_word_op
from repro_torch.kernels.registry import GuardTripped, get_op
from repro_torch.metrics import DIV_FRAC_OUT, error_stats, grid8, sample_uints

__all__ = [
    "SiteResult",
    "ann_accuracy_drop",
    "default_sites",
    "measure_pack_site",
    "measure_site",
    "run_campaign",
    "smoke",
    "main",
]


@dataclass(frozen=True)
class SiteResult:
    """Measured impact + detectability of one fault site on one op."""

    op: str
    width: int
    coeff_bits: int
    site: str
    bit: int
    kind: str
    persistence: str
    rate: float
    guard_tripped: bool      # eager output guard raised GuardTripped
    scrub_detected: bool     # table read-back diffed vs pristine oracle
    changed_rate: float      # fraction of outputs that moved vs clean
    nonfinite_rate: float    # NaN/Inf fraction of faulted outputs
    are_clean_pct: float
    are_fault_pct: float
    are_delta_pct: float     # amplification: faulted ARE% - clean ARE%
    wce_clean: float
    wce_fault: float
    wce_delta: float

    @property
    def detected(self) -> bool:
        """Deterministically caught by guard or scrub (not just measured)."""
        return self.guard_tripped or self.scrub_detected

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["detected"] = self.detected
        return d

    def __str__(self):
        det = ("guard" if self.guard_tripped else
               "scrub" if self.scrub_detected else "measured-only")
        return (f"{self.op} w{self.width} cb{self.coeff_bits} "
                f"{self.site}/{self.kind} bit{self.bit} "
                f"[{self.persistence}] -> dARE={self.are_delta_pct:+.3f}% "
                f"changed={self.changed_rate:.3f} "
                f"nonfinite={self.nonfinite_rate:.3f} det={det}")


def default_sites(op: str, width: int, *, full: bool = False
                  ) -> tuple[FaultSpec, ...]:
    """The deterministic site set swept per (op, width).

    The quick set covers each fault class once (table flip, table
    stuck-at, persistent log-stage strike, transient log-stage strike);
    ``full`` widens the table-bit sweep across the coefficient word and
    adds a single-entry upset and a stuck-0.
    """
    sites = [
        FaultSpec(site="table", bit=20, kind="flip", op=op, width=width),
        FaultSpec(site="table", bit=28, kind="stuck1", op=op, width=width),
        FaultSpec(site="log", bit=width // 2, kind="stuck1", width=width),
        FaultSpec(site="log", bit=width - 1, kind="flip", width=width,
                  persistence="transient", rate=0.05),
    ]
    if full:
        sites += [
            FaultSpec(site="table", bit=b, kind="flip", op=op, width=width)
            for b in (4, 12, 16, 24, 30)
        ]
        sites += [
            FaultSpec(site="table", bit=14, kind="stuck0", op=op,
                      width=width),
            FaultSpec(site="table", bit=20, kind="flip", op=op, width=width,
                      index=27),
            FaultSpec(site="log", bit=2, kind="stuck1", width=width,
                      persistence="transient", rate=0.01),
        ]
    return tuple(sites)


def _operands(op: str, width: int, n: int, seed: int):
    if width == 8:
        return grid8()
    # paper divider format is 16/8: 8-bit divisor keeps the quotient
    # above the frac_out quantization floor (table2_sisd convention)
    return sample_uints(width, n, seed, b_width=8 if op == "div" else width)


def _lanes(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64)).to(dev)


def _values(out: torch.Tensor, scale: float = 1.0) -> np.ndarray:
    return from_lanes(out).cpu().numpy().astype(np.float64) / scale


def measure_site(spec: FaultSpec, op: str, *, width: int = 8,
                 coeff_bits: int = 6, n: int = 65536, seed: int = 0,
                 device: torch.device | str = "cuda") -> SiteResult:
    """One fault site through the elemwise datapath: amplification vs the
    exact reference, plus guard / scrub detectability, all under a single
    arming of ``spec``."""
    dev = require_device(device)
    sspec = SimdiveSpec(width=width, coeff_bits=coeff_bits)
    bound = get_op("elemwise", sspec, "auto")
    guarded = get_op("elemwise", sspec, "auto", guard=True)
    A, B = _operands(op, width, n, seed)
    At, Bt = _lanes(A, dev), _lanes(B, dev)
    kw = {"op": op}
    scale = 1.0
    if op == "div":
        kw["frac_out"] = DIV_FRAC_OUT
        scale = float(2 ** DIV_FRAC_OUT)
    exact = (A.astype(np.float64) * B if op == "mul"
             else A / B.astype(np.float64))
    clean = _values(bound(At, Bt, **kw), scale)
    ident = (op, width, coeff_bits, sspec.index_bits)
    with fault_injection(spec):
        fault = _values(bound(At, Bt, **kw), scale)
        tripped = False
        try:
            guarded(At, Bt, **kw)
        except GuardTripped:
            tripped = True
        scrubbed = (bool(scrub_tables((ident,)))
                    if spec.site == "table" else False)
    sc = error_stats(clean, exact)
    sf = error_stats(fault, exact)
    return SiteResult(
        op=op, width=width, coeff_bits=coeff_bits,
        site=spec.site, bit=spec.bit, kind=spec.kind,
        persistence=spec.persistence, rate=spec.rate,
        guard_tripped=tripped, scrub_detected=scrubbed,
        changed_rate=float((fault != clean).mean()),
        nonfinite_rate=float((~np.isfinite(fault)).mean()),
        are_clean_pct=sc.are_pct, are_fault_pct=sf.are_pct,
        are_delta_pct=sf.are_pct - sc.are_pct,
        wce_clean=sc.wce, wce_fault=sf.wce, wce_delta=sf.wce - sc.wce,
    )


def measure_pack_site(spec: FaultSpec, *, coeff_bits: int = 6,
                      n: int = 16384, seed: int = 0,
                      device: torch.device | str = "cuda") -> SiteResult:
    """A packed-lane-boundary strike through the 4x8-bit packed kernel.

    The pack hook fires where the kernel repacks its lanes: on the card
    in ``csrc/packed_simd.cu``, on the CPU in ``packed_word_op`` (the
    kernel body; ``packed_ref`` repacks through ``simd_pack.pack`` and
    never fires it). No cheap exact reference exists at the repacked word
    level, so amplification is reported against the *clean* packed output
    (``are_clean_pct == 0`` by construction) — the interesting fields are
    ``changed_rate`` and the cross-lane corruption it implies.
    """
    if spec.site != "pack":
        raise ValueError(f"measure_pack_site needs a pack-site spec, "
                         f"got {spec.site!r}")
    dev = require_device(device)
    sspec = SimdiveSpec(width=8, coeff_bits=coeff_bits)
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 256, n, dtype=np.uint32)
    b = rng.integers(1, 256, n, dtype=np.uint32)
    aw, bw = pack(_lanes(a, dev), 8), pack(_lanes(b, dev), 8)
    tab = dp.op_table("mul", 8, coeff_bits, sspec.index_bits, device=dev)
    bound = get_op("packed", sspec, "auto")

    def run():
        if dev.type == "cuda":
            return bound(aw, bw, op="mul")
        return packed_word_op(aw, bw, tab, spec=sspec, op="mul", frac_out=0)

    clean = _values(run())
    with fault_injection(spec):
        fault = _values(run())
    sf = error_stats(fault, clean)
    return SiteResult(
        op="mul", width=8, coeff_bits=coeff_bits,
        site=spec.site, bit=spec.bit, kind=spec.kind,
        persistence=spec.persistence, rate=spec.rate,
        guard_tripped=False, scrub_detected=False,
        changed_rate=float((fault != clean).mean()),
        nonfinite_rate=float((~np.isfinite(fault)).mean()),
        are_clean_pct=0.0, are_fault_pct=sf.are_pct,
        are_delta_pct=sf.are_pct,
        wce_clean=0.0, wce_fault=sf.wce, wce_delta=sf.wce,
    )


def ann_accuracy_drop(spec: FaultSpec, *, quick: bool = True,
                      device: torch.device | str = "cuda",
                      backend: str = "auto", ws=None) -> dict:
    """Table 4 ANN inference accuracy, clean vs under ``spec``.

    The 784-100-10 MLP of :mod:`repro_torch.apps.table4_ann` trained on
    ``device`` (200 steps, or 600 when not ``quick``), or the float weights
    ``ws`` when given; its 8-bit inference runs on ``get_op("matmul_int",
    SimdiveSpec(8, 6), backend)``: under ``'auto'`` the ``logmatmul``
    kernel on the card, under ``'ref'`` the plain version wherever the
    tensors lie."""
    from repro_torch.apps.table4_ann import (
        make_dataset, quantized_infer, to_torch, train_float)
    from repro_torch.metrics import classification_accuracy

    dev = require_device(device)
    (xtr, ytr), (xte, yte) = make_dataset(seed=0)
    if ws is None:
        ws, _ = train_float(xtr, ytr, hidden=(100,),
                            steps=200 if quick else 600, seed=0, device=dev)
    ws = to_torch(ws, dev)
    mul = get_op("matmul_int", SimdiveSpec(width=8, coeff_bits=6),
                 backend=backend)

    def accuracy():
        return classification_accuracy(
            quantized_infer(ws, xte, mul).cpu().numpy(), yte)

    acc_clean = accuracy()
    with fault_injection(spec):
        acc_fault = accuracy()
    return {"spec": _spec_dict(spec), "acc_clean_pct": acc_clean,
            "acc_fault_pct": acc_fault,
            "acc_drop_pct_points": acc_clean - acc_fault}


def _spec_dict(spec: FaultSpec) -> dict:
    return {"site": spec.site, "bit": spec.bit, "kind": spec.kind,
            "persistence": spec.persistence, "op": spec.op,
            "width": spec.width, "index": spec.index, "rate": spec.rate,
            "seed": spec.seed}


def run_campaign(*, widths=(8, 16), coeff_bits: int = 6, full: bool = False,
                 seed: int = 0, ann: bool = False,
                 device: torch.device | str = "cuda",
                 report=print) -> dict:
    """The full sweep: every default site for every (op, width), plus a
    pack-boundary strike, summarized into a plain-JSON report."""
    results: list[SiteResult] = []
    for width in widths:
        for op in ("mul", "div"):
            cb = coeff_bits if width == 8 else 8
            for spec in default_sites(op, width, full=full):
                r = measure_site(spec, op, width=width, coeff_bits=cb,
                                 seed=seed, device=device)
                results.append(r)
                report(f"fault-campaign,{r}")
    # the pack hook sees the *output* bus width (2w = 16 for 8-bit lanes)
    pack_spec = FaultSpec(site="pack", bit=7, kind="flip", width=16)
    r = measure_pack_site(pack_spec, coeff_bits=coeff_bits, seed=seed,
                          device=device)
    results.append(r)
    report(f"fault-campaign,{r}")
    table = [r for r in results if r.site == "table"]
    doc = {
        "schema": "simdive-fault-campaign/v1",
        "sites": [r.as_dict() for r in results],
        "summary": {
            "n_sites": len(results),
            "table_sites": len(table),
            "table_scrub_detected": sum(r.scrub_detected for r in table),
            "guard_trips": sum(r.guard_tripped for r in results),
            "max_are_delta_pct": max(r.are_delta_pct for r in results),
            "max_nonfinite_rate": max(r.nonfinite_rate for r in results),
        },
    }
    if ann:
        doc["ann"] = ann_accuracy_drop(
            FaultSpec(site="table", bit=20, kind="stuck1", op="mul",
                      width=8), device=device)
        report(f"fault-campaign,ann,{doc['ann']}")
    # the scrub is the deterministic detector for persistent table upsets
    # — a miss here is a campaign bug, fail loudly rather than report it.
    # (stuck-at faults matching the bit's existing value alter nothing —
    # changed_rate 0 — and correctly scrub clean)
    missed = [r for r in table
              if r.changed_rate > 0 and not r.scrub_detected]
    if missed:
        raise RuntimeError(
            f"table-scrub missed {len(missed)} persistent table fault(s): "
            + "; ".join(str(r) for r in missed))
    return doc


def smoke(report=print, device: torch.device | str = "cuda") -> bool:
    """Smoke check: one flipped correction-table bit per op must be
    detected, and disarming must restore bit-identical outputs."""
    dev = require_device(device)
    ok = True
    for op in ("mul", "div"):
        spec = FaultSpec(site="table", bit=20, kind="flip", op=op, width=8)
        r = measure_site(spec, op, width=8, coeff_bits=6, device=dev)
        detected = r.scrub_detected and r.changed_rate > 0
        report(f"fault-smoke,{op},detected={detected},{r}")
        if not detected:
            report(f"fault-smoke,FAIL,{op} table flip not detected")
            ok = False
        # disarmed: the live table must be the pristine cached object and
        # the op must be bit-identical to a never-faulted run
        t_live = build_table(op, 8, 6)
        t_clean = build_table_clean(op, 8, 6)
        if t_live is not t_clean:
            report(f"fault-smoke,FAIL,{op} disarmed table not cache-"
                   "identical to the pristine oracle")
            ok = False
        bound = get_op("elemwise", SimdiveSpec(width=8, coeff_bits=6), "auto")
        A, B = _operands(op, 8, 0, 0)
        At, Bt = _lanes(A, dev), _lanes(B, dev)
        kw = {"op": op, "frac_out": DIV_FRAC_OUT} if op == "div" \
            else {"op": op}
        o1 = _values(bound(At, Bt, **kw))
        with fault_injection(spec):
            pass  # arm and disarm
        o2 = _values(bound(At, Bt, **kw))
        if not np.array_equal(o1, o2):
            report(f"fault-smoke,FAIL,{op} outputs moved after disarm")
            ok = False
    report(f"fault-smoke,{'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SIMDive SEU resilience campaign (PyTorch/CUDA port)")
    ap.add_argument("--smoke", action="store_true",
                    help="one table bit per op -> detected, disarmed "
                         "bit-identical; exit 1 on failure")
    ap.add_argument("--out", default=None,
                    help="write the campaign report JSON here")
    ap.add_argument("--full", action="store_true",
                    help="widen the per-op table-bit sweep")
    ap.add_argument("--ann", action="store_true",
                    help="also measure Table 4 ANN accuracy drop")
    ap.add_argument("--widths", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; an error without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        return 0 if smoke(device=args.device) else 1
    doc = run_campaign(widths=tuple(args.widths), full=args.full,
                       seed=args.seed, ann=args.ann, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"fault-campaign,report,{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
