"""Loss-divergence metrics: how far an approximate training run drifts
from its exact twin.

Counterpart of ``repro.metrics.divergence``. The training scenario
(:mod:`repro_torch.train`) runs two models on bitwise-identical batch
sequences — one exact, one dispatching SIMDive arithmetic — and asks
three questions per step:

  * **loss delta** — the approximate run's loss minus the exact twin's,
    on the same batch at the same step;
  * **gradient cosine similarity** — global cosine between the two runs'
    gradient trees (1.0 = the approximate arithmetic leaves the
    training signal's direction untouched);
  * **parameter drift** — relative L2 distance between the two parameter
    trees after the update (how far the trajectories have separated).

:class:`DivergenceTrace` accumulates the per-step records and summarizes
them, and its JSON form (schema :data:`DIVERGENCE_SCHEMA`) is the
reference's, field for field. The tree metrics work on the port's nested
dicts of tensors, on the device, leaves in sorted key order as
``jax.tree.leaves`` walks a dict; a ``None`` gradient leaf (no autograd
path, where the reference has a zero array: ROADMAP R-8) adds zero to
every dot product and norm, as the reference's zeros do.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = [
    "DIVERGENCE_SCHEMA",
    "tree_dot",
    "tree_norm",
    "grad_cosine",
    "param_drift",
    "DivergenceTrace",
]

DIVERGENCE_SCHEMA = "simdive-train-divergence/v1"


def tree_dot(a, b) -> torch.Tensor:
    """Global dot product of two matching trees (float32 accumulation);
    a pair with a ``None`` side adds nothing."""
    dots = [torch.dot(x.reshape(-1).to(torch.float32),
                      y.reshape(-1).to(torch.float32))
            for x, y in zip(tree_leaves(a), tree_leaves(b))
            if x is not None and y is not None]
    if not dots:
        return torch.zeros((), dtype=torch.float32)
    total = dots[0]
    for d in dots[1:]:
        total = total + d
    return total


def tree_norm(t) -> torch.Tensor:
    """Global L2 norm of a tree."""
    return torch.sqrt(tree_dot(t, t) + 0.0)


def grad_cosine(ga, gb, eps: float = 1e-30) -> torch.Tensor:
    """Global cosine similarity between two gradient trees."""
    num = tree_dot(ga, gb)
    den = tree_norm(ga) * tree_norm(gb)
    return num / den.clamp(min=eps)


def param_drift(pa, pb, eps: float = 1e-30) -> torch.Tensor:
    """Relative L2 distance ||pa - pb|| / ||pb|| between two parameter
    trees. 0.0 = bitwise-identical trajectories."""
    diff = tree_map(lambda x, y: x.to(torch.float32) - y.to(torch.float32),
                    pa, pb)
    return tree_norm(diff) / tree_norm(pb).clamp(min=eps)


@dataclass
class DivergenceTrace:
    """Per-step divergence records of one approx-vs-exact twin run.

    ``records`` is a list of plain dicts (step, loss_exact, loss_approx,
    loss_delta, grad_cosine, param_drift, rung); :meth:`summary` reduces
    them to the gated statistics, :meth:`as_dict` is the report document
    (schema :data:`DIVERGENCE_SCHEMA`).
    """
    meta: dict = field(default_factory=dict)
    records: list = field(default_factory=list)

    def record(self, step: int, *, loss_exact: float, loss_approx: float,
               grad_cosine: float | None = None,
               param_drift: float | None = None,
               rung: str | None = None) -> dict:
        rec = {
            "step": int(step),
            "loss_exact": float(loss_exact),
            "loss_approx": float(loss_approx),
            "loss_delta": float(loss_approx) - float(loss_exact),
        }
        if grad_cosine is not None:
            rec["grad_cosine"] = float(grad_cosine)
        if param_drift is not None:
            rec["param_drift"] = float(param_drift)
        if rung is not None:
            rec["rung"] = str(rung)
        self.records.append(rec)
        return rec

    # ------------------------------------------------------- statistics --
    def _series(self, key: str) -> list:
        return [r[key] for r in self.records if key in r]

    def final_loss_delta_pct(self) -> float:
        """|loss_approx - loss_exact| / |loss_exact| * 100 at the last
        recorded step — the BENCH ``train`` family's headline stat."""
        if not self.records:
            raise ValueError("empty divergence trace")
        last = self.records[-1]
        denom = max(abs(last["loss_exact"]), 1e-30)
        return 100.0 * abs(last["loss_delta"]) / denom

    def max_abs_loss_delta(self) -> float:
        return max(abs(d) for d in self._series("loss_delta"))

    def min_grad_cosine(self) -> float | None:
        vals = self._series("grad_cosine")
        return min(vals) if vals else None

    def max_param_drift(self) -> float | None:
        vals = self._series("param_drift")
        return max(vals) if vals else None

    def steps_to_loss(self, target: float) -> dict:
        """First step at which each twin's loss <= ``target`` (None =
        never reached within the trace)."""
        out = {"exact": None, "approx": None}
        for rec in self.records:
            if out["exact"] is None and rec["loss_exact"] <= target:
                out["exact"] = rec["step"]
            if out["approx"] is None and rec["loss_approx"] <= target:
                out["approx"] = rec["step"]
        return out

    def default_loss_target(self) -> float:
        """The steps-to-loss-X target the summary reports: halfway (in
        loss) between the exact twin's first and final loss — reached by
        mid-run, so both twins' step counts are comparable and finite for
        any run that actually learns."""
        first = self.records[0]["loss_exact"]
        last = self.records[-1]["loss_exact"]
        return 0.5 * (first + last)

    def summary(self) -> dict:
        target = self.default_loss_target()
        s = {
            "steps": len(self.records),
            "loss_target": target,
            "steps_to_loss": self.steps_to_loss(target),
            "final_loss_exact": self.records[-1]["loss_exact"],
            "final_loss_approx": self.records[-1]["loss_approx"],
            "final_loss_delta_pct": self.final_loss_delta_pct(),
            "max_abs_loss_delta": self.max_abs_loss_delta(),
        }
        if self._series("grad_cosine"):
            s["min_grad_cosine"] = self.min_grad_cosine()
        if self._series("param_drift"):
            s["max_param_drift"] = self.max_param_drift()
        rungs = [r["rung"] for r in self.records if "rung" in r]
        if rungs:
            s["rungs"] = sorted(set(rungs))
        return s

    # ---------------------------------------------------- serialization --
    def as_dict(self) -> dict:
        return {"schema": DIVERGENCE_SCHEMA, "meta": dict(self.meta),
                "summary": self.summary(), "records": list(self.records)}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_dict(cls, d: dict) -> "DivergenceTrace":
        if not isinstance(d, dict) or d.get("schema") != DIVERGENCE_SCHEMA:
            raise ValueError(
                f"not a divergence trace (expected schema "
                f"{DIVERGENCE_SCHEMA!r}, got "
                f"{d.get('schema') if isinstance(d, dict) else type(d)})")
        return cls(meta=dict(d.get("meta") or {}),
                   records=list(d.get("records") or []))

    @classmethod
    def load(cls, path: str) -> "DivergenceTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def render(self) -> str:
        s = self.summary()
        lines = [f"divergence over {s['steps']} steps: "
                 f"final loss {s['final_loss_approx']:.4f} vs "
                 f"{s['final_loss_exact']:.4f} exact "
                 f"(delta {s['final_loss_delta_pct']:.3f}%)"]
        if "min_grad_cosine" in s:
            lines.append(f"  min grad cosine {s['min_grad_cosine']:.5f}")
        if "max_param_drift" in s:
            lines.append(f"  max param drift {s['max_param_drift']:.3e}")
        stl = s["steps_to_loss"]
        lines.append(f"  steps to loss <= {s['loss_target']:.3f}: "
                     f"exact {stl['exact']}, approx {stl['approx']}")
        if not math.isfinite(s["final_loss_delta_pct"]):
            lines.append("  !!! non-finite divergence")
        return "\n".join(lines)
