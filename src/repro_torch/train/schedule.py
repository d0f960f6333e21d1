"""Precision schedules: which approximation rung serves which train step.

Runtime-reconfigurable precision (arxiv 2310.10053) applied to training:
a :class:`PrecisionSchedule` is an ordered list of **rungs** — ``(start
step, policy)`` pairs — that switches the arithmetic the forward (and,
with ``backward='approx'``, the backward) matmuls dispatch at step
boundaries. The canonical shape is *exact warmup → approximate
steady-state* (:func:`warmup_schedule`); :func:`ramp_schedule` staggers
layers in one rung at a time, least-sensitive first, from a
``sensitivity.greedy_assign`` per-layer assignment.

Everything is a pure function of the step number: ``rung_at(step)`` on a
resumed run returns exactly the rung the killed run was on, so
checkpoint/resume under a schedule replays the policy sequence the same
way the data pipeline replays the batch sequence — the loss curve stays
bitwise continuous.

Counterpart of ``repro.train.schedule``. Serialization mirrors
:class:`repro_torch.tuning.TuningPolicy` (JSON schema
``simdive-schedule/v1``): each rung embeds a full ``simdive-policy/v1``
document or ``null`` for exact arithmetic, so a schedule file is
self-contained, and a file either package writes loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace

from repro_torch.core.approx import ApproxConfig
from repro_torch.tuning.select import TuningPolicy, PolicyEntry  # noqa: F401
from repro_torch.tuning.sensitivity import assignment_policy

__all__ = [
    "SCHEDULE_SCHEMA",
    "ScheduleRung",
    "PrecisionSchedule",
    "warmup_schedule",
    "ramp_schedule",
]

SCHEDULE_SCHEMA = "simdive-schedule/v1"


@dataclass(frozen=True)
class ScheduleRung:
    """One precision rung: from ``start_step`` (inclusive) until the next
    rung's start, dispatch runs under ``policy`` (``None`` = exact
    arithmetic). Hashable — the training loop keys its step cache on the
    resolved :class:`ApproxConfig`, which embeds the policy."""
    start_step: int
    policy: TuningPolicy | None = None
    label: str = ""

    def as_dict(self) -> dict:
        return {"start_step": self.start_step,
                "policy": None if self.policy is None
                else self.policy.as_dict(),
                "label": self.label}

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleRung":
        pol = d.get("policy")
        return cls(start_step=int(d["start_step"]),
                   policy=None if pol is None
                   else TuningPolicy.from_dict(pol),
                   label=str(d.get("label", "")))


@dataclass(frozen=True)
class PrecisionSchedule:
    """An ordered tuple of :class:`ScheduleRung`, covering every step.

    Rungs must start at step 0 and be strictly increasing — every step
    has exactly one rung, deterministically, which is what makes resume
    replay the same precision sequence. ``meta`` is free-form provenance
    (budget, source profile), sorted pairs like a policy's.
    """
    rungs: tuple = ()
    meta: tuple = ()

    def __post_init__(self):
        if not self.rungs:
            raise ValueError("a PrecisionSchedule needs at least one rung")
        starts = [r.start_step for r in self.rungs]
        if starts[0] != 0:
            raise ValueError(
                f"the first rung must start at step 0 (got {starts[0]}): "
                "every step needs a rung for resume to be deterministic")
        if any(b <= a for a, b in zip(starts, starts[1:])):
            raise ValueError(
                f"rung start steps must be strictly increasing, got "
                f"{starts}")

    # --------------------------------------------------------- resolution
    def rung_at(self, step: int) -> ScheduleRung:
        """The rung serving ``step`` — a pure function of the step, so a
        resumed run lands on the same rung the killed run was on."""
        cur = self.rungs[0]
        for r in self.rungs[1:]:
            if r.start_step > step:
                break
            cur = r
        return cur

    def policy_at(self, step: int) -> TuningPolicy | None:
        return self.rung_at(step).policy

    def config_at(self, step: int, base: ApproxConfig) -> ApproxConfig:
        """The :class:`ApproxConfig` serving ``step``: ``base`` with this
        step's rung policy, or ``base`` forced exact on a ``None`` rung.

        ``base`` carries everything the schedule does not decide —
        backward mode, k_chunk, guard, which call sites approximate. A
        disabled ``base`` (mode 'exact') is promoted to 'simdive' on
        policy rungs, so callers can hand the schedule a plain default
        config.
        """
        rung = self.rung_at(step)
        if rung.policy is None:
            return replace(base, mode="exact", policy=None)
        mode = base.mode if base.enabled else "simdive"
        return replace(base, mode=mode, policy=rung.policy)

    def boundaries(self) -> tuple:
        """Rung start steps — each one builds the train step anew (a new
        ApproxConfig; the reference recompiles its jitted step there)."""
        return tuple(r.start_step for r in self.rungs)

    def meta_dict(self) -> dict:
        return dict(self.meta)

    # ------------------------------------------------------ serialization
    def as_dict(self) -> dict:
        return {
            "schema": SCHEDULE_SCHEMA,
            "meta": {k: v for k, v in self.meta},
            "rungs": [r.as_dict() for r in self.rungs],
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionSchedule":
        if not isinstance(d, dict) or d.get("schema") != SCHEDULE_SCHEMA:
            raise ValueError(
                f"not a precision schedule (expected schema "
                f"{SCHEDULE_SCHEMA!r}, got "
                f"{d.get('schema') if isinstance(d, dict) else type(d)})")
        unknown = sorted(set(d) - {"schema", "meta", "rungs"})
        if unknown:
            import warnings
            warnings.warn(
                f"precision schedule has unknown top-level field(s) "
                f"{unknown}; this {SCHEDULE_SCHEMA} reader ignores them "
                "and they will not survive a re-save", stacklevel=2)
        rungs = tuple(ScheduleRung.from_dict(r) for r in d.get("rungs", []))
        meta = tuple(sorted((d.get("meta") or {}).items()))
        return cls(rungs=rungs, meta=meta)

    @classmethod
    def from_json(cls, s: str) -> "PrecisionSchedule":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "PrecisionSchedule":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def render(self) -> str:
        head = ", ".join(f"{k}={v}" for k, v in self.meta) or "no meta"
        lines = [f"PrecisionSchedule ({head})"]
        for r in self.rungs:
            what = "exact" if r.policy is None else \
                f"{len(r.policy.entries)} policy entr" \
                f"{'y' if len(r.policy.entries) == 1 else 'ies'}"
            tag = f" [{r.label}]" if r.label else ""
            lines.append(f"  step >= {r.start_step}: {what}{tag}")
        return "\n".join(lines)


# -------------------------------------------------------------- builders --
def warmup_schedule(policy: TuningPolicy, *, warmup_steps: int,
                    meta: dict | None = None) -> PrecisionSchedule:
    """Exact warmup -> approximate steady-state: the canonical two-rung
    schedule. ``warmup_steps == 0`` collapses to a single policy rung."""
    if warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")
    m = {"warmup_steps": warmup_steps, **(meta or {})}
    if warmup_steps == 0:
        rungs = (ScheduleRung(0, policy, "steady"),)
    else:
        rungs = (ScheduleRung(0, None, "warmup"),
                 ScheduleRung(warmup_steps, policy, "steady"))
    return PrecisionSchedule(rungs=rungs, meta=tuple(sorted(m.items())))


def ramp_schedule(assignment: dict, *, op: str = "matmul",
                  start_step: int = 0, every: int = 1,
                  order=None, meta: dict | None = None
                  ) -> PrecisionSchedule:
    """Stagger a per-layer assignment in, one layer per rung.

    ``assignment`` maps layer label -> :class:`PolicyEntry` (a
    ``sensitivity.greedy_assign`` result); ``order`` is the entry order
    (default: sorted labels — pass the profile's least-sensitive-first
    order to flip the most tolerant layers early). Rung *i* (at
    ``start_step + i*every``) approximates the first ``i+1`` layers of
    ``order``; the policies are built with ``policy_only`` consumers in
    mind — layers not yet entered carry no entry, so a ``policy_only``
    config runs them exact.
    """
    if not assignment:
        raise ValueError("ramp_schedule needs a non-empty assignment")
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    order = list(order) if order is not None else sorted(assignment)
    if sorted(order) != sorted(assignment):
        raise ValueError(
            f"order {sorted(order)} must be a permutation of the "
            f"assignment's layers {sorted(assignment)}")
    rungs = []
    if start_step > 0:
        rungs.append(ScheduleRung(0, None, "warmup"))
    for i, layer in enumerate(order):
        pol = assignment_policy(
            {l: assignment[l] for l in order[:i + 1]}, op=op,
            meta={"ramp_rung": i})
        rungs.append(ScheduleRung(start_step + i * every, pol,
                                  f"+{layer}"))
    m = {"layers": len(order), "every": every, **(meta or {})}
    return PrecisionSchedule(rungs=tuple(rungs),
                             meta=tuple(sorted(m.items())))
