"""Budget -> config: the selection layer of the accuracy autotuner.

Counterpart of ``repro.tuning.select``. :func:`select_config` hands back
the *cheapest* concrete registry dispatch config (a :class:`PolicyEntry` —
width, coeff_bits, index_bits, backend) whose measured accuracy meets an
error budget, ranked by a BENCH trajectory's measured wall-clock where
available and by static cost (fewer correction bits, narrower lane) where
not. An infeasible budget raises :class:`BudgetError` naming the nearest
achievable stat, so a caller learns *how far off* the ask was.

A chosen configuration ships with a deployment as a :class:`TuningPolicy`
— a serializable set of per-(op, layer) entries (JSON schema
``simdive-policy/v1``) that ``ApproxConfig(policy=...)`` resolves at
dispatch time (see :mod:`repro_torch.core.approx`) and
``python -m repro_torch.launch.serve --policy PATH`` serves.

**One file, both packages.** A policy file keeps the reference's backend
names, so a policy written by either package loads and dispatches in the
other, and ``to_json`` of the same entries is byte-equal. The port reads
them through :data:`BACKEND_NAMES`: ``auto`` -> ``auto``, ``ref`` ->
``ref`` (the plain versions, the oracle), and ``pallas`` / ``pallas-tpu``
/ ``pallas-interpret`` -> ``cuda`` (the hand-written kernel). Any other
name, the port's own ``cuda`` included, is refused when an entry is made
or loaded.

Port-specific defaults: :class:`PolicyEntry`, :func:`select_config` and
:func:`build_policy` default to ``backend='auto'`` (the reference:
``'ref'``), as ``ApproxConfig.backend`` does — under ``'ref'`` a policy
built on the card would serve every op through the plain versions and no
kernel would run. Selection measures on ``device`` (default the card);
``device='cpu'`` runs the plain versions and gives the same stats.
``width=None`` considers widths 8 and 16: the port refuses width 32.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, fields, replace

import torch

from .frontier import DEFAULT_COEFF_SWEEP, build_frontier

__all__ = [
    "POLICY_SCHEMA",
    "BACKEND_NAMES",
    "BudgetError",
    "PolicyEntry",
    "TuningPolicy",
    "port_backend",
    "select_config",
    "build_policy",
]

POLICY_SCHEMA = "simdive-policy/v1"

#: a policy file's backend name (the reference's registry names, the
#: interchange form) -> the port's registry backend
BACKEND_NAMES = {
    "auto": "auto",
    "ref": "ref",
    "pallas": "cuda",
    "pallas-tpu": "cuda",
    "pallas-interpret": "cuda",
}


def port_backend(name: str) -> str:
    """The port's registry backend for a policy's backend ``name``."""
    try:
        return BACKEND_NAMES[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"policy backend {name!r} is not a {POLICY_SCHEMA} backend name "
            f"(one of {sorted(BACKEND_NAMES)}); the hand-written kernel is "
            "written 'pallas', its interchange name, which the port serves "
            "as its 'cuda' backend") from None


class BudgetError(ValueError):
    """No config meets the requested error budget; the message carries
    the nearest achievable stat and the config that achieves it."""


@dataclass(frozen=True)
class PolicyEntry:
    """One concrete registry dispatch config, optionally layer-scoped.

    This is both what :func:`select_config` returns and what a
    :class:`TuningPolicy` is made of. ``backend`` is an interchange name
    (:data:`BACKEND_NAMES`). ``stats`` is a sorted tuple of ``(name,
    value)`` pairs documenting the evidence behind the choice (frontier
    error stats + joined timing); it rides through JSON but never affects
    dispatch. Hashable on purpose: ``ApproxConfig`` embeds policies whole,
    and the served prefill and step are memoized on it.
    """
    op: str                      # logical op: 'mul'|'div'|'matmul'|'attention'
    width: int
    coeff_bits: int
    index_bits: int = 3
    backend: str = "auto"
    kernel: str = "elemwise"
    frac_out: int | None = None  # divider output bits (None = caller's knob)
    layer: str | None = None     # None = the op's default entry
    stats: tuple = ()

    def __post_init__(self):
        port_backend(self.backend)

    def spec(self):
        """The :class:`~repro_torch.core.simdive.SimdiveSpec` this entry
        pins (default rounding — the same construction the BENCH grid
        times)."""
        from repro_torch.core.simdive import SimdiveSpec
        return SimdiveSpec(width=self.width, coeff_bits=self.coeff_bits,
                           index_bits=self.index_bits)

    def bind(self, *, backend: str | None = None, kernel: str | None = None):
        """A callable :class:`~repro_torch.kernels.registry.BoundOp` for
        this config — ``entry.bind()(a, b, op=entry.op, ...)``. ``backend``
        overrides the entry's with another interchange name."""
        from repro_torch.kernels import get_op
        return get_op(kernel or self.kernel, self.spec(),
                      port_backend(backend or self.backend))

    def stats_dict(self) -> dict:
        return dict(self.stats)

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["stats"] = {k: v for k, v in self.stats}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyEntry":
        known = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["stats"] = tuple(sorted((d.get("stats") or {}).items()))
        kw["width"] = int(kw["width"])
        kw["coeff_bits"] = int(kw["coeff_bits"])
        if "index_bits" in kw:
            kw["index_bits"] = int(kw["index_bits"])
        return cls(**kw)

    def label(self) -> str:
        scope = f"[{self.layer}]" if self.layer else ""
        return (f"{self.op}{scope}: {self.kernel}/{self.width}b/"
                f"cb{self.coeff_bits}/ib{self.index_bits}/{self.backend}")


@dataclass(frozen=True)
class TuningPolicy:
    """A deployable set of per-(op, layer) dispatch configs.

    ``lookup(op, layer)`` resolves layer-scoped entries first, then the
    op's default (``layer=None``) entry, then ``None`` — the caller's own
    config remains the fallback (see ``ApproxConfig.resolve``). ``meta``
    is free-form provenance (budget, metric, source BENCH run), sorted
    pairs so the policy stays hashable and JSON round-trips exactly.
    """
    entries: tuple = ()
    meta: tuple = ()

    def lookup(self, op: str, layer: str | None = None):
        if layer is not None:
            for e in self.entries:
                if e.op == op and e.layer == layer:
                    return e
        for e in self.entries:
            if e.op == op and e.layer is None:
                return e
        return None

    def meta_dict(self) -> dict:
        return dict(self.meta)

    def distinct_configs(self) -> tuple:
        """The distinct ``(op, width, coeff_bits, index_bits, frac_out)``
        dispatch configs this policy can resolve to, sorted: the table and
        kernel-spec identities a deployment of it reads. Ordered as the
        reference orders them; an unset ``frac_out`` sorts first."""
        return tuple(sorted({
            (e.op, e.width, e.coeff_bits, e.index_bits, e.frac_out)
            for e in self.entries},
            key=lambda c: c[:4] + (-1 if c[4] is None else c[4],)))

    def with_entries(self, *entries) -> "TuningPolicy":
        return replace(self, entries=self.entries + tuple(entries))

    # ------------------------------------------------------ serialization
    def as_dict(self) -> dict:
        return {
            "schema": POLICY_SCHEMA,
            "meta": {k: v for k, v in self.meta},
            "entries": [e.as_dict() for e in self.entries],
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "TuningPolicy":
        if not isinstance(d, dict) or d.get("schema") != POLICY_SCHEMA:
            raise ValueError(
                f"not a tuning policy (expected schema {POLICY_SCHEMA!r}, "
                f"got {d.get('schema') if isinstance(d, dict) else type(d)})")
        unknown = sorted(set(d) - {"schema", "meta", "entries"})
        if unknown:
            # same-schema documents from a newer writer: loadable, but the
            # extra fields are dropped on round-trip — say so out loud
            warnings.warn(
                f"tuning policy has unknown top-level field(s) {unknown}; "
                f"this {POLICY_SCHEMA} reader ignores them and they will "
                "not survive a re-save", stacklevel=2)
        entries = tuple(PolicyEntry.from_dict(e)
                        for e in d.get("entries", []))
        meta = tuple(sorted((d.get("meta") or {}).items()))
        return cls(entries=entries, meta=meta)

    @classmethod
    def from_json(cls, s: str) -> "TuningPolicy":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "TuningPolicy":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def render(self) -> str:
        head = ", ".join(f"{k}={v}" for k, v in self.meta) or "no meta"
        return "\n".join([f"TuningPolicy ({head})"]
                         + [f"  {e.label()}" for e in self.entries])


# ------------------------------------------------------------ selection --
def _rank_key(point, prefer: str):
    """Sort key among budget-meeting points. 'fastest' ranks by measured
    us-per-item (untimed points last, then by static cost); 'cheapest'
    ranks by static cost alone (fewest correction bits, narrowest lane)."""
    static = (point.coeff_bits, point.width)
    upi = point.us_per_item
    if prefer == "cheapest":
        return (static, upi if upi is not None else float("inf"))
    if prefer == "fastest":
        return ((0, upi) if upi is not None else (1, 0.0), static)
    raise ValueError(f"prefer must be 'fastest' or 'cheapest', "
                     f"got {prefer!r}")


def select_config(op: str, *, error_budget: float, metric: str = "are_pct",
                  width: int | None = None, prefer: str = "fastest",
                  index_bits: int = 3, backend: str = "auto",
                  coeff_sweep=DEFAULT_COEFF_SWEEP, bench="auto",
                  layer: str | None = None, error_fn=None,
                  device: torch.device | str = "cuda") -> PolicyEntry:
    """The cheapest config of ``op`` meeting ``error_budget`` on ``metric``.

    ``width=None`` considers every lane width the port computes (8, 16); a
    concrete ``width`` restricts the candidate set to that lane. Among
    budget-meeting frontier points, ``prefer='fastest'`` picks the minimal
    measured wall-clock (``best_us`` joined from ``bench``; within one
    width that is exactly the minimal ``best_us``, across widths the
    per-item rate) and ``prefer='cheapest'`` the fewest correction bits.
    Deterministic given a frozen BENCH file: error stats are
    exhaustive/seeded-stratified, the join is a lookup. ``backend`` is the
    interchange name the entry carries; ``device`` is where the error
    sweeps run (default the card).

    Raises :class:`BudgetError` when nothing meets the budget, with the
    nearest achievable stat and its config in the message.
    """
    port_backend(backend)
    widths = (width,) if width is not None else _available_widths()
    points = []
    for w in widths:
        points.extend(build_frontier(op, width=w, coeff_sweep=coeff_sweep,
                                     index_bits=index_bits, backend=backend,
                                     bench=bench, error_fn=error_fn,
                                     device=device))
    scored = [(p.stat(metric), p) for p in points
              if p.stat(metric) is not None]
    if not scored:
        raise BudgetError(f"no frontier point of op {op!r} carries "
                          f"metric {metric!r}")
    feasible = [p for e, p in scored if e <= error_budget]
    if not feasible:
        nearest = min(scored, key=lambda ep: ep[0])
        raise BudgetError(
            f"no config of op {op!r} meets {metric} <= {error_budget:g}: "
            f"nearest achievable is {metric}={nearest[0]:.6g} "
            f"({nearest[1].label()}); widen the budget or the sweep "
            f"(widths={list(widths)}, coeff_sweep={list(coeff_sweep)})")
    best = min(feasible, key=lambda p: _rank_key(p, prefer))
    stats = dict(best.error)
    stats["error_source"] = best.error_source
    if best.best_us is not None:
        stats["best_us"] = best.best_us
        if best.us_per_item is not None:
            stats["us_per_item"] = best.us_per_item
    return PolicyEntry(op=op, width=best.width, coeff_bits=best.coeff_bits,
                       index_bits=best.index_bits, backend=best.backend,
                       kernel=best.kernel, layer=layer,
                       stats=tuple(sorted(stats.items())))


def _available_widths() -> tuple:
    """Widths the port computes: 8 and 16 (width 32 is refused, see
    :func:`repro_torch.core.mitchell.check_width`)."""
    return (8, 16)


def build_policy(ops=("mul", "div"), *, error_budget: float,
                 metric: str = "are_pct", width: int | None = None,
                 prefer: str = "fastest", bench="auto",
                 coeff_sweep=DEFAULT_COEFF_SWEEP,
                 meta: dict | None = None, error_fn=None,
                 backend: str = "auto",
                 device: torch.device | str = "cuda") -> TuningPolicy:
    """One :func:`select_config` per op, assembled into a policy."""
    entries = tuple(
        select_config(op, error_budget=error_budget, metric=metric,
                      width=width, prefer=prefer, bench=bench,
                      coeff_sweep=coeff_sweep, error_fn=error_fn,
                      backend=backend, device=device)
        for op in ops)
    m = {"metric": metric, "budget": error_budget, "prefer": prefer}
    if isinstance(bench, str) and bench != "auto":
        m["bench"] = bench
    m.update(meta or {})
    return TuningPolicy(entries=entries, meta=tuple(sorted(m.items())))
