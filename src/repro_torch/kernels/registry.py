"""Kernel registry — the single dispatch entry for every SIMDive op.

Counterpart of ``repro.kernels.registry``. ``get_op(op, spec, backend)``
resolves an op to a callable bound to its spec and backend:

  * ``'ref'``  — the op's plain PyTorch version, on whatever device the
    tensors lie (the oracle; on the CPU the only choice);
  * ``'cuda'`` — the hand-written CUDA kernel; raises on a CPU tensor, and
    for a CUDA tensor launches the kernel or raises — there is no
    fallback to the plain version when a build or a launch fails;
  * ``'auto'`` — resolved per call by where the tensors lie: CUDA tensors
    go to ``'cuda'``, CPU tensors to ``'ref'``.

An op whose kernel takes a launch shape registers its default
(``default_block``) and may register ``block_candidates``; an explicit
``block=`` wins over both. Otherwise the block is chosen per (op, width,
shape buckets, backend, kwargs signature) by the reference's
measure-and-cache autotune (:func:`_pick_block`): every candidate is timed
once with CUDA events (:func:`repro_torch.metrics.timing.time_callable`)
and the fastest is cached. Timing happens only on the ``cuda`` backend and
never while a CUDA graph is being captured: a capture that meets a shape
whose block is still to be timed raises, so a graph never holds a block
the eager call would not have picked (run the call once eagerly first, as
the captured decode step of :mod:`repro_torch.launch.serve` does).
``SIMDIVE_AUTOTUNE=0`` (or ``off``) caches the registered default untimed,
as in the reference. :func:`export_autotune_cache` /
:func:`preload_autotune_cache` round-trip the cache through JSON
(``chip_smoke.py`` pins a schedule that way); they and
:func:`clear_autotune_cache` advance :func:`autotune_generation`, and a
graph captured under an older generation is not replayed. An op
registered without a default block takes no ``block=``.
:func:`register_op` is the hook new ops plug into. The built-in ops
(``elemwise``, ``packed``, ``attention``, ``decode_attention``,
``matmul_int``, ``matmul_emul``) are registered by
:mod:`repro_torch.kernels.ops` on first use; ``packed`` takes
``block=(threads,)`` and registers no candidates; ``decode_attention``
takes no ``block=`` (its wrapper plans its cluster size from the shape and
the card, ``cluster=`` pins it); ``attention`` takes
``block=(q_chunk, kv_chunk[, depth])`` and, like the matmul ops, autotunes
between its depth-0 and ``cp.async``-ring schedules.

Launch counts are kept by the kernel wrappers, one count per schedule;
:func:`launch_counts` reports them under the names each op registered them
with (``elemwise``; ``packed``; ``attention`` and ``attention_pipelined``;
``decode_attention``; ``matmul`` and ``matmul_pipelined``, shared by both
matmul ops). A launch captured into a CUDA graph is not a launch: whoever
captures takes the captured launches back out of the counts
(:func:`launches_between`, :func:`add_launches` with ``times=-1``) and adds
them once per replay.

Guarded dispatch (``get_op(..., guard=True)``, the reference's): every
output is checked against its op's invariant — finite floats; attention
rows under 4x max |v|; elemwise results inside their lane range, no
saturated quotient over a nonzero denominator and no quotient under the
floor at ``frac_out >= 4``; matmul accumulators under K (2^w - 1)^2 — and
a violation raises :class:`GuardTripped`. The check reads the output back
to the host. A call made while a CUDA graph is being captured passes
unchecked, as a traced call passes in the reference: it has no values
yet, and its replays are never checked, so guarded serving on the card
checks each graph's eager warm run and relies on the scheduler's
watchdog after that. ``decode_attention``, which exists only in the
port, takes the attention rule with v the cache rows the call reads plus
the new token.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

__all__ = [
    "BACKENDS",
    "GuardTripped",
    "OpImpl",
    "BoundOp",
    "register_op",
    "get_op",
    "resolve_backend",
    "shape_bucket",
    "launch_counts",
    "reset_launch_counts",
    "launches_between",
    "add_launches",
    "all_ops",
    "op_default_block",
    "dry_dispatch",
    "autotune_cache",
    "autotune_generation",
    "clear_autotune_cache",
    "export_autotune_cache",
    "preload_autotune_cache",
]

#: backends accepted by :func:`get_op`; 'auto' resolves per call
BACKENDS = ("auto", "ref", "cuda")


class GuardTripped(RuntimeError):
    """An output guard rejected a kernel result — loud and structured.

    Raised by guarded dispatch (``get_op(..., guard=True)``) when an op's
    output violates its invariant (see :func:`_guard_check`). Carries the
    dispatch identity, so the serving watchdog can attribute and retry;
    the fields and the message are the reference's."""

    def __init__(self, *, op: str, backend: str, width: int, reason: str,
                 bad: int, total: int):
        self.op = op
        self.backend = backend
        self.width = width
        self.reason = reason
        self.bad = int(bad)
        self.total = int(total)
        super().__init__(
            f"output guard tripped on op {op!r} (backend {backend}, "
            f"width {width}): {reason} [{self.bad}/{self.total} elements]")


@dataclass(frozen=True)
class OpImpl:
    """One registered op: a plain version plus an optional CUDA kernel.

    ``ref(*tensors, spec=..., **kw)`` is the plain PyTorch entry;
    ``cuda(*tensors, spec=..., **kw)`` launches the kernel and is also
    handed ``block=`` when the op registered a ``default_block``.
    ``kernels`` maps a count's name to the wrapper that carries its
    ``launches`` count (one per schedule). ``analysis`` is the static
    analyzer's metadata hook (:mod:`repro_torch.analysis.widthcheck`):
    ``analysis(width)`` returns the op's trace cases at that width, a
    declared skip reason (a string), or None for a width outside the op.
    """
    name: str
    ref: Callable[..., Any]
    cuda: Callable[..., Any] | None = None
    default_block: tuple | None = None
    block_candidates: tuple = ()
    kernels: dict = field(default_factory=dict)
    analysis: Callable | None = None


_REGISTRY: dict[str, OpImpl] = {}
_AUTOTUNE_CACHE: dict[tuple, tuple] = {}
_AUTOTUNE_GENERATION = 0


def register_op(name: str, *, ref: Callable, cuda: Callable | None = None,
                default_block: tuple | None = None,
                block_candidates: tuple = (),
                kernels: dict | None = None,
                analysis: Callable | None = None) -> OpImpl:
    """Register a new op under ``name``; ``analysis`` is the widthcheck
    metadata hook (see :class:`OpImpl`)."""
    if name in _REGISTRY:
        raise ValueError(f"op {name!r} already registered")
    if block_candidates and default_block is None:
        raise ValueError(f"op {name!r}: block candidates need a default_block")
    entry = OpImpl(name=name, ref=ref, cuda=cuda,
                   default_block=default_block,
                   block_candidates=tuple(tuple(b) for b in block_candidates),
                   kernels=dict(kernels or {}), analysis=analysis)
    _REGISTRY[name] = entry
    return entry


def _ensure_builtin_ops() -> None:
    from . import ops  # noqa: F401  (registers the built-in ops on import)


def all_ops() -> tuple[OpImpl, ...]:
    """Every registered :class:`OpImpl`, name-sorted (the reference's
    enumeration of the registry)."""
    _ensure_builtin_ops()
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def op_default_block(name: str) -> tuple | None:
    """The registered default block of op ``name`` (None for an op that
    takes no ``block=``, or an unknown op); autotuned winners override it
    at dispatch time, per shape bucket."""
    _ensure_builtin_ops()
    entry = _REGISTRY.get(name)
    return None if entry is None else entry.default_block


# the dry run's handler (launch/dryrun.py): while one is installed, tensors
# on the ``meta`` device stand for the card's and every call that would
# reach a CUDA kernel goes to the handler instead, which checks the
# kernel's shape contract and counts its launch, operations and bytes
_DRY: list = []


class dry_dispatch:
    """Within the block, ``meta`` tensors resolve ``auto`` to ``'cuda'``
    and every call bound to ``'cuda'`` returns ``handler(entry, spec,
    block, tensors, kw)`` (the output's shape and dtype, nothing
    launched), as the dry run traces a step on the card."""

    def __init__(self, handler):
        self.handler = handler

    def __enter__(self):
        _DRY.append(self.handler)
        return self

    def __exit__(self, *exc):
        _DRY.remove(self.handler)


def resolve_backend(backend: str, *tensors: torch.Tensor) -> str:
    """Collapse 'auto' onto 'cuda' or 'ref' by where ``tensors`` lie (under
    :class:`dry_dispatch`, ``meta`` tensors stand for the card's)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    if _DRY and any(t.is_meta for t in tensors):
        return "cuda"
    return "cuda" if any(t.is_cuda for t in tensors) else "ref"


def shape_bucket(shape: tuple) -> tuple:
    """Pow-2 bucket of a shape: one autotune entry serves nearby shapes."""
    return tuple(1 << max(int(d) - 1, 0).bit_length() for d in shape)


def _kernels() -> dict:
    _ensure_builtin_ops()
    out = {}
    for e in _REGISTRY.values():
        out.update(e.kernels)
    return out


def launch_counts() -> dict[str, int]:
    """Kernel launches per count name since the last reset."""
    return {name: k.launches for name, k in sorted(_kernels().items())}


def reset_launch_counts() -> None:
    for k in _kernels().values():
        k.launches = 0


def launches_between(before: dict, after: dict) -> dict[str, int]:
    """Launches per count name from one :func:`launch_counts` snapshot to
    a later one; names that did not move are left out."""
    return {name: n - before.get(name, 0) for name, n in after.items()
            if n != before.get(name, 0)}


def add_launches(launches: dict, times: int = 1) -> None:
    """Add ``times`` x ``launches`` (a :func:`launches_between` result) to
    the counts: once per replay of a CUDA graph that holds them, and
    ``times=-1`` to take back what a capture counted."""
    kernels = _kernels()
    for name, n in launches.items():
        kernels[name].launches += n * times


# ------------------------------------------------------------- autotune --
def autotune_cache() -> dict:
    """The live (op, width, shape-buckets, backend, kwargs-sig) -> block
    cache."""
    return _AUTOTUNE_CACHE


def autotune_generation() -> int:
    """How many times :func:`clear_autotune_cache` and
    :func:`preload_autotune_cache` have changed the cache's blocks. A block
    first timed for a new shape adds an entry and leaves it as it is: no
    entry a graph was captured with changes then."""
    return _AUTOTUNE_GENERATION


def _advance_generation() -> None:
    global _AUTOTUNE_GENERATION
    _AUTOTUNE_GENERATION += 1


def clear_autotune_cache() -> None:
    _AUTOTUNE_CACHE.clear()
    _advance_generation()


def _kwargs_sig(kw: dict) -> tuple:
    """Stable, hashable, JSON-round-trippable signature of the per-call
    kwargs that can steer tuning (``op=``, ``frac_out=``, ``k_chunk=``...);
    tensor-valued kwargs contribute their pow-2 shape bucket."""
    sig = []
    for k in sorted(kw):
        v = kw[k]
        if isinstance(v, (bool, int, float, str, type(None))):
            sig.append((k, v))
        elif hasattr(v, "shape"):
            sig.append((k, "array", tuple(shape_bucket(v.shape))))
        else:
            sig.append((k, repr(v)))
    return tuple(sig)


def export_autotune_cache() -> list:
    """The live cache as JSON-ready records ``[{"key": [...], "block":
    [...]}, ...]``; :func:`preload_autotune_cache` re-tuples them, so
    export -> json -> preload round-trips exactly."""
    def jsonable(x):
        if isinstance(x, tuple):
            return [jsonable(i) for i in x]
        return x

    return [{"key": jsonable(k), "block": list(v)}
            for k, v in sorted(_AUTOTUNE_CACHE.items(),
                               key=lambda kv: repr(kv[0]))]


def preload_autotune_cache(records: list) -> int:
    """Seed the cache from :func:`export_autotune_cache` output. Returns
    how many entries were loaded; malformed records, records of
    unregistered ops and blocks outside the op's current candidates (plus
    its default) are skipped. Advances :func:`autotune_generation`."""
    def tupleize(x):
        if isinstance(x, list):
            return tuple(tupleize(i) for i in x)
        return x

    _ensure_builtin_ops()
    _advance_generation()
    loaded = 0
    for rec in records or []:
        try:
            key = tupleize(rec["key"])
            block = tuple(int(d) for d in rec["block"])
        except (KeyError, TypeError, ValueError):
            continue
        entry = _REGISTRY.get(key[0]) if isinstance(key, tuple) and key \
            else None
        if entry is None:
            continue
        allowed = set(entry.block_candidates)
        if entry.default_block is not None:
            allowed.add(entry.default_block)
        if block not in allowed:
            continue
        _AUTOTUNE_CACHE[key] = block
        loaded += 1
    return loaded


def _autotune_mode() -> str:
    """'off' (``SIMDIVE_AUTOTUNE`` = 0 / off / empty) or 'on'. The
    reference's 'force' (time under its interpreter) means 'on' here: the
    port times only real kernel launches."""
    v = os.environ.get("SIMDIVE_AUTOTUNE", "1")
    return "off" if v in ("0", "off", "") else "on"


def _capturing() -> bool:
    """Whether a CUDA graph is being captured on the current stream."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _pick_block(entry: OpImpl, spec, backend: str, tensors, kw) -> tuple:
    """Cached per-(op, width, shape-buckets, backend, kwargs-sig) block
    choice, measured once: each candidate's call timed by CUDA events, the
    fastest kept. Nothing is timed or cached while a CUDA graph is being
    captured (the counterpart of the reference's tracer check): there a
    block that would still have to be timed raises, since the default the
    capture could serve instead may not be the block the eager call picks."""
    key = (entry.name, spec.width,
           tuple(shape_bucket(t.shape) for t in tensors), backend,
           _kwargs_sig(kw))
    cached = _AUTOTUNE_CACHE.get(key)
    if cached is not None:
        return cached
    candidates = entry.block_candidates or (entry.default_block,)
    capturing = _capturing()
    if len(candidates) < 2 or _autotune_mode() == "off":
        if not capturing:
            _AUTOTUNE_CACHE[key] = entry.default_block
        return entry.default_block
    if capturing:
        raise RuntimeError(
            f"op {entry.name!r}: no block is settled for {key} and a CUDA "
            "graph is being captured, where nothing is timed; call it once "
            "eagerly at these shapes before the capture")
    from repro_torch.metrics.timing import time_callable

    best, best_s = None, None
    for cand in candidates:
        t = time_callable(entry.cuda, *tensors, spec=spec, block=cand,
                          iters=2, warmup=1, **kw)
        if best_s is None or t.best_s < best_s:
            best, best_s = cand, t.best_s
    _AUTOTUNE_CACHE[key] = best
    return best


# ---------------------------------------------------------- output guard --
def _int_values(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(``t`` as int64 values, its dtype's largest value as such a value):
    ``uint32`` lanes through their int32 bit pattern, the one view every
    device has; ``uint64`` lanes as their own bits, so a value of 2^63 or
    more reads below zero and the all-ones word reads -1."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, 0xFFFFFFFF
    # simdive-lint: allow(unguarded-uint64): the guard reads uint64 lanes through their int64 bits, as from_lanes does
    if t.dtype == torch.uint64:
        return t.view(torch.int64), -1
    return t.to(torch.int64), int(torch.iinfo(t.dtype).max)


def _at_most(o: torch.Tensor, lim: int) -> torch.Tensor:
    """Unsigned ``o <= lim`` on values from :func:`_int_values`: a value
    below zero is a 64-bit lane of 2^63 or more."""
    if lim >= (1 << 63):
        return (o >= 0) | (o <= lim - (1 << 64))
    return (o >= 0) & (o <= lim)


def _attention_vmax(name: str, tensors, kw) -> float:
    """max |v| over what the attention call reads: ``attention``'s whole v;
    ``decode_attention``'s valid cache rows and its new token."""
    if name == "attention":
        return float(tensors[2].abs().max())
    from .decode_attention import history_valid

    q, _, v_cache, _, v_new = tensors
    Smax = v_cache.shape[1]
    valid = history_valid(Smax, kw["pos"], kw["slot"],
                          ring_full=kw.get("ring_full", False),
                          window=kw.get("window", 0), device=q.device)
    valid = valid.reshape(-1, Smax)[:, :, None, None]
    rows = v_cache.abs().masked_fill(~valid, 0)
    return max(float(rows.max()), float(v_new.abs().max()))


def _guard_check(name: str, spec, backend: str, tensors, kw, out) -> None:
    """Check one op output, the reference's rules, counts and reasons:
    finite floats, integers inside the lane-derived range. The bounds are
    loose by design — legitimate approximation error never approaches
    them; only an upset datapath (or a real kernel bug) does. A call made
    while a CUDA graph is being captured passes unchecked: its output has
    no values yet."""
    if _capturing():
        return
    total = out.numel()
    w = int(spec.width)
    frac = int(kw.get("frac_out", 0) or 0)

    def trip(reason, bad):
        raise GuardTripped(op=name, backend=backend, width=w,
                           reason=reason, bad=bad, total=total)

    def count(mask) -> int:
        return int(mask.sum().item())

    if out.is_floating_point():
        nbad = total - count(torch.isfinite(out))
        if nbad:
            trip("non-finite output", nbad)
    if name in ("attention", "decode_attention"):
        # softmax-weighted rows are near-convex combinations of v; even
        # with Mitchell's worst-case divider error they stay well under a
        # few times max |v| — far under what a saturated quotient does
        lim = 4.0 * max(_attention_vmax(name, tensors, kw), 1e-30)
        nbad = count(out.abs().to(torch.float32) > lim)
        if nbad:
            trip(f"|output| exceeds {lim:.3g} (4x max |v|)", nbad)
    elif name == "elemwise":
        kind = kw.get("op", "mul")
        o, sat = _int_values(out)        # sat: the divider's x/0 word
        mul_lim = (1 << (2 * w)) - 1
        div_lim = 1 << (w + frac)
        if kind == "mul":
            ok = _at_most(o, mul_lim)
        elif kind == "div":
            ok = _at_most(o, div_lim) | (o == sat)
        else:                            # mixed: either bound + saturation
            ok = _at_most(o, max(mul_lim, div_lim)) | (o == sat)
        nbad = total - count(ok)
        if nbad:
            trip(f"{kind} result outside the width-{w} lane range", nbad)
        if kind in ("div", "mixed"):
            # the datapath saturates to all-ones only on a zero
            # denominator; a saturated quotient anywhere else is the
            # signature of an upset correction table or log stage
            den = _int_values(tensors[1])[0]
            nbad = count((o == sat) & (den != 0))
            if nbad:
                trip("saturated quotient with nonzero denominator", nbad)
            if kind == "div" and frac >= 4:
                # a >= b > 0: the quotient is >= ~0.97 * 2^frac on every
                # shipped config; 2^(frac-2) keeps a 4x margin, and an
                # upset correction term collapses exactly these quotients
                floor = 1 << (frac - 2)
                num = _int_values(tensors[0])[0]
                nbad = count((num >= den) & (den != 0)
                             & _at_most(o, floor - 1))
                if nbad:
                    trip(f"quotient below 2^{frac - 2} with ratio >= 1",
                         nbad)
    elif name in ("matmul_int", "matmul_emul"):
        K = int(tensors[0].shape[-1])
        lim = K * ((1 << w) - 1) ** 2
        if lim < (1 << 63) - 1:
            nbad = count(out.to(torch.int64).abs() > lim)
            if nbad:
                trip(f"|accumulator| exceeds K * (2^{w}-1)^2", nbad)
    elif name == "sqrt":
        lim = 1 << ((w + 1) // 2 + frac + 1)
        nbad = total - count(_at_most(_int_values(out)[0], lim))
        if nbad:
            trip(f"sqrt result exceeds 2^{(w + 1) // 2 + frac + 1}", nbad)
    # 'packed': output words span the full uint32 range — the range check
    # is vacuous, as in the reference


@dataclass(frozen=True)
class BoundOp:
    """An op bound to (spec, backend, launch shape) — callable."""
    entry: OpImpl
    spec: Any
    backend: str            # 'auto' | 'ref' | 'cuda'
    block: tuple | None     # None => autotuned / the registered default
    guard: bool = False     # check every output (GuardTripped)

    def __call__(self, *tensors, **kw):
        backend = resolve_backend(self.backend, *tensors)
        if _DRY and backend == "cuda":
            return _DRY[-1](self.entry, self.spec, self.block, tensors, kw)
        out = self._run(backend, tensors, kw)
        if self.guard:
            _guard_check(self.entry.name, self.spec, backend, tensors, kw,
                         out)
        return out

    def _run(self, backend: str, tensors, kw):
        if backend == "ref":
            return self.entry.ref(*tensors, spec=self.spec, **kw)
        for t in tensors:
            if not t.is_cuda:
                raise ValueError(
                    f"op {self.entry.name!r}: backend 'cuda' was given a "
                    f"tensor on {t.device}; move it to the card or ask for "
                    "backend 'ref'")
        if self.entry.cuda is None:
            raise ValueError(
                f"op {self.entry.name!r} has no CUDA kernel and was given "
                "tensors on the card; ask for backend 'ref' explicitly")
        if self.entry.default_block is None:
            return self.entry.cuda(*tensors, spec=self.spec, **kw)
        block = self.block
        if block is None:
            block = _pick_block(self.entry, self.spec, backend, tensors, kw)
        return self.entry.cuda(*tensors, spec=self.spec, block=block, **kw)


def get_op(op: str, spec, backend: str = "auto", *,
           block: tuple | None = None, guard: bool = False) -> BoundOp:
    """Resolve ``op`` to a callable bound to ``spec``/``backend``/``block``.

    The returned :class:`BoundOp` takes the op's tensors plus per-call
    keywords (``op=``, ``mode=``, ``frac_out=``, ``k_chunk=``, ...).
    ``guard=True`` checks every output and raises :class:`GuardTripped` on
    a violation; a call under CUDA-graph capture passes unchecked.
    """
    _ensure_builtin_ops()
    entry = _REGISTRY.get(op)
    if entry is None:
        raise KeyError(f"unknown op {op!r}; registered: {sorted(_REGISTRY)}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and entry.cuda is None:
        raise ValueError(f"op {op!r} has no CUDA kernel")
    if block is not None and entry.default_block is None:
        raise ValueError(f"op {op!r} takes no block=: its kernel is compiled "
                         "for one tile")
    return BoundOp(entry=entry, spec=spec, backend=backend,
                   block=None if block is None else tuple(block),
                   guard=guard)
