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
(``default_block``) and an explicit ``block=`` wins over it; the reference's
measure-and-cache block autotune loop is not ported yet. An op whose kernel
is compiled for one tile registers none and takes no ``block=``.
:func:`register_op` is the hook new ops plug into. The built-in ops (``elemwise``, ``attention``) are registered by
:mod:`repro_torch.kernels.ops` on first use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = [
    "BACKENDS",
    "OpImpl",
    "BoundOp",
    "register_op",
    "get_op",
    "resolve_backend",
    "shape_bucket",
    "launch_counts",
    "reset_launch_counts",
]

#: backends accepted by :func:`get_op`; 'auto' resolves per call
BACKENDS = ("auto", "ref", "cuda")


@dataclass(frozen=True)
class OpImpl:
    """One registered op: a plain version plus an optional CUDA kernel.

    ``ref(*tensors, spec=..., **kw)`` is the plain PyTorch entry;
    ``cuda(*tensors, spec=..., **kw)`` launches the kernel and is also
    handed ``block=`` when the op registered a ``default_block``.
    ``kernel`` is the wrapper that carries the ``launches`` count.
    """
    name: str
    ref: Callable[..., Any]
    cuda: Callable[..., Any] | None = None
    default_block: tuple | None = None
    kernel: Callable[..., Any] | None = None


_REGISTRY: dict[str, OpImpl] = {}


def register_op(name: str, *, ref: Callable, cuda: Callable | None = None,
                default_block: tuple | None = None,
                kernel: Callable | None = None) -> OpImpl:
    """Register a new op under ``name``."""
    if name in _REGISTRY:
        raise ValueError(f"op {name!r} already registered")
    entry = OpImpl(name=name, ref=ref, cuda=cuda,
                   default_block=default_block, kernel=kernel)
    _REGISTRY[name] = entry
    return entry


def _ensure_builtin_ops() -> None:
    from . import ops  # noqa: F401  (registers the built-in ops on import)


def resolve_backend(backend: str, *tensors: torch.Tensor) -> str:
    """Collapse 'auto' onto 'cuda' or 'ref' by where ``tensors`` lie."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    return "cuda" if any(t.is_cuda for t in tensors) else "ref"


def shape_bucket(shape: tuple) -> tuple:
    """Pow-2 bucket of a shape (the reference's reporting bucket)."""
    return tuple(1 << max(int(d) - 1, 0).bit_length() for d in shape)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last reset (wrapper counters)."""
    _ensure_builtin_ops()
    return {name: e.kernel.launches for name, e in sorted(_REGISTRY.items())
            if e.kernel is not None}


def reset_launch_counts() -> None:
    _ensure_builtin_ops()
    for e in _REGISTRY.values():
        if e.kernel is not None:
            e.kernel.launches = 0


@dataclass(frozen=True)
class BoundOp:
    """An op bound to (spec, backend, launch shape) — callable."""
    entry: OpImpl
    spec: Any
    backend: str            # 'auto' | 'ref' | 'cuda'
    block: tuple | None     # None => the op's registered default, if any

    def __call__(self, *tensors, **kw):
        backend = resolve_backend(self.backend, *tensors)
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
        block = self.block if self.block is not None \
            else self.entry.default_block
        return self.entry.cuda(*tensors, spec=self.spec, block=block, **kw)


def get_op(op: str, spec, backend: str = "auto", *,
           block: tuple | None = None) -> BoundOp:
    """Resolve ``op`` to a callable bound to ``spec``/``backend``/``block``.

    The returned :class:`BoundOp` takes the op's tensors plus per-call
    keywords (``op=``, ``mode=``, ``frac_out=``, ...).
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
    return BoundOp(entry=entry, spec=spec, backend=backend, block=block)
