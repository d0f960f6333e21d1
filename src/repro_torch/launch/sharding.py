"""Logical-axis sharding rules threaded through the model code, and the
collectives the port's sharded paths call.

Counterpart of ``repro.launch.sharding``. Models name the logical axes of
their activations and weights (``"batch"``, ``"heads"``, ``"ff"``,
``"vocab"``...); :func:`use_rules` binds those names to the axes of a mesh
(:mod:`repro_torch.launch.mesh`) for the code inside the block. With no
binding active (unit tests, one device) every helper here is a no-op, so
the same model code runs unsharded and sharded.

Default binding, the reference's:
  batch   -> ("pod", "data")   pod axis exists only on the multi-pod mesh
  heads/kv/ff/vocab/dmodel_tp/ssm_heads -> ("model",)  (tensor parallel)

Where the reference hands its global arrays to GSPMD, the port computes on
local shards: every rank holds its slice of each tensor the mesh splits,
and the sharded paths call ``torch.distributed`` collectives where GSPMD
or ``shard_map`` put them. Only ``all_reduce`` (SUM and MAX) is used on
the device, so the same code runs over NCCL and over a ``gloo`` group
(two processes on one card). A group of one rank is an identity, and
its collectives are skipped.

Autograd crosses a collective through Megatron's pair of functions:
:func:`copy_to` (identity forward, ``all_reduce`` SUM backward) where a
replicated tensor enters a model-parallel region, :func:`reduce_from`
(``all_reduce`` SUM forward, identity backward) where partial sums leave
it; :func:`scatter_to` takes a rank's slice of a replicated tensor
(backward: the slice's gradient padded with zeros, summed over the
group). ``torch.distributed.all_reduce`` itself has no gradient.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import torch

__all__ = ["P", "use_rules", "shard", "current_mesh", "active",
           "logical_spec", "logical_axis_size", "DEFAULT_RULES",
           "axis_sizes", "group", "rank_in", "all_reduce",
           "all_reduce_max", "copy_to", "reduce_from", "scatter_to",
           "collective_counts", "reset_collective_counts"]


class P(tuple):
    """A partition spec: one entry a tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim split over their
    product). Equal, entry for entry, to the reference's
    ``jax.sharding.PartitionSpec``; missing trailing entries are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),               # bind to ("model",) for sequence parallelism
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": (),           # bind to ("model",) for expert parallelism
    "dmodel_tp": ("model",),  # row-parallel weight input dims
    "ssm_heads": ("model",),
}

# One binding stack for the process, not a thread's (the reference keeps
# it thread-local): on the card the autograd engine runs the backward —
# and a rematerialized layer's forward — on its own device threads, which
# must see the rules the forward ran under.
_STACK: list = []


def _state():
    return _STACK


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh: the port's
    (:class:`repro_torch.launch.mesh.Mesh`) or any object with
    ``axis_names`` and ``shape``."""
    return dict(zip(mesh.axis_names, mesh.shape))


@contextmanager
def use_rules(mesh, overrides: dict | None = None):
    """Bind logical rules to ``mesh`` for the code within the block."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    # keep only mesh axes that exist (e.g. drop "pod" on the single-pod mesh)
    axes = set(mesh.axis_names)
    bound = {
        name: tuple(a for a in val if a in axes)
        for name, val in rules.items()
    }
    _state().append((mesh, bound))
    try:
        yield
    finally:
        _state().pop()


def active() -> bool:
    return bool(_state())


def current_mesh():
    return _state()[-1][0] if _state() else None


def logical_spec(*dims) -> P:
    """Partition spec for logical dim names (None = replicated dim)."""
    _, rules = _state()[-1]
    parts = []
    for d in dims:
        if d is None:
            parts.append(None)
        else:
            axes = rules.get(d, ())
            parts.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return P(*parts)


def shard(x, *dims):
    """Name ``x``'s logical dims; a no-op when unbound. When bound it moves
    nothing (``x`` is already this rank's shard) and checks that every dim
    is named."""
    if not _state():
        return x
    if len(dims) != x.ndim:
        raise ValueError(f"shard: {len(dims)} logical dims {dims} for a "
                         f"tensor of shape {tuple(x.shape)}")
    return x


def logical_axis_size(name: str) -> int:
    """Number of devices the logical axis ``name`` shards over (1 when no
    mesh is bound — single-device tests)."""
    if not _state():
        return 1
    mesh, rules = _state()[-1]
    sizes = axis_sizes(mesh)
    n = 1
    for a in rules.get(name, ()):
        n *= sizes[a]
    return n


def _bound_axes(name: str) -> tuple:
    """The mesh axes of more than one rank that ``name`` — a logical axis,
    or a mesh axis itself (``"data"``, ``"model"``) — spans."""
    if not _state():
        return ()
    mesh, rules = _state()[-1]
    sizes = axis_sizes(mesh)
    axes = (name,) if name in sizes else rules.get(name, ())
    return tuple(a for a in axes if sizes[a] > 1)


def group(name: str):
    """The process group the logical axis (or mesh axis) ``name`` shards
    over, or None
    when unbound or over one rank. A logical axis over two mesh axes of
    more than one rank each (the multi-pod mesh's batch) has no group
    here: the production meshes are metadata."""
    axes = _bound_axes(name)
    if not axes:
        return None
    if len(axes) > 1:
        raise NotImplementedError(
            f"logical axis {name!r} spans mesh axes {axes}: the port runs "
            "collectives over one mesh axis a logical axis")
    return current_mesh().group(axes[0])


def rank_in(name: str) -> int:
    """This rank's index along the logical axis ``name`` (0 when unbound)."""
    axes = _bound_axes(name)
    if not axes:
        return 0
    if len(axes) > 1:
        group(name)                                   # raises
    return current_mesh().coord(axes[0])


# ------------------------------------------------------------ collectives --
_COUNTS: Counter = Counter()


def collective_counts() -> dict:
    """Collectives issued since :func:`reset_collective_counts`:
    ``{"all_reduce": n, "bytes": payload bytes}``."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def all_reduce(t: torch.Tensor, name: str, op: str = "sum") -> torch.Tensor:
    """``all_reduce`` ``t`` in place over the logical axis ``name``
    (``op`` 'sum' or 'max'); returns ``t``. A no-op without a group."""
    import torch.distributed as dist

    g = group(name)
    if g is None:
        return t
    _COUNTS["all_reduce"] += 1
    _COUNTS["bytes"] += t.numel() * t.element_size()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=rop, group=g)
    return t


def all_reduce_max(t: torch.Tensor, names) -> torch.Tensor:
    """The max of ``t`` over every rank of the logical axes ``names``, out
    of place and without gradient. Reduced in float32 (or int64), which
    holds every value of the narrower dtypes exactly."""
    names = [n for n in names if group(n) is not None]
    if not names:
        return t
    wide = torch.int64 if not t.is_floating_point() else torch.float32
    out = t.detach().to(wide).clone()
    for n in names:
        all_reduce(out, n, "max")
    return out.to(t.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.name), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        # 16-bit partial sums are added in float32 and rounded once
        wide = x.to(torch.float32) if x.element_size() < 4 \
            and x.is_floating_point() else x.contiguous().clone()
        return all_reduce(wide, name).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, name):
        n = logical_axis_size(name)
        size = x.shape[dim] // n
        ctx.dim, ctx.name, ctx.shape = dim, name, x.shape
        ctx.lo = rank_in(name) * size
        return x.narrow(dim, ctx.lo, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        return all_reduce(full, ctx.name), None, None


def copy_to(x: torch.Tensor, name: str = "model") -> torch.Tensor:
    """A replicated ``x`` entering the region split over ``name``:
    identity forward, ``all_reduce`` SUM of the gradient backward."""
    return x if group(name) is None else _CopyTo.apply(x, name)


def reduce_from(x: torch.Tensor, name: str = "model") -> torch.Tensor:
    """Partial sums leaving the region split over ``name``: ``all_reduce``
    SUM forward, identity backward."""
    return x if group(name) is None else _ReduceFrom.apply(x, name)


def scatter_to(x: torch.Tensor, dim: int, name: str = "model"
               ) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim`` (split over
    ``name`` in equal parts); backward, the slice's gradient in place in a
    zero tensor of ``x``'s shape, summed over the group."""
    if group(name) is None:
        return x
    if x.shape[dim] % logical_axis_size(name):
        raise ValueError(f"scatter_to: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {logical_axis_size(name)} ranks")
    return _ScatterTo.apply(x, dim, name)
