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
or ``shard_map`` put them. Only ``all_reduce`` (SUM and MAX),
``all_gather`` and ``reduce_scatter`` (SUM) are used on the device, so the
same code runs over NCCL, over a ``gloo`` group (two processes on one
card) and under the fake process group (the dry run). A group of one rank is an identity, and
its collectives are skipped. A logical axis over two mesh axes (the
multi-pod batch) runs over their flattened group.

Autograd crosses a collective through Megatron's pair of functions:
:func:`copy_to` (identity forward, ``all_reduce`` SUM backward) where a
replicated tensor enters a model-parallel region, :func:`reduce_from`
(``all_reduce`` SUM forward, identity backward) where partial sums leave
it; :func:`scatter_to` takes a rank's slice of a replicated tensor
(backward: the slice's gradient padded with zeros, summed over the
group); :func:`all_gather` joins the ranks' slices (backward: this
rank's slice of the gradient, or of its sum over the group);
:func:`reduce_scatter_from` is :func:`reduce_from` that keeps this rank's
slice of one dim (sequence parallelism; backward: the slices' gradients
gathered). ``torch.distributed.all_reduce`` itself has no gradient.

ZeRO-3 (``--fsdp``, ``--pure-dp``): a parameter leaf of which a rank holds
a slice over the data ranks is handed to the model as a
:class:`DataSplit`, gathered whole at its use (:func:`gathered`), a layer
at a time for a stacked leaf.

A computation that couples a batch's rows (the MoE's one-group dispatch
of a decode step) needs to know whether a call's rows are this rank's
share of the batch or the whole of it (a batch the data ranks do not
divide is held whole by each): the caller that splits the rows says so
with :func:`global_batch`, and :func:`rows_split` reads it.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import torch

__all__ = ["P", "use_rules", "unbound", "shard", "current_mesh", "active",
           "logical_spec", "logical_axis_size", "DEFAULT_RULES",
           "axis_sizes", "group", "rank_in", "all_reduce",
           "all_reduce_max", "all_gather", "reduce_scatter", "copy_to",
           "reduce_from", "reduce_scatter_from", "scatter_to",
           "seq_split", "seq_part", "seq_params", "DataSplit", "data_split", "gathered",
           "whole", "global_batch", "rows_split", "collective_counts", "reset_collective_counts"]


class P(tuple):
    """A partition spec: one entry a tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim split over their
    product). Equal, entry for entry, to the reference's
    ``jax.sharding.PartitionSpec``; missing trailing entries are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):          # pickles entry for entry
        return tuple(self)

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
    # a rule over two mesh axes of more than one rank gets its flattened
    # group here, made by every rank in one order (new_group's contract)
    sizes = axis_sizes(mesh)
    for val in bound.values():
        real = tuple(a for a in val if sizes[a] > 1)
        if len(real) > 1:
            mesh.group(real)
    _state().append((mesh, bound))
    try:
        yield
    finally:
        _state().pop()


@contextmanager
def unbound():
    """No rules bound within the block (the whole model's shapes, e.g. a
    decode cache's for its specs), whatever is bound outside it."""
    saved = _STACK[:]
    _STACK.clear()
    try:
        yield
    finally:
        _STACK[:] = saved


# the whole batch's row count where a call's rows may be a data rank's
# share of it (:func:`global_batch`)
_BATCH: list = []


@contextmanager
def global_batch(rows: int):
    """Within the block, a call with fewer than ``rows`` rows holds this
    rank's share of a batch of ``rows`` split over the ``"batch"`` ranks;
    one with all ``rows`` (a batch the ranks do not divide, held whole by
    each) holds the whole batch, as does every call outside such a
    block."""
    _BATCH.append(int(rows))
    try:
        yield
    finally:
        _BATCH.pop()


def rows_split(local: int) -> bool:
    """Whether a call's ``local`` rows are this rank's share of the batch
    :func:`global_batch` declares (False with no ``"batch"`` ranks or no
    declaration)."""
    if not _BATCH or group("batch") is None or local >= _BATCH[-1]:
        return False
    n = logical_axis_size("batch")
    if local * n != _BATCH[-1]:
        raise ValueError(
            f"{local} row(s) on each of {n} data ranks are not a share of "
            f"a batch of {_BATCH[-1]}")
    return True


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
    is named and that no mesh axis splits two dims (where the reference's
    ``PartitionSpec`` raises ``DuplicateSpecError``)."""
    if not _state():
        return x
    if len(dims) != x.ndim:
        raise ValueError(f"shard: {len(dims)} logical dims {dims} for a "
                         f"tensor of shape {tuple(x.shape)}")
    seen: dict = {}
    for d, part in zip(dims, logical_spec(*dims)):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is None:
                continue
            if a in seen:
                raise ValueError(
                    f"shard: mesh axis {a!r} would split two dims, logical "
                    f"{seen[a]!r} and {d!r} (the rules bind both to it)")
            seen[a] = d
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
    over, or None when unbound or over one rank. A logical axis over two
    mesh axes of more than one rank each (the multi-pod batch, ``("pod",
    "data")``) takes their flattened group, ranks in
    :func:`rank_in`'s order."""
    axes = _bound_axes(name)
    if not axes:
        return None
    return current_mesh().group(axes if len(axes) > 1 else axes[0])


def rank_in(name: str) -> int:
    """This rank's index along the logical axis ``name`` (0 when unbound):
    over several mesh axes, their coordinates major axis first, as
    :func:`~repro_torch.launch.specs.local_slice` lays a dim out."""
    axes = _bound_axes(name)
    if not axes:
        return 0
    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.coord(a)
    return idx


# ------------------------------------------------------------ collectives --
_COUNTS: Counter = Counter()


def collective_counts(by_axis: bool = False) -> dict:
    """Collectives issued since :func:`reset_collective_counts`:
    ``{"all_reduce": calls, "all_reduce_bytes": payload bytes,
    "all_gather": calls, "all_gather_bytes": gathered bytes,
    "reduce_scatter": calls, "reduce_scatter_bytes": reduced bytes,
    "bytes": the byte counts added}`` (an ``all_reduce``'s payload is its
    tensor, an ``all_gather``'s the tensor it returns, every rank's part,
    a ``reduce_scatter``'s the tensor it reduces, every rank's part).
    Kinds never issued are left out, but ``all_reduce`` and ``bytes``.
    ``by_axis``: the same counts keyed ``"<kind>@<mesh axes>"`` (e.g.
    ``"all_reduce@model"``, ``"all_gather@pod+data"``), ``[calls,
    bytes]`` each."""
    if by_axis:
        return {k[1]: [v, _COUNTS[("bytes",) + k[1:]]]
                for k, v in sorted(_COUNTS.items()) if k[0] == "calls"}
    kinds = ("all_reduce", "all_gather", "reduce_scatter")
    out = {k: 0 for kind in kinds for k in (kind, kind + "_bytes")}
    for (what, key), v in _COUNTS.items():
        kind = key.split("@")[0]
        out[kind if what == "calls" else kind + "_bytes"] += v
    out["bytes"] = sum(out[kind + "_bytes"] for kind in kinds)
    return {k: v for k, v in out.items() if v or k in ("all_reduce",
                                                       "bytes")}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(kind: str, name: str, nbytes: int) -> None:
    key = f"{kind}@{'+'.join(_bound_axes(name))}"
    _COUNTS[("calls", key)] += 1
    _COUNTS[("bytes", key)] += nbytes


def all_reduce(t: torch.Tensor, name: str, op: str = "sum") -> torch.Tensor:
    """``all_reduce`` ``t`` in place over the logical axis ``name``
    (``op`` 'sum' or 'max'); returns ``t``. A no-op without a group."""
    import torch.distributed as dist

    g = group(name)
    if g is None:
        return t
    _count("all_reduce", name, t.numel() * t.element_size())
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=rop, group=g)
    return t


def _gather(x: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along ``dim`` in
    :func:`rank_in`'s order: one ``all_gather``, counted."""
    import torch.distributed as dist

    n = logical_axis_size(name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _count("all_gather", name, n * x.numel() * x.element_size())
    dist.all_gather(parts, x, group=group(name))
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) summed over the logical axis
    ``name`` and cut along ``dim`` into equal parts: this rank's part, in
    :func:`rank_in`'s order (``t`` itself without a group). One
    ``reduce_scatter``, counted; no gradient (:func:`reduce_scatter_from`
    has one)."""
    import torch.distributed as dist

    g = group(name)
    if g is None:
        return t
    n = logical_axis_size(name)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _count("reduce_scatter", name, src.numel() * src.element_size())
    dist.reduce_scatter_tensor(out, src, group=g)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, dim, grad):
        ctx.name, ctx.dim, ctx.grad = name, dim, grad
        ctx.size = x.shape[dim]
        return _gather(x, name, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce(g.contiguous().clone(), ctx.name)
        lo = rank_in(ctx.name) * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None, \
            None


def all_gather(x: torch.Tensor, name: str, dim: int = -1,
               grad: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` along the logical axis ``name`` concatenated
    along ``dim``, rank 0's first (``x`` itself without a group). Its
    autograd pair: backward, this rank's slice of the gradient — right
    where every rank goes on with the same whole tensor (``grad="slice"``,
    Megatron's gather) — or, with ``grad="sum"``, of the gradient summed
    over the ranks first (``all_reduce``), where each rank goes on with a
    part of its own (the gradient of a gather is then a reduce-scatter)."""
    if group(name) is None:
        return x
    if grad not in ("slice", "sum"):
        raise ValueError(f"all_gather: grad must be 'slice' or 'sum', got "
                         f"{grad!r}")
    return _AllGather.apply(x, name, dim % x.ndim, grad)


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


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, dim):
        ctx.name, ctx.dim = name, dim
        # 16-bit partial sums are added in float32 and rounded once
        wide = x.to(torch.float32) if x.element_size() < 4 \
            and x.is_floating_point() else x
        return reduce_scatter(wide, name, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.name, ctx.dim), None, None


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


def reduce_scatter_from(x: torch.Tensor, name: str, dim: int
                        ) -> torch.Tensor:
    """Partial sums leaving the region split over ``name``, this rank's
    slice of ``dim`` kept (sequence parallelism's row-parallel output):
    ``reduce_scatter`` SUM forward (16-bit parts added in float32, rounded
    once), ``all_gather`` of the slices' gradients backward."""
    return x if group(name) is None else _ReduceScatterFrom.apply(x, name,
                                                                  dim)


def seq_split(S: int) -> bool:
    """Whether a stream of ``S`` tokens runs as the model ranks' slices of
    its sequence (sequence parallelism): the logical ``"seq"`` axis bound
    over more than one rank and dividing ``S``. A decode step's one token
    stays whole."""
    n = logical_axis_size("seq")
    return n > 1 and S % n == 0


def seq_part(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's slice of dim ``dim`` of a tensor every model rank holds
    whole (positions, masks, inputs: no gradient crosses it) where
    :func:`seq_split` holds for it, else ``t``."""
    if not seq_split(t.shape[dim]):
        return t
    n = t.shape[dim] // logical_axis_size("seq")
    return t.narrow(dim, rank_in("seq") * n, n)


def seq_params(tree):
    """A replicated parameter subtree (a norm's) used on this rank's slice
    of the sequence: each leaf through :func:`copy_to` over ``"seq"``, so
    its gradient is summed over the slices."""
    if isinstance(tree, dict):
        return {k: seq_params(v) for k, v in tree.items()}
    return copy_to(tree, "seq")


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


# ----------------------------------------------------------------- ZeRO-3 --
class _FromOwner(torch.autograd.Function):
    """A stacked leaf's layer that one rank of ``name`` holds whole (the
    leaf split over the layers): the owner's copy, zeros elsewhere, one
    ``all_reduce`` SUM (adding zeros is exact). Backward: the layer's
    gradient summed over the ranks, kept by the owner (zeros elsewhere).
    ``piece`` is a layer of this rank's own, so that every rank's backward
    runs and joins the collective."""

    @staticmethod
    def forward(ctx, piece, owner, name):
        ctx.owner, ctx.name = owner, name
        t = piece.clone() if owner else torch.zeros_like(piece)
        return all_reduce(t, name)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.name)
        return (g if ctx.owner else torch.zeros_like(g)), None, None


class DataSplit:
    """A parameter leaf of which this rank holds a slice over the logical
    axis ``name`` (ZeRO-3: the data ranks): ``local``, cut along ``dim``.
    :meth:`whole` gathers it at its use (``all_gather``; backward, this
    rank's slice of the gradient summed over the ranks, so the data ranks'
    gradients are added there and nowhere else). Indexing or unbinding a
    stacked leaf's layer axis gives a layer's handle: its slice, or where
    the leaf is split over the layers, the layer from the rank that holds
    it (:class:`_FromOwner`). A handle holds no gathered data: a layer
    recomputed in the backward (``cfg.remat``) gathers again."""

    def __init__(self, local: torch.Tensor, dim: int, name: str = "batch",
                 owner: bool | None = None):
        self.local, self.dim, self.name, self.owner = local, dim, name, owner

    def _layer(self, piece, i: int) -> "DataSplit":
        if self.dim > 0:
            return DataSplit(piece, self.dim - 1, self.name)
        n = self.local.shape[0]
        return DataSplit(piece, -1, self.name,
                         owner=rank_in(self.name) == i // n)

    def __getitem__(self, i: int) -> "DataSplit":
        if self.dim > 0:
            return self._layer(self.local[i], i)
        return self._layer(self.local[i % self.local.shape[0]], i)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a DataSplit unbinds its layer axis only")
        pieces = self.local.unbind(0)
        if self.dim > 0:
            return [self._layer(p, i) for i, p in enumerate(pieces)]
        n = len(pieces) * logical_axis_size(self.name)
        return [self._layer(pieces[i % len(pieces)], i) for i in range(n)]

    def whole(self) -> torch.Tensor:
        if self.owner is not None:
            return _FromOwner.apply(self.local, self.owner, self.name)
        return all_gather(self.local, self.name, self.dim, grad="sum")


def whole(t):
    """``t`` itself, or a :class:`DataSplit`'s gathered leaf."""
    return t.whole() if isinstance(t, DataSplit) else t


def gathered(tree):
    """A parameter tree (a layer's, or a subtree) with every
    :class:`DataSplit` leaf gathered (:func:`whole`); the same tree where
    there is none."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return whole(tree)


def data_split(params, layout):
    """``params`` with each leaf whose ``layout`` entry names a dim (the
    dim its spec splits over the data ranks: ``launch.train.
    zero3_layout``) handed to the model as a :class:`DataSplit`; the
    same tree without a layout."""
    if layout is None:
        return params
    if isinstance(params, dict):
        return {k: data_split(v, layout[k]) for k, v in params.items()}
    if layout is None or params is None:
        return params
    return DataSplit(params, layout)
