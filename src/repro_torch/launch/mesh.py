"""Meshes: the production meshes (metadata) and the host mesh the port
trains on.

Counterpart of ``repro.launch.mesh``. A :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` (named dims, one process
group a dim) with the reference's ``axis_names`` and the shape, and
answers the two questions the sharded paths ask: the process group of an
axis (or of several axes flattened into one: the multi-pod batch
``("pod", "data")``) and this rank's coordinate along it. Functions, not module
constants: building a mesh needs the default process group
(``torch.distributed.init_process_group``), which the caller starts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh"]


@dataclass(eq=False)
class Mesh:
    device_mesh: object                     # torch DeviceMesh
    _cpu_groups: dict = field(default_factory=dict, repr=False)
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> tuple:
        return tuple(self.device_mesh.shape)

    def group(self, axis):
        """The process group of the mesh axis ``axis``, or of the axes
        ``axis`` (a tuple) flattened into one, major axis first: made on
        first use by every rank for every group of those axes
        (:meth:`_rows`), as ``new_group`` requires, over the default
        group's backend (gloo, NCCL or the fake process group)."""
        if isinstance(axis, str) or len(axis) == 1:
            return self.device_mesh.get_group(
                axis if isinstance(axis, str) else axis[0])
        axis = tuple(axis)
        if axis not in self._groups:
            import torch.distributed as dist

            me = dist.get_rank()
            for row in self._rows(axis):
                g = dist.new_group(ranks=row)
                if me in row:
                    self._groups[axis] = g
        return self._groups[axis]

    def _rows(self, axes: tuple) -> list:
        """The global ranks of every group that spans ``axes`` (the other
        axes fixed), each in the order of its coordinates along ``axes``,
        major axis first."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.shape)) if i not in idx]
        n = 1
        for i in idx:
            n *= self.shape[i]
        ranks = self.device_mesh.mesh.permute(*rest, *idx).reshape(-1, n)
        return ranks.tolist()

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def cpu_group(self, axis: str):
        """A host (``gloo``) group over this rank's ranks along ``axis``,
        for the checkpoint's gathers; made on first use, by every rank
        for every group of the axis, as ``new_group`` requires."""
        if axis not in self._cpu_groups:
            import torch.distributed as dist

            i = self.axis_names.index(axis)
            ranks = self.device_mesh.mesh.movedim(i, -1).reshape(
                -1, self.shape[i])
            me = dist.get_rank()
            for row in ranks.tolist():
                g = dist.new_group(ranks=row, backend="gloo")
                if me in row:
                    self._cpu_groups[axis] = g
        return self._cpu_groups[axis]


def _make_mesh(shape: tuple, axes: tuple) -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; "
                         f"the process group has {dist.get_world_size()}")
    backend = dist.get_backend()
    kind = "cuda" if backend == "nccl" or (
        backend == "gloo" and torch.cuda.is_available()) else "cpu"
    return Mesh(init_device_mesh(kind, tuple(shape), mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_host_mesh(model: int | None = None) -> Mesh:
    """``(world / model, model)`` over dims ``("data", "model")``: every
    rank of the default process group."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if n % model:
        raise ValueError(f"--tp {model} does not divide the {n} ranks")
    return _make_mesh((n // model, model), ("data", "model"))
