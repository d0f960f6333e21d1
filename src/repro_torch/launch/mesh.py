"""Meshes: the production meshes (metadata) and the host mesh the port
trains on.

Counterpart of ``repro.launch.mesh``. A :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` (named dims, one process
group a dim) with the reference's ``axis_names`` and the shape, and
answers the two questions the sharded paths ask: the process group of an
axis and this rank's coordinate along it. Functions, not module
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

    @property
    def axis_names(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> tuple:
        return tuple(self.device_mesh.shape)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

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
