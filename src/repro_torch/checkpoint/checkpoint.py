"""Atomic, async checkpointing.

Counterpart of ``repro.checkpoint.checkpoint``, with the reference's
layout, so that a checkpoint either package writes restores in the other:

    <dir>/step_000000123.tmp/   (written)
    <dir>/step_000000123/       (atomic rename on completion)
        manifest.json           step, time, every array's shape and dtype
        arrays.npz              flat {path: ndarray}

Paths join dict keys with ``/`` in sorted order (a list or tuple element
is ``#i``), as the reference flattens its pytrees: a training checkpoint
holds ``params/...``, ``opt/mu/...``, ``opt/nu/...``, ``opt/step`` and,
with gradient compression, ``res/...``. A checkpoint is valid iff the
rename committed — a crash mid-write leaves only a ``.tmp`` directory,
which :func:`restore` and :func:`latest_step` ignore and
:func:`gc_keep_last` removes once stale. :func:`save_async` copies every
tensor to the host synchronously and writes in a daemon thread.

bfloat16 has no numpy dtype here: such a tensor is stored as its 2-byte
patterns (``V2``, which is how the reference's ``ml_dtypes`` arrays land
in the file too) and its manifest dtype ``bfloat16``, and restored to
``torch.bfloat16`` from either package's file.

Elastic, as the reference's: a checkpoint holds full arrays whatever
topology wrote it. A sharded run saves with ``shardings=`` (a tree of
:class:`~repro_torch.launch.specs.Sharding`): each leaf's shards are
gathered on the host over a CPU ``gloo`` group of each mesh axis that
splits it (:meth:`~repro_torch.launch.mesh.Mesh.cpu_group`), and rank 0
writes. :func:`restore` with ``shardings=`` gives each rank its slice of
the saved full arrays (:func:`~repro_torch.launch.specs.local_slice`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.metrics.timing import epoch_time

__all__ = ["save", "save_async", "restore", "latest_step", "gc_keep_last",
           "wait_pending", "gather_full"]

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            if node and all(re.fullmatch(r"#\d+", k) for k in node):
                return [listify(node[f"#{i}"]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _host(v) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of one leaf."""
    if torch.is_tensor(v):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def gather_full(t: torch.Tensor, sharding) -> torch.Tensor:
    """The full host tensor of this rank's shard ``t`` under ``sharding``:
    an ``all_gather`` on the host for each split dim, over the CPU group
    of its mesh axes (each gathered in turn, minor axis first)."""
    import torch.distributed as dist

    from repro_torch.launch.sharding import axis_sizes

    mesh = sharding.mesh
    sizes = axis_sizes(mesh)
    t = t.detach().cpu()
    for dim, part in enumerate(sharding.spec):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        for a in reversed(axes):
            if sizes[a] == 1:
                continue
            wire = t.contiguous()
            if wire.dtype in (torch.bfloat16, torch.float16):
                wire = wire.view(torch.int16)
            parts = [torch.empty_like(wire) for _ in range(sizes[a])]
            dist.all_gather(parts, wire, group=mesh.cpu_group(a))
            t = torch.cat(parts, dim=dim).view(t.dtype)
    return t


def _snapshot(tree, shardings=None) -> dict:
    """Host copies of every leaf (gathered whole under ``shardings``);
    empty on a rank other than 0 of a sharded save, which writes nothing."""
    if shardings is None:
        return {k: _host(v) for k, v in _flatten(tree).items()}
    import torch.distributed as dist

    from repro_torch.core.tree import tree_map

    full = tree_map(gather_full, tree, shardings)
    if dist.get_rank() != 0:
        return {}
    return {k: _host(v) for k, v in _flatten(full).items()}


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:09d}")


def _write(ckpt_dir: str, step: int, flat: dict, indent) -> str:
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "time": epoch_time(),
        "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=indent)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree, shardings=None) -> str | None:
    """Synchronous checkpoint write (atomic commit via rename). With
    ``shardings``, every rank calls it, rank 0 writes the gathered full
    arrays and returns the path, the others None."""
    flat = _snapshot(tree, shardings)
    return _write(ckpt_dir, step, flat, 1) if flat else None


_PENDING: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree,
               shardings=None) -> threading.Thread | None:
    """Snapshot to host now (gathered under ``shardings``, as
    :func:`save`), write to disk in the background."""
    flat = _snapshot(tree, shardings)
    if not flat:
        return None
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, None),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def restore(ckpt_dir: str, step: int | None = None, shardings=None,
            like=None, device="cpu"):
    """Load a checkpoint as ``(step, tree)``, every leaf a tensor on
    ``device`` (the newest committed step when ``step`` is None).
    ``shardings``: a tree of :class:`~repro_torch.launch.specs.Sharding`
    matching the saved tree; each leaf is this rank's slice of the saved
    full array, whatever topology wrote it (elastic). ``like``: an
    optional tree of tensors to take target dtypes from."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["arrays"].items()}
    on_host = "cpu" if shardings is not None else device
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: _tensor(z[k], dtypes[k], on_host) for k in z.files}
    tree = _unflatten(flat)
    if shardings is not None:
        from repro_torch.core.tree import tree_map

        tree = tree_map(lambda a, s: s.local(a).contiguous().to(device),
                        tree, shardings)
    if like is not None:
        from repro_torch.core.tree import tree_map

        tree = tree_map(lambda ref, a: a.to(ref.dtype), like, tree)
    return step, tree


def gc_keep_last(ckpt_dir: str, keep: int = 3, tmp_grace_s: float = 300.0):
    """Keep the newest ``keep`` checkpoints; reap *stale* .tmp leftovers.

    A .tmp dir younger than ``tmp_grace_s`` may be an in-flight async write
    (save_async runs in a background thread) — never touch those; only
    genuinely crashed writes (old mtimes) are removed.
    """
    if not os.path.isdir(ckpt_dir):
        return
    steps = []
    now = epoch_time()
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.endswith(".tmp"):
            try:
                if now - os.path.getmtime(path) > tmp_grace_s:
                    shutil.rmtree(path, ignore_errors=True)
            except OSError:
                pass
            continue
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    for s in sorted(steps)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
