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
``torch.bfloat16`` from either package's file. The reference's
``shardings=`` (an elastic re-layout onto a mesh) waits for the port's
mesh (ROADMAP A-10).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "gc_keep_last",
           "wait_pending"]

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


def _snapshot(tree) -> dict:
    return {k: _host(v) for k, v in _flatten(tree).items()}


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
        "time": time.time(),
        "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=indent)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree) -> str:
    """Synchronous checkpoint write (atomic commit via rename)."""
    return _write(ckpt_dir, step, _snapshot(tree), 1)


_PENDING: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree) -> threading.Thread:
    """Snapshot to host now, write to disk in the background."""
    flat = _snapshot(tree)
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


def restore(ckpt_dir: str, step: int | None = None, like=None,
            device="cpu"):
    """Load a checkpoint as ``(step, tree)``, every leaf a tensor on
    ``device`` (the newest committed step when ``step`` is None).
    ``like``: an optional tree of tensors to take target dtypes from."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["arrays"].items()}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: _tensor(z[k], dtypes[k], device) for k in z.files}
    tree = _unflatten(flat)
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
    now = time.time()
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
