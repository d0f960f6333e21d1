"""Optimizers (AdamW, Lion, SGD-momentum), the cosine schedule and global
norm clipping.

Counterpart of ``repro.optim.optimizers``: ``(init, update)`` pairs over
the port's nested dicts of tensors (:mod:`repro_torch.core.tree`). The
moments are float32 and ``step`` an int32 scalar, as the reference keeps
them; the learning rate, the bias corrections and every update are
float32. ``update`` is functional: it returns new parameter and state
trees and leaves its inputs alone.

A ``None`` gradient leaf (autograd found no path to it) counts as a zero
gradient everywhere, as the reference's zero arrays do (ROADMAP R-8): its
moments decay, it adds nothing to the global norm, and AdamW's and Lion's
weight decay still reach it.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "lion", "momentum", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params[, split]) -> (params, state, metrics); split:
    # global_norm's, on a mesh that splits some leaves
    update: Callable


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    """``lr(step)``: linear warmup over ``warmup`` steps, then a cosine to
    ``final_frac * base_lr`` at ``total``; a float32 scalar tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(_F32)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in
    sorted key order; ``None`` leaves add nothing.

    ``split``: on a bound mesh, a tree of ``tree``'s structure naming for
    each leaf the logical axis whose ranks hold the rest of it, or a tuple
    of such axes (None: the leaf is whole here). Those leaves' sums are
    added over their axes (one ``all_reduce`` an axis and group of
    leaves), so every rank gets the whole tree's norm."""
    leaves = tree_leaves(tree)
    axes = tree_leaves(split) if split is not None else [None] * len(leaves)
    sq = [(g.to(_F32).square().sum(),
           ax if ax is None or isinstance(ax, tuple) else (ax,))
          for g, ax in zip(leaves, axes) if g is not None]
    if not sq:
        return torch.zeros((), dtype=_F32)
    if split is not None:
        from repro_torch.launch.sharding import all_reduce

        for ax in sorted({ax for _, ax in sq if ax is not None}):
            idx = [i for i, (_, a) in enumerate(sq) if a == ax]
            summed = torch.stack([sq[i][0] for i in idx])
            for name in ax:
                summed = all_reduce(summed, name)
            for j, i in enumerate(idx):
                sq[i] = (summed[j], ax)
    total = sq[0][0]
    for s, _ in sq[1:]:
        total = total + s
    return total.sqrt()


def clip_by_global_norm(tree, max_norm, split=None):
    """``(tree scaled by min(1, max_norm / norm), norm)``; each leaf scaled
    in float32 and cast back to its dtype. ``split``: :func:`global_norm`'s."""
    n = global_norm(tree, split)
    scale = torch.clamp(max_norm / n.clamp(min=1e-9), max=1.0)
    return tree_map(lambda g: None if g is None
                    else (g.to(_F32) * scale).to(g.dtype), tree), n


def _zeros32(p):
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _grad32(g, p):
    return _zeros32(p) if g is None else g.to(_F32)


def _lr_fn(lr):
    return lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=_F32, device=step.device))


def _unzip(out, n):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], out) for i in range(n))


def _step0(params):
    leaf = next((p for p in tree_leaves(params) if torch.is_tensor(p)), None)
    device = leaf.device if leaf is not None else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          clip_norm: float | None = 1.0) -> Optimizer:
    """AdamW; ``lr`` a float or a schedule ``fn(step) -> lr``. Weight decay
    reaches every leaf of two or more dims (not norms or biases)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros32, params),
                "nu": tree_map(_zeros32, params),
                "step": _step0(params)}

    def update(grads, state, params, split=None, shard=None):
        """``shard``: ZeRO-1, a tree of ``params``' structure whose leaves
        ``cut`` a whole leaf to the slice this rank's moments hold and
        ``join`` the ranks' updated slices back into the whole leaf
        (``repro_torch.launch.train.zero1_layout``). The clip's norm is the
        whole gradients'; each leaf's update is elementwise, so a sliced
        update is the whole one's slice."""
        step = state["step"] + 1
        gnorm = torch.zeros((), dtype=_F32, device=step.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, split)
        lr_t = lr_fn(step)
        stepf = step.to(_F32)
        b1c = 1 - b1 ** stepf
        b2c = 1 - b2 ** stepf

        def upd(p, g, m, v, sh=None):
            g = _grad32(g, p)
            if sh is not None:
                p, g = sh.cut(p), sh.cut(g)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g.square()
            delta = (m2 / b1c) / ((v2 / b2c).sqrt() + eps)
            if weight_decay and p.ndim >= 2:
                delta = delta + weight_decay * p.to(_F32)
            new = (p.to(_F32) - lr_t * delta).to(p.dtype)
            return (new if sh is None else sh.join(new)), m2, v2

        new_params, mu, nu = _unzip(
            tree_map(upd, params, grads, state["mu"], state["nu"],
                     *(() if shard is None else (shard,))), 3)
        return new_params, {"mu": mu, "nu": nu, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def lion(lr, *, b1=0.9, b2=0.99, weight_decay=0.1,
         clip_norm=1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros32, params), "step": _step0(params)}

    def update(grads, state, params, split=None):
        step = state["step"] + 1
        grads, gnorm = clip_by_global_norm(grads, clip_norm, split)
        lr_t = lr_fn(step)

        def upd(p, g, m):
            g = _grad32(g, p)
            d = torch.sign(b1 * m + (1 - b1) * g)
            if weight_decay and p.ndim >= 2:
                d = d + weight_decay * p.to(_F32)
            m2 = b2 * m + (1 - b2) * g
            return (p.to(_F32) - lr_t * d).to(p.dtype), m2

        new_params, mu = _unzip(tree_map(upd, params, grads, state["mu"]),
                                2)
        return new_params, {"mu": mu, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def momentum(lr, *, beta=0.9, clip_norm=None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros32, params), "step": _step0(params)}

    def update(grads, state, params, split=None):
        step = state["step"] + 1
        gnorm = torch.zeros((), dtype=_F32, device=step.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, split)
        lr_t = lr_fn(step)

        def upd(p, g, m):
            m2 = beta * m + _grad32(g, p)
            return (p.to(_F32) - lr_t * m2).to(p.dtype), m2

        new_params, mu = _unzip(tree_map(upd, params, grads, state["mu"]),
                                2)
        return new_params, {"mu": mu, "step": step}, \
            {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
