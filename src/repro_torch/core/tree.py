"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer states are nested dicts whose leaves
are tensors. :func:`tree_leaves` walks them in sorted key order, the order
``jax.tree.leaves`` gives a dict, so sums over leaves add in the
reference's order. A gradient leaf may be ``None``: autograd found no path
from the loss to that parameter, where JAX gives a zero array (ROADMAP
R-8); every consumer counts ``None`` as zero.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["tree_leaves", "tree_map", "value_and_grad"]


def tree_leaves(tree) -> list:
    """Leaves in sorted key order (``None`` leaves included)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``; the result has
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a loss over a parameter tree:
    ``value_and_grad(fn)(params, *args) -> (loss, grads)``.

    Each floating-point leaf of ``params`` is taken as a fresh leaf that
    requires grad (the caller's tensors are not touched), ``fn`` runs with
    grad mode on, and ``grads`` has ``params``' structure: a tensor of the
    leaf's dtype, or ``None`` where the loss does not depend on the leaf
    (an integer leaf too). ``loss`` comes back detached.
    """
    def run(params, *args):
        leaves: list = []

        def take(p):
            if torch.is_tensor(p) and p.is_floating_point():
                p = p.detach().requires_grad_()
                leaves.append(p)
            return p

        live = tree_map(take, params)
        with torch.enable_grad():
            loss = fn(live, *args)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): g for p, g in zip(leaves, got)}
        grads = tree_map(lambda p: by_id.get(id(p)), live)
        return loss.detach(), grads

    return run
