"""Bridge from the JAX reference's parameters to the port's.

Both packages keep the same parameter tree (stacked ``(L, ...)`` leaves
under ``params["stack"]["layers"]``, ``embed (C, V, D)``, ``final_norm``),
so the bridge is a checked leaf-by-leaf copy: the tests hand both models
the *same* random init this way and compare what they compute. A linear
the reference quantized (``quantize_params``: a ``QuantizedWeight`` leaf
with int8 ``q`` and float32 ``scale``) becomes the port's
:class:`~repro_torch.models.layers.QuantizedWeight`, so both packages can
serve the same quantized weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import QuantizedWeight
from .model import _dt
from .transformer import _layer_leaves, hybrid_leaves

__all__ = ["params_from_reference"]


def _expected_shapes(cfg: ModelConfig) -> dict:
    """Every leaf's path and shape: the tree ``LM.init`` makes for ``cfg``
    (an MoE config has ``moe/*`` leaves in place of ``mlp/*``, a gelu MLP
    no ``w3``, an rwkv6 config the RWKV6 layer's leaves, a hybrid config
    the Mamba2 layer's and ``stack/shared/*``, ``stack/lora_a``,
    ``stack/lora_b``; ``C = max(n_codebooks, 1)`` embedding tables and
    heads)."""
    D, C = cfg.d_model, max(cfg.n_codebooks, 1)
    norm = (("w",), ("b",)) if cfg.norm == "layernorm" else (("w",),)
    shapes = {("embed",): (C, cfg.vocab_size, D)}
    shapes.update({("final_norm",) + k: (D,) for k in norm})
    if cfg.n_layers:
        shapes.update({("stack", "layers") + path: (cfg.n_layers,) + shape
                       for path, shape, _ in _layer_leaves(cfg)})
        if cfg.family == "hybrid":
            shapes.update({("stack",) + path: shape
                           for path, shape, _ in hybrid_leaves(cfg)})
    if not cfg.tie_embeddings:
        shapes[("head",)] = (C, D, cfg.vocab_size)
    return shapes


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def params_from_reference(tree, cfg: ModelConfig,
                          device: torch.device | str = "cpu") -> dict:
    """Turn the reference's parameter pytree — a nested dict whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``) — into the
    port's parameters on ``device``, in ``cfg.param_dtype``.

    A leaf with ``q`` and ``scale`` (the reference's ``QuantizedWeight``)
    is carried over as int8 ``q`` and float32 ``scale``, not cast. Raises
    ``ValueError`` naming the leaf when the tree does not have exactly the
    leaves and shapes the port's stack expects for ``cfg`` (an
    MoE tree for a dense config, a shared expert ``cfg`` does not have, or
    a bias or norm leaf it does not have, is refused, not partly
    loaded).
    """
    want = _expected_shapes(cfg)
    got = dict(_flatten(tree))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"unexpected {extra}")
    pdt = _dt(cfg.param_dtype)
    out: dict = {}
    for path, leaf in got.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            node[path[-1]] = _quantized(leaf, want[path], path, device)
            continue
        arr = np.asarray(leaf)
        if tuple(arr.shape) != want[path]:
            raise ValueError(f"leaf {'/'.join(path)}: shape {arr.shape}, "
                             f"expected {want[path]}")
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)   # e.g. bfloat16 host arrays
        # torch.tensor copies: host arrays handed over may be read-only
        node[path[-1]] = torch.tensor(arr).to(device=device, dtype=pdt)
    return out


def _quantized(leaf, shape, path, device) -> QuantizedWeight:
    q, scale = np.asarray(leaf.q), np.asarray(leaf.scale)
    want_scale = tuple(shape[:-2]) + (1, shape[-1])
    if tuple(q.shape) != shape or tuple(scale.shape) != want_scale \
            or q.dtype != np.int8:
        raise ValueError(f"leaf {'/'.join(path)}: quantized q {q.dtype} "
                         f"{q.shape}, scale {scale.shape}; expected int8 "
                         f"{shape} and {want_scale}")
    return QuantizedWeight(
        q=torch.tensor(q).to(device),
        scale=torch.tensor(scale.astype(np.float32)).to(device))
