"""Parameter / optimizer / input sharding specs, computed from shapes.

Counterpart of ``repro.launch.specs``. ``param_specs`` maps every leaf of
the model tree to a partition spec (:class:`~repro_torch.launch.sharding.P`)
by path pattern (tensor-parallel on ``'model'``); ``opt_specs``
additionally shards optimizer moments over the data axis (ZeRO-1);
``fsdp_specs`` shards each leaf's largest divisible dim; ``batch_specs``
and ``cache_specs`` give a batch's and a decode cache's shapes and specs;
``sanitize_specs`` replicates every dim a spec would split unevenly.

Every function takes shapes, not data: a leaf is anything with ``shape``
(a ``meta`` tensor, a :class:`TensorShape`), so the specs of a full-size
configuration are computed with nothing allocated
(:func:`param_shapes`). A mesh is anything with ``axis_names`` and
``shape``. :func:`local_slice` turns a spec into one rank's slice, the
one place the port does so (parameter placement and the elastic
``checkpoint.restore``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from .sharding import P, axis_sizes

__all__ = ["TensorShape", "param_shapes", "param_specs", "opt_specs",
           "fsdp_specs", "batch_axes_for", "batch_specs", "cache_specs",
           "as_shardings", "sanitize_specs", "Sharding", "local_slice"]


@dataclass(frozen=True)
class TensorShape:
    """A shape and dtype standing for an array (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


# path-pattern -> spec factory (first match wins); m='model'
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",                ("vocab_row",)),    # (n_emb, V, D)
    (r"head$",                 ("vocab_col",)),    # (n_emb, D, V)
    (r"(wq|wk|wv|w1|w3)$",     ("col",)),          # (L, D, out) -> out on m
    (r"(bq|bk|bv)$",           ("vec",)),          # (L, out)
    (r"(wo|w2)$",              ("row",)),          # (L, in, D) -> in on m
    (r"moe/router$",           ("rep",)),
    (r"moe/(w1|w3)$",          ("moe_col",)),      # (L, E, D, F)
    (r"moe/w2$",               ("moe_row",)),      # (L, E, F, D)
    (r"moe/shared/(w1|w3)$",   ("col",)),
    (r"moe/shared/w2$",        ("row",)),
    (r"(wr|wk|wv|wg|cm_wk|cm_wr|wz|wx|wdt)$", ("col",)),
    (r"(cm_wv|out_proj)$",     ("row",)),
    (r"u_bonus$",              ("heads_vec",)),    # (L, H, dk)
    (r"lora_a$",               ("rep",)),
    (r"lora_b$",               ("col",)),          # (n_inv, r, H*dh)
    (r"(conv_x)$",             ("conv_col",)),     # (L, K, d_inner)
    (r".*",                    ("rep",)),
]


def _leaf_spec(kind: str, ndim: int) -> P:
    m = "model"
    if kind == "rep":
        return P()
    if kind == "vocab_row":
        return P(None, m, None)
    if kind == "vocab_col":
        return P(None, None, m)
    if kind in ("col", "vec"):     # (..., D, out) / (..., out): shard last
        return P(*([None] * (ndim - 1) + [m]))
    if kind == "row":              # (..., in, D): shard second-to-last
        return P(*([None] * (ndim - 2) + [m, None]))
    if kind == "moe_col":          # (L, E, D, F)
        return P(None, None, None, m)
    if kind == "moe_row":          # (L, E, F, D)
        return P(None, None, m, None)
    if kind == "heads_vec":        # (L, H, dk)
        return P(None, m, None)
    if kind == "conv_col":         # (L, K, channels)
        return P(None, None, m)
    raise ValueError(kind)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _rebuild(tree, specs, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, specs, f"{prefix}{k}/")
                for k, v in tree.items()}
    return specs[prefix.rstrip("/")]


def _scale_spec(qspec: P, scale_ndim: int) -> P:
    """Spec for a QuantizedWeight's (…,1,N) scale: same as the weight's,
    minus the (size-1) reduced dim's sharding."""
    parts = list(qspec) + [None] * (scale_ndim - len(qspec))
    if len(parts) >= 2:
        parts[-2] = None
    return P(*parts[:scale_ndim])


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors: every leaf's
    shape and dtype, nothing allocated."""
    from repro_torch.models import build

    from .sharding import unbound

    with unbound():
        return build(cfg, "meta").init()


def param_specs(params_shape) -> dict:
    """Tree of partition specs matching the params tree.
    :class:`~repro_torch.models.layers.QuantizedWeight` leaves map to
    ``QuantizedWeight(q=spec, scale=spec)`` nodes."""
    from repro_torch.models.layers import QuantizedWeight

    specs = {}
    for path, leaf in _walk(params_shape):
        for pat, (kind,) in _PARAM_RULES:
            if re.search(pat, path):
                sp = _leaf_spec(kind, len(leaf.shape))
                if isinstance(leaf, QuantizedWeight):
                    sp = QuantizedWeight(q=sp, scale=_scale_spec(
                        sp, len(leaf.scale.shape)))
                specs[path] = sp
                break
    return _rebuild(params_shape, specs)


def _spec_map(fn, spec_tree, *rest):
    """``fn(leaf, *leaves)`` over a tree of specs (or shapes) and trees of
    its structure; a QuantizedWeight node maps field by field."""
    from repro_torch.models.layers import QuantizedWeight

    if isinstance(spec_tree, dict):
        return {k: _spec_map(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, QuantizedWeight):
        return QuantizedWeight(
            q=_spec_map(fn, spec_tree.q, *(r.q for r in rest)),
            scale=_spec_map(fn, spec_tree.scale, *(r.scale for r in rest)))
    return fn(spec_tree, *rest)


def opt_specs(pspecs, batch_axes=("data",)):
    """ZeRO-1: shard each moment additionally over the data axis, on the
    first dim the param spec leaves unsharded."""
    def zero1(spec):
        parts = list(spec)
        # idempotent: already sharded over a batch axis (e.g. FSDP params)
        for p in parts:
            axes = p if isinstance(p, tuple) else (p,)
            if any(a in batch_axes for a in axes):
                return spec
        for i in range(len(parts)):
            if parts[i] is None:
                parts[i] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
                return P(*parts)
        return spec

    return _spec_map(zero1, pspecs)


def fsdp_specs(params_shape, axes: tuple, mesh) -> dict:
    """ZeRO-3/FSDP: shard every leaf's largest divisible dim over ``axes``
    (falling back to replication for small/indivisible leaves)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    ax = axes if len(axes) > 1 else axes[0]

    def spec(leaf):
        shape = tuple(leaf.shape)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n == 0 and shape[i] >= n:
                parts = [None] * len(shape)
                parts[i] = ax
                return P(*parts)
        return P()

    return _spec_map(spec, params_shape)


def batch_axes_for(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(TensorShape, spec) dicts for the train/prefill batch."""
    ba = batch_axes_for(mesh)
    b = ba if len(ba) > 1 else (ba[0] if ba else None)
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    sds = {
        "tokens": TensorShape(tok_shape, torch.int32),
        "labels": TensorShape(tok_shape, torch.int32),
    }
    spec = {"tokens": P(b), "labels": P(b)}
    if cfg.mrope:
        sds["positions"] = TensorShape((B, S, 3), torch.int32)
        spec["positions"] = P(b)
    if cfg.vision_stub:
        n_p = min(1024, S // 4)
        sds["patch_embeds"] = TensorShape((B, n_p, cfg.d_model),
                                          torch.bfloat16)
        sds["patch_mask"] = TensorShape((B, S), torch.bool)
        spec["patch_embeds"] = P(b)
        spec["patch_mask"] = P(b)
    if shape.kind == "prefill":
        del sds["labels"], spec["labels"]
    return sds, spec


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(cache of ``meta`` tensors, spec tree) for the decode cache. K/V
    split by kv head where the kv heads divide the model axis, else by
    sequence (context-parallel decode)."""
    from repro_torch.models import build

    from .sharding import unbound

    ba = batch_axes_for(mesh)
    b = ba if len(ba) > 1 else (ba[0] if ba else None)
    B, S = shape.global_batch, shape.seq_len
    with unbound():                     # the whole cache's shapes
        cache = build(cfg, "meta").empty_cache(B, S)
    model_size = axis_sizes(mesh)["model"]
    specs = {}
    for path, leaf in _walk(cache):
        tail = path.split("/")[-1]
        if tail in ("k", "v"):
            if leaf.shape[3] % model_size == 0:
                specs[path] = P(None, b, None, "model", None)
            else:
                specs[path] = P(None, b, "model", None, None)
        elif tail == "conv":
            specs[path] = P(None, b, None, "model")         # (L,B,K-1,C)
        elif leaf.ndim >= 3:
            # recurrent states (L,B,H,...) / (L,B,D): shard 3rd dim on model
            specs[path] = P(None, b, "model", *([None] * (leaf.ndim - 3)))
        else:
            specs[path] = P(None, b)
    return cache, _rebuild(cache, specs)


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: P

    def local(self, t):
        return local_slice(t, self.spec, self.mesh)


def as_shardings(mesh, spec_tree):
    return _spec_map(lambda s: Sharding(mesh, s), spec_tree)


def sanitize_specs(spec_tree, shape_tree, mesh):
    """Drop per-dim shardings that do not divide the dim (the reference's
    jit argument shardings require exact divisibility)."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        ndim = len(leaf.shape)
        parts = list(spec)
        parts += [None] * (ndim - len(parts))
        for i, p in enumerate(parts):
            if p is None:
                continue
            axes = p if isinstance(p, tuple) else (p,)
            k = 1
            for a in axes:
                k *= sizes[a]
            if leaf.shape[i] % k != 0:
                parts[i] = None
        return P(*parts)

    return _spec_map(fix, spec_tree, shape_tree)


def local_slice(t, spec: P, mesh):
    """This rank's slice of the full tensor ``t`` under ``spec`` on
    ``mesh``: each dim a spec entry names is cut into equal parts over
    the product of its axes (major axis first, as ``NamedSharding``
    lays them out) and the part at this rank's coordinates kept. Raises
    where a dim does not divide (:func:`sanitize_specs` first)."""
    sizes = axis_sizes(mesh)
    for i, p in enumerate(spec):
        if p is None:
            continue
        axes = p if isinstance(p, tuple) else (p,)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + (mesh.coord(a) if sizes[a] > 1 else 0)
        if n == 1:
            continue
        if t.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        size = t.shape[i] // n
        t = t.narrow(i, idx * size, size)
    return t
