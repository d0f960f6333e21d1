"""Decoder assembly: blocks, the layer loop, decode caches.

Counterpart of ``repro.models.transformer``. Per-layer parameters stay
stacked with a leading L axis, as the reference keeps them
(``params["layers"]["wq"]`` is ``(L, D, H*dh)``); the reference's
``lax.scan`` over that axis is a Python loop here, indexing views. An
attention stack's decode cache is a dict of stacked ``(L, B, S, KV, dh)``
tensors; the rwkv6 stack's is the recurrent carry stacked over layers,
``{"ssm": {"att_x" (L,B,D), "ffn_x" (L,B,D), "state" (L,B,H,dk,dk)
float32}}``, with no seq axis; the hybrid stack's both, ``{"ssm": {"conv"
(L,B,3,d_inner+2N), "ssm" (L,B,H,N,P) float32}, "k" / "v" (n_inv,B,S,KV,
dh)}``, one K/V slab a shared-block invocation.

The dense family's features are built: qk-norm (qwen3), qkv biases
(qwen2.5, stablelm), LayerNorm and partial rotary (stablelm); the MoE
family's block (:mod:`repro_torch.models.moe`, mixtral and llama4-scout),
which takes the MLP's place; and the modality-stub families' (qwen2-vl's
M-RoPE, musicgen's gelu MLP; their sinusoidal positions, codebooks and
vision stub live in :mod:`repro_torch.models.model`); and the family
``ssm`` stack of RWKV6 blocks (:mod:`repro_torch.models.ssm`, rwkv6-1.6b);
and the hybrid stack (zamba2-2.7b): groups of ``hybrid_period`` Mamba2
blocks, each group followed by one *shared* attention + MLP block whose q
projection takes a per-invocation LoRA delta, merged on every call.
:func:`stack_train` runs every family's stack for training: no cache,
nothing written in place, each layer recomputed in the backward under
``cfg.remat``.

Sequence parallelism (the logical ``"seq"`` axis bound to the model
ranks, ``--sp``): an attention block whose residual stream ``x`` is this
rank's slice of the sequence (fewer rows than ``positions``) norms the
slice, gathers it once for its column-parallel projections and
reduce-scatters its row-parallel outputs back to the slice
(:func:`attn_block_train`). ZeRO-3: a layer's parameters may arrive as
:class:`~repro_torch.launch.sharding.DataSplit` handles, gathered at the
layer's start (:func:`~repro_torch.launch.sharding.gathered`), inside the
recomputed region under ``cfg.remat``.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import serving_segments
from repro_torch.launch.sharding import (
    P,
    _gather,
    all_gather,
    all_reduce,
    gathered,
    logical_axis_size,
    rank_in,
    scatter_to,
    seq_params,
    whole,
)
from .layers import (
    QuantizedWeight,
    apply_norm,
    apply_rope,
    chunked_attention,
    decode_attention_append,
    dense,
    flash_attention,
    mlp,
    nest,
    rmsnorm,
    rope_tables,
    uniform_,
)
from .moe import moe_ffn, moe_leaves
from .ssm import (
    mamba2_block,
    mamba2_empty_carry,
    mamba2_leaves,
    rwkv6_block,
    rwkv6_empty_carry,
    rwkv6_leaves,
)


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for architecture features the port does not build: a family
    other than the reference's, a hybrid stack that is not Mamba2 groups
    of ``hybrid_period > 0`` layers with a whole number of groups (the
    reference's stack would drop the remainder), experts outside an MoE
    stack, and activations or position embeddings the reference does not
    have either."""
    hybrid = cfg.family == "hybrid"
    missing = [name for name, on in (
        ("family " + cfg.family,
         cfg.family not in ("dense", "moe", "vlm", "audio", "ssm",
                            "hybrid")),
        (f"hybrid ssm {cfg.ssm!r}", hybrid and cfg.ssm != "mamba2"),
        (f"hybrid_period {cfg.hybrid_period}",
         hybrid and cfg.hybrid_period <= 0),
        (f"n_layers {cfg.n_layers} not a multiple of hybrid_period "
         f"{cfg.hybrid_period}", hybrid and cfg.hybrid_period > 0
         and cfg.n_layers % cfg.hybrid_period != 0),
        ("n_experts", bool(cfg.n_experts) and cfg.family != "moe"),
        ("act " + cfg.act, cfg.act not in ("swiglu", "gelu")),
        ("pos_emb " + cfg.pos_emb, cfg.pos_emb not in ("rope", "sin")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def _rwkv6_heads(cfg: ModelConfig) -> int:
    """The rwkv6 stack's heads: the reference sizes them by d_head."""
    return cfg.d_model // cfg.d_head


# ------------------------------------------------------------------- init --
def _layer_leaves(cfg: ModelConfig):
    """One layer's leaves ``(path, shape, init)`` in the reference's tree
    and in the order their random draws are made; ``init`` is a fan-in
    (uniform(+-fan_in^-0.5)), ``"ones"`` (norm gains), ``"zeros"``
    (biases), or for the recurrent layers ``("limit", lim)``
    (uniform(+-lim)), ``("full", value)`` (a constant) and
    ``("loglinspace", (lo, hi))`` (Mamba2's ``A_log``)."""
    if cfg.family == "ssm":
        return rwkv6_leaves(cfg.d_model, _rwkv6_heads(cfg), cfg.d_ff)
    if cfg.family == "hybrid":
        return mamba2_leaves(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
    return _attn_leaves(cfg)


def _attn_leaves(cfg: ModelConfig):
    """An attention block's leaves (:func:`_layer_leaves`' form): the
    attention stacks' layer and the hybrid stack's shared block."""
    H, KV, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    norm = [("w", "ones")] + ([("b", "zeros")] if cfg.norm == "layernorm"
                              else [])
    leaves = [(("ln_attn", k), (D,), how) for k, how in norm]
    leaves += [(("wq",), (D, H * dh), D), (("wk",), (D, KV * dh), D),
               (("wv",), (D, KV * dh), D), (("wo",), (H * dh, D), H * dh)]
    leaves += [(("ln_mlp", k), (D,), how) for k, how in norm]
    if cfg.qkv_bias:
        leaves += [(("bq",), (H * dh,), "zeros"),
                   (("bk",), (KV * dh,), "zeros"),
                   (("bv",), (KV * dh,), "zeros")]
    if cfg.qk_norm:
        leaves += [(("q_norm", "w"), (dh,), "ones"),
                   (("k_norm", "w"), (dh,), "ones")]
    if cfg.n_experts and cfg.family == "moe":
        leaves += [(("moe",) + path, shape, fan_in) for path, shape, fan_in
                   in moe_leaves(D, cfg.d_ff, cfg.n_experts,
                                 cfg.n_shared_experts)]
    else:
        # a gelu MLP has no gate: w1 and w2 alone, as init_attn_layer
        leaves += [(("mlp", "w1"), (D, cfg.d_ff), D),
                   (("mlp", "w2"), (cfg.d_ff, D), cfg.d_ff)]
        if cfg.act == "swiglu":
            leaves.append((("mlp", "w3"), (D, cfg.d_ff), D))
    return leaves


def _fill(t: torch.Tensor, init, gen: torch.Generator) -> torch.Tensor:
    if init == "ones":
        return t.fill_(1)
    if init == "zeros":
        return t.zero_()
    if isinstance(init, tuple):
        how, val = init
        if how == "full":
            return t.fill_(val)
        if how == "loglinspace":
            # the reference's log(linspace(lo, hi, n).astype(float32))
            lo, hi = val
            return t.copy_(torch.linspace(lo, hi, t.shape[-1],
                                          dtype=torch.float64,
                                          device=t.device)
                           .to(torch.float32).log_())
        # ("limit", lim) is uniform(+-lim): the fan-in lim^-2
        return uniform_(t, val ** -2, gen)
    return uniform_(t, init, gen)


def n_invocations(cfg: ModelConfig) -> int:
    """How many times the hybrid stack runs its shared block: once after
    each group of ``hybrid_period`` Mamba2 layers."""
    return cfg.n_layers // cfg.hybrid_period


def hybrid_leaves(cfg: ModelConfig):
    """The hybrid stack's leaves beside its layers, :func:`_layer_leaves`'
    form: the shared block's (unstacked; ``init_attn_layer``'s), then
    ``lora_a`` ``(n_inv, D, r)`` at fan-in D and ``lora_b`` ``(n_inv, r,
    H*dh)`` of zeros, one pair an invocation."""
    r, D = cfg.hybrid_lora_rank, cfg.d_model
    n_inv = n_invocations(cfg)
    return ([(("shared",) + path, shape, init)
             for path, shape, init in _attn_leaves(cfg)]
            + [(("lora_a",), (n_inv, D, r), D),
               (("lora_b",), (n_inv, r, cfg.n_heads * cfg.d_head),
                "zeros")])


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               shardings=None):
    """Stacked per-layer params (leading L axis): uniform(+-fan_in^-0.5)
    linears (an MoE block's experts and router too), unit norms, zero
    biases, and the recurrent layers' own limits and constants — the
    reference's distributions and tree; the random streams
    differ. Each stacked leaf is allocated once and filled layer by layer
    in :func:`_layer_leaves`' order: the values a ``torch.stack`` of
    whole per-layer draws gives, without a second copy of the
    parameters. The hybrid stack adds its shared block and LoRA pairs
    (:func:`hybrid_leaves`), drawn after the layers.

    ``shardings``: the stack's subtree of this rank's
    :class:`~repro_torch.launch.specs.Sharding`s (the layer axis never
    split). A split leaf is allocated at this rank's shape, and each
    layer's draw is made whole, as unsplit, and cut to its slice at once:
    the unsplit tree's values sliced, with one whole layer leaf beside
    the shards at most. A leaf split over the layers (ZeRO-3) holds this
    rank's layers; every layer's draw is still made, in order."""
    _check_ported(cfg)
    L = cfg.n_layers
    if L == 0:
        return {"layers": {}}
    leaves = _layer_leaves(cfg)
    shard = {path: _at(shardings["layers"], path) if shardings else None
             for path, _, _ in leaves}
    flat = {path: torch.empty(_local_shape((L,) + shape, shard[path]),
                              dtype=dtype, device=device)
            for path, shape, _ in leaves}
    # the layers each leaf holds here, and its cut within a layer
    held = {path: _held_layers(flat[path].shape[0], L, shard[path])
            for path, _, _ in leaves}
    inner = {path: _inner(shard[path]) for path, _, _ in leaves}
    for i in range(L):
        for path, shape, init in leaves:
            lo = held[path]
            mine = lo <= i < lo + flat[path].shape[0]
            if mine and flat[path].shape[1:] == shape:
                _fill(flat[path][i - lo], init, gen)
                continue
            whole = _fill(torch.empty(shape, dtype=dtype, device=device),
                          init, gen)
            if mine:
                flat[path][i - lo].copy_(inner[path].local(whole[None])[0])
            del whole
    out = {"layers": nest(flat)}
    if cfg.family == "hybrid":
        extra = {}
        for path, shape, init in hybrid_leaves(cfg):
            whole = _fill(torch.empty(shape, dtype=dtype, device=device),
                          init, gen)
            extra[path] = (whole if not shardings
                           else _at(shardings, path).local(whole).clone())
        out.update(nest(extra))
    return out


def _held_layers(n: int, L: int, sharding) -> int:
    """The first layer of a stacked leaf that holds ``n`` of ``L`` layers
    on this rank (its spec splits the layer axis where ``n < L``)."""
    if n == L:
        return 0
    from repro_torch.launch.specs import local_slice

    return int(local_slice(torch.arange(L), P(sharding.spec[0]),
                           sharding.mesh)[0])


def _inner(sharding):
    """A stacked leaf's sharding within a layer: its spec without the
    layer axis's entry (None unsplit)."""
    if sharding is None:
        return None
    from repro_torch.launch.specs import Sharding

    return Sharding(sharding.mesh, P(None, *tuple(sharding.spec)[1:]))


def _at(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _local_shape(shape: tuple, sharding) -> tuple:
    if sharding is None:
        return shape
    return tuple(sharding.local(torch.empty(shape, device="meta")).shape)


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s view of the stacked parameter tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters of a stack, ZeRO-3 slices gathered."""
    return gathered(layer_params(params["layers"], i))


# -------------------------------------------------------------- attention --
def _rope_for(cfg: ModelConfig, positions):
    """RoPE tables and rotated width for ``positions``: M-RoPE sections
    under ``cfg.mrope`` ((B,S,3) positions; (B,S) ones take plain RoPE),
    none under sinusoidal positions (added at the embedding)."""
    rot = int(cfg.d_head * cfg.partial_rotary)
    rot -= rot % 2
    if cfg.pos_emb != "rope" or rot == 0:
        return None, 0
    return rope_tables(positions, rot, cfg.rope_theta,
                       cfg.mrope_sections if cfg.mrope else None), rot


def check_mesh(cfg: ModelConfig) -> None:
    """Raise, with the reason, where the bound mesh's model axis would
    split ``cfg`` in a way the port does not run: a recurrent stack
    (rwkv6, or the hybrid's Mamba2 layers) whose heads the axis does not
    divide while their projections' widths split, which would cut a
    recurrent head. Every attention split runs, a cut head included
    (:func:`head_plan`): the model reads each weight's split from its
    width (:func:`_qkv`, :func:`_ffn`)."""
    tp = logical_axis_size("heads")
    if tp == 1:
        return
    if cfg.family == "ssm":
        H, width = _rwkv6_heads(cfg), cfg.d_model
    elif cfg.family == "hybrid":
        width = 2 * cfg.d_model
        H = width // cfg.ssm_head_dim
    else:
        return
    if H % tp and width % tp == 0:
        raise NotImplementedError(
            f"{cfg.name} at tp {tp}: the {cfg.family} stack's {width} "
            f"channels split over {tp} model ranks would cut one of its {H} "
            "recurrent heads")


def head_plan(H: int, KV: int, tp: int, r: int) -> tuple:
    """Which heads model rank ``r`` of ``tp`` attends with where the
    placement cuts a head: ``(q0, q1, kv0, kv1, per_head)``, query heads
    ``[q0, q1)`` over kv heads ``[kv0, kv1)``. With at least as many kv
    heads as ranks a rank takes whole GQA groups, ``KV / tp`` of them
    rounded up or down (every rank some, the first ranks the larger
    parts, as GSPMD's padded shards run); with fewer, ``H / tp`` query
    heads rounded likewise, a kv head held by every rank whose query
    heads it serves. Where those query heads span two kv heads without
    filling either (``per_head``), each query head attends alone with its
    kv head (G 1). The last ranks hold no head (``q0 == q1``) when
    ``H < tp``."""
    G = H // KV

    def cut(n: int, i: int) -> int:              # ceil(i * n / tp)
        return -(-i * n // tp)

    if KV >= tp:
        k0, k1 = cut(KV, r), cut(KV, r + 1)
        return k0 * G, k1 * G, k0, k1, False
    q0, q1 = cut(H, r), cut(H, r + 1)
    if q1 == q0:
        return q0, q1, 0, 0, False
    k0, k1 = q0 // G, (q1 - 1) // G + 1
    return q0, q1, k0, k1, k1 - k0 > 1


def _width(w) -> int:
    """A linear's output width as this rank holds it (an int8
    :class:`QuantizedWeight`'s too)."""
    return (w.q if isinstance(w, QuantizedWeight) else w).shape[-1]


def _rows(w) -> int:
    """A linear's input width as this rank holds it."""
    return (w.q if isinstance(w, QuantizedWeight) else w).shape[-2]


def _col(w, full: int, axis: str):
    """``dense``'s ``split`` for a column-parallel linear: ``("col",
    axis)`` where the placement gave this rank fewer than the ``full``
    output columns, else None (the weight is whole)."""
    return ("col", axis) if _width(w) < full else None


def _cut(p, cfg: ModelConfig) -> bool:
    """Whether the placement cut a head: ``wq`` split though the model
    ranks do not divide the query heads, or ``wk`` / ``wv`` split though
    they do not divide the kv heads."""
    tp = logical_axis_size("heads")
    dh = cfg.d_head
    return (_width(p["wq"]) < cfg.n_heads * dh and cfg.n_heads % tp != 0) \
        or (_width(p["wk"]) < cfg.n_kv_heads * dh
            and cfg.n_kv_heads % tp != 0)


def _whole(flat: list, fulls: list) -> list:
    """The whole of each (B,S,width) projection in ``flat`` that this
    rank holds a column split of (``fulls``: their whole widths): the
    split ones joined in one ``all_gather`` over the model ranks (its
    gradient summed over them: each rank goes on with heads of its
    own)."""
    split = [i for i, (t, n) in enumerate(zip(flat, fulls))
             if t.shape[-1] < n]
    if not split:
        return flat
    tp = logical_axis_size("heads")
    widths = [flat[i].shape[-1] for i in split]
    g = all_gather(torch.cat([flat[i] for i in split], -1), "heads", -1,
                   grad="sum")
    g = g.reshape(*g.shape[:-1], tp, sum(widths))
    out = list(flat)
    for i, piece in zip(split, g.split(widths, -1)):
        out[i] = piece.reshape(*piece.shape[:-2], tp * piece.shape[-1])
    return out


def _qkv(p, h, cfg: ModelConfig, rope, rot, whole: bool = False,
         seq: bool = False):
    """q, k, v of one block in heads: the linears, the biases (in the
    activation dtype), then qk-norm over d_head — always the exact
    ``rmsnorm``, as in the reference, whatever ``use_in_norm`` says —,
    then RoPE.

    On a bound mesh each weight's split is read from its own width: a
    ``wq`` narrower than ``H * dh`` is this rank's columns, a ``wk`` /
    ``wv`` narrower than ``KV * dh`` its kv columns; a whole one is
    replicated. Where the columns cut a head (:func:`_cut`), or with
    ``whole``, the split ones are gathered first (:func:`_whole`): then
    every head comes back.

    ``seq``: ``h`` is this rank's slice of the sequence, gathered once
    for the three column-parallel projections (each reduce-scatters its
    input gradient); q, k and v come back whole along the sequence."""
    dh = cfg.d_head
    cols = [_col(p["wq"], cfg.n_heads * dh, "heads")] \
        + [_col(p["wk"], cfg.n_kv_heads * dh, "kv")] * 2
    full = None
    if seq:
        _sp_split(cfg, all(cols), "wq / wk / wv")
        full = _gather(h, "heads", 1)
        cols = [c + ("seq",) for c in cols]
    q, k, v = (dense(h, p[name], cfg.approx, c, full)
               for name, c in zip(("wq", "wk", "wv"), cols))
    B, S = q.shape[:2]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if whole or _cut(p, cfg):
        q, k, v = _whole([q, k, v], [cfg.n_heads * dh,
                                     cfg.n_kv_heads * dh,
                                     cfg.n_kv_heads * dh])
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"]["w"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"]["w"], cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    return q, k, v


def _plan_heads(q, k, v, cfg: ModelConfig):
    """This rank's heads of the whole q / k / v (:func:`head_plan`) in
    the attention layout: ``(qs (B,S,KVloc,Gloc,dh), ks, vs, plan)``."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    plan = head_plan(H, KV, logical_axis_size("heads"), rank_in("heads"))
    q0, q1, k0, k1, per_head = plan
    B, S = q.shape[:2]
    if per_head:
        idx = torch.arange(q0, q1, device=k.device) // G
        return (q[:, :, q0:q1, None], k.index_select(2, idx),
                v.index_select(2, idx), plan)
    n_kv = max(k1 - k0, 1)
    return (q[:, :, q0:q1].reshape(B, S, k1 - k0, (q1 - q0) // n_kv,
                                   cfg.d_head),
            k[:, :, k0:k1], v[:, :, k0:k1], plan)


def _join_heads(o, cfg: ModelConfig):
    """The whole (B,S,H*dh) attention output from every rank's heads
    (:func:`head_plan`): each rank's part padded to the largest, one
    ``all_gather`` over the model ranks (its gradient summed over them),
    the padding dropped."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    tp = logical_axis_size("heads")
    sizes = [(q1 - q0) * dh for q0, q1, *_ in
             (head_plan(H, KV, tp, r) for r in range(tp))]
    top = max(sizes)
    g = all_gather(torch.nn.functional.pad(o, (0, top - o.shape[-1])),
                   "heads", -1, grad="sum")
    return torch.cat([g[..., r * top:r * top + n]
                      for r, n in enumerate(sizes)], -1)


def _sp_split(cfg: ModelConfig, split: bool, what: str) -> None:
    """Raise where sequence parallelism meets a linear the model ranks do
    not split: its weight's gradient would come from this rank's rows
    alone."""
    if not split:
        raise NotImplementedError(
            f"{cfg.name}: sequence parallelism over "
            f"{logical_axis_size('seq')} model ranks with {what} whole "
            "(its width does not divide): every linear of an attention "
            "block must split")


def _wo(p, o, x, cfg: ModelConfig, seq: bool = False):
    """``x + o @ wo``: a split ``wo`` is row-parallel — its rows of the
    whole ``o`` (this rank's slice where ``o`` is whole here), the partial
    sums added —, so the residual stream stays replicated over the model
    ranks. ``seq``: ``x`` is this rank's slice of the sequence (``o``
    whole along it): the partial sums are reduce-scattered to the slice."""
    full = cfg.n_heads * cfg.d_head
    rows = _rows(p["wo"])
    if rows == full:
        return x + dense(o, p["wo"], cfg.approx)
    if o.shape[-1] == full:
        o = o.narrow(-1, rank_in("heads") * rows, rows)
    return x + dense(o, p["wo"], cfg.approx,
                     ("row", "heads") + (("seq",) if seq else ()))


def attn_block_train(p, x, cfg: ModelConfig, positions, train=False):
    """Full-sequence block (train / prefill). Returns (x', (k, v), aux):
    ``aux`` is an MoE block's load-balance loss (float32 zero for an MLP);
    an MoE block dispatches at ``cfg.moe_capacity_factor``. ``train``
    takes the differentiable :func:`chunked_attention` whatever backend
    the config resolves (the attention kernels are forward-only).

    On a bound mesh the K/V returned are laid out as the decode cache
    holds them (:func:`cache_kv`). Three layouts: this rank's kv heads and
    their query groups (the model ranks divide the kv heads); its query
    heads over K/V whole and repeated (they divide the query heads, the
    K/V columns stay whole); and, where a split cuts a head, every head
    gathered, this rank's heads attended (:func:`head_plan`) and the
    output gathered back before ``wo``.

    Sequence parallelism: where ``x`` has fewer rows than ``positions``
    it is this rank's slice of the sequence (the reference's
    ``shard(x, "batch", "seq", None)``): the norms run on the slice, the
    projections and the attention on the whole sequence (:func:`_qkv`),
    ``wo`` and the MLP's ``w2`` reduce-scatter back to the slice; the
    norms' weights, used on this rank's rows alone, have their gradients
    summed over the ranks (:func:`~repro_torch.launch.sharding.copy_to`
    over ``"seq"``)."""
    B, S = x.shape[0], positions.shape[1]
    seq = x.shape[1] < S
    if seq:
        p = dict(p, ln_attn=seq_params(p["ln_attn"]),
                 ln_mlp=seq_params(p["ln_mlp"]))
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    rope, rot = _rope_for(cfg, positions)
    h = apply_norm(x, p["ln_attn"], cfg.norm, cfg.norm_eps, cfg.approx)
    cut = _cut(p, cfg)
    q, k, v = _qkv(p, h, cfg, rope, rot, seq=seq)
    h_loc, kv_loc = q.shape[2], k.shape[2]
    if cut:
        qs, ks, vs, _ = _plan_heads(q, k, v, cfg)
    elif h_loc == kv_loc * G:
        # whole, or this rank's kv heads and their query groups
        qs, ks, vs = q.reshape(B, S, kv_loc, G, dh), k, v
    else:
        # wq split, K/V whole: the reference's other tensor-parallel
        # layout, query heads flattened, K/V repeated G-fold and this
        # rank's heads taken
        qs = q.reshape(B, S, h_loc, 1, dh)
        ks = scatter_to(k.repeat_interleave(G, dim=2), 2, "heads")
        vs = scatter_to(v.repeat_interleave(G, dim=2), 2, "heads")
    n_loc = qs.shape[2] * qs.shape[3]
    if n_loc:
        attend = chunked_attention if train else flash_attention
        o = attend(
            qs, ks, vs, causal=True,
            window=cfg.sliding_window, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, approx=cfg.approx,
        ).reshape(B, S, n_loc * dh)
    else:
        o = qs.new_zeros((B, S, 0))
    if cut:
        o = _join_heads(o, cfg)
    x = _wo(p, o, x, cfg, seq)
    h = apply_norm(x, p["ln_mlp"], cfg.norm, cfg.norm_eps, cfg.approx)
    y, aux = _ffn(p, h, cfg, cfg.moe_capacity_factor, seq)
    return x + y, (cache_kv(k, cfg), cache_kv(v, cfg)), aux


def cache_kv(t, cfg: ModelConfig):
    """A block's (B,S,kv,dh) K or V as the decode cache holds it on this
    rank (``specs.cache_specs``, sanitized): its kv heads where the model
    ranks divide them, else its slice of the sequence where they divide
    that, else whole. ``t`` is this rank's kv heads in the first case
    (or whole), whole in the others."""
    tp = logical_axis_size("kv")
    if tp == 1:
        return t
    r, KV, S = rank_in("kv"), cfg.n_kv_heads, t.shape[1]
    if KV % tp == 0:
        n = KV // tp
        return t if t.shape[2] == n else t.narrow(2, r * n, n)
    if S % tp == 0:
        return t.narrow(1, r * (S // tp), S // tp)
    return t


def _ffn(p, h, cfg: ModelConfig, capacity_factor: float,
         seq: bool = False):
    """The block's MLP, or its MoE, and the MoE's aux loss (a float32
    zero for an MLP; serving drops it, as the reference's does). ``seq``:
    ``h`` is this rank's slice of the sequence."""
    if seq:
        w1 = p["moe"]["w1"] if "moe" in p else p["mlp"]["w1"]
        _sp_split(cfg, _width(w1) < cfg.d_ff, "the MLP")
    if "moe" in p:
        return moe_ffn(h, p["moe"], top_k=cfg.n_experts_active,
                       capacity_factor=capacity_factor, approx=cfg.approx,
                       split=_width(p["moe"]["w1"]) < cfg.d_ff, seq=seq)
    return (mlp(h, p["mlp"], cfg.act, cfg.approx,
                split=_width(p["mlp"]["w1"]) < cfg.d_ff, seq=seq),
            _zero_aux(h.device))


def _zero_aux(device):
    return torch.zeros((), dtype=torch.float32, device=device)


def decode_slot(cfg: ModelConfig, Smax: int, pos):
    """Cache slot for the token at ``pos`` (ring for sliding-window)."""
    if cfg.sliding_window and Smax <= cfg.sliding_window:
        return pos % Smax
    return pos


def attn_block_decode(p, x, cfg: ModelConfig, cache, pos, positions,
                      seq=None):
    """Single-token block against a *read-only* cache.

    x: (B,1,D); cache {k,v}: (B,Smax,KV,dh). Returns (x', (k_new, v_new))
    where k_new/v_new are the (B,1,KV,dh) slabs the caller writes into the
    stacked cache buffer.

    On a bound mesh the cache is laid out as :func:`cache_kv` lays it: this
    rank's kv heads (where the model ranks divide them: its query groups
    attend over them, one kernel call), else — every head of q, k and v
    gathered — its slice of the sequence, ``seq = (first slot, whole
    cache's slots)``, combined over the ranks (:func:`_decode_seq_split`),
    or the whole cache. ``k_new`` / ``v_new`` are then whole too."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    Smax = cache["k"].shape[1] if seq is None else seq[1]
    rope, rot = _rope_for(cfg, positions)
    h = apply_norm(x, p["ln_attn"], cfg.norm, cfg.norm_eps, cfg.approx)
    tp = logical_axis_size("kv")
    by_heads = KV % tp == 0
    q, k, v = _qkv(p, h, cfg, rope, rot, whole=not by_heads)
    if by_heads and tp > 1 and k.shape[2] == KV:
        n, r = KV // tp, rank_in("kv")
        k, v = k.narrow(2, r * n, n), v.narrow(2, r * n, n)
        q = q.narrow(2, r * n * G, n * G)
    ring_full = bool(cfg.sliding_window and Smax <= cfg.sliding_window)
    slot = decode_slot(cfg, Smax, pos)
    window = 0 if ring_full else cfg.sliding_window
    q = q.reshape(B, k.shape[2], G, dh)
    if seq is None:
        o = decode_attention_append(
            q, cache["k"], cache["v"], k, v, pos, slot, ring_full=ring_full,
            window=window, approx=cfg.approx)
    else:
        o = _decode_seq_split(q, cache["k"], cache["v"], k, v, pos, slot,
                              seq, ring_full=ring_full, window=window,
                              approx=cfg.approx)
    x = _wo(p, o.reshape(B, 1, -1), x, cfg)
    h = apply_norm(x, p["ln_mlp"], cfg.norm, cfg.norm_eps, cfg.approx)
    # the reference's decode step fixes the MoE capacity factor at 4.0
    y, _ = _ffn(p, h, cfg, 4.0)
    return x + y, (k.to(cache["k"].dtype), v.to(cache["v"].dtype))


def _decode_seq_split(q, k_cache, v_cache, k_new, v_new, pos, slot, seq, *,
                      ring_full, window, approx):
    """:func:`~repro_torch.models.layers.decode_attention_append` over a
    cache whose sequence the model ranks split (``seq = (this rank's
    first slot, the whole cache's slots)``), every head on every rank:
    each rank's scores over its slots, the row maxima's ``all_reduce``
    MAX, each rank's ``exp`` sums and ``p . V`` (the new token's term on
    model rank 0 alone), one ``all_reduce`` SUM of both, then the
    finalize ``acc / l`` (the SIMDive divider where the config asks for
    it). The whole cache's arithmetic, the sums over ranks in another
    order. ``pos`` / ``slot``: ints, or (B,) tensors (per-row positions:
    each row's valid slots counted against its own position)."""
    from repro_torch.kernels.decode_attention import history_valid
    from repro_torch.launch.sharding import all_reduce_max
    from .layers import _finalize

    lo, Smax = seq
    B, n, KVH, dh = k_cache.shape
    f32 = torch.float32
    scale = dh ** -0.5
    qf = q.to(f32)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.to(f32)) * scale
    valid = history_valid(Smax, pos, slot, ring_full=ring_full,
                          window=window, device=q.device)[..., lo:lo + n]
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    s_self = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, 0].to(f32)) * scale
    if rank_in("kv"):
        s_self = torch.full_like(s_self, float("-inf"))
    m = all_reduce_max(torch.maximum(s.amax(dim=-1), s_self), ["kv"])
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1) + p_self
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    acc = acc + p_self[..., None] * v_new[:, 0].to(f32)[:, :, None, :]
    both = all_reduce(torch.cat([acc.reshape(-1), l.reshape(-1)]), "kv")
    acc = both[:acc.numel()].view(acc.shape)
    l = both[acc.numel():].view(l.shape)
    return _finalize(acc, l, approx).to(q.dtype)


# ------------------------------------------------------------ layer stack --
def _approx_segments(cfg: ModelConfig):
    """Policy-resolved layer segments ``((lo, hi, seg_cfg), ...)``:
    contiguous layer runs whose ``ApproxConfig`` resolves identically under
    ``cfg.approx.policy``, each with a ``ModelConfig`` carrying that run's
    layer-labelled approx config. No policy yields one segment with the
    original ``cfg``."""
    segs = serving_segments(cfg.approx, cfg.n_layers)
    if len(segs) == 1 and segs[0][2] == cfg.approx:
        return ((0, cfg.n_layers, cfg),)
    # keep the layer label even for a single segment: a uniform
    # layer-scoped policy still needs cfg.approx.layer set for lookup
    return tuple((lo, hi, replace(cfg, approx=acfg))
                 for lo, hi, acfg in segs)


def _token_index(slot, batch: int, device):
    """Where :func:`_write_token` writes the decoded token: a scalar
    ``slot`` as an int (one strided write), a (B,) ``slot`` — per-row
    positions, read on the card — as ``(rows, slot)``, built once a step
    for every layer's writes."""
    if torch.is_tensor(slot) and slot.ndim:
        return torch.arange(batch, device=device), slot
    return int(slot)


def _owned_rows(local, n: int):
    """Where :func:`_write_token` writes per-row slots ``local`` (B,)
    (relative to this rank's first slot) on a rank holding ``n`` slots of
    the sequence: ``(rows, slots, owned)``, a row's slot clamped into the
    rank's range and written only where ``owned`` (read on the card:
    nothing reaches the host)."""
    owned = (local >= 0) & (local < n)
    rows = torch.arange(local.shape[0], device=local.device)
    return rows, local.clamp(0, n - 1), owned


def _write_token(buf, i, at, new):
    """Write one decoded token's (B,1,KV,dh) slab into the stacked
    (L,B,Smax,KV,dh) cache at layer ``i``, at ``at`` (:func:`_token_index`)
    — **in place** (where the reference updates a donated buffer): a seq
    slot, or each row at its own depth; nothing where ``at`` is None.
    Returns ``buf``.
    """
    if at is None:                     # another rank holds the slot
        return buf
    if isinstance(at, tuple) and len(at) == 3:
        rows, slot, owned = at          # this rank's rows of the slots
        old = buf[i, rows, slot]
        buf[i, rows, slot] = torch.where(owned[:, None, None], new[:, 0],
                                         old)
    elif isinstance(at, tuple):
        rows, slot = at
        buf[i, rows, slot] = new[:, 0]
    else:
        buf[i, :, at] = new[:, 0]
    return buf


def hybrid_shared(params, g: int, dtype, width: int | None = None):
    """The shared block's parameters for invocation ``g``: its own, with
    ``wq + lora_a[g] @ lora_b[g]`` in place of ``wq``, the LoRA pair cast
    to the activation ``dtype`` first, as in the reference. The merge is
    made on every call, as the reference makes it (a ``(D, r) @ (r, H*dh)``
    product and a ``(D, H*dh)`` float32 sum each time). An int8 ``wq``
    (``--quantize``) raises: the reference's prefill cannot add the delta
    to a ``QuantizedWeight`` (a ``TypeError``), and its decode step would
    skip the LoRA.

    ``width``: ``H * dh``, the whole ``wq``'s columns. On a bound mesh
    whose model ranks split ``wq`` and ``lora_b`` by columns, ``lora_b``
    is gathered and the whole product made, then this rank's columns
    taken: the unsplit merge's values bit for bit (the product of a
    column slice may round differently), which the SIMDive ``wq`` after
    it quantizes."""
    sp = gathered(dict(params["shared"]))
    if isinstance(sp["wq"], QuantizedWeight):
        raise NotImplementedError(
            "the hybrid stack's shared block merges a per-invocation LoRA "
            "delta into wq on every call; an int8 wq (--quantize) cannot "
            "take it (the reference's prefill raises TypeError there)")
    la = whole(params["lora_a"][g]).to(dtype)
    lb = whole(params["lora_b"][g]).to(dtype)
    if width is not None and lb.shape[-1] < width:
        delta = scatter_to(la @ all_gather(lb, "heads", -1), 1, "heads")
    else:
        delta = la @ lb
    sp["wq"] = sp["wq"] + delta
    return sp


def _q_width(cfg: ModelConfig) -> int:
    return cfg.n_heads * cfg.d_head


def _hybrid_groups(cfg: ModelConfig):
    """``(g, range of g's Mamba2 layers)`` for each shared-block
    invocation."""
    P = cfg.hybrid_period
    return ((g, range(g * P, (g + 1) * P)) for g in range(n_invocations(cfg)))


def unbind_layers(layers: dict, n: int) -> list:
    """The stacked parameter tree as ``n`` per-layer trees, each leaf
    ``unbind``-ed once: the backward stacks the layers' gradients into one
    tensor a leaf, where indexing layer by layer (:func:`layer_params`)
    would add a full-size zero-padded gradient a layer."""
    if not layers:
        return [{} for _ in range(n)]
    flat = {k: (unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0))
            for k, v in layers.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``cfg.remat`` recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint`` a layer). The numbers do not change; the layer's
    forward kernels launch once more in the backward."""
    if cfg.remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _carry0(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """A zero recurrent carry as a layer computes on it: on a bound mesh
    this rank's heads of the state (and, for Mamba2, its x channels of
    the conv window), the token shifts whole."""
    tp = logical_axis_size("heads")
    if cfg.family == "ssm":
        H = _rwkv6_heads(cfg)
        split = tp > 1 and cfg.d_model % tp == 0
        return rwkv6_empty_carry(batch, cfg.d_model, H, dtype, device,
                                 H // tp if split else None)
    inner = 2 * cfg.d_model
    split = tp > 1 and inner % tp == 0
    return mamba2_empty_carry(batch, cfg.d_model, cfg.ssm_state,
                              cfg.ssm_head_dim, dtype, device,
                              inner // tp if split else None)


def _whole_dim(t, full: int):
    """``t`` whole along its last dim (``full`` wide): gathered over the
    model ranks where this rank holds a slice."""
    if t.shape[-1] == full:
        return t
    return all_gather(t.contiguous(), "heads", -1)


def _cut_dim(t, full: int):
    """This rank's slice of the last dim of a whole ``t`` where the decode
    cache splits it over the model ranks (``specs.cache_specs``:
    ``full`` divides), else ``t``."""
    tp = logical_axis_size("heads")
    if tp == 1 or full % tp:
        return t
    n = full // tp
    return t.narrow(-1, rank_in("heads") * n, n)


def _carry_in(cfg: ModelConfig, c: dict) -> dict:
    """One layer's recurrent carry from the decode cache's layout
    (:func:`_carry_out`) into the one the layer computes on
    (:func:`_carry0`)."""
    if logical_axis_size("heads") == 1:
        return c
    D = cfg.d_model
    if cfg.family == "ssm":
        return {"att_x": _whole_dim(c["att_x"], D),
                "ffn_x": _whole_dim(c["ffn_x"], D), "state": c["state"]}
    inner, N = 2 * D, cfg.ssm_state
    conv = _whole_dim(c["conv"], inner + 2 * N)
    n = c["ssm"].shape[1] * cfg.ssm_head_dim
    if n < inner:
        lo = rank_in("heads") * n
        conv = torch.cat([conv[..., lo:lo + n], conv[..., inner:]], -1)
    return {"conv": conv, "ssm": c["ssm"]}


def _carry_out(cfg: ModelConfig, c: dict) -> dict:
    """A layer's new carry as the decode cache holds it on this rank
    (``specs.cache_specs``, sanitized): the token shifts' and the conv
    window's channels split where the model ranks divide them, the states
    by head (as computed)."""
    if logical_axis_size("heads") == 1:
        return c
    D = cfg.d_model
    if cfg.family == "ssm":
        return {"att_x": _cut_dim(c["att_x"], D),
                "ffn_x": _cut_dim(c["ffn_x"], D), "state": c["state"]}
    inner, N = 2 * D, cfg.ssm_state
    conv = c["conv"]
    n = conv.shape[-1] - 2 * N
    if n < inner:
        conv = torch.cat([_whole_dim(conv[..., :n], inner),
                          conv[..., n:]], -1)
    return {"conv": _cut_dim(conv, inner + 2 * N), "ssm": c["ssm"]}


def stack_train(params, x, cfg: ModelConfig, positions):
    """The layer stack over (B,S,D) with nothing cached: returns (x, aux),
    ``aux`` the summed MoE load-balance losses (float32; zero without
    experts). The attention stacks run one pass per policy segment
    (:func:`_approx_segments`), attention on :func:`chunked_attention`;
    the rwkv6 stack runs every layer from a zero carry; the hybrid stack
    each group of ``hybrid_period`` Mamba2 layers (each from a zero
    carry), then the shared block with the group's LoRA merged into
    ``wq``. Under ``cfg.remat`` each layer (a Mamba2 or rwkv6 layer, an
    attention block; not the hybrid's shared block) is recomputed in the
    backward, as in the reference. Nothing is written in place."""
    _check_ported(cfg)
    check_mesh(cfg)
    aux = _zero_aux(x.device)
    if cfg.n_layers == 0:
        return x, aux
    layers = unbind_layers(params["layers"], cfg.n_layers)
    if cfg.family == "ssm":
        H = _rwkv6_heads(cfg)
        carry0 = _carry0(cfg, x.shape[0], x.dtype, x.device)

        def rwkv6_layer(p, xc):
            return rwkv6_block(gathered(p), xc, carry0, H, cfg.ssm_chunk,
                               cfg.approx, cfg.d_ff)[0]

        for p in layers:
            x = _remat(cfg, rwkv6_layer, p, x)
        return x, aux
    if cfg.family == "hybrid":
        carry0 = _carry0(cfg, x.shape[0], x.dtype, x.device)

        def mamba2_layer(p, xc):
            return mamba2_block(gathered(p), xc, carry0, cfg.ssm_state,
                                cfg.ssm_head_dim, cfg.ssm_chunk,
                                cfg.approx)[0]

        for g, group in _hybrid_groups(cfg):
            for i in group:
                x = _remat(cfg, mamba2_layer, layers[i], x)
            x, _, a = attn_block_train(hybrid_shared(params, g, x.dtype,
                                                     _q_width(cfg)), x,
                                       cfg, positions, train=True)
            aux = aux + a
        return x, aux
    for lo, hi, seg_cfg in _approx_segments(cfg):
        def attn_layer(p, xc, seg_cfg=seg_cfg):
            y, _, a = attn_block_train(gathered(p), xc, seg_cfg, positions,
                                       train=True)
            return y, a

        for i in range(lo, hi):
            x, a = _remat(cfg, attn_layer, layers[i], x)
            aux = aux + a
    return x, aux


def stack_prefill(params, x, cfg: ModelConfig, positions):
    """Full-sequence forward that also returns the decode cache: per-layer
    K/V stacked (L,B,S,KV,dh), cache seq length == S; for the rwkv6 stack
    each layer's final recurrent carry, stacked (each layer starts from a
    zero carry, and runs ``cfg.approx`` whole: no policy segments, as in
    the reference); for the hybrid stack each Mamba2 layer's final carry
    (each from a zero carry) and each shared-block invocation's K/V, the
    whole stack at ``cfg.approx``, as in the reference. On a bound mesh
    the cache comes back as this rank holds it (:func:`cache_kv`,
    :func:`_carry_out`)."""
    _check_ported(cfg)
    check_mesh(cfg)
    if cfg.n_layers == 0:
        return x, empty_cache(cfg, x.shape[0], x.shape[1], x.dtype, x.device)
    if cfg.family == "hybrid":
        carry0 = _carry0(cfg, x.shape[0], x.dtype, x.device)
        carries, ks, vs = [], [], []
        for g, layers in _hybrid_groups(cfg):
            for i in layers:
                x, c = mamba2_block(_layer(params, i), x,
                                    carry0, cfg.ssm_state, cfg.ssm_head_dim,
                                    cfg.ssm_chunk, cfg.approx)
                carries.append(_carry_out(cfg, c))
            x, (k, v), _ = attn_block_train(
                hybrid_shared(params, g, x.dtype, _q_width(cfg)), x, cfg,
                positions)
            ks.append(k)
            vs.append(v)
        return x, {"ssm": {name: torch.stack([c[name] for c in carries])
                           for name in carry0},
                   "k": torch.stack(ks).to(x.dtype),
                   "v": torch.stack(vs).to(x.dtype)}
    if cfg.family == "ssm":
        H = _rwkv6_heads(cfg)
        carry0 = _carry0(cfg, x.shape[0], x.dtype, x.device)
        carries = []
        for i in range(cfg.n_layers):
            x, c = rwkv6_block(_layer(params, i), x, carry0,
                               H, cfg.ssm_chunk, cfg.approx, cfg.d_ff)
            carries.append(_carry_out(cfg, c))
        return x, {"ssm": {k: torch.stack([c[k] for c in carries])
                           for k in carry0}}
    ks, vs = [], []
    for lo, hi, seg_cfg in _approx_segments(cfg):
        for i in range(lo, hi):
            x, (k, v), _ = attn_block_train(
                _layer(params, i), x, seg_cfg, positions)
            ks.append(k)
            vs.append(v)
    return x, {"k": torch.stack(ks).to(x.dtype),
               "v": torch.stack(vs).to(x.dtype)}


# ----------------------------------------------------------------- caches --
def empty_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device):
    """Decode cache dict (stacked over layers); zeros, each leaf its own
    buffer (the decode step writes them in place). On a bound mesh each
    leaf has this rank's shape (``specs.cache_specs``, sanitized: K/V by
    kv head, else by sequence; the recurrent states by head, the token
    shifts and the conv window by channel; a dim the model ranks do not
    divide whole); ``batch`` is this rank's rows."""
    _check_ported(cfg)
    KV, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    tp = logical_axis_size("heads")

    def local(shape: tuple, dim: int) -> tuple:
        if tp == 1 or shape[dim] % tp:
            return shape
        return shape[:dim] + (shape[dim] // tp,) + shape[dim + 1:]

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "ssm":
            c = rwkv6_empty_carry(batch, cfg.d_model, _rwkv6_heads(cfg),
                                  dtype, "meta")
        else:
            c = mamba2_empty_carry(batch, cfg.d_model, cfg.ssm_state,
                                   cfg.ssm_head_dim, dtype, "meta")
        # (L,B,D) token shifts and (L,B,K-1,C) conv split their last dim,
        # the (L,B,H,...) states their heads
        ssm = {k: zeros(local((L,) + tuple(a.shape),
                              2 if a.ndim >= 3 and k != "conv"
                              else a.ndim), a.dtype)
               for k, a in c.items()}
        if cfg.family == "ssm":
            return {"ssm": ssm}
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    n_kv = L
    out = {}
    if cfg.family == "hybrid":
        out["ssm"] = ssm
        n_kv = n_invocations(cfg)
    shape = (n_kv, batch, S, KV, dh)
    shape = local(shape, 3) if tp == 1 or KV % tp == 0 else local(shape, 2)
    for name in ("k", "v"):
        out[name] = zeros(shape)
    return out


def _seq_split(cfg: ModelConfig, max_seq):
    """``(this rank's first slot, the whole cache's slots)`` where the
    decode cache built for ``max_seq`` holds a slice of the sequence on a
    bound mesh (:func:`cache_kv`, :func:`empty_cache`), else None. Raises
    where only ``max_seq`` can tell (the model ranks do not divide the kv
    heads) and it is not given."""
    tp = logical_axis_size("kv")
    if tp == 1 or cfg.n_kv_heads % tp == 0:
        return None
    if max_seq is None:
        raise ValueError(
            f"{cfg.name} at tp {tp}: the decode cache splits its sequence "
            "where the model ranks divide it; pass the cache's max_seq")
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    if S % tp:
        return None
    return rank_in("kv") * (S // tp), S


def stack_decode(params, x, cfg: ModelConfig, cache, pos, positions,
                 max_seq=None):
    """One-token decode through the stack. x: (B,1,D). Writes one token
    per layer into ``cache`` in place and returns it: a K/V slot, or the
    recurrent layer's new carry (a chunk of one token, as the reference's
    step), copied over the old one after the layer has read it; the
    hybrid stack does both, a carry a Mamba2 layer and a K/V slot a
    shared-block invocation.

    ``max_seq``: the whole cache's slots, where a bound mesh may split its
    sequence (:func:`_seq_split`; ``LM.decode_step`` asks for it); a rank
    writes the new token only where it holds the slot."""
    _check_ported(cfg)
    check_mesh(cfg)
    if cfg.n_layers == 0:
        return x, cache
    if cfg.family == "ssm":
        H, st = _rwkv6_heads(cfg), cache["ssm"]
        for i in range(cfg.n_layers):
            x, c = rwkv6_block(_layer(params, i), x,
                               _carry_in(cfg, {k: a[i] for k, a in
                                               st.items()}), H, 1,
                               cfg.approx, cfg.d_ff)
            for k, a in _carry_out(cfg, c).items():
                st[k][i].copy_(a)
        return x, cache
    kc, vc = cache["k"], cache["v"]
    seq = _seq_split(cfg, max_seq)
    if seq is None:
        at = _token_index(decode_slot(cfg, kc.shape[2], pos), x.shape[0],
                          kc.device)
    elif torch.is_tensor(pos) and pos.ndim:
        # each row's slot, written by the rank that holds it
        at = _owned_rows(decode_slot(cfg, seq[1], pos) - seq[0],
                         kc.shape[2])
    else:
        at = decode_slot(cfg, seq[1], int(pos)) - seq[0]
        at = at if 0 <= at < kc.shape[2] else None
    if cfg.family == "hybrid":
        st = cache["ssm"]
        for g, layers in _hybrid_groups(cfg):
            for i in layers:
                x, c = mamba2_block(_layer(params, i), x,
                                    _carry_in(cfg, {k: a[i] for k, a in
                                                    st.items()}),
                                    cfg.ssm_state, cfg.ssm_head_dim, 1,
                                    cfg.approx)
                for k, a in _carry_out(cfg, c).items():
                    st[k][i].copy_(a)
            x, (k_new, v_new) = attn_block_decode(
                hybrid_shared(params, g, x.dtype, _q_width(cfg)), x, cfg,
                {"k": kc[g], "v": vc[g]}, pos, positions, seq)
            _write_token(kc, g, at, k_new)
            _write_token(vc, g, at, v_new)
        return x, cache
    for lo, hi, seg_cfg in _approx_segments(cfg):
        for i in range(lo, hi):
            x, (k_new, v_new) = attn_block_decode(
                _layer(params, i), x, seg_cfg,
                {"k": kc[i], "v": vc[i]}, pos, positions, seq)
            _write_token(kc, i, at, k_new)
            _write_token(vc, i, at, v_new)
    return x, cache
