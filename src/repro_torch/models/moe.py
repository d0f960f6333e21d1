"""Mixture-of-Experts FFN with capacity-based dispatch (Switch-style).

Counterpart of ``repro.models.moe`` on one device. Tokens are scattered
into a static ``(G, E, C, D)`` capacity buffer by cumsum position, the
expert matmuls run as batched einsums over every expert, and the results
gather back weighted by the renormalised router probabilities. Tokens past
an expert's capacity ``C`` go to an overflow slot that is cut off: they are
dropped and fall through the residual connection.

Every step is a static-shape tensor op (comparisons, ``cumsum``,
``scatter_``, ``gather``): nothing reads a tensor on the host, so the
dispatch runs inside the captured prefill and decode graphs. Top-k is a
stable descending sort, so ties go to the lower expert index as in
``jax.lax.top_k`` (``torch.topk`` makes no such promise).

The routed experts are exact batched matmuls in the activation dtype, even
under ``ApproxConfig.emulate``; only the shared expert goes through
:func:`~repro_torch.models.layers.dense` (the SIMDive ``logmatmul`` kernel
when emulated), as in the reference.

On a bound mesh (:mod:`repro_torch.launch.sharding`) :func:`moe_ffn` takes
:func:`_moe_ffn_spmd`, the reference's ``shard_map`` path: dispatch local
to each data shard, the experts' hidden dim split over the model ranks,
one ``all_reduce`` of the token-space output, the load-balance statistics
averaged over the data ranks; its shared expert runs as plain matmuls, as
the reference's does. A call that takes the plain form with split weights
(a decode step's one token) sums the routed experts' partial output and
the shared expert's over ``"ff"`` as that path does. Under the experts
override (``{"experts": ("model",), "ff": ()}``) each model rank computes
its ``E / tp`` experts whole and the slot-space outputs are gathered
before the combine (:func:`_routed_by_expert`); with ``"ff"`` still on the
model axis the plain form raises, as the reference's ``shard`` does.
A call that makes one group of the batch (a decode step) whose rows the
data ranks split (:func:`~repro_torch.launch.sharding.global_batch`)
gathers every rank's expert choices first, so capacity and drops are the
whole batch's, as the reference's one group makes them; rows each rank
holds whole dispatch as they are.
Under sequence parallelism the block gathers the sequence first (the
dispatch is a sequence's) and reduce-scatters its output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig
from repro_torch.launch import sharding as shardlib
from .layers import EXACT, QuantizedWeight, dense, nest, uniform_


def moe_leaves(d_model, d_ff, n_experts, n_shared):
    """The block's leaves ``(path, shape, fan_in)`` in the order their
    random draws are made: each is uniform(+-fan_in^-0.5)."""
    D, Fd, E = d_model, d_ff, n_experts
    leaves = [(("router",), (D, E), D), (("w1",), (E, D, Fd), D),
              (("w3",), (E, D, Fd), D), (("w2",), (E, Fd, D), Fd)]
    if n_shared:
        leaves += [(("shared", "w1"), (D, Fd), D),
                   (("shared", "w3"), (D, Fd), D),
                   (("shared", "w2"), (Fd, D), Fd)]
    return leaves


def init_moe(gen: torch.Generator, d_model, d_ff, n_experts, n_shared,
             dtype, device):
    """The reference's leaves, shapes and distributions (``router (D,E)``,
    ``w1, w3 (E,D,F)``, ``w2 (E,F,D)``, ``shared/{w1,w3} (D,F)``,
    ``shared/w2 (F,D)``); the random streams differ."""
    return nest({path: uniform_(torch.empty(shape, dtype=dtype,
                                            device=device), fan_in, gen)
                 for path, shape, fan_in in moe_leaves(
                     d_model, d_ff, n_experts, n_shared)})


def _dispatch(xt, probs, top_k: int, capacity_factor: float,
              over: str | None = None):
    """Grouped capacity dispatch. xt: (G,Tg,D); probs: (G,Tg,E).

    Returns ``(buf (G,E,C,D), dst (G,Tg*K), gates (G,Tg*K,1), gi (G,1),
    gate_idx (G,Tg,K))``. Slots are numbered token-major, then k; an
    entry's slot in its expert is its cumsum position, kept while
    ``0 <= pos < C``, else sent to the overflow slot ``E*C`` (cut off) with
    its gate zeroed.

    ``over``: the logical axis whose ranks hold the rest of the one group
    (G == 1; rank 0's tokens first). Every rank's expert choices are
    gathered (one small ``all_gather``), so the capacity and the positions
    are the whole group's, as one process dispatching it would make them;
    this rank's tokens take their slots in that buffer."""
    G, Tg, D = xt.shape
    E = probs.shape[-1]
    # stable descending sort: ties to the lower index, as lax.top_k
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    flat_e = gate_idx.reshape(G, Tg * top_k)                   # (G,TgK)
    every = flat_e if over is None else \
        shardlib.all_gather(flat_e, over, 1)                   # whole group
    C = max(int(capacity_factor * (every.shape[1] // top_k) * top_k / E), 1)
    oh = (every[..., None] == torch.arange(E, device=xt.device)
          ).to(torch.int32)                                    # (G,TgK,E)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1           # slot in expert
    if every is not flat_e:
        pos = pos.narrow(1, shardlib.rank_in(over) * Tg * top_k, Tg * top_k)
    keep = (pos < C) & (pos >= 0)
    dst = torch.where(keep, flat_e * C + pos,
                      torch.full_like(flat_e, E * C))          # overflow slot

    xk = xt[:, :, None].expand(G, Tg, top_k, D).reshape(G, Tg * top_k, D)
    gi = torch.arange(G, device=xt.device)[:, None]
    # each kept entry owns its slot; only the overflow row, cut off below,
    # is written more than once
    buf = torch.zeros((G, E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf.scatter_(1, dst[..., None].expand(G, Tg * top_k, D), xk)
    buf = buf[:, :-1].reshape(G, E, C, D)
    gates = gate_vals.reshape(G, -1, 1) * keep[..., None].to(gate_vals.dtype)
    return buf, dst, gates, gi, gate_idx


def _aux_terms(probs, gate_idx):
    """Load-balance stats: (mean router prob, top-1 frequency) per expert."""
    E = probs.shape[-1]
    lead = tuple(range(probs.ndim - 1))
    me = probs.mean(dim=lead)
    top1 = gate_idx[..., 0, None] == torch.arange(E, device=probs.device)
    ce = top1.to(torch.float32).mean(dim=tuple(range(gate_idx.ndim - 1)))
    return me, ce


def _routed_by_expert(buf, p, dt):
    """The routed experts' slot-space output ``(G,E,C,D)`` where the
    experts override splits them over the model ranks: this rank's
    ``E / tp`` experts (``w1`` / ``w3`` ``(E_loc,D,F)``, ``w2``
    ``(E_loc,F,D)``, whole) on its slots of ``buf``, the ranks' outputs
    gathered along the experts (backward: this rank's slice of the
    gradient)."""
    e = p["w1"].shape[0]
    mine = buf.narrow(1, shardlib.rank_in("experts") * e, e)
    h = F.silu(torch.einsum("gecd,edf->gecf", mine, p["w1"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", mine, p["w3"].to(dt))
    h = shardlib.shard(h, "batch", "experts", None, "ff")
    y = torch.einsum("gecf,efd->gecd", h, p["w2"].to(dt))
    return shardlib.all_gather(y, "experts", 1)


def _moe_ffn_spmd(x, p, *, top_k, capacity_factor, split, seq=False):
    """The sharded block: ``x`` (B_loc,S,D) is this data rank's rows;
    under ``split`` ``w1`` / ``w3`` (E,D,F_loc) and ``w2`` (E,F_loc,D) are
    this model rank's slice of the experts' hidden dim (and the shared
    expert's), else the whole block, which every model rank computes. Dispatch is
    local (one group a sequence); each rank's expert outputs are partial
    sums over its hidden slice, combined back to token space (and the
    shared expert's partial product added) before ONE ``all_reduce`` of
    (B_loc,S,D). The router's statistics ``me`` / ``ce`` are averaged over
    the data ranks, so every rank holds the whole batch's aux loss.
    ``seq``: ``x`` is already the whole sequence gathered from the
    ranks' slices (the experts split, ``split``); the output is
    reduce-scattered back to them.

    Autograd: ``x`` and the gates enter the split region through
    :func:`~repro_torch.launch.sharding.copy_to` (their gradients from the
    ranks' partial outputs are summed), the output leaves it through
    :func:`~repro_torch.launch.sharding.reduce_from`; ``me`` leaves the
    data region the same way, so each data rank's backward carries its
    rows' share of the aux loss's gradient."""
    G, Tg, D = x.shape
    E = p["router"].shape[1]
    dt = x.dtype
    logits = (x.reshape(-1, D) @ p["router"].to(dt)).to(
        torch.float32).reshape(G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    xc = shardlib.copy_to(x, "ff") if split else x
    buf, dst, gates, gi, gate_idx = _dispatch(xc, probs, top_k,
                                              capacity_factor)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w1"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", buf, p["w3"].to(dt))
    C = buf.shape[2]
    y = torch.einsum("gecf,efd->gecd", h, p["w2"].to(dt)).reshape(
        G, E * C, D)                      # partial over the F shards
    # combine back to token space BEFORE the all_reduce: one (G,Tg,D)
    # reduction instead of a slot-space one
    y = torch.cat([y, torch.zeros((G, 1, D), dtype=dt, device=y.device)],
                  dim=1)
    g = (shardlib.copy_to(gates, "ff") if split else gates).to(dt)
    out_k = y.gather(1, dst[..., None].expand(G, Tg * top_k, D)) * g
    out = out_k.reshape(G, Tg, top_k, D).sum(dim=2)
    if "shared" in p:
        sh = p["shared"]
        hs = F.silu(xc @ sh["w1"].to(dt)) * (xc @ sh["w3"].to(dt))
        out = out + hs @ sh["w2"].to(dt)         # also partial: one sum
    if split:
        out = shardlib.reduce_scatter_from(out, "ff", 1) if seq \
            else shardlib.reduce_from(out, "ff")
    me, ce = _aux_terms(probs, gate_idx)
    n_b = shardlib.logical_axis_size("batch")
    me = shardlib.reduce_from(me, "batch") / n_b
    ce = shardlib.all_reduce(ce.detach().clone(), "batch") / n_b
    return out, E * torch.sum(me * ce)


def moe_ffn(x, p, *, top_k: int, capacity_factor: float = 1.25,
            approx: ApproxConfig = EXACT, grouped: bool = True,
            split: bool = False, seq: bool = False):
    """x: (B,S,D) -> (B,S,D), plus the load-balancing aux loss (a 0-d
    float32 tensor). Without a mesh, the reference's ``_moe_ffn_jnp``.
    ``grouped`` dispatches one group a sequence, else one group for the
    batch; a decode step's one token a row is always one group, so its
    rows compete for slots — across the data ranks too, where the caller
    declares the rows their shares of a batch
    (:func:`~repro_torch.launch.sharding.global_batch`; :func:`_dispatch`'s
    ``over``). On a bound mesh a grouped multi-token call
    with float experts takes :func:`_moe_ffn_spmd`, as the reference's
    ``moe_ffn`` takes its ``shard_map`` path (its shared expert then runs
    plain, whatever ``approx`` says), unless the experts override splits
    the experts (the reference's ``shard_map`` path needs ``"ff"`` bound).
    ``split``: the experts' weights are this rank's slice of their hidden
    dim over the logical axis ``"ff"`` (the caller reads it from their
    width).

    Sequence parallelism: an ``x`` that is this rank's slice of the
    sequence (:func:`~repro_torch.launch.sharding.seq_split` of the whole
    length; the caller says so with ``seq``, the experts split over
    ``"ff"``) is gathered whole first and the output reduce-scattered
    back."""
    experts = shardlib.group("experts") is not None
    if seq:
        if experts:
            raise NotImplementedError(
                "sequence parallelism with the experts override: the "
                "block would gather a sequence split over the ranks that "
                "split its experts; bind one of 'seq' and 'experts'")
        # every rank goes on with the whole sequence, its own partial
        # products summed by the reduce-scatter
        x = shardlib.all_gather(x, "seq", 1)
    ff_bound = shardlib.active() and shardlib.logical_spec("ff")[0] \
        is not None
    if (grouped and ff_bound and x.shape[1] > 1
            and not isinstance(p["w1"], QuantizedWeight)):
        return _moe_ffn_spmd(x, p, top_k=top_k,
                             capacity_factor=capacity_factor, split=split,
                             seq=seq)
    B, S, D = x.shape
    E = p["router"].shape[1]
    if not grouped or S == 1:
        G, Tg = 1, B * S
    else:
        G, Tg = B, S
    xt = x.reshape(G, Tg, D)

    logits = (xt @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # the routed experts' partial products (split over "ff") or this
    # rank's experts (the override): x's gradient from them is summed
    # over the ranks
    by_expert = experts and p["w1"].shape[0] < E
    xc = xt
    if split or by_expert:
        xc = shardlib.copy_to(xt, "ff" if split else "experts")
    if G == 1 and shardlib.rows_split(B):
        # one group over the batch (a decode step) whose rows the data
        # ranks split: they dispatch as the one group they are
        out = _dispatch(xc, probs, top_k, capacity_factor, "batch")
    else:
        out = _dispatch(xc, probs, top_k, capacity_factor)
    buf, dst, gates, gi, gate_idx = out
    me, ce = _aux_terms(probs, gate_idx)
    if torch.is_grad_enabled() and shardlib.group("batch") is not None:
        # the whole batch's statistics where a loss takes the aux (the
        # experts override's training); serving drops it, as the
        # reference's decode step does, so no collective is spent on it
        n_b = shardlib.logical_axis_size("batch")
        me = shardlib.reduce_from(me, "batch") / n_b
        ce = shardlib.all_reduce(ce.detach().clone(), "batch") / n_b
    aux = E * torch.sum(me * ce)

    dt = x.dtype
    buf = shardlib.shard(buf, "batch", "experts", None, None)
    C = buf.shape[2]
    if by_expert:
        y = _routed_by_expert(buf, p, dt)
    else:
        h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w1"].to(dt))) \
            * torch.einsum("gecd,edf->gecf", buf, p["w3"].to(dt))
        h = shardlib.shard(h, "batch", "experts", None, "ff")
        y = torch.einsum("gecf,efd->gecd", h, p["w2"].to(dt))
    y = y.reshape(G, E * C, D)
    y = torch.cat([y, torch.zeros((G, 1, D), dtype=y.dtype,
                                  device=y.device)], dim=1)

    g = (shardlib.copy_to(gates, "ff") if split else gates).to(dt)
    out_k = y.gather(1, dst[..., None].expand(G, Tg * top_k, D)) * g
    out = out_k.reshape(G, Tg, top_k, D).sum(dim=2).reshape(B * S, D)

    shared = whole = None
    if "shared" in p:
        shared, whole = _shared(x.reshape(B * S, D), p["shared"], approx,
                                split)
        if not whole:
            out = out + shared
    out = out.reshape(B, S, D)
    if split:
        # the routed partials (and a plain shared expert's) summed once
        out = shardlib.reduce_from(out, "ff")
    if whole:
        out = out + shared.reshape(B, S, D)
    return out, aux


def _shared(xf, sh, approx: ApproxConfig, split: bool):
    """``(out, whole)``: the shared expert on (T, D) tokens through
    :func:`dense`. Split over ``"ff"`` (``w1`` / ``w3`` this rank's
    columns, ``w2`` its rows), ``w2``'s partial product comes back
    unsummed (``whole`` False), for the caller's one sum with the routed
    experts'; but where ``w2`` runs the SIMDive emulation, whose integer
    partial sums must be added before its one rescale (bit-equal to the
    unsplit linear), ``w2`` sums its own (:func:`dense`'s row split) and
    the output comes back whole, added after the routed experts' sum."""
    col = ("col", "ff") if split else None
    hs = F.silu(dense(xf, sh["w1"], approx, col)) * dense(xf, sh["w3"],
                                                          approx, col)
    if not split:
        return dense(hs, sh["w2"], approx), False
    if _emulated(approx):
        return dense(hs, sh["w2"], approx, ("row", "ff")), True
    return hs @ sh["w2"].to(hs.dtype), False


def _emulated(approx: ApproxConfig) -> bool:
    """Whether :func:`dense` runs a float weight's product on the SIMDive
    emulation under ``approx``."""
    return (approx.enabled and approx.use_in_linear and approx.emulate
            and approx.active_for("matmul"))
