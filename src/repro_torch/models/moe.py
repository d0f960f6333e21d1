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
the reference's does.
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


def _dispatch(xt, probs, top_k: int, capacity_factor: float):
    """Grouped capacity dispatch. xt: (G,Tg,D); probs: (G,Tg,E).

    Returns ``(buf (G,E,C,D), dst (G,Tg*K), gates (G,Tg*K,1), gi (G,1),
    gate_idx (G,Tg,K))``. Slots are numbered token-major, then k; an
    entry's slot in its expert is its cumsum position, kept while
    ``0 <= pos < C``, else sent to the overflow slot ``E*C`` (cut off) with
    its gate zeroed."""
    G, Tg, D = xt.shape
    E = probs.shape[-1]
    # stable descending sort: ties to the lower index, as lax.top_k
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    C = max(int(capacity_factor * Tg * top_k / E), 1)
    flat_e = gate_idx.reshape(G, Tg * top_k)                   # (G,TgK)
    oh = (flat_e[..., None] == torch.arange(E, device=xt.device)
          ).to(torch.int32)                                    # (G,TgK,E)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1           # slot in expert
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


def _moe_ffn_spmd(x, p, *, top_k, capacity_factor, split):
    """The sharded block: ``x`` (B_loc,S,D) is this data rank's rows;
    under ``split`` ``w1`` / ``w3`` (E,D,F_loc) and ``w2`` (E,F_loc,D) are
    this model rank's slice of the experts' hidden dim (and the shared
    expert's), else the whole block, which every model rank computes. Dispatch is
    local (one group a sequence); each rank's expert outputs are partial
    sums over its hidden slice, combined back to token space (and the
    shared expert's partial product added) before ONE ``all_reduce`` of
    (B_loc,S,D). The router's statistics ``me`` / ``ce`` are averaged over
    the data ranks, so every rank holds the whole batch's aux loss.

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
        out = shardlib.reduce_from(out, "ff")
    me, ce = _aux_terms(probs, gate_idx)
    n_b = shardlib.logical_axis_size("batch")
    me = shardlib.reduce_from(me, "batch") / n_b
    ce = shardlib.all_reduce(ce.detach().clone(), "batch") / n_b
    return out, E * torch.sum(me * ce)


def moe_ffn(x, p, *, top_k: int, capacity_factor: float = 1.25,
            approx: ApproxConfig = EXACT, grouped: bool = True,
            split: bool = False):
    """x: (B,S,D) -> (B,S,D), plus the load-balancing aux loss (a 0-d
    float32 tensor). Without a mesh, the reference's ``_moe_ffn_jnp``.
    ``grouped`` dispatches one group a sequence, else one group for the
    batch; a decode step's one token a row is always one group, so its
    rows compete for slots. On a bound mesh a grouped multi-token call
    with float experts takes :func:`_moe_ffn_spmd`, as the reference's
    ``moe_ffn`` takes its ``shard_map`` path (its shared expert then runs
    plain, whatever ``approx`` says). ``split``: the experts' weights are
    this rank's slice of their hidden dim over the logical axis ``"ff"``
    (the caller reads it from their width)."""
    if (grouped and shardlib.active() and x.shape[1] > 1
            and not isinstance(p["w1"], QuantizedWeight)):
        return _moe_ffn_spmd(x, p, top_k=top_k,
                             capacity_factor=capacity_factor, split=split)
    B, S, D = x.shape
    E = p["router"].shape[1]
    if not grouped or S == 1:
        G, Tg = 1, B * S
    else:
        G, Tg = B, S
    xt = x.reshape(G, Tg, D)

    logits = (xt @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    buf, dst, gates, gi, gate_idx = _dispatch(xt, probs, top_k,
                                              capacity_factor)
    me, ce = _aux_terms(probs, gate_idx)
    aux = E * torch.sum(me * ce)

    w1 = p["w1"].to(x.dtype)
    w3 = p["w3"].to(x.dtype)
    w2 = p["w2"].to(x.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1)) * torch.einsum(
        "gecd,edf->gecf", buf, w3)
    C = buf.shape[2]
    y = torch.einsum("gecf,efd->gecd", h, w2).reshape(G, E * C, D)
    y = torch.cat([y, torch.zeros((G, 1, D), dtype=y.dtype,
                                  device=y.device)], dim=1)

    out_k = y.gather(1, dst[..., None].expand(G, Tg * top_k, D)) \
        * gates.to(y.dtype)
    out = out_k.reshape(G, Tg, top_k, D).sum(dim=2)

    if "shared" in p:
        sh = p["shared"]
        xf = x.reshape(B * S, D)
        hs = F.silu(dense(xf, sh["w1"], approx)) * dense(xf, sh["w3"],
                                                         approx)
        out = out.reshape(B * S, D) + dense(hs, sh["w2"], approx)
    return out.reshape(B, S, D), aux
