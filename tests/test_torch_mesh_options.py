"""The mesh's last options, on the CPU: the MoE decode step on a model
mesh, sequence parallelism (``--sp``), ZeRO-3 (``--pure-dp``, ``--fsdp``),
the experts override and per-row positions over a sequence-split cache.

Spawned ``gloo`` groups run the port's sharded paths on their own shards
with the plain versions of every op, all spawned at once by one fixture,
each under its own time limit (``JOIN_S``):

- ``tp2``: two ranks, mesh (data 1, model 2): mixtral-8x7b's and
  llama4-scout's served forward (a prefill and decode steps, divider-only)
  with each decode step's collectives; the MoE block under the experts
  override (and the refusal with ``"ff"`` still on the model axis);
  smollm-360m's decode steps with per-row positions over its
  sequence-split cache (one kv head over two ranks); stablelm-1.6b's
  first step under ``--sp``, its SIMDive linears at the sequence-parallel
  shard shapes, and a prefill under ``--sp``; smollm's first step under
  ``--pure-dp`` (the batch over both ranks, every parameter split over
  them);
- ``fsdp``: four ranks, mesh (data 2, model 2): smollm's first step under
  ``--fsdp``, with and without ``cfg.remat``;
- ``dry``: one process tracing the same steps with the dry run
  (``launch/dryrun.py``) under the fake process group;
- and, in the ``tp2`` group's two processes on a mesh of (data 2, model
  1): llama4-scout's served forward and its MoE block, each rank its half
  of the rows, the decode step's MoE at a capacity its experts overflow:
  one group over the batch, as the reference's ``_moe_ffn_jnp`` makes it;
  and the same on a batch the two ranks do not divide, held whole by
  each.

Everything is held against the unsplit port in this process (which the
other ``test_torch_*`` files hold to the reference), and the specs and
the experts probe against the reference (``src/repro``), the latter in a
subprocess with two host devices. Tolerances are
``tests/test_torch_mesh_cases.py``'s: a first step's loss within 8
float32 ulps, every gradient leaf within one bf16 ulp of its largest
magnitude or twice the float-order witness's distance; served logits
within ``LOGIT_ULP`` bf16 ulps of the unsplit run's largest logit. The
SIMDive linears and the experts' routed output are ``torch.equal`` to
unsplit.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as t_ckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import sharding as shardlib
from repro_torch.launch import train as t_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("mesh", 16, 4, "train")
SIMDIVE = ApproxConfig(mode="simdive", backward="approx")
LOSS_RTOL = 8 * 2.0 ** -23
GRAD_ULP = 2.0 ** -8
LOGIT_ULP = 6 * 2.0 ** -8
JOIN_S = 240                         # each spawned group's own time limit
PROMPT, STEPS = 8, 3                 # the served MoE: prefill, decode
MAX_SEQ, ROW_STEPS = 8, 4            # per-row positions: cache, steps
ROW_START = (0, MAX_SEQ - ROW_STEPS)  # row 1 ends at max_seq - 1
GROUPS = {"tp2": 2, "fsdp": 4, "dry": 1}
MOE = {"mixtral": "mixtral-8x7b", "llama4": "llama4-scout-17b-a16e"}
# the MoE decode step over data ranks: rows, and a capacity factor at
# which 4 experts of top-1 overflow (C = 2 of 8 rows; 1 of a rank's 4);
# a batch two ranks do not divide (each holds it whole)
DP_ROWS, DP_CAPACITY, DP_WHOLE = 8, 1.0, 3


def _train_config(arch: str, remat: bool = False):
    from dataclasses import replace

    return replace(get_config(arch, smoke=True), remat=remat).with_approx(
        SIMDIVE)


def _serve_config(arch: str):
    from repro_torch.launch.serve import serving_config

    return serving_config(arch, smoke=True, approx="simdive")


# ----------------------------------------------------- one training step --
@contextmanager
def _first_grads(out: dict):
    """Record the gradients the first step hands the optimizer (the output
    of ``sum_over_data``) into ``out["grads"]``."""
    saved = t_train.sum_over_data

    def rec(grads, *rest):
        grads = saved(grads, *rest)
        out.setdefault("grads", tree_map(
            lambda g: None if g is None else g.detach().clone(), grads))
        return grads

    t_train.sum_over_data = rec
    try:
        yield
    finally:
        t_train.sum_over_data = saved


def train_once(cfg, tp: int = 1, sp: bool = False, zero3=None) -> dict:
    """``launch.train.train``'s first step at SHAPE on the CPU: the loss,
    the gradients handed to the optimizer (on a mesh gathered whole under
    the run's placement) and the step's collectives by mesh axes."""
    import torch.distributed as dist

    rec: dict = {}
    shardlib.reset_collective_counts()
    with _first_grads(rec):
        _, losses = t_train.train(cfg, SHAPE, steps=1, ckpt_dir=None,
                                  tp=tp, device="cpu", log_every=10, sp=sp,
                                  zero3=zero3)
    out = {"loss": losses[0],
           "collectives": shardlib.collective_counts(by_axis=True)}
    if not dist.is_initialized():
        out["grads"] = rec["grads"]
        return out
    mesh = t_train.make_host_mesh(model=tp)
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, sp,
                                                    zero3 == "pure_dp")):
        psh = t_train.placement(cfg, mesh, zero3=zero3)[0]["params"]
        out["grads"] = tree_map(lambda g, s: None if g is None
                                else t_ckpt.gather_full(g, s),
                                rec["grads"], psh)
        out["held"] = _held(cfg, psh)
    return out


def _held(cfg, psh) -> list:
    """For each parameter leaf: (whole elements, this rank's elements,
    the ranks its spec splits it over)."""
    from repro_torch.launch.specs import param_shapes

    sizes = shardlib.axis_sizes(shardlib.current_mesh())
    rows = []
    for leaf, sh in zip(tree_leaves(param_shapes(cfg)), tree_leaves(psh)):
        n = 1
        for part in sh.spec:
            for a in (() if part is None else part if isinstance(part, tuple)
                      else (part,)):
                n *= sizes[a]
        rows.append((leaf.numel(), sh.local(torch.empty(
            leaf.shape, device="meta")).numel(), n, tuple(leaf.shape)))
    return rows


class _HeadInF32(torch.autograd.Function):
    """The head's ``x @ w`` with its input gradient accumulated in
    float32 by one GEMM and rounded once (the float-order witness)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w_dtype = w.dtype
        w = w.to(x.dtype)
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g.to(torch.float32) @ w.to(torch.float32).T).to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw.to(ctx.w_dtype)


def witness_once(cfg) -> dict:
    from repro_torch.models import model

    saved = model.dense
    model.dense = lambda x, w, approx=None, split=None: _HeadInF32.apply(
        x, w)
    try:
        return train_once(cfg)
    finally:
        model.dense = saved


# ------------------------------------------------------------ serving ----
@contextmanager
def _recorded_dispatch(capacity=None):
    """Record each decode step's MoE dispatch (a call of one token a
    row) as ``(dst, C)``: every entry's slot, or the overflow slot
    ``E * C``, and the capacity. ``capacity``: the decode step's MoE
    dispatches at that factor, not at the reference's fixed 4.0."""
    from repro_torch.models import moe, transformer

    calls, decode = [], []
    saved_dispatch, saved_ffn = moe._dispatch, transformer.moe_ffn

    def dispatch(*args, **kw):
        out = saved_dispatch(*args, **kw)
        if decode:
            calls.append((out[1].clone(), out[0].shape[2]))
        return out

    def ffn(x, p, **kw):
        if x.shape[1] != 1:
            return saved_ffn(x, p, **kw)
        if capacity is not None:
            kw["capacity_factor"] = capacity
        decode.append(True)
        try:
            return saved_ffn(x, p, **kw)
        finally:
            decode.pop()

    moe._dispatch, transformer.moe_ffn = dispatch, ffn
    try:
        yield calls
    finally:
        moe._dispatch, transformer.moe_ffn = saved_dispatch, saved_ffn


def served_moe(cfg, rows: int = 2, capacity=None) -> dict:
    """A prefill of PROMPT tokens and STEPS decode steps (a cache of
    PROMPT + STEPS slots holding the prefill's) on ``rows`` prompts, this
    data rank's share of them: the logits gathered over the vocabulary,
    each step's collectives and each decode step's MoE dispatches
    (:func:`_recorded_dispatch`, at ``capacity``)."""
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    params = _placed(lm, cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = _share(torch.randint(0, cfg.vocab_size, (rows, PROMPT),
                                  generator=gen))
    with _recorded_dispatch(capacity) as calls, \
            shardlib.global_batch(rows):
        out = _served_steps(lm, cfg, params, tokens)
    out["dispatch"] = calls
    return out


def _share(t):
    """This data rank's share of the batch ``t``, or the whole of it where
    the ranks do not divide it (as ``sanitize_specs`` lays it)."""
    n, rows = shardlib.logical_axis_size("batch"), t.shape[0]
    if rows % n:
        return t
    return t.narrow(0, shardlib.rank_in("batch") * rows // n, rows // n)


def _served_steps(lm, cfg, params, tokens) -> dict:
    """:func:`served_moe`'s prefill and decode steps on ``tokens``."""
    logits, cache = lm.prefill(params, {"tokens": tokens})
    out = {"prefill": _whole_vocab(logits, cfg), "steps": [],
           "collectives": []}
    dcache = lm.empty_cache(tokens.shape[0], PROMPT + STEPS)
    for name in ("k", "v"):
        dcache[name][:, :, :PROMPT].copy_(cache[name])
    for i in range(STEPS):
        shardlib.reset_collective_counts()
        lg, dcache = lm.decode_step(params, dcache, tokens[:, i],
                                    PROMPT + i, max_seq=PROMPT + STEPS)
        out["collectives"].append(shardlib.collective_counts(by_axis=True))
        out["steps"].append(_whole_vocab(lg, cfg))
    return out


def per_row_steps(cfg) -> list:
    """ROW_STEPS decode steps from an empty cache of MAX_SEQ slots, row
    ``b`` at position ``ROW_START[b] + i`` (the last at max_seq - 1): the
    logits gathered over the vocabulary."""
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    params = _placed(lm, cfg)
    cache = lm.empty_cache(2, MAX_SEQ)
    start = torch.tensor(ROW_START)
    out = []
    for i in range(ROW_STEPS):
        tok = torch.tensor([3 + i, 11 + 2 * i])
        lg, cache = lm.decode_step(params, cache, tok, start + i,
                                   max_seq=MAX_SEQ)
        out.append(_whole_vocab(lg, cfg))
    return out


def sp_prefill(cfg) -> torch.Tensor:
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    params = _placed(lm, cfg)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    return _whole_vocab(lm.prefill(params, {"tokens": tokens})[0], cfg)


def _placed(lm, cfg):
    params = lm.init(0)
    mesh = shardlib.current_mesh()
    if mesh is not None:
        psh = t_train.placement(cfg, mesh)[0]["params"]
        params = tree_map(lambda p, s: s.local(p).contiguous(), params, psh)
    return params


def _whole_vocab(lg, cfg):
    if lg.shape[-1] < cfg.vocab_size:
        return shardlib.all_gather(lg.contiguous(), "vocab", -1)
    return lg


# ------------------------------------------------- the experts override --
def moe_inputs(arch: str, S: int, B: int = 2):
    """The MoE block's float32 weights and x (B, S, D), from numpy seed
    3."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(3)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def u(*shape, fan):
        return (rng.uniform(-1, 1, shape) * fan ** -0.5).astype(np.float32)

    p = {"router": u(D, E, fan=D), "w1": u(E, D, Fd, fan=D),
         "w3": u(E, D, Fd, fan=D), "w2": u(E, Fd, D, fan=Fd)}
    if cfg.n_shared_experts:
        p["shared"] = {"w1": u(D, Fd, fan=D), "w3": u(D, Fd, fan=D),
                       "w2": u(Fd, D, fan=Fd)}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return cfg, p, x


def moe_block(arch: str, S: int, by_expert: bool):
    """The block's output and aux: unbound, or on this rank's experts
    under the bound override (``by_expert``)."""
    from repro_torch.models.moe import moe_ffn

    cfg, p, x = moe_inputs(arch, S)
    p = tree_map(torch.from_numpy, p)
    if by_expert:
        n, r = shardlib.logical_axis_size("experts"), \
            shardlib.rank_in("experts")
        e = cfg.n_experts // n
        p.update({k: p[k][r * e:(r + 1) * e].contiguous()
                  for k in ("w1", "w3", "w2")})
    with torch.no_grad():
        return moe_ffn(torch.from_numpy(x), p, top_k=cfg.n_experts_active,
                       capacity_factor=4.0)


def moe_block_dp(rows: int = DP_ROWS) -> dict:
    """llama4-scout's block on one token of each of ``rows`` rows at
    DP_CAPACITY (this data rank's share of them): output and dispatch."""
    from repro_torch.models import transformer

    cfg, p, x = moe_inputs(MOE["llama4"], 1, rows)
    x = _share(torch.from_numpy(x))
    with torch.no_grad(), _recorded_dispatch() as calls, \
            shardlib.global_batch(rows):
        # through the module's name, which the recorder wraps
        out, _ = transformer.moe_ffn(x, tree_map(torch.from_numpy, p),
                                     top_k=cfg.n_experts_active,
                                     capacity_factor=DP_CAPACITY)
    return {"out": out, "dispatch": calls}


def _dp_cases() -> dict:
    """The MoE decode step over two data ranks (mesh (data 2, model 1)):
    llama4-scout served, and its block."""
    mesh = t_train.make_host_mesh(model=1)
    with shardlib.use_rules(mesh, t_train.rules_for(mesh)):
        return _dp_runs()


def _dp_runs() -> dict:
    """:func:`_dp_cases`' runs, on a split batch and on a whole one."""
    cfg = _serve_config(MOE["llama4"])
    return {"serve": served_moe(cfg, DP_ROWS, DP_CAPACITY),
            "block": moe_block_dp(),
            "serve_whole": served_moe(cfg, DP_WHOLE, DP_CAPACITY),
            "block_whole": moe_block_dp(DP_WHOLE)}


def _experts_cases(mesh) -> dict:
    out = {}
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, experts=True)):
        for arch in MOE.values():
            for S in (1, 8):
                out[(arch, S)] = moe_block(arch, S, True)
        shardlib.reset_collective_counts()
        moe_block(MOE["mixtral"], 1, True)
        out["collectives"] = shardlib.collective_counts(by_axis=True)
        cfg = _train_config(MOE["llama4"])
        specs = t_train.placement(cfg, mesh)[0]["params"]
        out["specs"] = {k: tuple(specs["stack"]["layers"]["moe"][k].spec)
                        for k in ("w1", "w2", "router")}
        out["shared_spec"] = tuple(
            specs["stack"]["layers"]["moe"]["shared"]["w1"].spec)
    with shardlib.use_rules(mesh, {"batch": ("data",),
                                   "experts": ("model",)}):
        try:
            moe_block("mixtral-8x7b", 1, False)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
        out["spmd_runs"] = moe_block("mixtral-8x7b", 8, False)[0].shape
    return out


# --------------------------------------------------------- SP linears ----
def sp_linears(cfg) -> dict:
    """Every SIMDive linear of layer 0 at the sequence-parallel shard
    shapes (x (B,S,K) from seed 4): forward and both gradient products
    ``torch.equal`` to the unsplit linear's rows / columns."""
    from repro_torch.models.layers import dense

    tp, r = shardlib.logical_axis_size("heads"), shardlib.rank_in("heads")
    specs = t_train.placement(cfg, shardlib.current_mesh())[0]["params"]
    layer = specs["stack"]["layers"]
    B, S = 2, 8
    s_loc = slice(r * S // tp, (r + 1) * S // tp)
    out = {}
    for i, name in enumerate(("wq", "wk", "wv", "wo", "w1", "w3", "w2")):
        path = ("mlp", name) if name in ("w1", "w2", "w3") else (name,)
        sh = layer
        for k in path:
            sh = sh[k]
        spec = tuple(sh.spec)
        kind = "row" if spec[-1] is None else "col"
        K = cfg.d_model if kind == "col" else (
            cfg.d_ff if name == "w2" else cfg.n_heads * cfg.d_head)
        N = cfg.d_model if kind == "row" else (
            cfg.d_ff if name in ("w1", "w3") else
            (cfg.n_heads if name == "wq" else cfg.n_kv_heads) * cfg.d_head)
        gen = torch.Generator().manual_seed(400 + i)
        x0 = torch.randn((B, S, K), generator=gen).to(torch.bfloat16)
        w0 = torch.randn((K, N), generator=gen) * K ** -0.5
        g0 = torch.randn((B, S, N), generator=gen).to(torch.bfloat16)

        def run(x, w, g, split):
            x = x.clone().requires_grad_()
            w = w.clone().requires_grad_()
            y = dense(x, w, cfg.approx, split)
            y.backward(g)
            return y.detach(), x.grad, w.grad

        with shardlib.unbound():
            y, gx, gw = run(x0, w0, g0, None)
        if kind == "col":
            n = N // tp
            c = slice(r * n, (r + 1) * n)
            got = run(x0[:, s_loc], w0[:, c], g0[..., c],
                      ("col", "heads", "seq"))
            want = (y[..., c], gx[:, s_loc], gw[:, c])
        else:
            k = K // tp
            c = slice(r * k, (r + 1) * k)
            got = run(x0[..., c], w0[c], g0[:, s_loc],
                      ("row", "heads", "seq"))
            want = (y[:, s_loc], gx[..., c], gw[c])
        out[name] = (kind, [torch.equal(a, b) for a, b in zip(got, want)])
    return out


# ------------------------------------------------------------- ranks ----
def _rank_main(rank, world, group, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    res = {}
    try:
        if group == "dry":
            res = _dry_cases()
        else:
            dist.init_process_group(
                "gloo", init_method=f"file://{store}", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=JOIN_S))
            res = _tp2_cases() if group == "tp2" else _fsdp_cases()
            dist.destroy_process_group()
    finally:
        torch.save(res, f"{out}.{rank}")


def _tp2_cases() -> dict:
    mesh = t_train.make_host_mesh(model=2)
    res = {"serve": {}}
    with shardlib.use_rules(mesh, {"batch": ("data",)}):
        for run, arch in MOE.items():
            res["serve"][run] = served_moe(_serve_config(arch))
        res["rows"] = per_row_steps(_serve_config("smollm-360m"))
    res["experts"] = _experts_cases(mesh)
    res["dp"] = _dp_cases()
    with shardlib.use_rules(mesh, t_train.rules_for(mesh, sp=True)):
        res["sp_linears"] = sp_linears(_train_config("stablelm-1.6b"))
        res["sp_prefill"] = {a: sp_prefill(_serve_config(a))
                             for a in ("stablelm-1.6b", "mixtral-8x7b")}
    res["sp"] = train_once(_train_config("stablelm-1.6b"), tp=2, sp=True)
    res["pure_dp"] = train_once(_train_config("smollm-360m"), tp=2,
                                zero3="pure_dp")
    return res


def _fsdp_cases() -> dict:
    return {"fsdp": train_once(_train_config("smollm-360m"), tp=2,
                               zero3="fsdp"),
            "fsdp_remat": train_once(_train_config("smollm-360m", True),
                                     tp=2, zero3="fsdp")}


def _dry_cases() -> dict:
    """The same first steps (and the MoE decode steps, at full width and
    the served depth) traced by the dry run, as rank 0 of their meshes."""
    from dataclasses import replace

    from repro_torch.launch import dryrun

    out = {}
    for tag, arch, mesh, kw in (
            ("sp", "stablelm-1.6b", (1, 2), {"sp": True}),
            ("pure_dp", "smollm-360m", (1, 2), {"zero3": "pure_dp"}),
            ("fsdp", "smollm-360m", (2, 2), {"zero3": "fsdp"})):
        out[tag] = dryrun.trace_cell(_train_config(arch), SHAPE, mesh,
                                     ("data", "model"), zero1=False, **kw)
    for run, arch in MOE.items():
        cfg = replace(_serve_config(arch), n_layers=2)
        full = replace(get_config(arch), n_layers=2).with_approx(cfg.approx)
        out["decode_" + run] = dryrun.trace_cell(
            full, ShapeConfig("d", PROMPT + STEPS, 2, "decode"), (1, 2),
            ("data", "model"), pos=PROMPT)
    full = replace(get_config(MOE["llama4"]), n_layers=2).with_approx(
        _serve_config(MOE["llama4"]).approx)
    for tag, rows in (("decode_dp", DP_ROWS),
                      ("decode_dp_whole", DP_WHOLE)):
        out[tag] = dryrun.trace_cell(
            full, ShapeConfig("d", PROMPT + STEPS, rows, "decode"), (2, 1),
            ("data", "model"), pos=PROMPT)
    return out


def _spawn(group: str, tmp: Path):
    import torch.multiprocessing as mp

    d = tmp / group
    d.mkdir()
    ctx = mp.spawn(_rank_main, args=(GROUPS[group], group,
                                     str(d / "store"), str(d / "out")),
                   nprocs=GROUPS[group], join=False)
    return ctx, d


def _join(ctx, group: str, deadline: float) -> None:
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the spawned {group!r} group did not finish in "
                        f"{JOIN_S} s")


# --------------------------------------------------------- reference ----
def reference_main(out: str) -> None:
    """The reference on two host devices (run as a script): the MoE block
    under ``{"experts": ("model",), "ff": ()}`` and unbound, the refusal
    with ``"ff"`` bound, and the ZeRO-3 specs of the smoke configs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import use_rules
    from repro.launch.specs import fsdp_specs, opt_specs, param_specs
    from repro.models.model import build as ref_build
    from repro.models.layers import EXACT
    from repro.models.moe import _dispatch, _moe_ffn_jnp, moe_ffn

    assert len(jax.devices()) == 2, jax.devices()
    mesh = make_host_mesh(model=2)
    res = {}
    for arch in MOE.values():
        for S in (1, 8):
            cfg, p, x = moe_inputs(arch, S)
            p = jax.tree.map(jnp.asarray, p)

            def run(p=p, x=x, cfg=cfg):
                return moe_ffn(jnp.asarray(x), p, top_k=cfg.n_experts_active,
                               capacity_factor=4.0)[0]

            res[f"{arch}/{S}/unbound"] = np.asarray(run())
            with mesh, use_rules(mesh, {"experts": ("model",), "ff": ()}):
                res[f"{arch}/{S}/override"] = np.asarray(run())
    for tag, rows in (("dp", DP_ROWS), ("dp_whole", DP_WHOLE)):
        cfg, p, x = moe_inputs(MOE["llama4"], 1, rows)
        p = jax.tree.map(jnp.asarray, p)
        res[f"{tag}/out"] = np.asarray(_moe_ffn_jnp(
            jnp.asarray(x), p, top_k=cfg.n_experts_active,
            capacity_factor=DP_CAPACITY, approx=EXACT, grouped=True)[0])
        xt = jnp.asarray(x).reshape(1, rows, -1)
        probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32),
                               axis=-1)
        res[f"{tag}/dst"] = np.asarray(_dispatch(
            xt, probs, cfg.n_experts_active, DP_CAPACITY)[1])
    try:
        with mesh, use_rules(mesh, {"experts": ("model",)}):
            moe_block_ref = moe_inputs("mixtral-8x7b", 1)
            moe_ffn(jnp.asarray(moe_block_ref[2]),
                    jax.tree.map(jnp.asarray, moe_block_ref[1]), top_k=2,
                    capacity_factor=4.0)
        res["refusal"] = np.array("")
    except Exception as e:  # noqa: BLE001 - the probe records the type
        res["refusal"] = np.array(type(e).__name__)
    for arch in ("smollm-360m", "stablelm-1.6b"):
        shapes = jax.eval_shape(ref_build(ref_config(arch, smoke=True)).init,
                                jax.random.PRNGKey(0))
        for tag, specs in (
                ("fsdp", opt_specs(param_specs(shapes), ("data",))),
                ("pure_dp", fsdp_specs(shapes, ("data", "model"), mesh))):
            flat = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]
            for path, spec in flat:
                key = "/".join(str(getattr(k, "key", k)) for k in path)
                res[f"spec/{arch}/{tag}/{key}"] = np.array(repr(tuple(spec)))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_options")
    start = time.monotonic()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    ref_path = tmp / "reference.npz"
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(ref_path)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    spawned = {g: _spawn(g, tmp) for g in GROUPS}
    unsplit = {"serve": {r: served_moe(_serve_config(a))
                         for r, a in MOE.items()},
               "dp": _dp_runs(),
               "rows": per_row_steps(_serve_config("smollm-360m")),
               "sp_prefill": {a: sp_prefill(_serve_config(a))
                              for a in ("stablelm-1.6b", "mixtral-8x7b")}}
    for arch in MOE.values():
        for S in (1, 8):
            unsplit[(arch, S)] = moe_block(arch, S, False)
    for tag, arch in (("stablelm", "stablelm-1.6b"),
                      ("smollm", "smollm-360m")):
        unsplit[tag] = train_once(_train_config(arch))
        unsplit[tag + "_witness"] = witness_once(_train_config(arch))
    ranks = {}
    for g, (ctx, d) in spawned.items():
        _join(ctx, g, start + JOIN_S)
        ranks[g] = [torch.load(f"{d}/out.{r}", weights_only=False)
                    for r in range(GROUPS[g])]
    log, _ = ref.communicate(timeout=max(start + JOIN_S - time.monotonic(),
                                         1.0))
    assert ref.returncode == 0, log.decode()[-3000:]
    with np.load(ref_path) as z:
        reference = {k: z[k] for k in z.files}
    return {"ranks": ranks, "unsplit": unsplit, "reference": reference}


# -------------------------------------------------------------- tests ----
def _close_logits(got, want) -> None:
    tol = LOGIT_ULP * float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


def _check_grads(got: dict, want: dict, witness: dict) -> None:
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for g, g0, gw in zip(tree_leaves(got["grads"]), tree_leaves(
            want["grads"]), tree_leaves(witness["grads"])):
        assert (g is None) == (g0 is None)
        if g is None:
            continue
        assert g.shape == g0.shape
        top = float(g0.float().abs().max())
        err = float((g.float() - g0.float()).abs().max())
        w_err = float((gw.float() - g0.float()).abs().max())
        assert err <= max(GRAD_ULP * top, 2 * w_err), (err, top, w_err)


@pytest.mark.parametrize("run", list(MOE))
def test_moe_decode_on_a_model_mesh_matches_unsplit(runs, run):
    """The MoE's plain form on split weights (a decode step) sums the
    routed experts' partial output (and the shared expert's) over the
    model ranks: the prefill and every decode step within LOGIT_ULP of
    unsplit, and each step's all-reduces over the model axis one a layer
    more than the attention's alone would give (each layer's MoE issues
    its reduction): a layer's ``wo`` sum and its MoE's, and the
    vocabulary-parallel embedding's."""
    want = runs["unsplit"]["serve"][run]
    cfg = _serve_config(MOE[run])
    for res in runs["ranks"]["tp2"]:
        got = res["serve"][run]
        _close_logits(got["prefill"], want["prefill"])
        for g, w in zip(got["steps"], want["steps"]):
            _close_logits(g, w)
        for c in got["collectives"]:
            assert c["all_reduce@model"][0] == 2 * cfg.n_layers + 1, c


@pytest.mark.parametrize("run", list(MOE))
def test_moe_decode_dry_run_counts_the_moe_reduction(runs, run):
    """The dry run's decode step of the same config at full width issues
    the ranks' all-reduces a step (the repaired MoE's among them)."""
    dry = runs["ranks"]["dry"][0]["decode_" + run]["per_device"]
    got = runs["ranks"]["tp2"][0]["serve"][run]["collectives"][0]
    assert dry["collectives"]["all_reduce@model"][0] \
        == got["all_reduce@model"][0]


def test_moe_decode_over_data_ranks_dispatches_one_group(runs):
    """A decode step's MoE on two data ranks (mesh (data 2, model 1))
    dispatches the batch as one group, as the reference's single-token
    ``_moe_ffn_jnp`` does: llama4-scout served on DP_ROWS rows at
    DP_CAPACITY, where its experts overflow, takes the unsplit run's
    capacity, slots and drops at every step and layer, and its logits;
    its block on one token a row equals the unsplit block and the
    reference's slots and output. Each step gathers the ranks' expert
    choices once a layer, and the dry run counts those gathers."""
    want = runs["unsplit"]["dp"]
    ref = runs["reference"]
    cfg = _serve_config(MOE["llama4"])
    E, k = cfg.n_experts, cfg.n_experts_active
    n = len(runs["ranks"]["tp2"])
    b = DP_ROWS // n
    assert len(want["serve"]["dispatch"]) == STEPS * cfg.n_layers
    assert any(bool((dst == E * C).any())
               for dst, C in want["serve"]["dispatch"]), "nothing dropped"
    (dst0, C0), = want["block"]["dispatch"]
    assert bool((dst0 == E * C0).any()), "the block dropped nothing"
    assert np.array_equal(dst0.numpy(), ref["dp/dst"])
    np.testing.assert_allclose(want["block"]["out"].numpy(), ref["dp/out"],
                               rtol=1e-5, atol=1e-5)
    for r, res in enumerate(runs["ranks"]["tp2"]):
        rows, ent = slice(r * b, (r + 1) * b), slice(r * b * k,
                                                     (r + 1) * b * k)
        got = res["dp"]["serve"]
        assert len(got["dispatch"]) == len(want["serve"]["dispatch"])
        for (dst, C), (dst_w, C_w) in zip(got["dispatch"],
                                          want["serve"]["dispatch"]):
            assert C == C_w and torch.equal(dst, dst_w[:, ent])
        assert torch.equal(got["prefill"], want["serve"]["prefill"][rows])
        for g, w in zip(got["steps"], want["serve"]["steps"]):
            assert torch.equal(g, w[rows])
        for c in got["collectives"]:
            assert c["all_gather@data"][0] == cfg.n_layers, c
        (dst, C), = res["dp"]["block"]["dispatch"]
        assert C == C0 and torch.equal(dst, dst0[:, ent])
        assert np.array_equal(dst.numpy(), ref["dp/dst"][:, ent])
        assert torch.equal(res["dp"]["block"]["out"],
                           want["block"]["out"][rows])
    dry = runs["ranks"]["dry"][0]["decode_dp"]["per_device"]
    assert dry["collectives"]["all_gather@data"][0] == cfg.n_layers


def test_moe_decode_over_data_ranks_on_a_whole_batch(runs):
    """A batch the two data ranks do not divide (DP_WHOLE rows) is held
    whole by each: its decode step's MoE dispatches the rows as they are,
    gathering nothing, so each rank's slots, drops and logits equal the
    unsplit run's and its block the reference's ``_moe_ffn_jnp``; the dry
    run counts no gather for it."""
    want = runs["unsplit"]["dp"]
    ref = runs["reference"]
    (dst0, C0), = want["block_whole"]["dispatch"]
    assert np.array_equal(dst0.numpy(), ref["dp_whole/dst"])
    np.testing.assert_allclose(want["block_whole"]["out"].numpy(),
                               ref["dp_whole/out"], rtol=1e-5, atol=1e-5)
    for res in runs["ranks"]["tp2"]:
        got = res["dp"]["serve_whole"]
        assert len(got["dispatch"]) == len(want["serve_whole"]["dispatch"])
        for (dst, C), (dst_w, C_w) in zip(got["dispatch"],
                                          want["serve_whole"]["dispatch"]):
            assert C == C_w and torch.equal(dst, dst_w)
        assert torch.equal(got["prefill"], want["serve_whole"]["prefill"])
        for g, w in zip(got["steps"], want["serve_whole"]["steps"]):
            assert torch.equal(g, w)
        for c in got["collectives"]:
            assert c.get("all_gather@data", (0, 0))[0] == 0, c
        (dst, C), = res["dp"]["block_whole"]["dispatch"]
        assert C == C0 and torch.equal(dst, dst0)
        assert torch.equal(res["dp"]["block_whole"]["out"],
                           want["block_whole"]["out"])
    dry = runs["ranks"]["dry"][0]["decode_dp_whole"]["per_device"]
    assert dry["collectives"].get("all_gather@data", (0, 0))[0] == 0


@pytest.mark.parametrize("arch", list(MOE.values()))
@pytest.mark.parametrize("S", [1, 8])
def test_experts_override_routed_output_equals_unsplit(runs, arch, S):
    """Under ``{"experts": ("model",), "ff": ()}`` each rank computes its
    experts whole and the slot-space outputs are gathered before the
    combine: output and aux ``torch.equal`` to the unsplit block, and the
    reference's block under the same override equals its unbound one."""
    want = runs["unsplit"][(arch, S)]
    ref = runs["reference"]
    for res in runs["ranks"]["tp2"]:
        out, aux = res["experts"][(arch, S)]
        assert torch.equal(out, want[0]) and torch.equal(aux, want[1])
    np.testing.assert_allclose(ref[f"{arch}/{S}/override"],
                               ref[f"{arch}/{S}/unbound"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(want[0].numpy(), ref[f"{arch}/{S}/unbound"],
                               rtol=1e-5, atol=1e-5)


def test_experts_override_places_and_refuses(runs):
    """The override's placement: the routed experts split by expert over
    the model ranks, the router and the shared expert whole; one gather
    of the slot-space output a block. With ``"ff"`` still on the model
    axis the plain form raises naming the duplicate axis, where the
    reference raises ``DuplicateSpecError``; the multi-token form takes
    the ``"ff"`` split, as the reference's ``shard_map`` path does."""
    assert str(runs["reference"]["refusal"]) == "DuplicateSpecError"
    for res in runs["ranks"]["tp2"]:
        e = res["experts"]
        assert e["specs"]["w1"] == (None, "model", None, None)
        assert e["specs"]["w2"] == (None, "model", None, None)
        assert set(e["specs"]["router"]) == {None}
        assert set(e["shared_spec"]) == {None}
        assert e["collectives"]["all_gather@model"][0] == 1
        assert e["refusal"] and "'model'" in e["refusal"]
        assert "experts" in e["refusal"] and "ff" in e["refusal"]
        assert tuple(e["spmd_runs"]) == (2, 8, 96)


def test_per_row_positions_over_a_sequence_split_cache(runs):
    """smollm-360m at tp 2 (one kv head) splits its cache by sequence:
    rows at distinct depths — one from slot 0, one ending at max_seq - 1
    — each counted against its own position, each new token written by
    the rank that holds its slot: every step within LOGIT_ULP of
    unsplit."""
    want = runs["unsplit"]["rows"]
    for res in runs["ranks"]["tp2"]:
        assert len(res["rows"]) == ROW_STEPS
        for g, w in zip(res["rows"], want):
            _close_logits(g, w)


def test_sp_linears_equal_unsplit(runs):
    """Under ``--sp`` every SIMDive linear of layer 0 — column-parallel
    on the gathered sequence, row-parallel reduce-scattering its integer
    partial sums before the one rescale — is ``torch.equal`` to the
    unsplit linear's rows and columns (forward, gx, gw)."""
    for res in runs["ranks"]["tp2"]:
        kinds = set()
        for name, (kind, equal) in res["sp_linears"].items():
            assert all(equal), (name, kind, equal)
            kinds.add(kind)
        assert kinds == {"col", "row"}


def test_sp_first_step_and_prefill(runs):
    """``--sp`` at tp 2: the first step's loss and gradients within the
    witness of unsplit, the step's row-parallel sums reduce-scattered;
    a prefill's last logits within LOGIT_ULP (stablelm, and mixtral's MoE
    block gathering the sequence)."""
    un = runs["unsplit"]
    for res in runs["ranks"]["tp2"]:
        _check_grads(res["sp"], un["stablelm"], un["stablelm_witness"])
        assert res["sp"]["collectives"]["reduce_scatter@model"][0] > 0
        for arch, got in res["sp_prefill"].items():
            _close_logits(got, un["sp_prefill"][arch])


@pytest.mark.parametrize("tag", ["pure_dp", "fsdp", "fsdp_remat"])
def test_zero3_first_step_matches_unsplit(runs, tag):
    """``--pure-dp`` (two ranks) and ``--fsdp`` (2 x 2): the first step's
    loss and gradients (this rank's slices of the data ranks' sums,
    gathered) within the witness of unsplit; every rank's loss the
    same."""
    group = "tp2" if tag == "pure_dp" else "fsdp"
    ranks = runs["ranks"][group]
    un = runs["unsplit"]
    for res in ranks:
        _check_grads(res[tag], un["smollm"], un["smollm_witness"])
    assert len({r[tag]["loss"] for r in ranks}) == 1


@pytest.mark.parametrize("tag", ["pure_dp", "fsdp"])
def test_zero3_rank_holds_its_share(runs, tag):
    """Each rank's parameter elements: every leaf its whole over the
    ranks its spec splits it over; under ``--pure-dp`` every leaf with a
    dim the two ranks divide is split (1/n of it held), under ``--fsdp``
    the moments' ZeRO-1 slice on the parameters."""
    group = "tp2" if tag == "pure_dp" else "fsdp"
    for res in runs["ranks"][group]:
        held = res[tag]["held"]
        for whole, mine, n, shape in held:
            assert mine * n == whole, (shape, whole, mine, n)
            if tag == "pure_dp" and any(d % 2 == 0 for d in shape):
                assert n == 2, shape
        assert sum(m for _, m, _, _ in held) < sum(w for w, _, _, _ in held)


def test_fsdp_remat_gathers_again_in_the_backward(runs):
    """Under ``cfg.remat`` a layer's gathered weights are freed and
    gathered again in the backward: more gathers over the data ranks,
    the same loss and gradients."""
    for res in runs["ranks"]["fsdp"]:
        a, b = res["fsdp"], res["fsdp_remat"]
        assert a["loss"] == b["loss"]
        for g, h in zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])):
            assert (g is None and h is None) or torch.equal(g, h)
        calls = {k: v[0] for k, v in a["collectives"].items()}
        again = {k: v[0] for k, v in b["collectives"].items()}
        gathered = [k for k in calls if k.startswith(("all_gather@data",
                                                      "all_reduce@data"))]
        assert gathered and sum(again[k] for k in gathered) \
            > sum(calls[k] for k in gathered)


@pytest.mark.parametrize("tag", ["sp", "pure_dp", "fsdp"])
def test_dry_run_equals_the_ranks(runs, tag):
    """The dry run's trace of each flag's first step (rank 0 of the
    mesh, fake process group): collectives by mesh axes, calls and bytes,
    equal to what every rank issued."""
    group = "fsdp" if tag == "fsdp" else "tp2"
    want = runs["ranks"]["dry"][0][tag]["per_device"]["collectives"]
    want = {k: [int(c), int(b)] for k, (c, b) in want.items()}
    for res in runs["ranks"][group]:
        got = {k: [int(c), int(b)] for k, (c, b)
               in res[tag]["collectives"].items()}
        assert got == want, (got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "stablelm-1.6b"])
@pytest.mark.parametrize("tag", ["fsdp", "pure_dp"])
def test_zero3_specs_equal_the_reference(runs, arch, tag):
    """``placement(..., zero3=)``'s parameter specs before sanitizing are
    the reference's: ``opt_specs(param_specs)`` over the data axis
    (``--fsdp``) and ``fsdp_specs`` over both axes (``--pure-dp``), on
    the reference's two-device host mesh's metadata (data 1, model 2)."""
    from repro_torch.launch.specs import (
        fsdp_specs,
        opt_specs,
        param_shapes,
        param_specs,
    )

    class Mesh:
        axis_names, shape = ("data", "model"), (1, 2)

    cfg = get_config(arch, smoke=True)
    shapes = param_shapes(cfg)
    specs = opt_specs(param_specs(shapes), ("data",)) if tag == "fsdp" \
        else fsdp_specs(shapes, ("data", "model"), Mesh)
    ref = runs["reference"]
    flat = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = tree

    walk(specs)
    assert flat
    for key, spec in flat.items():
        want = str(ref[f"spec/{arch}/{tag}/{key}"])
        assert repr(tuple(spec)) == want, (key, spec, want)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        reference_main(sys.argv[2])
