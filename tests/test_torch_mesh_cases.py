"""The mesh's remaining cases, on the CPU: cut heads, the recurrent and
hybrid stacks at tp 2, the multi-pod batch, ZeRO-1 moments and the served
forward on a mesh.

Spawned ``gloo`` groups run the port's sharded paths on their own shards
with the plain versions of every op, each group under its own time limit
(``JOIN_S``), all spawned at once by one fixture:

- ``smollm``: smollm-360m's smoke config at tp 2 — 3 query heads over 1
  kv head, so both a query head and the kv head are cut
  (:func:`repro_torch.models.transformer.head_plan`);
- ``rwkv6`` and ``zamba2``: the recurrent stack and the hybrid stack at
  tp 2 (their heads, the token shifts, the conv window and the gated
  norm split over the model ranks);
- ``pod``: a (pod 2, data 2, model 1) mesh of four ranks whose batch runs
  over both mesh axes (one flattened group), and a ZeRO-1 step on it.

Each tp-2 group trains the first step (its gradients gathered whole)
and serves a prefill and decode steps, against the unsplit port in this
process (the unsplit port is held to the reference by the other
``test_torch_*`` files). Tolerances: a first step's loss within 8
float32 ulps of the unsplit one (``tests/test_torch_mesh.py``'s), every
gradient leaf within one bf16 ulp of its largest magnitude or twice a
witness's distance, whichever is larger. The split changes only the
order of float additions — the vocabulary-parallel head's input
gradient, the gathered heads' and the norms' sums over the ranks — but
under ``backward='approx'`` each gradient product re-quantizes its
operands to 8-bit magnitudes, where one float32 ulp can move a value
across a rounding edge (a step of 1/255 of the operand's largest): the
witness is the unsplit run with the head's input gradient summed in
float32 by one GEMM (chip_smoke.py phase 18's order witness). The
served logits are held within ``LOGIT_ULP`` bf16 ulps of the unsplit
run's largest logit. The ZeRO-1 update is elementwise, so its step is
``torch.equal`` to the unsharded one.
"""
from __future__ import annotations

import datetime
import time
from pathlib import Path

import pytest
import torch

from repro_torch import checkpoint as t_ckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.core.tree import tree_leaves, tree_map, value_and_grad
from repro_torch.data import make_source, torch_batch
from repro_torch.launch import sharding as shardlib
from repro_torch.launch import train as t_train
from repro_torch.launch.specs import (
    batch_axes_for,
    cache_specs,
    local_slice,
    sanitize_specs,
)

torch.set_num_threads(1)

SHAPE = ShapeConfig("mesh", 16, 4, "train")
SIMDIVE = ApproxConfig(mode="simdive", backward="approx")
LOSS_RTOL = 8 * 2.0 ** -23
GRAD_ULP = 2.0 ** -8
LOGIT_ULP = 6 * 2.0 ** -8
JOIN_S = 240                         # each spawned group's own time limit
PROMPT, STEPS = 8, 4                 # the served cases: prefill, decode
ARCHS = {"smollm": "smollm-360m", "rwkv6": "rwkv6-1.6b",
         "zamba2": "zamba2-2.7b"}
GROUPS = {"smollm": 2, "rwkv6": 2, "zamba2": 2, "pod": 4}


def _config(run: str):
    return get_config(ARCHS[run], smoke=True).with_approx(SIMDIVE)


def _serve_config(run: str):
    """The served cases run divider-only, as ``serve --approx simdive``."""
    from repro_torch.launch.serve import serving_config

    return serving_config(ARCHS[run], smoke=True, approx="simdive")


def first_grads(cfg) -> tuple:
    """(loss, gradients) of the first step at SHAPE on the CPU, as
    ``launch.train.train`` takes it; on a mesh every gradient gathered
    whole."""
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    params = lm.init(0)
    mesh = shardlib.current_mesh()
    psh = None
    if mesh is not None:
        psh = t_train.placement(cfg, mesh)[0]["params"]
        params = tree_map(lambda p, s: s.local(p).contiguous(), params, psh)
    batch = torch_batch(t_train.local_rows(
        make_source(cfg, SHAPE, seed=0).batch(0)), "cpu")
    loss, grads = value_and_grad(lm.train_loss)(params, batch)
    grads = t_train.sum_over_data(grads)
    if mesh is not None:
        grads = tree_map(lambda g, s: None if g is None
                         else t_ckpt.gather_full(g, s), grads, psh)
    return float(loss), grads


class _HeadInF32(torch.autograd.Function):
    """The head's ``x @ w`` with its input gradient accumulated in
    float32 by one GEMM and rounded once (the witness's only change)."""

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


def witness_grads(cfg) -> tuple:
    """:func:`first_grads` unsplit with the head's input gradient in
    float32 (patches the model module's ``dense``, the head's alone)."""
    from repro_torch.models import model

    saved = model.dense
    model.dense = lambda x, w, approx=None, split=None: _HeadInF32.apply(
        x, w)
    try:
        return first_grads(cfg)
    finally:
        model.dense = saved


def served(cfg, max_seq: int) -> dict:
    """A prefill of PROMPT tokens (its last logits and its cache) and
    STEPS decode steps from an empty cache of ``max_seq`` slots fed the
    prompt's first tokens (each step's logits): on a mesh this rank's
    parameters, the logits gathered over the vocabulary."""
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    params = lm.init(0)
    mesh = shardlib.current_mesh()
    if mesh is not None:
        psh = t_train.placement(cfg, mesh)[0]["params"]
        params = tree_map(lambda p, s: s.local(p).contiguous(), params, psh)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen)

    def whole(lg):
        if lg.shape[-1] < cfg.vocab_size:
            return shardlib.all_gather(lg, "vocab", -1)
        return lg

    shardlib.reset_collective_counts()
    logits, cache = lm.prefill(params, {"tokens": tokens})
    out = {"prefill_collectives": shardlib.collective_counts(),
           "prefill": whole(logits), "cache": cache, "steps": []}
    dcache = lm.empty_cache(2, max_seq)
    for i in range(STEPS):
        lg, dcache = lm.decode_step(params, dcache, tokens[:, i], i,
                                    max_seq=max_seq)
        out["steps"].append(whole(lg))
    return out


def _rank_main(rank, world, group, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_S))
    res = {}
    try:
        if group == "pod":
            res.update(_pod_cases())
        else:
            mesh = t_train.make_host_mesh(model=2)
            with shardlib.use_rules(mesh, {"batch": ("data",)}):
                res["grads"] = first_grads(_config(group))
                scfg = _serve_config(group)
                res["serve"] = served(scfg, PROMPT)
                res["cache_specs"] = sanitize_specs(
                    *cache_specs(scfg, ShapeConfig("c", PROMPT, 2,
                                                   "decode"), mesh)[::-1],
                    mesh)
                res["coords"] = {a: mesh.coord(a) for a in mesh.axis_names}
                res["axis"] = (mesh.axis_names, mesh.shape)
    finally:
        torch.save(res, f"{out}.{rank}")
        dist.destroy_process_group()


def _pod_cases() -> dict:
    """On (pod 2, data 2, model 1): the first step with the batch over
    ("pod", "data"), and a ZeRO-1 step against the unsharded step."""
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.models import build
    from repro_torch.optim import adamw

    mesh = _make_mesh((2, 2, 1), ("pod", "data", "model"))
    out = {}
    with shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}):
        out["rank_in_batch"] = shardlib.rank_in("batch")
        out["grads"] = first_grads(_config("smollm"))
        cfg = _config("smollm")
        lm = build(cfg, "cpu")
        shardings, split = t_train.placement(cfg, mesh, zero1=True)
        params = lm.init(0, shardings["params"])
        opt = adamw(1e-3)
        batch = torch_batch(t_train.local_rows(
            make_source(cfg, SHAPE, seed=0).batch(0)), "cpu")
        plain = t_train.make_train_step(lm, opt, split=split)
        want_p, want_s, _ = plain(params, opt.init(params), batch)
        zero1 = t_train.zero1_layout(shardings)
        state = opt.init(params)
        state = {"mu": tree_map(lambda z, m: z.cut(m), zero1, state["mu"]),
                 "nu": tree_map(lambda z, m: z.cut(m), zero1, state["nu"]),
                 "step": state["step"]}
        want_mu = tree_map(lambda z, m: z.cut(m), zero1, want_s["mu"])
        shardlib.reset_collective_counts()
        step = t_train.make_train_step(lm, opt, split=split, zero1=zero1)
        got_p, got_s, _ = step(params, state, batch)
        out["zero1_collectives"] = shardlib.collective_counts(by_axis=True)
        out["zero1"] = {
            "params": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got_p), tree_leaves(want_p))),
            "mu": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got_s["mu"]), tree_leaves(want_mu))),
            "sliced": sum(z.dim is not None for z in tree_leaves(zero1)),
            "moment_shapes": all(
                tuple(m.shape) == tuple(s.local(p).shape) for m, s, p in zip(
                    tree_leaves(got_s["mu"]),
                    tree_leaves(shardings["opt"]["mu"]),
                    tree_leaves(lm.init(0))))}
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


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cases")
    start = time.monotonic()
    spawned = {g: _spawn(g, tmp) for g in GROUPS}
    unsplit = {}
    for run in ARCHS:
        unsplit[run] = {"grads": first_grads(_config(run)),
                        "witness": witness_grads(_config(run)),
                        "serve": served(_serve_config(run), PROMPT)}
    unsplit["pod"] = {"grads": unsplit["smollm"]["grads"],
                      "witness": unsplit["smollm"]["grads"]}
    ranks = {}
    for g, (ctx, d) in spawned.items():
        _join(ctx, g, start + JOIN_S)
        ranks[g] = [torch.load(f"{d}/out.{r}", weights_only=False)
                    for r in range(GROUPS[g])]
    return {"ranks": ranks, "unsplit": unsplit}


def _check_grads(got: tuple, want: tuple, witness: tuple) -> None:
    loss, grads = got
    loss0, grads0 = want
    assert abs(loss - loss0) <= LOSS_RTOL * abs(loss0), (loss, loss0)
    for g, g0, gw in zip(tree_leaves(grads), tree_leaves(grads0),
                         tree_leaves(witness[1])):
        assert (g is None) == (g0 is None)
        if g is None:
            continue
        assert g.shape == g0.shape
        top = float(g0.float().abs().max())
        err = float((g.float() - g0.float()).abs().max())
        w_err = float((gw.float() - g0.float()).abs().max())
        assert err <= max(GRAD_ULP * top, 2 * w_err), (err, top, w_err)


@pytest.mark.parametrize("run", ["smollm", "rwkv6", "zamba2", "pod"])
def test_first_step_on_the_mesh_matches_unsplit(cases, run):
    """The first step's loss and gathered gradients on the mesh against
    the unsplit port's, on rank 0 (the loss is every rank's)."""
    ranks = cases["ranks"][run]
    want = cases["unsplit"][run]
    _check_grads(ranks[0]["grads"], want["grads"], want["witness"])
    assert all(r["grads"][0] == ranks[0]["grads"][0] for r in ranks)


def test_cut_heads_gather_once_a_block(cases):
    """smollm's smoke config at tp 2 cuts a query head and the kv head:
    each block of the prefill gathers q / k / v once and the attention
    output once (in training, the gradients of both are all-reduced)."""
    from repro_torch.models.transformer import head_plan

    assert head_plan(3, 1, 2, 0) == (0, 2, 0, 1, False)
    assert head_plan(3, 1, 2, 1) == (2, 3, 0, 1, False)
    cfg = _config("smollm")
    for res in cases["ranks"]["smollm"]:
        c = res["serve"]["prefill_collectives"]
        assert c["all_gather"] == 2 * cfg.n_layers, c


@pytest.mark.parametrize("H,KV,tp", [(15, 5, 2), (15, 5, 16), (32, 8, 16),
                                     (40, 8, 16), (12, 2, 16), (24, 24, 16),
                                     (3, 1, 2), (20, 4, 8)])
def test_head_plan_covers_every_head_once(H, KV, tp):
    """Every query head goes to one rank, over the kv head it reads, every
    rank's heads fit the kernels (an integral group of at most 8), and
    rank 0 — the one the dry run traces — holds some."""
    from repro_torch.models.transformer import head_plan

    G, seen = H // KV, []
    for r in range(tp):
        q0, q1, k0, k1, per_head = head_plan(H, KV, tp, r)
        seen += list(range(q0, q1))
        if q1 == q0:
            continue
        if per_head:
            assert k1 - k0 > 1
        else:
            assert (q1 - q0) % (k1 - k0) == 0 and (q1 - q0) // (k1 - k0) <= 8
            assert all(h // G - k0 == (h - q0) // ((q1 - q0) // (k1 - k0))
                       for h in range(q0, q1))
    assert seen == list(range(H))
    assert head_plan(H, KV, tp, 0)[1] > 0


@pytest.mark.parametrize("run", ["smollm", "rwkv6", "zamba2"])
def test_served_forward_on_the_mesh_matches_unsplit(cases, run):
    """The prefill's last logits and every decode step's, gathered over
    the vocabulary, within LOGIT_ULP of the unsplit run's largest logit;
    and each rank's prefill cache the unsplit cache's slice under
    ``cache_specs`` (sanitized), within LOGIT_ULP of its largest
    magnitude: past the first row-parallel sum every layer's input moves
    by that sum's bf16 rounding, as the logits do."""
    want = cases["unsplit"][run]["serve"]
    for res in cases["ranks"][run]:
        got = res["serve"]
        tol = LOGIT_ULP * float(want["prefill"].abs().max())
        assert float((got["prefill"] - want["prefill"]).abs().max()) <= tol
        for g, w in zip(got["steps"], want["steps"]):
            tol = LOGIT_ULP * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol
        names, shape = res["axis"]
        mesh = _Coords(names, shape, res["coords"])
        specs = res["cache_specs"]
        tree_map(lambda full, spec, mine: _close_slice(full, spec, mine,
                                                       mesh),
                 want["cache"], specs, got["cache"])


def _close_slice(full, spec, mine, mesh):
    part = local_slice(full, spec, mesh)
    assert part.shape == mine.shape, (part.shape, mine.shape)
    top = float(full.float().abs().max())
    assert float((part.float() - mine.float()).abs().max()) <= LOGIT_ULP * top


class _Coords:
    def __init__(self, names, shape, coords):
        self.axis_names, self.shape, self._c = names, shape, coords

    def coord(self, axis):
        return self._c[axis]


def test_multi_pod_batch_runs_over_one_flattened_group(cases):
    """(pod 2, data 2): each rank's index along the batch is its pod and
    data coordinates, pod first, as ``local_slice`` lays a batch out."""
    got = sorted(r["rank_in_batch"] for r in cases["ranks"]["pod"])
    assert got == [0, 1, 2, 3]


def test_zero1_step_equals_the_unsharded_step(cases):
    """The moments held as this rank's data slice (``opt_specs`` over
    ("pod", "data")), the update on the slices, the parameters gathered
    back: parameters and moments ``torch.equal`` to the unsharded step's;
    the gathers run over the flattened (pod, data) group."""
    for res in cases["ranks"]["pod"]:
        z = res["zero1"]
        assert z["params"] and z["mu"] and z["sliced"] > 0, z
        assert z["moment_shapes"], z
        assert res["zero1_collectives"]["all_gather@pod+data"][0] \
            == z["sliced"]
