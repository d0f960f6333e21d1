"""The port's mesh against the reference's, on the CPU.

Spawned ``gloo`` groups of 2 and 3 processes run the port's sharded paths
(:mod:`repro_torch.launch.sharding`) on their own shards, with the plain
versions of every op: a tensor-parallel group (data 1, model 2), a
3-way tensor-parallel group and a data-parallel one (data 2, model 1),
each spawned once per module by one fixture that returns every case's
numbers. The reference's SPMD numbers — the vocab-parallel ``xent``,
``_moe_ffn_spmd`` and ``compress_psum`` under ``make_host_mesh(model=2)``
— come from one subprocess that runs this file as a script with two
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``) and
writes an ``.npz``; this module itself imports no JAX.

Tolerances. Every SIMDive linear's forward and, over the model axis,
both gradient products under ``backward='approx'`` are held
``torch.equal``: the split changes no integer and no scale. Float paths
differ from the unsplit run in the order of float additions only: the
vocab-parallel log-sum-exp and the loss's per-rank sums (the first
step's loss within ``LOSS_RTOL``, 8 float32 ulps), and the bf16 GEMMs
whose float32 accumulators run over a part of their operands (a column
slice of the head, a data rank's rows of a weight gradient), each of
whose outputs rounds to a bf16 neighbour at most: a gradient leaf within
one bf16 ulp of its largest magnitude (``GRAD_ULP``, 2^-8 of it). The
MoE block's expert outputs are bf16 partial sums over the hidden slices
(the reference's ``_moe_ffn_spmd`` adds them so too), which move the
block's output by bf16 roundings: its loss and gradients are held to
twice a witness, the unsplit run with every MoE block output moved by one
bf16 ulp (its lowest mantissa bit flipped). The second step's loss
follows AdamW's first, sign-like update, in which a gradient element that
float order moves across zero turns its parameter's step around (2 lr):
``STEP2_RTOL``, 1e-4 of the loss.
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
from repro_torch.core.tree import tree_leaves, tree_map, value_and_grad
from repro_torch.data import make_source, torch_batch
from repro_torch.launch import sharding as shardlib
from repro_torch.launch import train as t_train
from repro_torch.launch.specs import local_slice

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("mesh", 16, 4, "train")
SIMDIVE = ApproxConfig(mode="simdive", backward="approx")
LOSS_RTOL = 8 * 2.0 ** -23
GRAD_ULP = 2.0 ** -8
STEP2_RTOL = 1e-4
JOIN_S = 240                         # a spawned group's own time limit
RUNS = {  # name: (arch, approx, tp); each trained 2 steps at SHAPE
    "stablelm": ("stablelm-1.6b", SIMDIVE),
    "smollm": ("smollm-360m", SIMDIVE),
    "moe": ("mixtral-8x7b", ApproxConfig()),
}
GROUPS = {  # name: (world, tp, runs)
    "tp2": (2, 2, ("stablelm", "moe")),
    "tp3": (3, 3, ("smollm",)),
    "dp2": (2, 1, ("smollm",)),
}
LINEAR = (6, 64, 32)                 # M, K, N of the SIMDive linear cases


# ------------------------------------------------------------- inputs ----
def inputs() -> dict:
    """Every case's numpy inputs, from seed 0."""
    rng = np.random.default_rng(0)
    D, F, E = 96, 192, 4
    M, K, N = LINEAR
    return {
        "lg": (rng.standard_normal((2, 8, 64)) * 3).astype(np.float32),
        "lab": rng.integers(0, 64, (2, 8)).astype(np.int32),
        "router": (rng.standard_normal((D, E)) * D ** -0.5).astype(
            np.float32),
        "w1": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(
            np.float32),
        "w3": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(
            np.float32),
        "w2": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(
            np.float32),
        "sw1": (rng.standard_normal((D, F)) * D ** -0.5).astype(np.float32),
        "sw3": (rng.standard_normal((D, F)) * D ** -0.5).astype(np.float32),
        "sw2": (rng.standard_normal((F, D)) * F ** -0.5).astype(np.float32),
        "x": rng.standard_normal((2, 8, D)).astype(np.float32),
        "g": rng.standard_normal((2, 5, 7)).astype(np.float32),
        "r": (rng.standard_normal((2, 5, 7)) * 1e-3).astype(np.float32),
        "lin_x": rng.standard_normal((M, K)).astype(np.float32),
        "lin_w": (rng.standard_normal((K, N)) * K ** -0.5).astype(
            np.float32),
        "lin_g": rng.standard_normal((M, N)).astype(np.float32),
    }


def moe_params(a: dict, lib) -> dict:
    """The MoE block's tree from :func:`inputs` (``lib``: an array maker)."""
    return {"router": lib(a["router"]), "w1": lib(a["w1"]),
            "w3": lib(a["w3"]), "w2": lib(a["w2"]),
            "shared": {"w1": lib(a["sw1"]), "w3": lib(a["sw3"]),
                       "w2": lib(a["sw2"])}}


def reference_main(out: str) -> None:
    """The reference's SPMD paths on two host devices (run as a script)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP

    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import use_rules
    from repro.models.loss import _plain_xent, xent
    from repro.models.moe import moe_ffn
    from repro.optim.grad_compress import compress_psum

    assert len(jax.devices()) == 2, jax.devices()
    a = inputs()
    mesh = make_host_mesh(model=2)
    lg, lab = jnp.asarray(a["lg"]), jnp.asarray(a["lab"])
    with use_rules(mesh):
        xe = xent(lg, lab)
        moe_out, moe_aux = moe_ffn(jnp.asarray(a["x"]),
                                   moe_params(a, jnp.asarray), top_k=1,
                                   capacity_factor=4.0)
    g_plain = jax.grad(lambda v: jnp.mean(_plain_xent(v, lab)))(lg)
    fn = shard_map(lambda g, r: compress_psum(g[0], r[0], "model"),
                   mesh=mesh, in_specs=(JP("model"), JP("model")),
                   out_specs=(JP(), JP("model")), check_rep=False)
    cg, cr = fn(jnp.asarray(a["g"]), jnp.asarray(a["r"]))
    np.savez(out, xent=np.asarray(xe), g_plain=np.asarray(g_plain),
             moe_out=np.asarray(moe_out), moe_aux=np.asarray(moe_aux),
             cg=np.asarray(cg), cr=np.asarray(cr).reshape(2, 5, 7))


# --------------------------------------------------------------- ranks ----
def _config(run: str):
    arch, approx = RUNS[run]
    return get_config(arch, smoke=True).with_approx(approx)


def first_grads(cfg) -> tuple:
    """(loss, gradients) of the first step at SHAPE on the CPU, as
    :func:`repro_torch.launch.train.train` takes it: this rank's
    parameters and rows, the data ranks' gradients added; on a mesh every
    gradient gathered whole (rank 0's are returned, the others'
    None)."""
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


def init_cut_equal(cfg) -> bool:
    """``LM.init(0, shardings)`` (each leaf cut as it is drawn) equal to
    the unsplit ``LM.init(0)`` sliced, leaf for leaf."""
    from repro_torch.models import build

    lm = build(cfg, "cpu")
    psh = t_train.placement(cfg, shardlib.current_mesh())[0]["params"]
    cut = tree_leaves(lm.init(0, psh))
    sliced = tree_leaves(tree_map(lambda p, s: s.local(p), lm.init(0), psh))
    return len(cut) == len(sliced) and all(
        a.shape == b.shape and torch.equal(a, b) for a, b in zip(cut,
                                                                 sliced))


def _linear_cases(a: dict, tp: int) -> dict:
    """Each SIMDive linear split over the mesh, forward and both gradient
    products beside the unsplit linear's (full tensors on every rank)."""
    from repro_torch.models.layers import dense

    M, K, N = LINEAR
    x0, w0, g0 = (torch.from_numpy(a[k]) for k in ("lin_x", "lin_w",
                                                   "lin_g"))
    out = {}
    with shardlib.use_rules(_NO_MESH):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = dense(x, w, SIMDIVE)
        y.backward(g0)
        out["full"] = (y.detach(), x.grad, w.grad)
    r = shardlib.rank_in("ff") if tp > 1 else shardlib.rank_in("batch")
    if tp == 1:                          # data-parallel: this rank's rows
        m = M // shardlib.logical_axis_size("batch")
        y = dense(x0[r * m:(r + 1) * m], w0, SIMDIVE)
        out["dp"] = y.detach()
        return out
    n, k = N // tp, K // tp
    x, w = x0.clone().requires_grad_(), w0[:, r * n:(r + 1) * n].clone()
    w.requires_grad_()
    y = dense(x, w, SIMDIVE, ("col", "ff"))
    y.backward(g0[:, r * n:(r + 1) * n])
    out["col"] = (y.detach(), x.grad, w.grad)
    x = x0[:, r * k:(r + 1) * k].clone().requires_grad_()
    w = w0[r * k:(r + 1) * k].clone().requires_grad_()
    y = dense(x, w, SIMDIVE, ("row", "ff"))
    y.backward(g0)
    out["row"] = (y.detach(), x.grad, w.grad)
    return out


class _NoMesh:
    """A mesh of one rank a dim: binding it changes nothing but the loss's
    branch, so ``use_rules(_NO_MESH)`` inside a rank runs unsplit."""
    axis_names = ("data", "model")
    shape = (1, 1)


_NO_MESH = _NoMesh()


def _tp2_cases(a: dict, ckpt_dir: str) -> dict:
    from repro_torch.models.loss import xent
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim.grad_compress import compress_psum

    r = shardlib.rank_in("vocab")
    out = {}
    lg = torch.from_numpy(a["lg"])[..., r * 32:(r + 1) * 32]
    lg.requires_grad_()
    per_tok = xent(lg, torch.from_numpy(a["lab"]).long())
    per_tok.mean().backward()
    out["xent"], out["xent_grad"] = per_tok.detach(), lg.grad
    p = moe_params(a, torch.from_numpy)
    x = torch.from_numpy(a["x"])
    # experts the placement left whole (a hidden dim the axis does not
    # divide): every model rank computes the whole block
    out["moe_block_whole"] = moe_ffn(x, p, top_k=1, capacity_factor=4.0)
    f = 192 // 2
    for name in ("w1", "w3"):
        p[name] = p[name][..., r * f:(r + 1) * f]
        p["shared"][name] = p["shared"][name][:, r * f:(r + 1) * f]
    p["w2"] = p["w2"][:, r * f:(r + 1) * f]
    p["shared"]["w2"] = p["shared"]["w2"][r * f:(r + 1) * f]
    out["moe_block"] = moe_ffn(x, p, top_k=1, capacity_factor=4.0,
                               split=True)
    out["moe_block_simdive"] = moe_ffn(x, p, top_k=1, capacity_factor=4.0,
                                       approx=SIMDIVE, split=True)
    cg, cr = compress_psum({"g": torch.from_numpy(a["g"][r])},
                           {"g": torch.from_numpy(a["r"][r])}, "model")
    out["compress"] = (cg["g"], cr["g"])
    # elastic restore: a checkpoint written unsplit, read on this mesh
    cfg = _config("stablelm")
    shardings = t_train.placement(cfg, shardlib.current_mesh())[0]
    out["restored"] = t_ckpt.restore(ckpt_dir, shardings=shardings)[1]
    # splits once refused: the recurrent stacks at tp 2 and a cut
    # head (smollm-360m's 15 query heads over 2 ranks) now place
    placed = {}
    for arch, smoke in (("rwkv6-1.6b", True), ("zamba2-2.7b", True),
                        ("smollm-360m", False)):
        sh = t_train.placement(get_config(arch, smoke=smoke),
                               shardlib.current_mesh())[0]["params"]
        layer = sh["stack"]["layers"]
        name = {"rwkv6-1.6b": "wr", "zamba2-2.7b": "wz"}.get(arch, "wq")
        placed[arch] = tuple(layer[name].spec)
    out["refusals"] = placed
    return out


def _compress_step_case() -> dict:
    """One ``grad_compress`` step with ``compress_axis="batch"`` (smollm
    smoke, this data rank's rows) beside its plain form: every data rank's
    gradients (added in here over the group, one rank's slot each)
    quantized on their own, the int8 payloads summed and rescaled by the
    larger scale, then the same AdamW update."""
    from repro_torch.models import build
    from repro_torch.optim import adamw, zero_residual
    from repro_torch.optim.grad_compress import quantize_grad

    cfg = _config("smollm")
    lm = build(cfg, "cpu")
    params, opt = lm.init(0), adamw(1e-3)
    batch = torch_batch(t_train.local_rows(
        make_source(cfg, SHAPE, seed=0).batch(0)), "cpu")
    step = t_train.make_train_step(lm, opt, grad_compress=True,
                                   compress_axis="batch")
    got, _, got_res, _ = step(params, opt.init(params),
                              zero_residual(params), batch)
    _, grads = value_and_grad(lm.train_loss)(params, batch)
    n, r = shardlib.logical_axis_size("batch"), shardlib.rank_in("batch")

    def every(p, g):
        slots = torch.zeros((n,) + tuple(p.shape), dtype=torch.float32)
        if g is not None:
            slots[r] = g.to(torch.float32)
        return shardlib.all_reduce(slots, "batch")

    qs = tree_map(lambda s: [quantize_grad(s[i], torch.zeros_like(s[i]))
                             for i in range(n)],
                  tree_map(every, params, grads))
    want = tree_map(lambda q: sum(x.to(torch.int32) for x, _, _ in q).to(
        torch.float32) * max(s for _, s, _ in q), qs)
    want_p = opt.update(want, opt.init(params), params)[0]
    want_res = tree_map(lambda q: q[r][2], qs)
    return {"params": (got, want_p), "res": (got_res, want_res)}


def _rank_main(rank, world, tp, group, store, out, a, ckpt_in, ckpt_out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_S))
    res = {}
    try:
        mesh = t_train.make_host_mesh(model=tp)
        with shardlib.use_rules(mesh, {"batch": ("data",)}):
            res["linears"] = _linear_cases(a, tp)
            if group == "tp2":
                res.update(_tp2_cases(a, ckpt_in))
            if group == "dp2":
                res["compress_step"] = _compress_step_case()
            for run in GROUPS[group][2]:
                res[run] = first_grads(_config(run))
                res[run + "_init"] = init_cut_equal(_config(run))
        for run in GROUPS[group][2]:
            ck = ckpt_out if run == "stablelm" else None
            params, losses = t_train.train(
                _config(run), SHAPE, steps=2, ckpt_dir=ck, tp=tp,
                device="cpu", log_every=10)
            res[run + "_train"] = (losses, params)
        res["mesh"] = (mesh.axis_names, mesh.shape, mesh.coord("data"),
                       mesh.coord("model"))
    finally:
        torch.save(res, f"{out}.{rank}")
        dist.destroy_process_group()


def _spawn(group: str, tmp: Path, a: dict, ckpt_in: str):
    import torch.multiprocessing as mp

    world, tp, _ = GROUPS[group]
    d = tmp / group
    d.mkdir()
    ctx = mp.spawn(_rank_main, args=(world, tp, group, str(d / "store"),
                                     str(d / "out"), a, ckpt_in,
                                     str(d / "ckpt")),
                   nprocs=world, join=False)
    return ctx, d


def _join(ctx, deadline: float) -> None:
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("a spawned gloo group did not finish in time")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    a = inputs()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    ref_path = tmp / "reference.npz"
    ref = subprocess.Popen([sys.executable, __file__, "--reference",
                            str(ref_path)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # an unsplit checkpoint for the elastic restore
    from repro_torch.models import build
    from repro_torch.optim import adamw

    cfg = _config("stablelm")
    params0 = build(cfg, "cpu").init(0)
    ckpt_in = str(tmp / "unsplit")
    t_ckpt.save(ckpt_in, 0, {"params": params0,
                             "opt": adamw(1e-3).init(params0)})
    deadline = time.monotonic() + JOIN_S
    spawned = {g: _spawn(g, tmp, a, ckpt_in) for g in GROUPS}
    unsplit = {}
    for run in RUNS:
        loss, grads = first_grads(_config(run))
        _, losses = t_train.train(_config(run), SHAPE, steps=2,
                                  ckpt_dir=None, device="cpu", log_every=10)
        unsplit[run] = (loss, grads, losses)
    with _moe_output_nudged():
        unsplit["moe_witness"] = first_grads(_config("moe"))
    ranks = {}
    for g, (ctx, d) in spawned.items():
        _join(ctx, deadline)
        ranks[g] = [torch.load(f"{d}/out.{r}", weights_only=False)
                    for r in range(GROUPS[g][0])]
        ranks[g + "_ckpt"] = str(d / "ckpt")
    log, _ = ref.communicate(timeout=max(deadline - time.monotonic(), 1.0))
    assert ref.returncode == 0, log.decode()[-3000:]
    with np.load(ref_path) as z:
        reference = {k: z[k] for k in z.files}
    return {"a": a, "ranks": ranks, "unsplit": unsplit,
            "reference": reference, "params0": params0}


@contextmanager
def _moe_output_nudged():
    """Every MoE block output moved by one bf16 ulp (its lowest mantissa
    bit flipped): the MoE runs' witness."""
    from repro_torch.models import transformer

    saved = transformer.moe_ffn

    def nudged(*args, **kw):
        out, aux = saved(*args, **kw)
        assert out.dtype == torch.bfloat16
        moved = (out.detach().view(torch.int16) ^ 1).view(torch.bfloat16)
        return out + (moved - out.detach()), aux

    transformer.moe_ffn = nudged
    try:
        yield
    finally:
        transformer.moe_ffn = saved


# --------------------------------------------------------------- tests ----
def test_mesh_is_data_by_model(mesh_runs):
    for g, (world, tp, _) in GROUPS.items():
        coords = set()
        for res in mesh_runs["ranks"][g]:
            names, shape, dc, mc = res["mesh"]
            assert names == ("data", "model")
            assert shape == (world // tp, tp)
            coords.add((dc, mc))
        assert len(coords) == world


def test_xent_vocab_parallel_matches_reference(mesh_runs):
    ref = mesh_runs["reference"]
    for r, res in enumerate(mesh_runs["ranks"]["tp2"]):
        np.testing.assert_allclose(res["xent"].numpy(), ref["xent"],
                                   rtol=4 * 2.0 ** -23, atol=0)
        np.testing.assert_allclose(
            res["xent_grad"].numpy(),
            ref["g_plain"][..., r * 32:(r + 1) * 32],
            rtol=4 * 2.0 ** -23, atol=1e-9)


def test_moe_spmd_matches_reference(mesh_runs):
    ref = mesh_runs["reference"]
    for res in mesh_runs["ranks"]["tp2"]:
        whole, whole_aux = res["moe_block_whole"]
        np.testing.assert_allclose(whole.numpy(), ref["moe_out"], rtol=0,
                                   atol=2e-6)
        assert abs(float(whole_aux) - float(ref["moe_aux"])) <= 1e-6
        out, aux = res["moe_block"]
        # float32 round-off of a D=96 / F=192 product chain, two partial
        # sums added: a few ulps of the output's magnitude (~1)
        np.testing.assert_allclose(out.numpy(), ref["moe_out"], rtol=0,
                                   atol=2e-6)
        assert abs(float(aux) - float(ref["moe_aux"])) <= 1e-6


def test_moe_spmd_shared_expert_runs_plain(mesh_runs):
    """The SPMD block's shared expert is plain matmuls, as the
    reference's ``_moe_ffn_spmd`` has it, whatever ``approx`` says; the
    unsharded block runs it through ``dense(approx)``."""
    from repro_torch.models.moe import moe_ffn

    a = mesh_runs["a"]
    for res in mesh_runs["ranks"]["tp2"]:
        (o, x), (os_, xs) = res["moe_block"], res["moe_block_simdive"]
        assert torch.equal(o, os_) and torch.equal(x, xs)
    p = moe_params(a, torch.from_numpy)
    x = torch.from_numpy(a["x"])
    exact = moe_ffn(x, p, top_k=1, capacity_factor=4.0)[0]
    approx = moe_ffn(x, p, top_k=1, capacity_factor=4.0, approx=SIMDIVE)[0]
    assert not torch.equal(exact, approx)


def test_compress_axis_step_is_compress_psum_over_the_data_ranks(
        mesh_runs):
    """``make_train_step(grad_compress=True, compress_axis="batch")`` at
    data 2: the parameters and residuals ``torch.equal`` to the step's
    plain form (:func:`_compress_step_case`)."""
    for res in mesh_runs["ranks"]["dp2"]:
        for got, want in res["compress_step"].values():
            assert tree_leaves(got) and all(
                torch.equal(x, y)
                for x, y in zip(tree_leaves(got), tree_leaves(want)))
    with pytest.raises(ValueError, match="shards of different parameters"):
        t_train.make_train_step(None, None, grad_compress=True,
                                compress_axis="model")


def test_compress_psum_matches_reference_bit_for_bit(mesh_runs):
    ref = mesh_runs["reference"]
    for r, res in enumerate(mesh_runs["ranks"]["tp2"]):
        cg, cr = res["compress"]
        assert np.array_equal(cg.numpy(), ref["cg"])
        assert np.array_equal(cr.numpy(), ref["cr"][r])


@pytest.mark.parametrize("split", ["col", "row"])
def test_simdive_linear_tensor_parallel_is_bit_equal(mesh_runs, split):
    M, K, N = LINEAR
    for r, res in enumerate(mesh_runs["ranks"]["tp2"]):
        y0, gx0, gw0 = res["linears"]["full"]
        y, gx, gw = res["linears"][split]
        n, k = N // 2, K // 2
        if split == "col":
            want = (y0[:, r * n:(r + 1) * n], gx0, gw0[:, r * n:(r + 1) * n])
        else:
            want = (y0, gx0[:, r * k:(r + 1) * k], gw0[r * k:(r + 1) * k])
        for got, exp in zip((y, gx, gw), want):
            assert torch.equal(got, exp)


def test_simdive_linear_data_parallel_forward_is_bit_equal(mesh_runs):
    m = LINEAR[0] // 2
    for r, res in enumerate(mesh_runs["ranks"]["dp2"]):
        y0 = res["linears"]["full"][0]
        assert torch.equal(res["linears"]["dp"], y0[r * m:(r + 1) * m])


def _leaf_errors(got: dict, want: dict) -> list:
    """(max |got - want|, max |want|) of every non-None leaf; a leaf
    None in one tree is None in the other."""
    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
            out.append((float((g.float() - w.float()).abs().max()),
                        float(w.abs().max())))
    return out


@pytest.mark.parametrize("group,run", [("tp2", "stablelm"), ("tp2", "moe"),
                                       ("tp3", "smollm"), ("dp2", "smollm")])
def test_train_on_mesh_matches_unsplit(mesh_runs, group, run):
    loss0, grads0, losses0 = mesh_runs["unsplit"][run]
    ranks = mesh_runs["ranks"][group]
    loss, grads = ranks[0][run]
    errs = _leaf_errors(grads, grads0)
    if run == "moe":
        w_loss, w_grads = mesh_runs["unsplit"]["moe_witness"]
        assert abs(loss - loss0) <= 2 * abs(w_loss - loss0)
        for (err, _), (w_err, _) in zip(errs, _leaf_errors(w_grads, grads0)):
            assert err <= 2 * w_err, (err, w_err)
    else:
        assert abs(loss - loss0) <= LOSS_RTOL * abs(loss0)
        for err, top in errs:
            assert err <= GRAD_ULP * top, (err, top)
    for res in ranks:
        losses = res[run + "_train"][0]
        assert losses == ranks[0][run + "_train"][0]
        assert len(losses) == 2
        assert abs(losses[0] - loss) <= LOSS_RTOL * abs(loss)
        assert abs(losses[1] - losses0[1]) <= STEP2_RTOL * abs(losses0[1])


@pytest.mark.parametrize("group", list(GROUPS))
def test_init_cuts_each_leaf_as_drawn(mesh_runs, group):
    """A rank's ``LM.init(seed, shardings)`` is the unsplit tree sliced
    (the leaves cut as they are drawn, so no rank holds the whole
    model)."""
    for res in mesh_runs["ranks"][group]:
        for run in GROUPS[group][2]:
            assert res[run + "_init"] is True, run


def test_restore_elastic_both_ways(mesh_runs):
    """Written unsplit, read on the tp-2 mesh; written by the tp-2 run,
    read unsplit: bit for bit (tests/test_train_substrate.py's elastic
    case)."""
    params0 = mesh_runs["params0"]
    ranks = mesh_runs["ranks"]["tp2"]
    for res in ranks:
        names, shape, dc, mc = res["mesh"]
        mesh = _CoordMesh(names, shape, {"data": dc, "model": mc})
        cfg = _config("stablelm")
        with shardlib.use_rules(mesh):
            psh = t_train.placement(cfg, mesh)[0]["params"]
        got = res["restored"]["params"]
        tree_map(lambda p, s, g: _assert_equal(s.local(p), g), params0,
                 psh, got)
    _, full = t_ckpt.restore(mesh_runs["ranks"]["tp2_ckpt"])
    assert t_ckpt.latest_step(mesh_runs["ranks"]["tp2_ckpt"]) == 2
    for res in ranks:
        names, shape, dc, mc = res["mesh"]
        mesh = _CoordMesh(names, shape, {"data": dc, "model": mc})
        with shardlib.use_rules(mesh):
            psh = t_train.placement(_config("stablelm"), mesh)[0]["params"]
        tree_map(lambda f, s, g: _assert_equal(
            local_slice(f, s.spec, mesh), g), full["params"], psh,
            res["stablelm_train"][1])


class _CoordMesh:
    """A mesh's metadata and one rank's coordinates, for slicing."""

    def __init__(self, names, shape, coords):
        self.axis_names, self.shape, self._coords = names, shape, coords

    def coord(self, axis):
        return self._coords[axis]


def _assert_equal(a, b):
    assert torch.equal(a, b)


def test_refusals_name_their_reason(mesh_runs):
    """Splits once refused now place, their projections split over
    the model axis (rwkv6's and Mamba2's heads, smollm-360m's 15 query
    heads cut over 2 ranks); the dry run's flags once refused (``--sp``,
    ``--pure-dp``, ``--fsdp``) now lower, each named in the cell's
    record, and the one combination left refused, ``--fsdp`` with
    ``--pure-dp`` (two placements of the parameters), raises naming
    it."""
    placed = mesh_runs["ranks"]["tp2"][0]["refusals"]
    for arch in ("rwkv6-1.6b", "zamba2-2.7b", "smollm-360m"):
        assert placed[arch] == (None, None, "model"), arch
    from repro_torch.launch import dryrun

    for flag in ("sp", "pure_dp", "fsdp"):
        meta = dryrun.lower_cell("stablelm-1.6b", "train_4k", False,
                                 **{flag: True})[-1]
        assert meta[flag] is True, (flag, meta)
    with pytest.raises(ValueError, match="two placements"):
        dryrun.lower_cell("stablelm-1.6b", "train_4k", False, fsdp=True,
                          pure_dp=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        reference_main(sys.argv[2])
