"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

Rank 0 of the production meshes runs a cell under the fake process group
on ``meta`` tensors. Held here: the parameter count of every config
against the reference's (``jax.eval_shape``); the bytes a rank holds
going into every ``shapes_for`` cell of every config, on both
production meshes, against a sum over the reference's own specs
(``repro.launch.specs``, the machinery of ``tests/test_torch_specs.py``);
the collectives a traced train step issues at world 2 against the ones
a spawned ``gloo`` group of two ranks issues in the same step; one FULL
production cell per family traced whole, inside its time and with the
process's peak memory growing under 1 GB; the flags of the next slice
refused with their reason; the SIMDive kernels counted only where the
config runs them; and a shape the card's kernel refuses making a cell an
error.
"""
from __future__ import annotations

import datetime
import json
import math
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as r_get_config
from repro.launch import specs as r_specs
from repro.models import build as r_build
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.configs import shapes_for
from repro_torch.core.approx import ApproxConfig
from repro_torch.launch import dryrun

torch.set_num_threads(1)

SHAPE = ShapeConfig("mesh", 16, 4, "train")
SIMDIVE = ApproxConfig(mode="simdive", backward="approx")
JOIN_S = 120                    # the spawned group's own time limit
CELL_S = 90                     # one FULL cell's trace on a shared CPU
FAMILY_CELLS = {"dense": "smollm-360m", "moe": "mixtral-8x7b",
                "vlm": "qwen2-vl-2b", "audio": "musicgen-medium",
                "ssm": "rwkv6-1.6b", "hybrid": "zamba2-2.7b"}
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _leave_no_group():
    """The dry run starts a fake default process group; end it."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------- the meshes --
@pytest.mark.parametrize("multi_pod", [False, True])
def test_check_mesh_refuses_no_full_config(multi_pod):
    """On both production meshes (tp 16) every FULL config places: the
    cut heads, the recurrent and the hybrid stacks included."""
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import check_mesh

    mesh_shape, _ = PRODUCTION[multi_pod]
    dryrun.fake_world(math.prod(mesh_shape))
    mesh = make_production_mesh(multi_pod=multi_pod)
    with shardlib.use_rules(mesh):
        for arch in ARCHS:
            check_mesh(get_config(arch))


# -------------------------------------------------------------- counts --
@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_equals_reference(arch):
    ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(
        jax.eval_shape(r_build(r_get_config(arch)).init,
                       jax.random.PRNGKey(0))))
    assert dryrun.n_params(get_config(arch)) == ref


class _Prod:
    def __init__(self, names, shape):
        self.axis_names, self.shape = names, shape

        class devices:
            pass

        devices.shape = shape
        self.devices = devices


def _local_bytes(sds, spec, sizes) -> int:
    """Bytes of this rank's slice of a reference ``ShapeDtypeStruct``
    under a (sanitized) reference spec."""
    shape = list(sds.shape)
    for i, part in enumerate(tuple(spec)):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        shape[i] //= math.prod(sizes[a] for a in axes)
    return math.prod(shape) * jnp.dtype(sds.dtype).itemsize


def _tree_bytes(sds_tree, spec_tree, sizes) -> int:
    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(spec_tree,
                            is_leaf=lambda x: isinstance(x, JP)
                            or x is None)
    assert len(leaves) == len(specs)
    return sum(_local_bytes(a, s, sizes) for a, s in zip(leaves, specs))


def _reference_argument_bytes(arch, shape, multi_pod) -> int:
    """What rank 0 holds going into the reference's cell, from its own
    specs: float32 parameters and ZeRO-1 moments and the batch (train),
    bf16 parameters and the batch (prefill) or the cache and the tokens
    (decode)."""
    names, mesh_shape = PRODUCTION[multi_pod][1], PRODUCTION[multi_pod][0]
    mesh = _Prod(names, mesh_shape)
    sizes = dict(zip(names, mesh_shape))
    cfg = r_get_config(arch)
    params = jax.eval_shape(r_build(cfg).init, jax.random.PRNGKey(0))
    if shape.kind != "train":
        params = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
            if s.dtype == jnp.float32 else s, params)
    pspecs = r_specs.sanitize_specs(r_specs.param_specs(params), params,
                                    mesh)
    total = _tree_bytes(params, pspecs, sizes)
    ba = r_specs.batch_axes_for(mesh)
    if shape.kind == "train":
        zspecs = r_specs.sanitize_specs(r_specs.opt_specs(pspecs, ba),
                                        params, mesh)
        f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                          jnp.float32),
                           params)
        total += 2 * _tree_bytes(f32, zspecs, sizes) + 4       # + step
    if shape.kind in ("train", "prefill"):
        bsds, bspec = r_specs.batch_specs(cfg, shape, mesh)
        bspec = r_specs.sanitize_specs(bspec, bsds, mesh)
        total += _tree_bytes(bsds, bspec, sizes)
    else:
        csds, cspec = r_specs.cache_specs(cfg, shape, mesh)
        cspec = r_specs.sanitize_specs(cspec, csds, mesh)
        total += _tree_bytes(csds, cspec, sizes)
        B = shape.global_batch
        tok = jax.ShapeDtypeStruct((B, cfg.n_codebooks) if cfg.n_codebooks
                                   else (B,), jnp.int32)
        tspec = r_specs.sanitize_specs(
            JP(ba if len(ba) > 1 else ba[0]), tok, mesh)
        total += _local_bytes(tok, tspec, sizes)
    return total


CELLS = [(arch, shp.name, mp) for arch in ARCHS
         for shp in shapes_for(get_config(arch)) for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_argument_bytes_equal_reference_specs(arch, shape, multi_pod):
    from repro.configs import SHAPES as R_SHAPES

    mesh_shape, axes = PRODUCTION[multi_pod]
    got = dryrun.argument_bytes(get_config(arch), SHAPES[shape], mesh_shape,
                                axes)
    assert got == _reference_argument_bytes(arch, R_SHAPES[shape],
                                            multi_pod)


# ------------------------------------------------- fake group vs gloo --
def _stablelm():
    return get_config("stablelm-1.6b", smoke=True).with_approx(SIMDIVE)


def _gloo_rank(rank, store, out):
    """One train step of smoke stablelm on (data 1, model 2) over gloo,
    its collectives counted by kind and mesh axes."""
    import torch.distributed as dist

    from repro_torch.data import make_source, torch_batch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch import train as t_train
    from repro_torch.models import build
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        mesh = t_train.make_host_mesh(model=2)
        with shardlib.use_rules(mesh, {"batch": ("data",)}):
            cfg = _stablelm()
            lm = build(cfg, "cpu")
            shardings, split = t_train.placement(cfg, mesh)
            params = lm.init(0, shardings["params"])
            opt = adamw(3e-4)
            batch = torch_batch(t_train.local_rows(
                make_source(cfg, SHAPE, seed=0).batch(0)), "cpu")
            step = t_train.make_train_step(lm, opt, split=split)
            state = opt.init(params)
            shardlib.reset_collective_counts()
            step(params, state, batch)
            counts = shardlib.collective_counts(by_axis=True)
        torch.save(counts, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_fake_group_counts_equal_a_gloo_group(tmp_path):
    """The collectives of one traced step at world 2 (smoke stablelm at
    tp 2: the kv-head layout, the split MLP, the vocabulary-parallel
    head and loss) are, call for call and byte for byte, those two gloo
    ranks issue in the same step."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_gloo_rank, args=(str(tmp_path / "store"),
                                     str(tmp_path / "out")),
                   nprocs=2, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo group did not finish in {JOIN_S} s")
    ranks = [torch.load(tmp_path / f"out.{r}") for r in range(2)]
    got = dryrun.trace_cell(_stablelm(), SHAPE, (1, 2), ("data", "model"),
                            zero1=False)["per_device"]["collectives"]
    assert ranks[0] == ranks[1]
    assert got == {k: list(v) for k, v in ranks[0].items()}
    assert got["all_reduce@model"][0] > 0


# ----------------------------------------------------------- the cells --
@pytest.mark.parametrize("family", list(FAMILY_CELLS))
def test_one_full_cell_per_family_traces(family):
    """A FULL-width decode cell of each family, every layer, on rank 0 of
    the single-pod mesh: ok, inside CELL_S, the process's peak memory
    growing under 1 GB (nothing of the cell is allocated)."""
    arch = FAMILY_CELLS[family]
    assert get_config(arch).family == family
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    res = dryrun.analyze(*dryrun.lower_cell(arch, "decode_32k", False))
    seconds = time.perf_counter() - t0
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert seconds < CELL_S, seconds
    assert grown * 1024 < 1e9, grown
    per = res["per_device"]
    assert res["n_devices"] == 256 and res["n_params"] > 1e8
    assert per["peak_bytes"] >= per["argument_bytes"] > 0
    assert per["bytes_accessed"] > 0 and per["flops"] > 0
    r = res["roofline"]
    assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert all(r[k] > 0 for k in ("compute_s", "memory_s"))
    if get_config(arch).family not in ("ssm",):
        kv = get_config(arch).n_kv_heads
        if kv % 16 == 0:
            assert per["kernels"]["decode_attention"]["launches"] > 0


@pytest.mark.parametrize("flag", ["--sp", "--pure-dp", "--fsdp"])
def test_flags_of_the_next_slice_name_their_reason(flag, tmp_path):
    """The flags once refused (``--sp``, ``--pure-dp``, ``--fsdp``) run:
    smollm-360m's train_4k single-pod cell (at one layer) records ``ok``
    with the flag, under the CLI's record name; beside both placements
    of the parameters (``--fsdp --pure-dp``) the CLI refuses it."""
    key = flag[2:].replace("-", "_")
    rec = dryrun.run_cell("smollm-360m", "train_4k", False,
                          out_dir=str(tmp_path), layers_override=1,
                          **{key: True})
    assert rec["status"] == "ok", rec.get("error")
    assert rec[key] is True
    (path,) = tmp_path.glob("*.json")
    assert json.loads(path.read_text())["status"] == "ok"
    assert path.stem.endswith(f"__{key}")
    with pytest.raises(SystemExit) as refused:
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                     "--mesh", "single", flag, "--fsdp", "--pure-dp",
                     "--out", str(tmp_path)])
    assert refused.value.code == 2


def test_simdive_kernels_counted_only_where_the_config_runs_them():
    """``approx`` is honoured: smollm-360m's decode step (2 of its 32
    layers) counts INT32 work on the divider under ``simdive`` and none
    under the config's own (exact) mode."""
    exact = dryrun.analyze(*dryrun.lower_cell(
        "smollm-360m", "decode_32k", False, layers_override=2))
    approx = dryrun.analyze(*dryrun.lower_cell(
        "smollm-360m", "decode_32k", False, layers_override=2,
        approx="simdive"))
    assert exact["approx"] == "exact" and approx["approx"] == "simdive"
    assert exact["per_device"]["int_ops"] == 0
    assert approx["per_device"]["int_ops"] > 0
    assert approx["per_device"]["kernels"]["elemwise"]["launches"] == 2


def test_a_shape_the_card_refuses_is_an_error(tmp_path):
    """smollm-360m with a d_head of 96, which neither attention kernel is
    compiled for: its prefill cell records an error, not ``ok``."""
    from dataclasses import replace

    cell = dryrun.lower_cell("smollm-360m", "prefill_32k", False,
                             layers_override=1,
                             cfg_edit=lambda c: replace(c, d_head=96,
                                                        n_heads=10,
                                                        n_kv_heads=5))
    with pytest.raises(ValueError, match="d_head"):
        dryrun.analyze(*cell)
