"""The port's sharding specs against the reference's: pure metadata, one
process.

``repro_torch.launch.specs`` computes every spec from shapes (``meta``
tensors for the full configurations: nothing is allocated), and each is
held, entry for entry, to ``repro.launch.specs`` on the same config: the
parameter, optimizer (ZeRO-1), FSDP, sanitized, batch and decode-cache
specs of all ten configurations, FULL and smoke, on the reference's
(16, 16) and (2, 16, 16) production meshes. The mesh tables
(``MeshConfig``, ``SHAPES``, ``shapes_for``) equal the reference's, the
production meshes build under the fake process group, and every case of
the reference's ``tests/test_specs_sharding.py`` is mirrored.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as r_get_config
from repro.configs import base as r_base
from repro.launch import specs as r_specs
from repro.models import build as r_build
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import base as t_base
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_shard
from repro_torch.launch import specs as t_specs
from repro_torch.launch.sharding import P
from repro_torch.models.layers import QuantizedWeight, quantize_weight

torch.set_num_threads(1)


class _FakeMesh:
    """The reference test's mesh: axis names and a devices shape."""
    axis_names = ("data", "model")
    shape = (4, 2)

    class devices:
        shape = (4, 2)


class _Prod:
    def __init__(self, names, shape):
        self.axis_names, self.shape = names, shape

        class devices:
            pass
        devices.shape = shape
        self.devices = devices


MESHES = {"single_pod": _Prod(("data", "model"), (16, 16)),
          "multi_pod": _Prod(("pod", "data", "model"), (2, 16, 16))}
CASES = [(arch, smoke) for arch in ARCHS for smoke in (False, True)]


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _shape(*shape):
    return t_specs.TensorShape(shape, torch.float32)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict whose leaves are specs (or
    QuantizedWeight spec nodes, split into q / scale)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif hasattr(v, "q") and hasattr(v, "scale"):
            out[f"{prefix}{k}/q"] = v.q
            out[f"{prefix}{k}/scale"] = v.scale
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same(port: dict, ref: dict):
    fp, fr = _flat(port), _flat(ref)
    assert set(fp) == set(fr)
    for k in fr:
        assert isinstance(fp[k], P), k
        assert tuple(fp[k]) == tuple(fr[k]), (k, fp[k], fr[k])


@pytest.fixture(scope="module")
def shapes():
    """Both packages' parameter shapes for every case: the port's as meta
    tensors, the reference's from ``jax.eval_shape``."""
    out = {}
    for arch, smoke in CASES:
        port = t_specs.param_shapes(get_config(arch, smoke=smoke))
        ref = jax.eval_shape(r_build(r_get_config(arch, smoke=smoke)).init,
                             jax.random.PRNGKey(0))
        out[arch, smoke] = (port, ref)
    return out


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_shapes_allocate_nothing_and_match(shapes, arch, smoke):
    port, ref = shapes[arch, smoke]
    fp = dict(t_specs._walk(port))
    fr = dict(r_specs._walk(ref))
    assert set(fp) == set(fr)
    for k, leaf in fp.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(fr[k].shape), k


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_opt_and_sanitized_specs_match(shapes, arch, smoke):
    port, ref = shapes[arch, smoke]
    ps, rs = t_specs.param_specs(port), r_specs.param_specs(ref)
    _same(ps, rs)
    for axes in (("data",), ("pod", "data")):
        _same(t_specs.opt_specs(ps, axes), r_specs.opt_specs(rs, axes))
    for name, mesh in MESHES.items():
        _same(t_specs.sanitize_specs(ps, port, mesh),
              r_specs.sanitize_specs(rs, ref, mesh))
        axes = t_specs.batch_axes_for(mesh) + ("model",)
        _same(t_specs.fsdp_specs(port, axes, mesh),
              r_specs.fsdp_specs(ref, axes, mesh))


@pytest.mark.parametrize("arch,smoke", CASES)
def test_batch_and_cache_specs_match(arch, smoke):
    tc, rc = get_config(arch, smoke=smoke), r_get_config(arch, smoke=smoke)
    for name, mesh in MESHES.items():
        for sname in t_base.SHAPES:
            ts, rs = t_base.SHAPES[sname], r_base.SHAPES[sname]
            if smoke:   # a smoke config at a train_4k batch of 32 rows
                ts = dataclasses.replace(ts, seq_len=64, global_batch=32)
                rs = dataclasses.replace(rs, seq_len=64, global_batch=32)
            t_sds, t_sp = t_specs.batch_specs(tc, ts, mesh)
            r_sds, r_sp = r_specs.batch_specs(rc, rs, mesh)
            _same(t_sp, r_sp)
            for k in r_sds:
                assert tuple(t_sds[k].shape) == tuple(r_sds[k].shape)
            if ts.kind != "decode":
                continue
            t_cache, t_csp = t_specs.cache_specs(tc, ts, mesh)
            r_cache, r_csp = r_specs.cache_specs(rc, rs, mesh)
            _same(t_csp, r_csp)
            for k, leaf in dict(t_specs._walk(t_cache)).items():
                assert leaf.device.type == "meta"
                assert tuple(leaf.shape) == tuple(
                    dict(r_specs._walk(r_cache))[k].shape), k


def test_mesh_tables_equal_the_reference():
    assert t_base.SINGLE_POD == t_base.MeshConfig((16, 16),
                                                  ("data", "model"))
    for t, r in ((t_base.SINGLE_POD, r_base.SINGLE_POD),
                 (t_base.MULTI_POD, r_base.MULTI_POD)):
        assert (t.shape, t.axes, t.n_devices) == (r.shape, r.axes,
                                                  r.n_devices)
    assert {k: dataclasses.astuple(v) for k, v in t_base.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in r_base.SHAPES.items()}
    for arch in ARCHS:
        assert [s.name for s in t_base.shapes_for(get_config(arch))] == \
            [s.name for s in r_base.shapes_for(r_get_config(arch))]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_the_fake_process_group(multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod)
        want = MESHES["multi_pod" if multi_pod else "single_pod"]
        assert mesh.axis_names == want.axis_names
        assert mesh.shape == want.shape
        assert mesh.coord("model") == 0 and mesh.group("model") is not None
        with t_shard.use_rules(mesh):
            assert t_shard.logical_axis_size("heads") == 16
            assert t_shard.logical_axis_size("batch") == (
                32 if multi_pod else 16)
            assert t_shard.logical_spec("batch", None, "vocab") == (
                P(("pod", "data"), None, "model") if multi_pod
                else P("data", None, "model"))
            x = torch.zeros(2, 3)
            assert t_shard.shard(x, "batch", None) is x
            with pytest.raises(ValueError):
                t_shard.shard(x, "batch")
    finally:
        dist.destroy_process_group()


def test_logical_rules_unbound_are_no_ops():
    x = torch.ones(3)
    assert not t_shard.active() and t_shard.current_mesh() is None
    assert t_shard.shard(x, "batch") is x
    assert t_shard.logical_axis_size("heads") == 1
    assert t_shard.group("heads") is None and t_shard.rank_in("vocab") == 0
    assert t_shard.copy_to(x) is x and t_shard.reduce_from(x) is x
    assert t_shard.DEFAULT_RULES == {
        k: v for k, v in __import__(
            "repro.launch.sharding", fromlist=["x"]).DEFAULT_RULES.items()}


def test_local_slice_lays_out_as_named_sharding():
    """A dim split over ("data", "model") is cut major axis first, as a
    ``NamedSharding`` lays out its devices."""
    class M:
        axis_names, shape = ("data", "model"), (2, 3)

        def __init__(self, d, m):
            self.c = {"data": d, "model": m}

        def coord(self, a):
            return self.c[a]

    t = torch.arange(24).reshape(12, 2)
    seen = []
    for d in range(2):
        for m in range(3):
            part = t_specs.local_slice(t, P(("data", "model")), M(d, m))
            assert part.shape == (2, 2)
            seen.append(part)
    assert torch.equal(torch.cat(seen), t)
    with pytest.raises(ValueError):
        t_specs.local_slice(torch.zeros(5, 2), P("model"), M(0, 0))


# ---- the reference's tests/test_specs_sharding.py, case for case ----
def test_fsdp_specs_picks_largest_divisible_dim():
    mesh = _FakeMesh()
    tree = {"w_big": _shape(12, 64, 256), "w_odd": _shape(3, 7, 129),
            "w_mid": _shape(16, 10, 6)}
    specs = t_specs.fsdp_specs(tree, ("data", "model"), mesh)
    assert specs["w_big"] == P(None, None, ("data", "model"))
    assert specs["w_odd"] == P()
    assert specs["w_mid"] == P(("data", "model"), None, None)
    ref = r_specs.fsdp_specs({k: _sds(*v.shape) for k, v in tree.items()},
                             ("data", "model"), mesh)
    assert all(tuple(specs[k]) == tuple(ref[k]) for k in tree)


def test_opt_specs_idempotent_on_fsdp_params():
    out = t_specs.opt_specs({"w": P("data", None, "model")}, ("data",))
    assert out["w"] == P("data", None, "model")
    out2 = t_specs.opt_specs({"w": P(None, "model")}, ("data",))
    assert out2["w"] == P("data", "model")
    assert tuple(r_specs.opt_specs({"w": JP(None, "model")},
                                   ("data",))["w"]) == tuple(out2["w"])


def test_sanitize_drops_indivisible_axes():
    out = t_specs.sanitize_specs({"a": P("data", "model")},
                                 {"a": _shape(6, 8)}, _FakeMesh())
    assert out["a"] == P(None, "model")


def test_param_specs_cover_every_leaf():
    shapes = t_specs.param_shapes(get_config("smollm-360m", smoke=True))
    specs = t_specs.param_specs(shapes)
    assert set(dict(t_specs._walk(specs))) == set(
        dict(t_specs._walk(shapes)))


def test_quantized_weight_specs_and_stack_axis():
    w = np.random.default_rng(0).normal(size=(3, 32, 64)).astype(np.float32)
    qw = quantize_weight(torch.from_numpy(w))
    assert isinstance(qw, QuantizedWeight)
    assert qw.q.shape == (3, 32, 64) and qw.scale.shape == (3, 1, 64)
    deq = qw.q.to(torch.float32) * qw.scale
    bound = qw.scale * 0.5 + 1e-7
    assert bool(((deq - torch.from_numpy(w)).abs() <= bound + 1e-6).all())
    sliced = qw[1]
    assert torch.equal(sliced.q.to(torch.float32) * sliced.scale, deq[1])
    specs = t_specs.param_specs({"stack": {"layers": {"wq": qw,
                                                      "wo": qw}}})
    ref = r_specs.param_specs({"stack": {"layers": {
        "wq": _rq(w), "wo": _rq(w)}}})
    _same(specs, ref)


def _rq(w):
    from repro.models.layers import quantize_weight as r_quantize

    return r_quantize(jnp.asarray(w))
