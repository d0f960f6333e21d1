"""Multi-pod dry run: trace every (arch x shape x mesh) cell on rank 0 of
the production mesh, with nothing allocated.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for a 256- or 512-chip TPU mesh and reads XLA's memory and cost
analyses and the post-SPMD HLO. The port runs eagerly, so its dry run
*runs* the cell, once, as rank 0 of the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`, ``(16, 16)`` or
``(2, 16, 16)``) under the fake process group (``torch.distributed``'s
``"fake"`` backend: every collective returns at once), on tensors of the
``meta`` device (shapes and dtypes, no data), at full depth: one train
step (ZeRO-1 moments by default), one prefill or one decode step. Each
rank holds its shards (the parameters by ``sanitize_specs(param_specs(
...))``, the moments by ``opt_specs``, the batch and the decode cache by
``batch_specs`` / ``cache_specs``), as a real run would.

Kernels are counted as the card would run them: under
:class:`~repro_torch.kernels.registry.dry_dispatch` a ``meta`` tensor
stands for the card's, so the model takes the kernel routes it takes on
the H100, and every call that would reach a CUDA kernel checks that
kernel's shape contract (the dtypes, d_head in {64, 80, 128}, the block,
``decode_attention``'s G <= 8 and cluster plan on the local (B, KV), the
matmul widths) — a shape the card would refuse makes the cell an error —
and counts its launch by name, its operations and bytes (the formulas
behind ``PERF.md`` §6's bounds), none of its plain version's.

Each cell's record (``results/dryrun_torch/<arch>__<shape>__<mesh>.json``):

- ``n_params``; ``status`` / ``error`` / ``trace``; ``trace_seconds``;
- ``per_device``: ``argument_bytes`` (what the rank holds going in;
  ``argument_parts``: of it the parameters, the optimizer state, the
  batch, the cache, the tokens),
  ``output_bytes`` (what the step returns that it did not take in),
  ``peak_bytes`` (the most bytes live at once over the trace: every
  tensor's storage from its allocation to its release), ``temp_bytes``
  (``peak - argument - output``, at least 0), ``flops`` (each
  dispatched float product by ``torch.utils.flop_counter``'s formulas,
  plus the attention kernels' own), ``flops_by_dtype``, ``int_ops`` (the SIMDive kernels'
  INT32 operations), ``bytes_accessed`` (each dispatched op's operands
  and result, a view's none; a kernel by its own count), ``kernels``
  (launches, operations and bytes by name), ``collective_bytes`` and
  ``collectives`` (calls and bytes by kind and mesh axes);
- ``roofline``: ``compute_s`` (bf16 products at the bf16 peak, float32
  at the float32 peak, INT32 operations at the INT32 rate), ``memory_s``
  (bytes over HBM), ``collective_s`` (each collective's ring traffic over
  its axes' link), ``bottleneck``; ``constants``: every rate used, with
  its source.

Left out on purpose (ROADMAP): the reference's HLO parsers
(``fused_bytes``, ``traffic_v2``, ``collective_bytes``,
``_attention_fuse_pairs``) have nothing to parse here, and its L0/L1
extrapolation exists because XLA costs a scan body once, where the
port's eager trace runs every layer. ``approx`` is honoured (the
reference accepts it and never reads it, ROADMAP R-12): ``None`` runs
the config's own mode (exact for every FULL config). Sequence
parallelism (``--sp``), ``--pure-dp`` and ``--fsdp`` raise
``NotImplementedError`` (ROADMAP A-10e).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --mesh single                        # one cell
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback
import warnings
import weakref
from contextlib import ExitStack
from dataclasses import replace

import torch

__all__ = ["CONSTANTS", "lower_cell", "trace_cell", "analyze", "run_cell",
           "main", "n_params", "fake_world", "kernel_cost",
           "argument_bytes", "roofline"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")

# NVIDIA H100 SXM5 (80 GB) figures, each with its source
PEAK_BF16_FLOPS = 989.4e12     # H100 SXM datasheet: BF16 tensor core, dense
PEAK_F32_FLOPS = 66.9e12       # H100 SXM datasheet: FP32 (no TF32 here)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM datasheet: HBM3 bandwidth
NVLINK_BYTES_PER_S = 450e9     # H100 SXM datasheet: NVLink 900 GB/s, 450 a way
NETWORK_BYTES_PER_S = 50e9     # DGX H100 datasheet: a 400 Gb/s NIC a GPU
INT32_OPS_PER_S = 1.673e13     # PERF.md §6: 132 SMs x 64 x 1,980 MHz, read
NODE_GPUS = 8                  # GPUs an NVLink domain holds (DGX H100)
SM_COUNT = 132                 # H100 SXM5: the decode cluster planner's SMs
CONSTANTS = {
    "peak_bf16_flops": [PEAK_BF16_FLOPS, "NVIDIA H100 SXM datasheet, BF16 "
                        "Tensor Core dense (989 TFLOPS; 1,979 with sparsity)"],
    "peak_f32_flops": [PEAK_F32_FLOPS, "NVIDIA H100 SXM datasheet, FP32 "
                       "(67 TFLOPS; the port uses no TF32)"],
    "hbm_bytes_per_s": [HBM_BYTES_PER_S, "NVIDIA H100 SXM datasheet, "
                        "HBM3 3.35 TB/s"],
    "nvlink_bytes_per_s": [NVLINK_BYTES_PER_S, "NVIDIA H100 SXM datasheet, "
                           "NVLink 900 GB/s both ways: 450 GB/s a direction; "
                           "prices an axis whose ranks share one 8-GPU node"],
    "network_bytes_per_s": [NETWORK_BYTES_PER_S, "NVIDIA DGX H100 datasheet, "
                            "one ConnectX-7 400 Gb/s port a GPU; prices an "
                            "axis that spans nodes (the production meshes' "
                            "16-rank axes span two 8-GPU nodes)"],
    "int32_ops_per_s": [INT32_OPS_PER_S, "PERF.md section 6: SMs x 64 "
                        "INT32 lanes x max SM clock, read on the H100"],
}

# the SIMDive kernels' operation counts, chip_smoke.py's (PERF.md §6)
LOGMATMUL_OPS_PER_PRODUCT = 11
LOGMATMUL_OPS_PER_OPERAND = 10
ELEMWISE_OPS_PER_LANE = 32
SQRT_OPS_PER_LANE = 14
PACKED_OPS_PER_LANE = 31.5


# ------------------------------------------------------------ the world --
def fake_world(world: int, rank: int = 0) -> None:
    """The default process group as rank ``rank`` of ``world`` under the
    fake backend (replacing one of another size): collectives return at
    once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


# ------------------------------------------------------------- kernels --
def _attention_pairs(Sq: int, Skv: int, causal: bool, window: int,
                     q_offset: int) -> int:
    """The (q, k) pairs a flash-attention call scores: every pair, or the
    causal (and windowed) ones."""
    if not causal and not window:
        return Sq * Skv
    total = 0
    for i in range(q_offset, q_offset + Sq):
        hi = min(i + 1, Skv) if causal else Skv
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def kernel_cost(name: str, spec, block, tensors, kw) -> tuple:
    """``(count name, output, float flops, int ops, bytes)`` of one call
    of registered op ``name`` bound to the card: its kernel's shape
    contract checked (as the kernel's wrapper checks it before a launch),
    the output's shape and dtype made on ``meta``, nothing launched."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lm
    from repro_torch.kernels.registry import op_default_block

    block = tuple(block) if block is not None else op_default_block(name)
    sfx = "_w32" if spec.width == 32 else ""
    if name == "attention":
        q, k, v = tensors
        BH, Sq, dh = q.shape
        G = kw.get("kv_group", 1)
        if k.shape != v.shape or k.shape[0] * G != BH or k.shape[2] != dh:
            raise ValueError(f"attention: q {tuple(q.shape)}, k / v "
                             f"{tuple(k.shape)} with kv_group {G}")
        if q.dtype not in fa._DTYPES or {k.dtype, v.dtype} != {q.dtype}:
            raise TypeError(f"attention kernel takes matching float32 or "
                            f"bfloat16 q/k/v, got {q.dtype}")
        if dh not in fa._HEAD_DIMS:
            raise ValueError(f"flash_attention kernel is compiled for "
                             f"d_head in {fa._HEAD_DIMS}, got {dh}")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors):
            raise RuntimeError("flash_attention CUDA kernel: q / k / v "
                               "require grad")
        _, depth = fa.check_block(block, q.dtype, dh)
        fa.check_aligned(q, k, v)
        pairs = BH * _attention_pairs(Sq, k.shape[1], kw.get("causal", True),
                                      kw.get("window", 0),
                                      kw.get("q_offset", 0))
        ints = ELEMWISE_OPS_PER_LANE * q.numel() if kw.get("approx_div") \
            else 0
        moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        count = "attention_pipelined" if depth else "attention"
        return count + sfx, torch.empty_like(q), 4 * pairs * dh, ints, moved
    if name == "decode_attention":
        q, kc, vc, kn, vn = tensors
        B, Smax, KVH, G, dh = da.check_args(
            q, kc, vc, kn, vn, kw["pos"], kw["slot"],
            ring_full=kw.get("ring_full", False), window=kw.get("window", 0))
        da.cluster_size(B, KVH, SM_COUNT)
        pos = kw["pos"]
        if torch.is_tensor(pos):
            raise ValueError("the dry run takes one int position a step")
        valid = min(int(pos), Smax)
        if kw.get("window") and Smax > kw["window"]:
            valid = min(valid, kw["window"] - 1)
        q_elems = q.numel()
        esz = q.element_size()
        moved = (2 * B * valid * KVH * dh * esz + 2 * q_elems * esz
                 + 2 * B * KVH * dh * esz + 256 * 4)
        ints = ELEMWISE_OPS_PER_LANE * q_elems if kw.get("approx_div") else 0
        return ("decode_attention" + sfx, torch.empty_like(q),
                4 * B * KVH * G * (valid + 1) * dh, ints, moved)
    if name in ("matmul_emul", "matmul_int"):
        x, w = tensors[0], tensors[2 if name == "matmul_emul" else 1]
        lm.check_matmul_width(spec.width, name)
        M, K = x.reshape(-1, x.shape[-1]).shape
        N = w.shape[1]
        if w.shape[0] != K:
            raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                             f"{tuple(w.shape)} do not multiply")
        wide = name == "matmul_emul" and lm.needs_wide(K, spec.width)
        (_, _, _), _, depth = lm.check_block(block, wide)
        out_dt = torch.int64 if name == "matmul_emul" else torch.int32
        out = torch.empty(tuple(x.shape[:-1]) + (N,), dtype=out_dt,
                          device=x.device)
        ints = (M * K * N * LOGMATMUL_OPS_PER_PRODUCT
                + (M * K + K * N) * LOGMATMUL_OPS_PER_OPERAND)
        moved = 4 * (M * K + K * N) + (8 if wide else 4) * M * N
        return ("matmul_pipelined" if depth else "matmul", out, 0, ints,
                moved)
    if name in ("elemwise", "sqrt", "packed"):
        a = tensors[0]
        ew.check_width(spec.width)
        if not 0 <= kw.get("frac_out", 0) <= 31:
            raise ValueError(f"frac_out must be in [0, 31]")
        n = a.numel()
        lane = 8 if spec.width == 32 else 4
        if name == "packed":
            out = torch.empty(tuple(a.shape[:-1]) + (2 * a.shape[-1],),
                              dtype=a.dtype, device=a.device)
            return ("packed", out, 0, PACKED_OPS_PER_LANE * 4 * n, 16 * n)
        if name == "sqrt":
            return ("sqrt" + sfx, torch.empty_like(a), 0,
                    SQRT_OPS_PER_LANE * n, 2 * lane * n)
        return ("elemwise" + sfx, torch.empty_like(a), 0,
                ELEMWISE_OPS_PER_LANE * n, 3 * lane * n)
    raise NotImplementedError(f"the dry run has no kernel model for {name!r}")


# --------------------------------------------------------------- meters --
def _flat(x) -> list:
    """The leaves of an aten op's result (a value, or a list / tuple of
    values) or of its ``(args, kwargs)``, lists flattened (a collective's
    list of lists too)."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
        args, kwargs = x
        x = (*args, *(kwargs[k] for k in sorted(kwargs)))
    elif not isinstance(x, (list, tuple)):
        return [x]
    out = []
    for v in x:
        if isinstance(v, (list, tuple)):
            for w in v:
                if isinstance(w, (list, tuple)):
                    out.extend(w)
                else:
                    out.append(w)
        else:
            out.append(v)
    return out


def _tensors(x) -> list:
    return [t for t in _flat(x) if isinstance(t, torch.Tensor)]


def _shapes(x):
    """``x`` with every tensor replaced by its shape (one level of
    nesting), as ``flop_counter``'s formulas take arguments."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (list, tuple)):
        return type(x)(_shapes(v) for v in x)
    return x


class _Meter:
    """Counts every op dispatched under it: bytes each op's operands and
    result move (a view none), float products' flops by dtype, and the
    bytes live at once (each storage from its first appearance to its
    release); plus the kernels' own counts (:meth:`kernel`)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.bytes = 0
        self.flops_by_dtype: dict = {}
        self.live = self.peak = 0
        self.seen: dict = {}
        self.paused = 0
        self.kernels: dict = {}
        self.int_ops = 0

    def track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        n = st.nbytes()
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        # the storage's Python object lives as long as the storage does
        self.seen[key] = (weakref.ref(st, self._freer(key, n)), n)

    def _freer(self, key, n):
        def free(_):
            self.live -= n
            self.seen.pop(key, None)
        return free

    def held(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors``."""
        out = {}
        for t in tensors:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                out[st._cdata] = st.nbytes()
        return sum(out.values())

    def op(self, func, args, kwargs, out, ins, outs,
           view: bool = False) -> None:
        """Count one op: ``ins`` / ``outs`` its tensor arguments and
        results."""
        if self.paused:
            return
        for t in outs:
            self.track(t)
        if view or _is_view(func):
            return
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        packet = func._overloadpacket
        if packet in self.registry:
            a, k = _shapes(args), {n: _shapes(v) for n, v in kwargs.items()}
            try:
                n = self.registry[packet](*a, **k, out_shape=_shapes(out))
            except TypeError:
                n = self.registry[packet](*a, **k)
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + int(n)

    def kernel(self, entry, spec, block, tensors, kw):
        self.paused += 1
        try:
            name, out, flops, ints, moved = kernel_cost(
                entry.name, spec, block, tensors, kw)
        finally:
            self.paused -= 1
        self.track(out)
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                             "int_ops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += flops
        row["int_ops"] += ints
        row["bytes"] += moved
        dt = "bfloat16" if tensors[0].dtype == torch.bfloat16 else "float32"
        if flops:
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + flops
        self.int_ops += ints
        self.bytes += moved
        return out


_FIXED: dict = {}       # op -> whether it may alias or mutate (its schema)
_VIEWS: dict = {}       # op -> whether it is a view


def _is_view(func) -> bool:
    out = _VIEWS.get(func)
    if out is None:
        out = _VIEWS[func] = bool(func.is_view)
    return out


def _aliases(func) -> bool:
    out = _FIXED.get(func)
    if out is None:
        out = _FIXED[func] = bool(func.is_view or func._schema.is_mutable)
    return out


def _key(func, args, kwargs, leaves):
    """A memo key of a functional, non-view op over ``meta`` tensors: the op
    and every argument's metadata (a tensor's shape, strides, dtype and
    offset; any other value itself; ``leaves`` the arguments flattened);
    None where the op may alias or mutate, or an argument is not
    hashable."""
    if _aliases(func):
        return None
    key = [func, tuple(kwargs), tuple(len(a) if isinstance(a, (list, tuple))
                                      else -1 for a in args)]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                return None
            key.append((tuple(x.shape), x.stride(), x.dtype,
                        x.storage_offset()))
        else:
            try:
                hash(x)
            except TypeError:
                return None
            key.append(x)
    return tuple(key)


def _dispatch_mode(meter: _Meter):
    """Every op dispatched under it counted by ``meter``. On ``meta``
    tensors an op's output depends on its inputs' metadata alone, so a
    functional op met again at the same metadata (the next layer's) makes
    its outputs from the first call's shapes and strides instead of
    running its meta function again (most are Python decompositions)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    memo: dict = {}

    def skeleton(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return type(x)(skeleton(v) for v in x)
        raise TypeError          # not a tensor result: never memoized

    def rebuild(x):
        if isinstance(x, tuple) and len(x) == 3 \
                and isinstance(x[2], torch.dtype):
            return torch.empty_strided(x[0], x[1], dtype=x[2],
                                       device="meta")
        return type(x)(rebuild(v) for v in x)

    def storages(tensors) -> set:
        return {t.untyped_storage()._cdata for t in tensors}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            leaves = _flat((args, kwargs))
            ins = [t for t in leaves if isinstance(t, torch.Tensor)]
            key = _key(func, args, kwargs, leaves)
            if memo.get(key) is not None:
                out = rebuild(memo[key])
                meter.op(func, args, kwargs, out, ins, _tensors(out))
                return out
            out = func(*args, **kwargs)
            outs = _tensors(out)
            # an op whose output shares an input's storage (a view not
            # marked one, a collective in place) moves and holds nothing
            # new, and is never made from the memo
            alias = bool(storages(outs) & storages(ins))
            if key is not None:
                try:
                    memo[key] = None if alias else skeleton(out)
                except TypeError:
                    memo[key] = None
            meter.op(func, args, kwargs, out, ins, outs, view=alias)
            return out

    return Mode()


# -------------------------------------------------------------- the cell --
def _mesh_for(multi_pod: bool):
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))


def _local(shapes, specs, mesh, dtype_of):
    """``meta`` tensors of this rank's slices of ``shapes`` under
    ``specs``, each in ``dtype_of(leaf)``."""
    from repro_torch.launch.specs import _spec_map, local_slice

    def one(sp, t):
        whole = torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        return torch.empty(tuple(local_slice(whole, sp, mesh).shape),
                           dtype=dtype_of(t), device="meta")

    if not isinstance(shapes, dict):
        return one(specs, shapes)
    return _spec_map(one, specs, shapes)


def _quantized_shapes(shapes):
    """The reference dry run's ``--quantized`` tree: every matmul weight of
    two dims of at least 64 (not an MoE expert) an int8
    :class:`~repro_torch.models.layers.QuantizedWeight` with its float32
    scale."""
    from repro_torch.launch.serve import _MATMUL_WEIGHTS
    from repro_torch.models.layers import QuantizedWeight

    def qz(tree, path=()):
        if isinstance(tree, dict):
            return {k: qz(v, path + (k,)) for k, v in tree.items()}
        name = path[-1] if path else ""
        if (name in _MATMUL_WEIGHTS and "moe" not in path and tree.ndim >= 2
                and tree.shape[-1] >= 64 and tree.shape[-2] >= 64):
            return QuantizedWeight(
                q=torch.empty(tree.shape, dtype=torch.int8, device="meta"),
                scale=torch.empty(tuple(tree.shape[:-2])
                                  + (1, tree.shape[-1]),
                                  dtype=torch.float32, device="meta"))
        return tree

    return qz(shapes)


def n_params(cfg) -> int:
    """The parameter count of ``cfg`` (every leaf's elements)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.specs import param_shapes

    return int(sum(math.prod(t.shape) for t in tree_leaves(
        param_shapes(cfg))))


def _leaves(tree):
    from repro_torch.models.layers import QuantizedWeight

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, QuantizedWeight):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, torch.Tensor):
        yield tree


def _arguments(cfg, shape, mesh, *, zero1: bool, microbatch: int,
               quantized: bool, serve_f32: bool, pos: int | None):
    """``(args, run)``: the ``meta`` tensors this rank holds going into the
    cell (rules bound) — parameters; moments and step; the batch rows;
    the decode cache and tokens — and the call that runs the cell on
    them."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import train as t_train
    from repro_torch.launch.sharding import P
    from repro_torch.launch.specs import (
        TensorShape,
        batch_axes_for,
        batch_specs,
        cache_specs,
        param_shapes,
        param_specs,
        sanitize_specs,
    )
    from repro_torch.models import build
    from repro_torch.optim import adamw

    serve = shape.kind in ("prefill", "decode")
    shapes = param_shapes(cfg)
    if serve and not serve_f32:
        # serving carries bf16 weights, as the reference's dry run
        shapes = tree_map(lambda t: torch.empty(
            t.shape, dtype=torch.bfloat16 if t.dtype == torch.float32
            else t.dtype, device="meta"), shapes)
    if serve and quantized:
        shapes = _quantized_shapes(shapes)
    pspecs = sanitize_specs(param_specs(shapes), shapes, mesh)
    lm = build(cfg, "meta")
    params = _local(shapes, pspecs, mesh, lambda t: t.dtype)
    bsds, bspec = batch_specs(cfg, shape, mesh)
    bspec = sanitize_specs(bspec, bsds, mesh)
    if shape.kind == "train":
        opt = adamw(3e-4)
        shardings, split = t_train.placement(cfg, mesh, zero1=zero1)
        mom = _unflat({k: s.spec for k, s in _paths(shardings["opt"]["mu"])},
                      shapes)
        opt_state = {
            "mu": _local(shapes, mom, mesh, lambda t: torch.float32),
            "nu": _local(shapes, mom, mesh, lambda t: torch.float32),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
        batch = _local(bsds, bspec, mesh, lambda t: t.dtype)
        step = t_train.make_train_step(
            lm, opt, microbatch=microbatch, split=split,
            zero1=t_train.zero1_layout(shardings) if zero1 else None)
        return ([params, opt_state, batch],
                lambda: step(params, opt_state, batch))
    if shape.kind == "prefill":
        batch = _local(bsds, bspec, mesh, lambda t: t.dtype)
        return [params, batch], lambda: lm.prefill(params, batch)
    csds, cspec = cache_specs(cfg, shape, mesh)
    cache = _local(csds, sanitize_specs(cspec, csds, mesh), mesh,
                   lambda t: t.dtype)
    b = tuple(batch_axes_for(mesh))
    tok = TensorShape((shape.global_batch, cfg.n_codebooks)
                      if cfg.n_codebooks else (shape.global_batch,),
                      torch.int32)
    tokens = _local(tok, sanitize_specs(P(b if len(b) > 1 else b[0]), tok,
                                        mesh), mesh, lambda t: t.dtype)
    at = shape.seq_len - 1 if pos is None else pos
    return ([params, cache, tokens],
            lambda: lm.decode_step(params, cache, tokens, at,
                                   max_seq=shape.seq_len))


# what :func:`_arguments` returns, by the cell's kind
_PARTS = {"train": ("params", "optimizer", "batch"),
          "prefill": ("params", "batch"),
          "decode": ("params", "cache", "tokens")}


def _bound(mesh_shape, axes, rank: int):
    """The fake world, the mesh and its rules for one cell (a context)."""
    from repro_torch.launch import sharding as shardlib
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.launch.specs import batch_axes_for

    fake_world(math.prod(mesh_shape), rank)
    mesh = _make_mesh(tuple(mesh_shape), tuple(axes))
    return mesh, shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)})


def argument_bytes(cfg, shape, mesh_shape: tuple, axes: tuple, *,
                   rank: int = 0, zero1: bool = True,
                   quantized: bool = False, serve_f32: bool = False) -> int:
    """The bytes rank ``rank`` holds going into the cell (:func:`trace_cell`'s
    ``argument_bytes``), with nothing traced."""
    mesh, rules = _bound(mesh_shape, axes, rank)
    with rules:
        args, _ = _arguments(cfg, shape, mesh, zero1=zero1, microbatch=1,
                             quantized=quantized, serve_f32=serve_f32,
                             pos=None)
    return _Meter().held(_leaves(args))


def _restore_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def trace_cell(cfg, shape, mesh_shape: tuple, axes: tuple, *, rank: int = 0,
               zero1: bool = True, microbatch: int = 1,
               quantized: bool = False, serve_f32: bool = False,
               pos: int | None = None) -> dict:
    """Run one cell as rank ``rank`` of a mesh of ``mesh_shape`` over
    ``axes`` under the fake process group, on ``meta`` tensors: ``cfg``'s
    train step (``shape.kind`` "train"; ZeRO-1 moments with ``zero1``),
    prefill or decode step (at ``pos``, the last slot by default) at
    ``shape``. Returns the measured record (``per_device``, ``roofline``
    and ``trace_seconds``; module docstring)."""
    from repro_torch.kernels.registry import dry_dispatch
    from repro_torch.launch import sharding as shardlib
    from repro_torch.metrics.timing import wall_clock

    mesh, rules = _bound(mesh_shape, axes, rank)
    meter = _Meter()
    with ExitStack() as stack:
        stack.callback(_restore_env, "SIMDIVE_AUTOTUNE",
                       os.environ.get("SIMDIVE_AUTOTUNE"))
        os.environ["SIMDIVE_AUTOTUNE"] = "0"     # the default blocks
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore")
        stack.enter_context(rules)
        # the arguments: this rank's shards, built before the meter starts
        # (their specs read the whole model's shapes) and counted live
        args, run = _arguments(cfg, shape, mesh, zero1=zero1,
                               microbatch=microbatch, quantized=quantized,
                               serve_f32=serve_f32, pos=pos)
        for t in _leaves(args):
            meter.track(t)
        arg_bytes = meter.held(_leaves(args))
        parts = {name: meter.held(_leaves(a))
                 for name, a in zip(_PARTS[shape.kind], args)}
        shardlib.reset_collective_counts()
        t0 = wall_clock()
        stack.enter_context(_dispatch_mode(meter))
        stack.enter_context(dry_dispatch(meter.kernel))
        out = run()
        in_ids = {t.untyped_storage()._cdata for t in _leaves(args)}
        out_bytes = meter.held(t for t in _leaves(out)
                               if t.untyped_storage()._cdata not in in_ids)
    seconds = wall_clock() - t0
    coll = shardlib.collective_counts(by_axis=True)
    per = {
        "argument_bytes": arg_bytes,
        "argument_parts": parts,
        "output_bytes": out_bytes,
        "temp_bytes": max(meter.peak - arg_bytes - out_bytes, 0),
        "peak_bytes": meter.peak,
        "flops": sum(meter.flops_by_dtype.values()),
        "flops_by_dtype": meter.flops_by_dtype,
        "int_ops": meter.int_ops,
        "bytes_accessed": meter.bytes,
        "kernels": meter.kernels,
        "collectives": coll,
        "collective_bytes": {k: v[1] for k, v in coll.items()},
    }
    return {"per_device": per, "roofline": roofline(per, mesh),
            "trace_seconds": seconds, "n_devices": math.prod(mesh_shape)}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _unflat(flat: dict, like):
    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return flat[prefix]

    return walk(like)


def _axis_rate(axes: tuple, mesh) -> float:
    """The link that prices a collective over ``axes``: NVLink where all
    its ranks share one node of :data:`NODE_GPUS` consecutive ranks (the
    mesh's minor axes first), the network otherwise."""
    names, shape = list(mesh.axis_names), list(mesh.shape)
    span = 1
    for a in axes:
        i = names.index(a)
        stride = math.prod(shape[i + 1:])
        span = max(span, stride * shape[i])
    return NVLINK_BYTES_PER_S if span <= NODE_GPUS else NETWORK_BYTES_PER_S


def roofline(per: dict, mesh) -> dict:
    """Seconds of the step's work at the H100's rates: compute (bf16 and
    float32 flops at their peaks, INT32 operations at the INT32 rate),
    memory (bytes accessed over HBM) and collectives (a ring all-reduce
    moves ``2 (n-1) / n`` of its payload a rank, an all-gather ``(n-1) /
    n`` of its result), and the largest of the three."""
    from repro_torch.launch.sharding import axis_sizes

    fl = per["flops_by_dtype"]
    bf = sum(v for k, v in fl.items() if k in ("bfloat16", "float16"))
    f32 = sum(v for k, v in fl.items() if k not in ("bfloat16", "float16"))
    compute = (bf / PEAK_BF16_FLOPS + f32 / PEAK_F32_FLOPS
               + per["int_ops"] / INT32_OPS_PER_S)
    sizes = axis_sizes(mesh)
    coll = 0.0
    for key, (_, nbytes) in per["collectives"].items():
        kind, axes = key.split("@")
        axes = tuple(axes.split("+"))
        n = math.prod(sizes[a] for a in axes)
        share = (2 if kind == "all_reduce" else 1) * (n - 1) / n
        coll += share * nbytes / _axis_rate(axes, mesh)
    out = {"compute_s": compute,
           "memory_s": per["bytes_accessed"] / HBM_BYTES_PER_S,
           "collective_s": coll}
    out["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: out[k])
    return out


def _refuse(**flags) -> None:
    """Raise for the placements of the next slice, named by their flag."""
    for flag, on in flags.items():
        if on:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: sequence parallelism, the "
                "experts override and ZeRO-3 placements are the next slice "
                "(ROADMAP A-10e)")


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               sp: bool = False, zero1: bool = True,
               approx: str | None = None,
               layers_override: int | None = None, cfg_edit=None,
               serve_f32: bool = False, microbatch: int = 1,
               fsdp: bool = False, pure_dp: bool = False,
               quantized: bool = False):
    """The reference's ``lower_cell``, for the port: ``(cfg, shape,
    mesh_shape, axes, meta)``, what :func:`analyze` traces. ``approx``
    (``"exact"``, ``"mitchell"``, ``"simdive"``) sets the config's mode;
    None keeps its own. ``sp`` / ``fsdp`` / ``pure_dp`` raise (A-10e)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.approx import ApproxConfig

    _refuse(sp=sp, fsdp=fsdp, pure_dp=pure_dp)
    cfg = get_config(arch)
    if layers_override is not None:
        cfg = replace(cfg, n_layers=layers_override)
    if cfg_edit is not None:
        cfg = cfg_edit(cfg)
    if approx is not None:
        cfg = cfg.with_approx(ApproxConfig(mode=approx))
    shape = SHAPES[shape_name]
    mesh_shape, axes = _mesh_for(multi_pod)
    return cfg, shape, mesh_shape, axes, {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "sp": sp, "zero1": zero1, "approx": cfg.approx.mode,
        "microbatch": microbatch, "quantized": quantized,
        "serve_f32": serve_f32}


def analyze(cfg, shape, mesh_shape, axes, meta) -> dict:
    res = trace_cell(cfg, shape, mesh_shape, axes,
                     zero1=meta["zero1"] and shape.kind == "train",
                     microbatch=meta["microbatch"],
                     quantized=meta["quantized"],
                     serve_f32=meta["serve_f32"])
    return {**meta, "n_params": n_params(cfg), **res,
            "constants": CONSTANTS}


def run_cell(arch, shape_name, multi_pod, out_dir=None, **kw):
    mesh_tag = "multipod" if multi_pod else "singlepod"
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    for k, v in kw.items():
        if v not in (False, None, True, 1) or v is True:
            tag += f"__{k}" if v is True else f"__{k}-{v}"
    out_dir = out_dir or RESULTS
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        print(f"[skip] {tag} (cached)")
        with open(path) as f:
            return json.load(f)
    print(f"[trace] {tag}", flush=True)
    try:
        res = analyze(*lower_cell(arch, shape_name, multi_pod, **kw))
        res["status"] = "ok"
    # simdive-lint: allow(swallowed-exception): recorded as a status=error artifact with traceback
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        res = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"[done] {tag}: {res.get('status')} "
          f"peak={res.get('per_device', {}).get('peak_bytes', 0) / 1e9:.2f}GB "
          f"bottleneck={res.get('roofline', {}).get('bottleneck', '-')} "
          f"trace={res.get('trace_seconds', 0):.1f}s", flush=True)
    return res


def main(argv=None):
    from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel activations (ROADMAP A-10e)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="no TP: batch over both mesh axes + ZeRO-3 params "
                         "(ROADMAP A-10e)")
    ap.add_argument("--fsdp", action="store_true",
                    help="params sharded over the data axes (train; "
                         "ROADMAP A-10e)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 QuantizedWeight serving (prefill/decode)")
    ap.add_argument("--approx", default=None,
                    choices=["exact", "mitchell", "simdive"],
                    help="the arithmetic's mode (default: each config's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _refuse(sp=args.sp, pure_dp=args.pure_dp, fsdp=args.fsdp)

    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([SHAPES[args.shape]] if args.shape else shapes_for(cfg))
        for shp in shapes:
            for mp in meshes:
                res = run_cell(arch, shp.name, mp, out_dir=args.out,
                               sp=args.sp, pure_dp=args.pure_dp,
                               fsdp=args.fsdp, microbatch=args.microbatch,
                               quantized=args.quantized, approx=args.approx)
                failures += res.get("status") != "ok"
    print(f"dry-run sweep complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
