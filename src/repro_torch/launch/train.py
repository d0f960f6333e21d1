"""Training driver: sharded train step, checkpoint/restart, deterministic
data.

Counterpart of ``repro.launch.train``. Fault-tolerance contract, as the
reference's:
  * checkpoints are atomic (tmp-dir + rename) and written async,
  * ``--resume auto`` restarts from the newest complete checkpoint,
  * data order is a pure function of (seed, step) and a precision
    schedule's rung a pure function of the step — a restart replays the
    exact batch and policy sequence, so loss curves are bitwise continuous,
  * restore re-lays-out onto the *current* mesh (elastic: a job
    checkpointed on N ranks resumes on M).
On the card that last point needs deterministic kernels: :func:`main`
turns on :func:`deterministic` there (an op without a deterministic form
raises); the CPU's kernels are deterministic already.

``--approx simdive`` trains with every linear on the SIMDive multiplier
(``logmatmul`` on the card) and the attention softmax's finalize on the
SIMDive divider (``elemwise``); ``--backward approx`` puts both gradient
products of every linear on the multiplier too. Attention always runs the
differentiable chunked path (:func:`repro_torch.models.layers.
chunked_attention`): the attention kernels are forward-only, as the
reference's Pallas kernel is.

The mesh: when the default process group has more than one rank,
:func:`train` builds ``make_host_mesh(model=tp)`` (``(world / tp, tp)``,
dims ``("data", "model")``) and binds the logical rules to it, as the
reference does when it sees more than one device; with one rank there is
no mesh and ``--tp`` changes nothing. Each rank holds its slice of every
parameter (``sanitize_specs(param_specs(...))``) and takes its data
rank's rows of the same global batch; the model's sharded paths call the
collectives (:mod:`repro_torch.launch.sharding`), the loss is the whole
batch's, and the step adds the data ranks' gradients (each rank's
backward carries its rows' share of the mean). Checkpoints hold full
arrays (gathered on the host) and restore onto any mesh.

Usage (CPU smoke; on the card drop ``--smoke --device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --device cpu --steps 20 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ck --save-every 10
Sharded, one process a rank (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; NCCL on the card, gloo on the CPU):
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch stablelm-1.6b --tp 2 --steps 20 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import os
import sys
from contextlib import ExitStack

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.approx import ApproxConfig
from repro_torch.core.device import require_device
from repro_torch.core.tree import tree_leaves, tree_map, value_and_grad
from repro_torch.data import make_source, torch_batch
from repro_torch.launch import sharding as shardlib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import P
from repro_torch.launch.specs import (
    Sharding,
    as_shardings,
    batch_axes_for,
    opt_specs,
    param_shapes,
    param_specs,
    sanitize_specs,
)
from repro_torch.metrics.timing import wall_clock
from repro_torch.models import build
from repro_torch.models.transformer import check_mesh
from repro_torch.optim import adamw, cosine_schedule

__all__ = ["make_train_step", "train", "main", "model_split",
           "sum_over_data", "local_rows", "start_process_group",
           "placement", "zero1_layout"]


def _add(a, b):
    return tree_map(lambda x, y: x if y is None else y if x is None
                    else x + y, a, b)


def sum_over_data(grads):
    """The data ranks' gradients added: every non-None leaf flattened into
    one float32 buffer, one ``all_reduce`` SUM over ``"batch"``, the leaves
    cut back out in their dtypes. A no-op without a data group."""
    import torch

    if shardlib.group("batch") is None:
        return grads
    leaves = [g for g in tree_leaves(grads) if g is not None]
    if not leaves:
        return grads
    flat = shardlib.all_reduce(
        torch.cat([g.reshape(-1).to(torch.float32) for g in leaves]),
        "batch")
    summed, pos = {}, 0
    for g in leaves:
        summed[id(g)] = flat[pos:pos + g.numel()].view(g.shape).to(g.dtype)
        pos += g.numel()
    return tree_map(lambda g: None if g is None else summed[id(g)], grads)


def model_split(pspecs, mesh):
    """For :func:`~repro_torch.optim.optimizers.global_norm`: ``"model"``
    where a leaf's spec splits it over the model axis (of more than one
    rank), else None."""
    n = shardlib.axis_sizes(mesh).get("model", 1)

    def one(spec):
        names = [a for part in spec if part is not None
                 for a in (part if isinstance(part, tuple) else (part,))]
        return "model" if n > 1 and "model" in names else None

    return tree_map(one, pspecs)


def placement(cfg, mesh, grad_compress: bool = False, zero1: bool = False):
    """``(shardings, split)`` of a training run on ``mesh`` (rules bound):
    the checkpoint tree's :class:`~repro_torch.launch.specs.Sharding`s —
    parameters by ``sanitize_specs(param_specs(...))``, the moments as
    their parameters (with ``zero1``, by ``opt_specs``: a data-axis slice
    more, ZeRO-1), the step replicated, the residual (under
    ``grad_compress``) as its parameter — and :func:`model_split`'s tree.
    Raises first where the model axis would split ``cfg`` in a way the
    port does not run (:func:`~repro_torch.models.transformer.
    check_mesh`); nothing is allocated."""
    check_mesh(cfg)
    shapes = param_shapes(cfg)
    pspecs = sanitize_specs(param_specs(shapes), shapes, mesh)
    psh = as_shardings(mesh, pspecs)
    msh = psh
    if zero1:
        msh = as_shardings(mesh, sanitize_specs(
            opt_specs(pspecs, batch_axes_for(mesh)), shapes, mesh))
    shardings = {"params": psh,
                 "opt": {"mu": msh, "nu": msh, "step": Sharding(mesh, P())}}
    if grad_compress:
        shardings["res"] = psh
    return shardings, model_split(pspecs, mesh)


class _Zero1:
    """One leaf's ZeRO-1 slice: dim ``dim`` of the rank's parameter cut
    over ``"batch"`` (:func:`zero1_layout`)."""

    def __init__(self, dim: int | None):
        self.dim = dim

    def cut(self, t):
        if self.dim is None or shardlib.group("batch") is None:
            return t
        n = t.shape[self.dim] // shardlib.logical_axis_size("batch")
        return t.narrow(self.dim, shardlib.rank_in("batch") * n, n)

    def join(self, t):
        if self.dim is None:
            return t
        return shardlib.all_gather(t, "batch", self.dim)


def zero1_layout(shardings) -> dict:
    """For ``make_train_step(..., zero1=)``: each leaf's ZeRO-1 slice from
    :func:`placement` ``(..., zero1=True)``'s shardings, the dim its
    moment spec splits over the data axes and its parameter spec does
    not (None: the moments are whole, as the parameter)."""
    def one(psh, msh):
        for i, (a, b) in enumerate(zip(tuple(psh.spec) + (None,) * 8,
                                       msh.spec)):
            if b is not None and a != b:
                return _Zero1(i)
        return _Zero1(None)

    return tree_map(one, shardings["params"], shardings["opt"]["mu"])


def make_train_step(lm, opt, microbatch: int = 1,
                    grad_compress: bool = False,
                    compress_axis: str | None = None, split=None,
                    zero1=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``microbatch`` > 1: gradient accumulation over that many equal row
    splits of the batch (the same math, a lower activation peak): the
    splits' gradients and losses summed in order, then divided by
    ``microbatch``. ``grad_compress``: int8 + error-feedback quantization
    of the gradients; the step grows a residual tree, ``step(params,
    opt_state, res, batch) -> (params, opt_state, res, metrics)``.

    On a bound mesh the data ranks' gradients are added
    (:func:`sum_over_data`), then ``compress_local`` quantizes them under
    ``grad_compress``; with ``compress_axis`` (the data axis, ``"batch"``
    or ``"data"``) the compressed all-reduce
    :func:`~repro_torch.optim.compress_psum` over it takes the plain sum's
    place, as the reference's ``compress_axis`` does. Another axis is
    refused: over the model ranks it would add shards of different
    parameters. ``split``: the optimizer's global-norm split tree
    (:func:`model_split`) where the mesh splits parameters.
    """
    if compress_axis not in (None, "batch", "data"):
        raise ValueError(
            f"compress_axis {compress_axis!r}: the compressed all-reduce "
            "adds the data ranks' gradients ('batch' or 'data'); over "
            "another axis it would add shards of different parameters")
    grad_fn = value_and_grad(lm.train_loss)

    def compute(params, batch):
        if microbatch == 1:
            return grad_fn(params, batch)
        grads = loss = None
        for i in range(microbatch):
            part = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                 + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()}
            li, gi = grad_fn(params, part)
            grads = gi if grads is None else _add(grads, gi)
            loss = li if loss is None else loss + li
        grads = tree_map(lambda g: None if g is None else g / microbatch,
                         grads)
        return loss / microbatch, grads

    def update(grads, opt_state, params):
        kw = {}
        if split is not None:
            kw["split"] = split
        if zero1 is not None:
            kw["shard"] = zero1
        return opt.update(grads, opt_state, params, **kw)

    if not grad_compress:
        def step(params, opt_state, batch):
            loss, grads = compute(params, batch)
            params, opt_state, metrics = update(sum_over_data(grads),
                                                opt_state, params)
            return params, opt_state, {"loss": loss, **metrics}
        return step

    from repro_torch.optim.grad_compress import compress_local, compress_psum

    def step(params, opt_state, res, batch):
        loss, grads = compute(params, batch)
        if compress_axis is not None:
            grads, res = compress_psum(grads, res, compress_axis)
        else:
            grads, res = compress_local(sum_over_data(grads), res)
        params, opt_state, metrics = update(grads, opt_state, params)
        return params, opt_state, res, {"loss": loss, **metrics}
    return step


def train(cfg, shape: ShapeConfig, *, steps: int, ckpt_dir: str | None,
          save_every: int = 50, resume: str = "auto", seed: int = 0,
          lr: float = 3e-4, tp: int = 1, log_every: int = 10,
          keep: int = 3, stop_after: int | None = None,
          microbatch: int = 1, schedule=None, grad_compress: bool = False,
          device="cuda", step_times: list | None = None):
    """Train ``cfg`` on ``device`` for ``steps`` steps; returns ``(params,
    losses)``, the losses of the steps this call ran, as floats (on a mesh,
    ``params`` are this rank's shards). ``step_times``: a list to append
    each step's host seconds to (the loss's read-back ends each step).

    ``stop_after``: simulate preemption — exit after that many steps
    WITHOUT the final checkpoint (only periodic commits survive), exactly
    like a killed worker. The lr schedule is always pinned to ``steps`` so
    a resumed run follows the same schedule.

    ``schedule`` (a :class:`repro_torch.train.PrecisionSchedule`) switches
    the approximation policy at rung boundaries: each step runs under
    ``schedule.config_at(step, cfg.approx)``, one train step built per
    rung config and cached. Because the rung is a pure function of the
    step — like the data order — a resumed run replays the same precision
    sequence and the loss curve stays bitwise continuous across a
    kill/resume that straddles a rung boundary.

    ``grad_compress``: int8 error-feedback gradient compression; the
    residual tree joins the checkpoint so resume carries the feedback
    state too.

    ``tp``: the model ranks of the mesh built when the default process
    group has more than one rank (module docstring); with one rank no
    mesh is bound and the run is unsharded, whatever ``tp`` says.
    """
    lm = build(cfg, device)
    opt = adamw(cosine_schedule(lr, warmup=min(100, steps // 10 + 1),
                                total=steps))
    import torch.distributed as dist

    ranks = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_host_mesh(model=tp) if ranks > 1 else None
    lead = mesh is None or dist.get_rank() == 0
    if mesh is None and tp != 1:
        print(f"# mesh: none bound (one process): --tp {tp} trains "
              "unsharded", flush=True)
    source = make_source(cfg, shape, seed=seed)

    with ExitStack() as stack:
        shardings = split = None
        if mesh is not None:
            stack.enter_context(
                shardlib.use_rules(mesh, {"batch": batch_axes_for(mesh)}))
            n_data = shardlib.logical_axis_size("batch")
            if shape.global_batch % n_data:
                raise ValueError(f"global batch {shape.global_batch} does "
                                 f"not split over {n_data} data ranks")
            shardings, split = placement(cfg, mesh, grad_compress)
            if lead:
                print(f"# mesh: {dict(zip(mesh.axis_names, mesh.shape))}",
                      flush=True)

        start_step = 0
        params = opt_state = res = None
        if ckpt_dir and resume == "auto" \
                and ckpt.latest_step(ckpt_dir) is not None:
            start_step, tree = ckpt.restore(ckpt_dir, shardings=shardings,
                                            device=lm.device)
            params, opt_state = tree["params"], tree["opt"]
            res = tree.get("res")
            if lead:
                print(f"[resume] step {start_step} from {ckpt_dir}")

        # One train step per ApproxConfig: a schedule rung boundary swaps in
        # a model rebuilt under that rung's policy (cached, so a schedule
        # that revisits a rung reuses its step). Key ``None`` is the
        # unscheduled path — exactly ``cfg`` as handed in.
        steps_by_cfg: dict = {}

        def step_for(acfg):
            fn = steps_by_cfg.get(acfg)
            if fn is None:
                lm_s = lm if acfg is None else build(cfg.with_approx(acfg),
                                                     lm.device)
                fn = make_train_step(lm_s, opt, microbatch=microbatch,
                                     grad_compress=grad_compress,
                                     split=split)
                steps_by_cfg[acfg] = fn
            return fn

        if params is None:
            # each leaf cut to this rank's slice as it is drawn
            params = lm.init(seed, shardings and shardings["params"])
            opt_state = opt.init(params)
        if grad_compress and res is None:
            from repro_torch.optim import zero_residual
            res = zero_residual(params)

        def ckpt_tree():
            tree = {"params": params, "opt": opt_state}
            if grad_compress:
                tree["res"] = res
            return tree

        losses = []
        t0 = t_step = wall_clock()
        for step in range(start_step, steps):
            acfg = schedule.config_at(step, cfg.approx) \
                if schedule is not None else None
            fn = step_for(acfg)
            batch = torch_batch(local_rows(source.batch(step)), lm.device)
            if grad_compress:
                params, opt_state, res, metrics = fn(params, opt_state, res,
                                                     batch)
            else:
                params, opt_state, metrics = fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step_times is not None:
                now = wall_clock()
                step_times.append(now - t_step)
                t_step = now
            if lead and (step % log_every == 0 or step == steps - 1):
                dt = wall_clock() - t0
                rung = ""
                if schedule is not None:
                    r = schedule.rung_at(step)
                    rung = f" rung={r.label or r.start_step}"
                print(f"[step {step:5d}] loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e}{rung} ({dt:.1f}s)",
                      flush=True)
            if ckpt_dir and save_every and (step + 1) % save_every == 0:
                ckpt.save_async(ckpt_dir, step + 1, ckpt_tree(), shardings)
                if lead:
                    ckpt.gc_keep_last(ckpt_dir, keep=keep)
            if stop_after is not None and step + 1 >= stop_after:
                ckpt.wait_pending()   # flush committed periodic saves only
                return params, losses
        if ckpt_dir:
            ckpt.wait_pending()
            ckpt.save(ckpt_dir, steps, ckpt_tree(), shardings)
    return params, losses


def local_rows(batch: dict) -> dict:
    """This data rank's rows of a global numpy batch (all of it unbound):
    ``B / n`` rows from ``rank * B / n``, ``n`` the ranks of ``"batch"``."""
    n = shardlib.logical_axis_size("batch")
    if n == 1:
        return batch
    r = shardlib.rank_in("batch")
    return {k: v[r * (v.shape[0] // n):(r + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


def deterministic():
    """Deterministic kernels for bitwise resume: cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, unless already set) and
    ``torch.use_deterministic_algorithms(True)``, under which an op that
    has no deterministic form raises instead of running."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def start_process_group(device) -> None:
    """Start the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) when it names more than one rank: NCCL on the card
    (each rank on its ``LOCAL_RANK`` card), gloo on the CPU. Nothing
    without one."""
    import datetime

    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    backend = "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=world,
                            timeout=datetime.timedelta(minutes=10))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the GPU; 'cpu' runs the "
                         "plain versions of every op)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--approx", default="exact",
                    choices=["exact", "mitchell", "simdive"])
    ap.add_argument("--policy", default=None, metavar="JSON",
                    help="tuning policy (simdive-policy/v1) for the "
                         "approximate arithmetic")
    ap.add_argument("--schedule", default=None, metavar="JSON",
                    help="precision schedule (simdive-schedule/v1): "
                         "per-rung policies switched at step boundaries")
    ap.add_argument("--backward", default="exact",
                    choices=["exact", "approx"],
                    help="'approx' emulates approximate backward matmuls "
                         "too (default: exact grads, straight-through)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--twin", action="store_true",
                    help="train exact + approx twins on identical batches "
                         "and report loss divergence instead of a single "
                         "run (no checkpoints)")
    ap.add_argument("--divergence-out", default=None, metavar="JSON",
                    help="with --twin: write the DivergenceTrace report")
    ap.add_argument("--assert-final-delta-pct", type=float, default=None,
                    help="with --twin: exit 1 if |final loss delta| "
                         "exceeds this percentage of the exact loss")
    ap.add_argument("--assert-grad-cosine", type=float, default=None,
                    help="with --twin: exit 1 if any step's gradient "
                         "cosine similarity falls below this")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    if dev.type == "cuda":
        deterministic()
    start_process_group(dev)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    policy = None
    if args.policy:
        from repro_torch.tuning import TuningPolicy
        policy = TuningPolicy.load(args.policy)
    schedule = None
    if args.schedule:
        from repro_torch.train import PrecisionSchedule
        schedule = PrecisionSchedule.load(args.schedule)

    if args.twin:
        import json

        from repro_torch.train import train_twin
        mode = args.approx if args.approx != "exact" else "simdive"
        base = ApproxConfig(mode=mode, policy=policy,
                            backward=args.backward)
        _, trace = train_twin(
            cfg, shape, steps=args.steps, approx=base, schedule=schedule,
            seed=args.seed, lr=args.lr, grad_compress=args.grad_compress,
            log_every=max(args.steps // 10, 1), device=args.device)
        print(trace.render())
        if args.divergence_out:
            trace.save(args.divergence_out)
            print(f"[twin] wrote {args.divergence_out}")
        failures = []
        delta = trace.final_loss_delta_pct()
        if args.assert_final_delta_pct is not None \
                and delta > args.assert_final_delta_pct:
            failures.append(
                f"final loss delta {delta:.3f}% > "
                f"{args.assert_final_delta_pct}%")
        gcos = trace.min_grad_cosine()
        if args.assert_grad_cosine is not None and gcos is not None \
                and gcos < args.assert_grad_cosine:
            failures.append(
                f"min grad cosine {gcos:.4f} < {args.assert_grad_cosine}")
        if failures:
            print("[twin] DIVERGED: " + "; ".join(failures))
            sys.exit(1)
        print(json.dumps(trace.summary(), sort_keys=True))
        return

    if args.approx != "exact" or policy is not None:
        mode = args.approx if args.approx != "exact" else "simdive"
        cfg = cfg.with_approx(ApproxConfig(mode=mode, policy=policy,
                                           backward=args.backward))
    train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
          save_every=args.save_every, resume=args.resume, seed=args.seed,
          lr=args.lr, tp=args.tp, microbatch=args.microbatch,
          schedule=schedule, grad_compress=args.grad_compress,
          device=args.device)


if __name__ == "__main__":
    main()
