"""Training driver: train step, checkpoint/restart, deterministic data.

Counterpart of ``repro.launch.train`` on one device. Fault-tolerance
contract, as the reference's:
  * checkpoints are atomic (tmp-dir + rename) and written async,
  * ``--resume auto`` restarts from the newest complete checkpoint,
  * data order is a pure function of (seed, step) and a precision
    schedule's rung a pure function of the step — a restart replays the
    exact batch and policy sequence, so loss curves are bitwise continuous.
On the card that last point needs deterministic kernels: :func:`main`
turns on :func:`deterministic` there (an op without a deterministic form
raises); the CPU's kernels are deterministic already.

``--approx simdive`` trains with every linear on the SIMDive multiplier
(``logmatmul`` on the card) and the attention softmax's finalize on the
SIMDive divider (``elemwise``); ``--backward approx`` puts both gradient
products of every linear on the multiplier too. Attention always runs the
differentiable chunked path (:func:`repro_torch.models.layers.
chunked_attention`): the attention kernels are forward-only, as the
reference's Pallas kernel is. The reference's mesh (``--tp`` > 1, the
``compress_psum`` all-reduce) waits for the port's mesh (ROADMAP A-10)
and is refused.

Usage (CPU smoke; on the card drop ``--smoke --device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --device cpu --steps 20 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ck --save-every 10
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.approx import ApproxConfig
from repro_torch.core.device import require_device
from repro_torch.core.tree import tree_map, value_and_grad
from repro_torch.data import make_source, torch_batch
from repro_torch.models import build
from repro_torch.optim import adamw, cosine_schedule

__all__ = ["make_train_step", "train", "main"]

_MESH = ("needs the port's mesh, which is not built yet (ROADMAP A-10): "
         "the port trains on one device")


def _add(a, b):
    return tree_map(lambda x, y: x if y is None else y if x is None
                    else x + y, a, b)


def make_train_step(lm, opt, microbatch: int = 1,
                    grad_compress: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``microbatch`` > 1: gradient accumulation over that many equal row
    splits of the batch (the same math, a lower activation peak): the
    splits' gradients and losses summed in order, then divided by
    ``microbatch``. ``grad_compress``: int8 + error-feedback quantization
    of the gradients (:func:`repro_torch.optim.compress_local`); the step
    grows a residual tree, ``step(params, opt_state, res, batch) ->
    (params, opt_state, res, metrics)``. The reference's mesh all-reduce
    (``compress_axis``) waits for the port's mesh.
    """
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

    if not grad_compress:
        def step(params, opt_state, batch):
            loss, grads = compute(params, batch)
            params, opt_state, metrics = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, **metrics}
        return step

    from repro_torch.optim.grad_compress import compress_local

    def step(params, opt_state, res, batch):
        loss, grads = compute(params, batch)
        grads, res = compress_local(grads, res)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        return params, opt_state, res, {"loss": loss, **metrics}
    return step


def train(cfg, shape: ShapeConfig, *, steps: int, ckpt_dir: str | None,
          save_every: int = 50, resume: str = "auto", seed: int = 0,
          lr: float = 3e-4, tp: int = 1, log_every: int = 10,
          keep: int = 3, stop_after: int | None = None,
          microbatch: int = 1, schedule=None, grad_compress: bool = False,
          device="cuda"):
    """Train ``cfg`` on ``device`` for ``steps`` steps; returns ``(params,
    losses)``, the losses of the steps this call ran, as floats.

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
    state too. ``tp`` > 1 raises: the port has no mesh yet.
    """
    if tp != 1:
        raise NotImplementedError(f"tp={tp} {_MESH}")
    lm = build(cfg, device)
    opt = adamw(cosine_schedule(lr, warmup=min(100, steps // 10 + 1),
                                total=steps))
    source = make_source(cfg, shape, seed=seed)

    start_step = 0
    params = opt_state = res = None
    if ckpt_dir and resume == "auto" and ckpt.latest_step(ckpt_dir) is not None:
        start_step, tree = ckpt.restore(ckpt_dir, device=lm.device)
        params, opt_state = tree["params"], tree["opt"]
        res = tree.get("res")
        print(f"[resume] step {start_step} from {ckpt_dir}")

    # One train step per ApproxConfig: a schedule rung boundary swaps in a
    # model rebuilt under that rung's policy (cached, so a schedule that
    # revisits a rung reuses its step). Key ``None`` is the unscheduled
    # path — exactly ``cfg`` as handed in.
    steps_by_cfg: dict = {}

    def step_for(acfg):
        fn = steps_by_cfg.get(acfg)
        if fn is None:
            lm_s = lm if acfg is None else build(cfg.with_approx(acfg),
                                                 lm.device)
            fn = make_train_step(lm_s, opt, microbatch=microbatch,
                                 grad_compress=grad_compress)
            steps_by_cfg[acfg] = fn
        return fn

    if params is None:
        params = lm.init(seed)
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
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        acfg = schedule.config_at(step, cfg.approx) \
            if schedule is not None else None
        fn = step_for(acfg)
        batch = torch_batch(source.batch(step), lm.device)
        if grad_compress:
            params, opt_state, res, metrics = fn(params, opt_state, res,
                                                 batch)
        else:
            params, opt_state, metrics = fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            rung = ""
            if schedule is not None:
                r = schedule.rung_at(step)
                rung = f" rung={r.label or r.start_step}"
            print(f"[step {step:5d}] loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}{rung} ({dt:.1f}s)",
                  flush=True)
        if ckpt_dir and save_every and (step + 1) % save_every == 0:
            ckpt.save_async(ckpt_dir, step + 1, ckpt_tree())
            ckpt.gc_keep_last(ckpt_dir, keep=keep)
        if stop_after is not None and step + 1 >= stop_after:
            ckpt.wait_pending()   # flush committed periodic saves only
            return params, losses
    if ckpt_dir:
        ckpt.wait_pending()
        ckpt.save(ckpt_dir, steps, ckpt_tree())
    return params, losses


def deterministic():
    """Deterministic kernels for bitwise resume: cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, unless already set) and
    ``torch.use_deterministic_algorithms(True)``, under which an op that
    has no deterministic form raises instead of running."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


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

    if args.tp != 1:
        raise NotImplementedError(f"--tp {args.tp} {_MESH}")
    if require_device(args.device).type == "cuda":
        deterministic()
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
