"""The exact-vs-approximate twin training loop.

Counterpart of ``repro.train.loop``. :func:`train_twin` trains two copies
of one model on a bitwise-identical batch sequence — the exact twin (plain
float arithmetic) and the approximate twin (SIMDive dispatch under an
:class:`ApproxConfig`, optionally rung-switched by a
:class:`PrecisionSchedule`) — from the same initialization, under the same
optimizer and lr schedule, and records a
:class:`repro_torch.metrics.DivergenceTrace` per step: loss delta,
gradient cosine similarity, parameter drift.

One twin step is built per rung config and cached, as the reference
caches one jitted step per ``ApproxConfig``. Gradient compression
(:func:`repro_torch.optim.compress_local`) is applied to the
*approximate* twin's gradients with error-feedback residuals carried in
the loop state. The single-run schedule-aware path lives in
:func:`repro_torch.launch.train.train` — this module is the measurement
side.
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.approx import EXACT, ApproxConfig
from repro_torch.core.tree import value_and_grad
from repro_torch.data import make_source, torch_batch
from repro_torch.metrics import DivergenceTrace, grad_cosine, param_drift
from repro_torch.models import build
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.optim.grad_compress import compress_local, zero_residual

__all__ = ["make_twin_step", "train_twin"]


def make_twin_step(lm_exact, lm_approx, opt, *, grad_compress: bool = False):
    """One step of both twins + the divergence statistics, on the device.

    ``step(params_e, opt_e, params_a, opt_a, res, batch)`` returns the
    advanced states plus a metrics dict of scalar tensors. The gradient
    cosine is measured *before* compression (it isolates the arithmetic's
    effect on the training signal); parameter drift is measured after both
    updates. ``res`` is the error-feedback residual tree (``None`` when
    compression is off).
    """
    grad_e = value_and_grad(lm_exact.train_loss)
    grad_a = value_and_grad(lm_approx.train_loss)

    def step(params_e, opt_e, params_a, opt_a, res, batch):
        loss_e, grads_e = grad_e(params_e, batch)
        loss_a, grads_a = grad_a(params_a, batch)
        gcos = grad_cosine(grads_a, grads_e)
        if grad_compress:
            grads_a, res = compress_local(grads_a, res)
        params_e, opt_e, m_e = opt.update(grads_e, opt_e, params_e)
        params_a, opt_a, _ = opt.update(grads_a, opt_a, params_a)
        metrics = {
            "loss_exact": loss_e, "loss_approx": loss_a,
            "grad_cosine": gcos,
            "param_drift": param_drift(params_a, params_e),
            "lr": m_e["lr"],
        }
        return params_e, opt_e, params_a, opt_a, res, metrics
    return step


def train_twin(cfg, shape: ShapeConfig, *, steps: int,
               approx: ApproxConfig | None = None, schedule=None,
               seed: int = 0, lr: float = 1e-3,
               grad_compress: bool = False, log_every: int = 0,
               meta: dict | None = None, device="cuda"):
    """Train exact and approximate twins in lockstep on ``device``;
    returns ``(params_approx, DivergenceTrace)``.

    ``approx`` is the approximate twin's base config (default: the
    config's own when it approximates, else ``ApproxConfig(mode=
    'simdive')``). ``schedule`` overrides it per step via
    ``config_at(step, approx)``. Data order is a pure function of
    ``(seed, step)`` (:mod:`repro_torch.data`), so both twins consume
    bitwise-identical batches and the trace measures arithmetic, not data
    noise. Both twins start from ``LM.init(seed)``.
    """
    base = approx if approx is not None else \
        (cfg.approx if cfg.approx.enabled else ApproxConfig(mode="simdive"))
    lm_e = build(cfg.with_approx(EXACT), device)
    opt = adamw(cosine_schedule(lr, warmup=min(100, steps // 10 + 1),
                                total=steps))
    source = make_source(cfg, shape, seed=seed)

    params0 = lm_e.init(seed)
    opt0 = opt.init(params0)
    params_e = params_a = params0
    opt_e = opt_a = opt0
    res = zero_residual(params0) if grad_compress else None

    trace = DivergenceTrace(meta={
        "arch": cfg.name, "steps": steps, "seed": seed, "lr": lr,
        "batch": shape.global_batch, "seq": shape.seq_len,
        "backward": base.backward, "grad_compress": bool(grad_compress),
        "approx": f"{base.mode}/w{base.width}/cb{base.coeff_bits}",
        **({"schedule_boundaries": list(schedule.boundaries())}
           if schedule is not None else {}),
        **(meta or {}),
    })

    steps_by_cfg: dict = {}

    def step_for(acfg: ApproxConfig):
        fn = steps_by_cfg.get(acfg)
        if fn is None:
            lm_a = build(cfg.with_approx(acfg), device)
            fn = make_twin_step(lm_e, lm_a, opt, grad_compress=grad_compress)
            steps_by_cfg[acfg] = fn
        return fn

    for step in range(steps):
        if schedule is not None:
            rung = schedule.rung_at(step)
            acfg = schedule.config_at(step, base)
            label = rung.label or f"rung@{rung.start_step}"
        else:
            acfg, label = base, None
        batch = torch_batch(source.batch(step), lm_e.device)
        params_e, opt_e, params_a, opt_a, res, m = step_for(acfg)(
            params_e, opt_e, params_a, opt_a, res, batch)
        rec = trace.record(step, loss_exact=float(m["loss_exact"]),
                           loss_approx=float(m["loss_approx"]),
                           grad_cosine=float(m["grad_cosine"]),
                           param_drift=float(m["param_drift"]),
                           rung=label)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"[twin {step:5d}] exact={rec['loss_exact']:.4f} "
                  f"approx={rec['loss_approx']:.4f} "
                  f"gcos={rec['grad_cosine']:.4f}"
                  + (f" ({label})" if label else ""), flush=True)
    return params_a, trace
