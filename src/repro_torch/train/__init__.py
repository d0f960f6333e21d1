"""repro_torch.train — approximate arithmetic in the training loop.

Counterpart of ``repro.train``:

  schedule   PrecisionSchedule / ScheduleRung: JSON-serializable step ->
             policy rungs (exact warmup -> approximate steady-state,
             per-layer ramps from a sensitivity assignment)
  loop       train_twin: exact-vs-approx twins on a bitwise-identical
             batch sequence, recording a metrics.DivergenceTrace
             (loss delta, grad cosine, parameter drift) per step

The single-run path (checkpoints, preemption, resume under a schedule)
stays in :mod:`repro_torch.launch.train`.
"""
from .schedule import (
    SCHEDULE_SCHEMA,
    PrecisionSchedule,
    ScheduleRung,
    ramp_schedule,
    warmup_schedule,
)
from .loop import make_twin_step, train_twin

__all__ = [
    "SCHEDULE_SCHEMA",
    "PrecisionSchedule",
    "ScheduleRung",
    "warmup_schedule",
    "ramp_schedule",
    "make_twin_step",
    "train_twin",
]
