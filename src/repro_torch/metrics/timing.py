"""Timing harness for kernels and serving callables.

Counterpart of ``repro.metrics.timing``. One discipline for every number:
warm the callable first, then time ``iters`` repetitions **synchronised
with the device** — CUDA events around each repetition when the work runs
on a GPU (PyTorch returns before the device finishes, so a bare host clock
would time the enqueue), ``time.perf_counter`` on the CPU. Results carry
the device they were taken on; a CPU number never stands in for a GPU one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.kernels.registry import shape_bucket

__all__ = ["TimingStats", "time_callable"]


@dataclass(frozen=True)
class TimingStats:
    """Synchronous profile of one callable on fixed operands."""
    mean_s: float
    best_s: float
    iters: int
    warmup: int
    shape_buckets: tuple      # pow-2 bucket of each tensor operand
    items: int | None         # caller-declared work items (e.g. tokens)
    device: str               # 'cpu' or the CUDA device's name

    @property
    def items_per_s(self) -> float | None:
        if self.items is None or self.mean_s == 0:
            return None
        return self.items / self.mean_s


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def time_callable(fn, *args, iters: int = 5, warmup: int = 1,
                  items: int | None = None,
                  device: torch.device | str | None = None,
                  **kw) -> TimingStats:
    """Time ``fn(*args, **kw)`` end to end, device-synchronised.

    ``device`` says where the work runs; by default it is read off the
    tensor arguments (any CUDA tensor => that GPU). ``items`` declares how
    many work units one call processes so ``items_per_s`` is meaningful.
    Raises ``ValueError`` on a non-positive best time.
    """
    leaves = [t for a in args for t in _tensors(a)]
    if device is None:
        device = next((t.device for t in leaves if t.is_cuda),
                      torch.device("cpu"))
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    warmup = max(warmup, 1)
    for _ in range(warmup):
        fn(*args, **kw)
    times = []
    if on_gpu:
        torch.cuda.synchronize(device)
        for _ in range(max(iters, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    best = min(times)
    if best <= 0:
        raise ValueError(f"non-positive best time ({best!r}s) timing {fn!r}: "
                         "the measurement is meaningless")
    name = torch.cuda.get_device_name(device) if on_gpu else "cpu"
    return TimingStats(mean_s=sum(times) / len(times), best_s=best,
                       iters=len(times), warmup=warmup,
                       shape_buckets=tuple(shape_bucket(t.shape)
                                           for t in leaves),
                       items=items, device=name)
