"""repro_torch.tuning — the accuracy side of the accuracy-budget autotuner.

Counterpart of ``repro.tuning`` for what is ported so far:

  frontier.py     measure_error: the analytic error stats of one registry
                  config (elemwise / packed / matmul_int / matmul_emul),
                  run through the port's kernels on the card by default

``FrontierPoint``, ``build_frontier``, ``pareto``, ``bench_timings``,
``frontier_table``, ``select.py`` and ``sensitivity.py`` are not ported
yet.
"""
from .frontier import measure_error

__all__ = ["measure_error"]
