"""repro_torch.metrics — measurement helpers (timing so far)."""
from .timing import TimingStats, time_callable

__all__ = ["TimingStats", "time_callable"]
