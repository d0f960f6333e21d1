"""repro_torch.models — the decoder (dense attention family so far)."""
from .model import LM, build

__all__ = ["LM", "build"]
