"""repro_torch.models — the decoder: every family's stack, served and trained."""
from .model import LM, build

__all__ = ["LM", "build"]
