"""repro_torch.models — the decoder: attention stacks and the rwkv6 stack."""
from .model import LM, build

__all__ = ["LM", "build"]
