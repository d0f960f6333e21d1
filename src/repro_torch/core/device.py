"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["require_device"]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA device
    and this host has none — the port never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False: repro_torch runs on the GPU unless the caller asks "
            "for device='cpu'")
    return device
