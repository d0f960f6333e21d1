from .optimizers import (adamw, lion, momentum, cosine_schedule,
                         clip_by_global_norm, global_norm)
from .grad_compress import compress_local, zero_residual

__all__ = ["adamw", "lion", "momentum", "cosine_schedule",
           "clip_by_global_norm", "global_norm", "compress_local",
           "zero_residual"]
