"""Token cross-entropy.

Counterpart of ``repro.models.loss``'s plain branch: the logits are cast
to float32, ``logsumexp`` over the vocabulary less the label's logit. The
reference's vocab-parallel branch (a ``shard_map`` over a mesh) has no
counterpart until the port has a mesh.

The label's logit is picked by advanced indexing rather than ``gather``:
its backward is ``index_put_`` with accumulation, which has a deterministic
form on the card (``torch.use_deterministic_algorithms``), as the
embedding's backward does.
"""
from __future__ import annotations

import torch

__all__ = ["xent", "mean_xent"]


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token loss (B,S) in float32. logits (B,S,V); labels (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    picked = flat[rows, labels.reshape(-1)].reshape(labels.shape)
    return lse - picked


def mean_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token loss; with ``mask``, the masked sum over
    ``max(sum(mask), 1)``."""
    per_tok = xent(logits, labels)
    if mask is None:
        return per_tok.mean()
    mask = mask.to(torch.float32)
    return (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
