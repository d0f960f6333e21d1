"""Token cross-entropy, and its vocab-parallel form on a mesh.

Counterpart of ``repro.models.loss``. Unbound, :func:`xent` is the
reference's plain branch: the logits cast to float32, ``logsumexp`` over
the vocabulary less the label's logit. On a bound mesh whose ``"vocab"``
axis is bound it is the vocab-parallel branch (Megatron-style): each
model rank holds its shard of the vocabulary's logits and computes its
local max, sum of exponentials and label pick; the max is combined with
``all_reduce`` MAX outside autograd (the reference's ``stop_gradient``),
the other two with ``all_reduce`` SUM, so no rank gathers the (B,S,V)
logits. The branch is taken even where the vocabulary is not split (an
axis of one rank, or a vocabulary the axis does not divide, whose head
:func:`~repro_torch.launch.specs.sanitize_specs` replicates), as the
reference takes it for any bound vocab axis; it differs from the plain
branch in float order only.

:func:`mean_xent` on a bound mesh is the mean over the whole batch: each
data rank's sum over its rows, added over the data ranks (forward;
backward each rank's own share) and divided by the batch's token count.

The label's logit is picked by advanced indexing rather than ``gather``:
its backward is ``index_put_`` with accumulation, which has a deterministic
form on the card (``torch.use_deterministic_algorithms``), as the
embedding's backward does.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shardlib

__all__ = ["xent", "mean_xent"]


def _pick(lg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = lg.reshape(-1, lg.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    return flat[rows, idx.reshape(-1)].reshape(idx.shape)


def _plain_xent(logits, labels):
    logits = logits.to(torch.float32)
    return torch.logsumexp(logits, dim=-1) - _pick(logits, labels)


def _vocab_parallel_xent(logits, labels, split: bool):
    lg = logits.to(torch.float32)
    v_loc = lg.shape[-1]
    off = shardlib.rank_in("vocab") * v_loc if split else 0
    m = lg.detach().amax(dim=-1)
    if split:
        shardlib.all_reduce(m, "vocab", "max")
    s = torch.exp(lg - m[..., None]).sum(dim=-1)
    inside = (labels >= off) & (labels < off + v_loc)
    pick = torch.where(inside, _pick(lg, (labels - off).clamp(0, v_loc - 1)),
                       torch.zeros_like(m))
    if split:
        s = shardlib.reduce_from(s, "vocab")
        pick = shardlib.reduce_from(pick, "vocab")
    return m + torch.log(s) - pick


def xent(logits: torch.Tensor, labels: torch.Tensor,
         vocab_size: int | None = None) -> torch.Tensor:
    """Per-token loss (B,S) in float32. logits (B,S,V) — on a bound mesh
    this rank's vocabulary shard where they are narrower than the full
    ``vocab_size`` (without ``vocab_size``: whenever the ``"vocab"`` axis
    has more than one rank); labels (B,S), global token ids."""
    if not shardlib.active() or not shardlib.logical_spec("vocab")[0]:
        return _plain_xent(logits, labels)
    split = (logits.shape[-1] < vocab_size if vocab_size is not None
             else shardlib.logical_axis_size("vocab") > 1)
    return _vocab_parallel_xent(logits, labels, split)


def mean_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor | None = None,
              vocab_size: int | None = None) -> torch.Tensor:
    """Mean token loss; with ``mask``, the masked sum over
    ``max(sum(mask), 1)``. On a bound mesh, over every data rank's rows."""
    per_tok = xent(logits, labels, vocab_size)
    if not shardlib.active():
        if mask is None:
            return per_tok.mean()
        mask = mask.to(torch.float32)
        return (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
    if mask is None:
        count = per_tok.new_tensor(
            float(per_tok.numel() * shardlib.logical_axis_size("batch")))
        total = per_tok.sum()
    else:
        mask = mask.to(torch.float32)
        count = shardlib.all_reduce(mask.sum().detach(), "batch")
        total = (per_tok * mask).sum()
    return shardlib.reduce_from(total, "batch") / count.clamp(min=1.0)
