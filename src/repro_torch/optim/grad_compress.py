"""Gradient compression: int8 payload + error feedback.

Counterpart of ``repro.optim.grad_compress``: :func:`compress_psum` is
the compressed all-reduce over a logical mesh axis (the int8 payloads
summed in int32, times the largest of the ranks' scales), and
:func:`compress_local` its one-host twin, which applies the same wire
quantization (per-tensor int8 with a float32 scale) with no reduction.
Both carry the quantization residual into the next step (error feedback).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payload is the reference's bit for bit. A ``None`` gradient leaf counts
as zero (ROADMAP R-8).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map

__all__ = ["quantize_grad", "dequantize_grad", "compress_psum",
           "compress_local", "zero_residual"]


def zero_residual(grads):
    """A float32 zero residual for every leaf of ``grads`` (a parameter
    tree will do)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def quantize_grad(g, res):
    """float grad + residual -> (int8 q, float32 scale, new residual)."""
    gf = res if g is None else g.to(torch.float32) + res
    scale = gf.abs().amax().clamp(min=1e-30) / 127.0
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, gf - q.to(torch.float32) * scale


def dequantize_grad(q, scale):
    return q.to(torch.float32) * scale


def _unzip2(out):
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


def compress_psum(grads, residuals, axis: str):
    """The sum over the logical mesh axis ``axis`` (a bound mesh,
    :mod:`repro_torch.launch.sharding`) with an int8 payload and error
    feedback: returns ``(grads, residuals)``. Each rank quantizes its
    gradient plus residual; the int8 payloads are summed in int32 (exact)
    and multiplied by the largest of the ranks' scales — not by the sum
    of each payload times its own scale — as the reference's
    ``compress_psum`` does. Two ``all_reduce`` a leaf: the payload's SUM,
    the scale's MAX."""
    from repro_torch.launch.sharding import all_reduce

    def one(r, g):
        q, scale, new_r = quantize_grad(g, r)
        summed = all_reduce(q.to(torch.int32), axis)
        scale_max = all_reduce(scale.clone(), axis, "max")
        return summed.to(torch.float32) * scale_max, new_r

    return _unzip2(tree_map(one, residuals, grads))


def compress_local(grads, residuals):
    """Quantize -> dequantize every leaf with error feedback: returns
    ``(grads, residuals)``, the gradients as float32, the single-host
    identity all-reduce of the reference's compressed path."""
    def one(r, g):
        q, scale, new_r = quantize_grad(g, r)
        return dequantize_grad(q, scale), new_r

    return _unzip2(tree_map(one, residuals, grads))
