"""Gradient compression: int8 payload + error feedback.

Counterpart of ``repro.optim.grad_compress`` for one host:
:func:`compress_local` applies the wire quantization a compressed
all-reduce would (per-tensor int8 with a float32 scale) and carries the
quantization residual into the next step (error feedback). The
reference's ``compress_psum`` needs a named mesh axis and waits for the
port's mesh (ROADMAP A-10). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 payload is the reference's bit for bit.
A ``None`` gradient leaf counts as zero (ROADMAP R-8).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map

__all__ = ["quantize_grad", "dequantize_grad", "compress_local",
           "zero_residual"]


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


def compress_local(grads, residuals):
    """Quantize -> dequantize every leaf with error feedback: returns
    ``(grads, residuals)``, the gradients as float32, the single-host
    identity all-reduce of the reference's compressed path."""
    def one(r, g):
        q, scale, new_r = quantize_grad(g, r)
        return dequantize_grad(q, scale), new_r

    out = tree_map(one, residuals, grads)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))
