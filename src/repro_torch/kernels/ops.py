"""Built-in SIMDive ops: registration + thin public entry points.

Counterpart of ``repro.kernels.ops`` for the ops ported so far: ``elemwise``
and ``attention``. Each registers its plain PyTorch version and its CUDA
kernel with :mod:`repro_torch.kernels.registry`. The kernels mask their
ragged edges themselves, so there is no pad-to-block step: any shape goes
straight in, and the results equal the reference's padded ones.
"""
from __future__ import annotations

from repro_torch.core.simdive import SimdiveSpec
from . import elemwise as _ew
from . import flash_attention as _fa
from .flash_attention import DEFAULT_DIV_SPEC, DEFAULT_FRAC_OUT
from .registry import get_op, register_op

__all__ = ["simdive_elemwise", "simdive_attention"]


# --------------------------------------------------------------- elemwise --
def _elemwise_ref(a, b, *, spec, op="mul", mode=None, frac_out=0):
    return _ew.elemwise_ref(a, b, spec, op=op, mode=mode, frac_out=frac_out)


def _elemwise_cuda(a, b, *, spec, block, op="mul", mode=None, frac_out=0):
    return _ew.elemwise_cuda(a, b, spec, op=op, mode=mode, frac_out=frac_out,
                             block=block)


# -------------------------------------------------------------- attention --
def _attention_ref(q, k, v, *, spec, causal=True, window=0, approx_div=True,
                   frac_out=DEFAULT_FRAC_OUT, q_offset=0, kv_group=1):
    return _fa.flash_attention_ref(
        q, k, v, spec=spec, causal=causal, window=window,
        approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
        kv_group=kv_group)


def _attention_cuda(q, k, v, *, spec, causal=True, window=0,
                    approx_div=True, frac_out=DEFAULT_FRAC_OUT, q_offset=0,
                    kv_group=1):
    return _fa.flash_attention_cuda(
        q, k, v, spec=spec, causal=causal, window=window,
        approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
        kv_group=kv_group)


register_op("elemwise", ref=_elemwise_ref, cuda=_elemwise_cuda,
            default_block=_ew.DEFAULT_BLOCK, kernel=_ew.elemwise_cuda)
register_op("attention", ref=_attention_ref, cuda=_attention_cuda,
            kernel=_fa.flash_attention_cuda)


# ------------------------------------------------------------- public API --
def simdive_elemwise(a, b, spec: SimdiveSpec, op: str = "mul", mode=None,
                     frac_out: int = 0, backend: str = "auto", block=None):
    """Elementwise SIMDive mul/div/mixed over same-shape lane tensors."""
    return get_op("elemwise", spec, backend, block=block)(
        a, b, op=op, mode=mode, frac_out=frac_out)


def simdive_attention(q, k, v, spec: SimdiveSpec | None = None, *,
                      causal: bool = True, window: int = 0,
                      approx_div: bool = True,
                      frac_out: int = DEFAULT_FRAC_OUT, q_offset: int = 0,
                      kv_group: int = 1, backend: str = "auto"):
    """Flash attention with the SIMDive softmax divider.

    q: (BH, Sq, dh); k, v: (BH / kv_group, Skv, dh) — heads flattened.
    ``spec`` picks the divider config (defaults to the width-16 attention
    divider).
    """
    spec = DEFAULT_DIV_SPEC if spec is None else spec
    return get_op("attention", spec, backend)(
        q, k, v, causal=causal, window=window, approx_div=approx_div,
        frac_out=frac_out, q_offset=q_offset, kv_group=kv_group)
