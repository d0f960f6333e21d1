"""repro_torch.kernels — hand-written CUDA kernels for the SIMDive hot spots.

Layering:

  datapath.py         composable stage library in plain PyTorch — the
                      log -> correct -> antilog datapath, host side
  csrc/simdive_datapath.cuh   the same stages, device side, included by
                      every kernel
  csrc/cp_async.cuh   cp.async copy / commit / wait helpers shared by the
                      ring schedules
  elemwise.py         fused elementwise mul/div/mixed and the log-domain
                      sqrt: wrappers + plain versions
                      (kernels: csrc/elemwise.cu)
  packed_simd.py      packed sub-word lanes (4x8-bit / 2x16-bit a uint32
                      word) through the same SISD unit, repacked onto the
                      doubled bus: wrapper + plain versions
                      (kernel: csrc/packed_simd.cu)
  flash_attention.py  online-softmax attention whose finalize runs the
                      SIMDive divider, depth-0 and cp.async kv-ring
                      schedules: wrappers + plain version
                      (kernel: csrc/flash_attention.cu)
  decode_attention.py one decode step's attention over a read-only cache
                      plus the new token, finalize (exact or SIMDive
                      divider) included, in one launch: wrapper + plain
                      version (kernel: csrc/decode_attention.cu)
  logmatmul.py        signed int32 matmul with SIMDive products, depth-0
                      and cp.async-ring schedules: wrappers + plain version
                      (kernel: csrc/logmatmul.cu; the int64-sum form in
                      csrc/logmatmul_wide.cu, both from csrc/logmatmul.cuh)
  build.py            nvcc build at first launch + ctypes loader
  registry.py         get_op()/register_op() — backend resolution and the
                      measure-and-cache block autotune
  ops.py              built-in op registration + thin public wrappers

Exports resolve lazily (PEP 562) so importing a leaf module never drags in
the whole op surface.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "simdive_elemwise": ".ops",
    "simdive_packed": ".ops",
    "simdive_attention": ".ops",
    "simdive_matmul_int": ".ops",
    "get_op": ".registry",
    "register_op": ".registry",
    "resolve_backend": ".registry",
    "launch_counts": ".registry",
    "reset_launch_counts": ".registry",
    "launches_between": ".registry",
    "add_launches": ".registry",
    "autotune_cache": ".registry",
    "autotune_generation": ".registry",
    "clear_autotune_cache": ".registry",
    "export_autotune_cache": ".registry",
    "preload_autotune_cache": ".registry",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
