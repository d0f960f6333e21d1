"""Flash attention with SIMDive divider normalization: kernel wrapper and
plain version.

Counterpart of ``repro.kernels.flash_attention``. The CUDA kernel is
``csrc/flash_attention.cu`` (online softmax over kv tiles, QK^T and PV in
the kernel's body, the divider in its finalize); the plain PyTorch version
is :func:`flash_attention_ref` (dense softmax, q-chunked) with
:func:`softmax_div`, composing the same datapath stages.

Contract (the reference's): ``q (BH, Sq, dh)``, ``k, v (BH, Skv, dh)`` with
heads flattened and matched, f32 or bf16, output ``(BH, Sq, dh)`` in
``q.dtype``. One extension: ``kv_group = G`` lets ``k, v`` be
``(BH / G, Skv, dh)`` — head ``bh`` reads kv head ``bh // G`` — so GQA
callers need not materialise the repeat.

``floor(log2 top)`` of the per-row quantizer is read from the float's
exponent field (``torch.frexp`` here, the exponent bits in the kernel), so
kernel and plain version agree exactly on the row scale; two ``log2``
implementations may differ in the last place just below a power of two.

**Products.** bf16 q/k/v run both products on the tensor cores
(``mma.sync`` m16n8k16, bf16 operands, f32 accumulation — the reference's
``dot_general`` contract): 4 warps a block, 16 q rows each, operands read
from bf16 shared-memory tiles by ``ldmatrix``, ``p`` rounded to bf16 in
registers. f32 q/k/v keep FMA loops on the CUDA cores (256 threads a
block): TF32 would round each operand to 10 mantissa bits.

**Blocks.** A launch shape is ``(q_chunk, kv_chunk)`` or ``(q_chunk,
kv_chunk, depth)`` as in the reference: ``depth`` 0 loads each kv tile
synchronously, ``D >= 1`` streams k/v tiles through a ``D``-slot
``cp.async`` ring (the reference's ``_kernel_pipelined``; 16-byte copies
for bf16, 4-byte for f32); every depth is bit-identical to depth 0. The
kernel is compiled for one tile, 64 q rows x 64 kv rows (:data:`TILES`).
The reference's TPU blocks (256..1024 rows) are not carried over: one
512 x 512 f32 score tile alone is 1 MB, against the 227 KB of shared
memory an H100 block may have. Shared memory grows with the depth, the
dtype and d_head (:func:`smem_bytes`): every depth fits for bf16 and for
f32 at d_head 64 and 80, f32 at d_head 128 takes depth <= 2. The kernel is
compiled for d_head 64, 80 (zamba2's) and 128. A block is checked against
the compiled tile, the depth limit and that memory for the call's dtype
and d_head before any launch (:func:`check_block`), and the registry's
candidates are checked for the worst case, f32 at d_head 128. bf16 q, k
and v must start 16-byte aligned (both schedules load 16 bytes at a time;
:func:`check_aligned`).

Each schedule's wrapper counts its own launches
(``flash_attention_cuda`` for depth 0, ``flash_attention_pipelined_cuda``
for the ring), so a run's launch counts show which schedule served it.

**Width 32.** A divider at width 32 (the reference's uint64 lanes) runs the
kernels' 64-bit-lane forms, compiled from ``csrc/flash_attention_w32.cu``
over the same templates (``csrc/flash_attention.cuh``) and entered through
the ``*_w32`` C entries; each such launch also counts apart, in
``flash_attention_cuda.w32`` / ``flash_attention_pipelined_cuda.w32``
(``attention_w32`` / ``attention_pipelined_w32`` in ``launch_counts()``).
Only the finalize differs: 8-byte lanes clipped at :func:`lane_max_float`
``(32)``. Its quotients are folded back to float32 rounded once
(:func:`repro_torch.core.mitchell.lanes_to_float`), as the kernel's
``__ull2float_rn`` does.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.core.error_lut import table_for
from repro_torch.core.mitchell import (
    check_width,
    lane_max_float,
    lanes_to_float,
)
from repro_torch.core.simdive import SimdiveSpec
from . import build
from . import datapath as dp

__all__ = ["DEFAULT_DIV_SPEC", "DEFAULT_FRAC_OUT", "TILES", "DEFAULT_BLOCK",
           "BLOCK_CANDIDATES", "split_block", "smem_bytes", "check_block",
           "check_aligned", "softmax_div_quantize", "softmax_div_lanes",
           "softmax_div", "flash_attention_ref", "flash_attention_cuda",
           "flash_attention_pipelined_cuda", "softmax_div_cuda"]

#: divider config the attention op resolves to when no policy overrides it:
#: width 16 + frac_out 15 keeps every anti-log shift < 32
DEFAULT_DIV_SPEC = SimdiveSpec(width=16, coeff_bits=8, index_bits=3)
DEFAULT_FRAC_OUT = 15
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80, 128)

#: (q_chunk, kv_chunk) tiles compiled into csrc/flash_attention.cu (its BQ,
#: BK): for bf16 4 warps of 16 q rows on the tensor cores, for f32 256
#: threads with a 4 x 4 score micro-tile each
TILES = frozenset({(64, 64)})
DEFAULT_BLOCK = (64, 64)
#: the autotune's choices: depth 0 and the 2-slot ring. A deeper ring does
#: not fit the worst case the wrapper takes (f32, d_head 128: depth 3 needs
#: 247,808 bytes); the wrapper still runs depths up to 4 where they fit.
BLOCK_CANDIDATES = ((64, 64), (64, 64, 2))
#: shared memory a block may use on Hopper, less the kernel's static
#: divider table (256 ints)
_SMEM_LIMIT = 232448 - 256 * 4
_MAX_DEPTH = 4                 # cp.async.wait_group takes an immediate
#: the bf16 kernel loads and copies q, k and v 16 bytes at a time (both
#: schedules)
_BF16_ALIGN = 16


def split_block(block) -> tuple[tuple[int, int], int]:
    """``((q_chunk, kv_chunk), depth)`` of a 2- or 3-tuple block; the
    2-tuple means the depth-0 schedule."""
    if len(block) not in (2, 3):
        raise ValueError(f"an attention block has 2 or 3 components, got "
                         f"{block}")
    depth = int(block[2]) if len(block) == 3 else 0
    return (int(block[0]), int(block[1])), depth


def smem_bytes(block, dtype=torch.float32, dh: int = 128) -> int:
    """Dynamic shared memory of one CUDA block (csrc/flash_attention.cu's
    ``smem_bytes_mma`` for bf16, ``smem_bytes`` / ``smem_bytes_pipe`` for
    f32). bf16: a q tile and, at depth 0, one k and one v tile, at depth D,
    D ring slots of them, all bf16 with rows padded by 16 bytes. f32 depth
    0: q, k (rows padded by one word), v and p tiles. f32 depth D: q and p
    tiles plus D ring slots of k and v rows, each padded by one word."""
    (bq, bk), depth = split_block(block)
    if dtype == torch.bfloat16:
        return 2 * (bq + 2 * max(depth, 1) * bk) * (dh + 8)
    if not depth:
        return 4 * (bq * (dh + 1) + bk * (dh + 1) + bk * dh + bq * (bk + 1))
    return 4 * (bq * (dh + 1) + bq * (bk + 1)) + depth * 2 * bk * (dh + 1) * 4


def check_block(block, dtype=torch.float32, dh: int = 128):
    """Raise ``ValueError`` unless the kernel can run ``block`` on
    ``dtype`` q/k/v of head size ``dh`` (by default the worst case the
    wrapper takes). Returns ``((q_chunk, kv_chunk), depth)``."""
    tile, depth = split_block(block)
    if tile not in TILES:
        raise ValueError(f"attention block {tuple(block)}: (q_chunk, "
                         f"kv_chunk) = {tile} is not a compiled tile "
                         f"{sorted(TILES)}")
    if not 0 <= depth <= _MAX_DEPTH:
        raise ValueError(f"attention block {tuple(block)}: depth must be in "
                         f"[0, {_MAX_DEPTH}]")
    need = smem_bytes(block, dtype, dh)
    if need > _SMEM_LIMIT:
        raise ValueError(f"attention block {tuple(block)} needs {need} bytes "
                         f"of shared memory for {dtype} at d_head {dh}, more "
                         f"than the {_SMEM_LIMIT} an H100 block can have")
    return tile, depth


def check_aligned(q, k, v) -> None:
    """Raise ``ValueError`` unless bf16 q, k and v start 16-byte aligned, as
    the kernel's 16-byte loads and copies need (rows are whole multiples of
    16 bytes at d_head 64 / 80 / 128, so only the start can be off). f32
    needs nothing more than its elements' own 4-byte alignment, which is all
    its ring's copies take."""
    if q.dtype != torch.bfloat16:
        return
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % _BF16_ALIGN:
            raise ValueError(
                f"flash_attention: {name} starts at address "
                f"{t.data_ptr():#x}, not {_BF16_ALIGN}-byte aligned as the "
                f"bf16 kernel's {_BF16_ALIGN}-byte loads need")


# ---------------------------------------------------------------- divider --
def softmax_div_quantize(acc: torch.Tensor, l: torch.Tensor, width: int):
    """Per-row shared-exponent quantization of ``(|acc|, l)`` into lanes.

    ``top = max(rowmax|acc|, l)`` anchors each row's scale
    ``2^(width - 2 - floor(log2 top))``, so both operands use the full lane
    and the result does not depend on how rows were blocked. Returns
    ``(qn (..., dh), qd (..., 1))`` int64 carriers.
    """
    num = acc.abs()
    den = l.clamp(min=1e-30)[..., None]
    top = torch.maximum(num.amax(dim=-1, keepdim=True), den).clamp(min=1e-30)
    _, e = torch.frexp(top)                      # top = m * 2^e, m in [.5, 1)
    sc = torch.ldexp(torch.ones_like(top), (width - 1) - e)
    lim = lane_max_float(width)
    qn = torch.round(num * sc).clamp(0.0, lim).to(torch.int64)
    qd = torch.round(den * sc).clamp(1.0, lim).to(torch.int64)
    return qn, qd


def softmax_div_lanes(acc, l, tab, *, width: int, index_bits: int = 3,
                      frac_out: int = DEFAULT_FRAC_OUT,
                      round_out: bool = True) -> torch.Tensor:
    """The divider's raw quotient lanes (int64 carrier) for ``acc / l``."""
    qn, qd = softmax_div_quantize(acc, l, width)
    return dp.lane_op(qn, qd.expand_as(qn), tab, width=width,
                      index_bits=index_bits, op="div", frac_out=frac_out,
                      round_out=round_out)


def softmax_div(acc, l, tab, *, width: int, index_bits: int = 3,
                frac_out: int = DEFAULT_FRAC_OUT,
                round_out: bool = True) -> torch.Tensor:
    """Softmax normalization ``acc / l[..., None]`` on the SIMDive divider.

    ``acc``: (..., dh) float32 signed accumulator rows; ``l``: (...,) > 0
    denominators; ``tab``: the int64 'div' table on ``acc``'s device. The
    quotient comes back at ``frac_out`` fraction bits and is folded back to
    float32 with the sign re-applied.
    """
    quot = softmax_div_lanes(acc, l, tab, width=width, index_bits=index_bits,
                             frac_out=frac_out, round_out=round_out)
    out = lanes_to_float(quot) * (2.0 ** -frac_out)
    return torch.where(acc < 0, -out, out)


# ---------------------------------------------------------- plain version --
def _kv_heads(x: torch.Tensor, kv_group: int) -> torch.Tensor:
    return x if kv_group == 1 else x.repeat_interleave(kv_group, dim=0)


def flash_attention_ref(q, k, v, *, spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                        causal=True, window=0, approx_div=False,
                        frac_out=DEFAULT_FRAC_OUT, q_offset=0, kv_len=None,
                        kv_group: int = 1) -> torch.Tensor:
    """Dense plain version on the kernel's (BH, S, dh) contract.

    Exact softmax (not online), the kernel's masking semantics and — under
    ``approx_div`` — the same divider stages. Products accumulate in f32;
    ``p`` is rounded to ``v``'s dtype before the PV product. q is processed
    in chunks of 512 rows, so a step materializes (BH, 512, Skv) scores.
    """
    BH, Sq, dh = q.shape
    Skv = k.shape[1]
    if kv_len is None:
        kv_len = Skv
    kf = _kv_heads(k, kv_group).to(torch.float32)
    vf = _kv_heads(v, kv_group).to(torch.float32)
    scale = dh ** -0.5
    kpos = torch.arange(Skv, device=q.device)[None, :]
    tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                    device=q.device) if approx_div else None
    outs = []
    for lo in range(0, Sq, 512):
        qi = q[:, lo:lo + 512].to(torch.float32)
        s = torch.einsum("bqd,btd->bqt", qi, kf) * scale
        qpos = q_offset + lo + torch.arange(qi.shape[1],
                                            device=q.device)[:, None]
        ok = kpos < kv_len
        if causal:
            ok = ok & (kpos <= qpos)
        if window:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok[None], s, torch.full_like(s, float("-inf")))
        m = s.amax(dim=-1)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1).clamp(min=1e-30)
        acc = torch.einsum("bqt,btd->bqd", p.to(v.dtype).to(torch.float32),
                           vf)
        if approx_div:
            out = softmax_div(acc, l, tab, width=spec.width,
                              index_bits=spec.index_bits, frac_out=frac_out,
                              round_out=spec.round_output)
        else:
            out = acc / l[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------- kernel wrapper --
def entry_suffix(width: int) -> str:
    """The C entries' suffix for a divider width: ``'_w32'`` names the
    64-bit-lane forms (``csrc/*_w32.cu``), ``''`` the uint32 ones."""
    check_width(width)
    return "_w32" if width == 32 else ""


def _check_cuda(name: str, **tensors) -> None:
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} CUDA kernel: {key} lies on {t.device}, "
                             "not on a CUDA device")


def _launch(q, k, v, *, spec, causal, window, approx_div, frac_out,
            q_offset, kv_len, kv_group, block) -> torch.Tensor:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention CUDA kernel: q / k / v require grad, and the "
            "kernel has no backward (nor has the reference's Pallas "
            "kernel); training attention runs the chunked path "
            "(models.layers.chunked_attention, taken by stack_train)")
    _check_cuda("flash_attention", q=q, k=k, v=v)
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"expected q (BH,Sq,dh), k/v (BH/G,Skv,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, Sq, dh = q.shape
    Skv = k.shape[1]
    if k.shape[0] * kv_group != BH or k.shape[2] != dh:
        raise ValueError(f"k/v {tuple(k.shape)} with kv_group {kv_group} do "
                         f"not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes matching float32 or "
                        f"bfloat16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is compiled for d_head in "
                         f"{_HEAD_DIMS}, got {dh}")
    _, depth = check_block(block, q.dtype, dh)
    sfx = entry_suffix(spec.width)
    if not 0 <= frac_out <= 31:
        raise ValueError(f"frac_out must be in [0, 31], got {frac_out}")
    if kv_len is None:
        kv_len = Skv
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_aligned(q, k, v)
    tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                    device=q.device, dtype=torch.int32)
    out = torch.empty_like(q)
    lib = build.load(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            tab.data_ptr(), tab.numel(), BH, Sq, Skv, dh, _DTYPES[q.dtype],
            int(kv_group), int(kv_len), int(q_offset), int(bool(causal)),
            int(window), int(bool(approx_div)), dh ** -0.5, spec.width,
            spec.index_bits, int(frac_out), int(spec.round_output),
            lane_max_float(spec.width))
    with torch.cuda.device(q.device):
        if depth:
            entry = "simdive_flash_attention_pipelined" + sfx
            code = getattr(lib, entry)(*args, depth, build.current_stream())
        else:
            entry = "simdive_flash_attention" + sfx
            code = getattr(lib, entry)(*args, build.current_stream())
    build.check(code, entry)
    return out


def flash_attention_cuda(q, k, v, *, spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                         causal=True, window=0, approx_div=False,
                         frac_out=DEFAULT_FRAC_OUT, q_offset=0, kv_len=None,
                         kv_group: int = 1,
                         block=DEFAULT_BLOCK) -> torch.Tensor:
    """Launch the CUDA kernel. Same arguments as :func:`flash_attention_ref`
    plus ``block``, ``(64, 64)`` or ``(64, 64, depth)``: depth 0 runs (and
    counts) here, ``>= 1`` goes to :func:`flash_attention_pipelined_cuda`.

    bf16 runs QK^T and PV on the tensor cores (``mma.sync``, f32
    accumulation), f32 on the CUDA cores (FMA, no TF32). Launches on the
    current stream and does not synchronise; the ragged edges of Sq and Skv
    are masked in the kernel. Raises on CPU tensors, on what the kernel does
    not take (dtype other than f32 / bf16, d_head other than 64 / 80 / 128,
    a block that is not compiled or whose ring does not fit for
    this dtype and d_head, bf16 q / k / v not 16-byte aligned, q / k / v
    that require grad with grad mode on: the kernel has no backward) and on
    a failed build or launch — it never gives way to another schedule or to
    the plain version.
    """
    if split_block(block)[1]:
        return flash_attention_pipelined_cuda(
            q, k, v, spec=spec, causal=causal, window=window,
            approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
            kv_len=kv_len, kv_group=kv_group, block=block)
    out = _launch(q, k, v, spec=spec, causal=causal, window=window,
                  approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
                  kv_len=kv_len, kv_group=kv_group, block=block)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.w32.launches += spec.width == 32
    return out


def flash_attention_pipelined_cuda(q, k, v, *, block,
                                   spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                                   causal=True, window=0, approx_div=False,
                                   frac_out=DEFAULT_FRAC_OUT, q_offset=0,
                                   kv_len=None,
                                   kv_group: int = 1) -> torch.Tensor:
    """The ``cp.async`` kv-ring schedule (``block`` depth >= 1);
    bit-identical to the depth-0 schedule at every depth. Its copies are 16
    bytes for bf16 (q, k and v 16-byte aligned once contiguous, as depth 0
    needs too) and 4 bytes for f32."""
    if not split_block(block)[1]:
        raise ValueError(f"block {tuple(block)} has depth 0: that is "
                         "flash_attention_cuda's schedule")
    out = _launch(q, k, v, spec=spec, causal=causal, window=window,
                  approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
                  kv_len=kv_len, kv_group=kv_group, block=block)
    flash_attention_pipelined_cuda.launches += 1
    flash_attention_pipelined_cuda.w32.launches += spec.width == 32
    return out


#: kernel launches made through each schedule's wrapper (read by
#: chip_smoke.py); ``w32.launches`` counts those of them that ran the
#: width-32 form, apart
flash_attention_cuda.launches = 0
flash_attention_pipelined_cuda.launches = 0
flash_attention_cuda.w32 = SimpleNamespace(launches=0)
flash_attention_pipelined_cuda.w32 = SimpleNamespace(launches=0)


def softmax_div_cuda(acc: torch.Tensor, l: torch.Tensor, *,
                     spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                     frac_out: int = DEFAULT_FRAC_OUT):
    """The attention kernel's finalize alone, on given ``(acc, l)``.

    Runs the same device function the flash kernel ends in. Returns
    ``(out float32 (..., dh), quot (..., dh))``, ``quot`` the raw lanes
    (``uint32``; ``uint64`` at width 32) — the hook that lets the in-kernel
    divider be held bit-equal to :func:`softmax_div`.
    """
    _check_cuda("softmax_div", acc=acc, l=l)
    if acc.dtype != torch.float32 or l.dtype != torch.float32 \
            or acc.shape[:-1] != l.shape:
        raise ValueError("softmax_div kernel takes float32 acc (..., dh) and "
                         f"l (...,); got {acc.dtype} {tuple(acc.shape)}, "
                         f"{l.dtype} {tuple(l.shape)}")
    sfx = entry_suffix(spec.width)
    acc, l = acc.contiguous(), l.contiguous()
    dh = acc.shape[-1]
    tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                    device=acc.device, dtype=torch.int32)
    out = torch.empty_like(acc)
    quot = torch.empty(acc.shape, device=acc.device,
                       dtype=torch.uint64 if sfx else torch.uint32)
    lib = build.load(acc.device)
    with torch.cuda.device(acc.device):
        code = getattr(lib, "simdive_softmax_div" + sfx)(
            acc.data_ptr(), l.data_ptr(), out.data_ptr(), quot.data_ptr(),
            l.numel(), dh, tab.data_ptr(), tab.numel(), spec.width,
            spec.index_bits, int(frac_out), int(spec.round_output),
            lane_max_float(spec.width), build.current_stream())
    build.check(code, "simdive_softmax_div" + sfx)
    return out, quot
