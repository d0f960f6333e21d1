"""Approximate log-domain matmul: kernel wrappers and plain version.

    C[m,n] = sum_k  sign(x[m,k]) * sign(w[k,n]) * SIMDive(|x[m,k]|, |w[k,n]|)

Counterpart of ``repro.kernels.logmatmul`` (``logmatmul_pallas``, its
depth-0 ``_kernel`` and pipelined ``_kernel_pipelined`` schedules over the
tile math of ``_tile_partial``) and of ``repro.kernels.ref.logmatmul_ref``.
The CUDA kernel is ``csrc/logmatmul.cu`` (its templates in
``csrc/logmatmul.cuh``, the wide form instantiated in
``csrc/logmatmul_wide.cu``); its plain PyTorch versions are
:func:`logmatmul_ref` and :func:`logmatmul_wide_ref`.

Contract (the reference's): signed int32 ``(M, K) @ (K, N)``, operands
clamped to the lane by ``sign_split`` (``|INT32_MIN|`` included), a product
with a zero magnitude adds 0, every signed product is the int32 that
``sign_join`` makes of it, and the sum wraps around in int32. Width 8 is
exact while ``K * 255^2 < 2^31``; width 16 wraps like the reference.

**The wide form** (``wide=True``; plain version :func:`logmatmul_wide_ref`)
keeps everything but the sum's width: each unsigned SIMDive product is
widened to int64 before its sign is applied, and the sum is the exact int64
that the reference's ``_matmul_emul_ref`` computes. The emulated matmul
(``ops._matmul_emul_cuda``) takes it wherever the int32 sum could wrap
(:func:`needs_wide`): every width-16 call and, at width 8, K of 32,769 and
more. ``matmul_int`` keeps the int32 contract.

**Blocks.** A launch shape is ``(bm, bn, bk)``, ``(bm, bn, bk, k_unroll)``
or ``(bm, bn, bk, k_unroll, depth)`` as in the reference: ``bm x bn`` is
the output tile of one CUDA block, ``bk`` the K slab staged in shared
memory per step, ``k_unroll`` the unroll factor of the in-slab K loop and
``depth`` the schedule — 0 loads each slab synchronously, ``D >= 1``
streams slabs through a ``D``-slot ``cp.async`` ring. The TPU's
``(128, 128, 128)`` tiles are not carried over: at depth 2 their ring alone
would need 256 KB, more than an SM's 227 KB of shared memory. The port's
own tiles (:data:`TILES`) are compiled into the kernel; every block the
registry offers is checked against them and against the shared-memory
limit when it is registered (:func:`check_block`).

A **skinny** block (``bn`` = :data:`SKINNY_BN`, ``bm`` = 4 or 8 rows) has
all ``bm`` rows in registers, 128 columns across a warp's lanes and 8 warps
splitting K; it is the default and the only kind the autotune times. Its
``bk`` is the most K rows one CUDA block covers — the kernel splits K
across blocks in ranges of at most ``bk`` (fewer when that fills the card)
and stages x for that range in shared memory; the weights do not pass
through shared memory at depth 0, and at depth ``D >= 1`` each warp
streams ``k_unroll`` weight rows a step through a ``D``-slot ring.

Each schedule's wrapper counts its own launches (``logmatmul_cuda`` for
depth 0, ``logmatmul_pipelined_cuda`` for the ring), so a run's launch
counts show which schedule served it.
"""
from __future__ import annotations

import torch

from repro_torch.core.mitchell import check_width
from repro_torch.core.simdive import SimdiveSpec
from repro_torch.faults.inject import active_faults
from . import build
from . import datapath as dp

__all__ = ["TILES", "SKINNY_BN", "DEFAULT_K_UNROLL", "DEFAULT_BLOCK",
           "BLOCK_CANDIDATES", "split_block", "is_skinny", "smem_bytes",
           "check_block", "check_faults", "check_matmul_width",
           "needs_wide", "logmatmul_ref",
           "logmatmul_wide_ref", "logmatmul_cuda",
           "logmatmul_pipelined_cuda"]

#: columns of a skinny tile: 32 lanes x 4 adjacent columns
SKINNY_BN = 128
_SKINNY_WARPS = 8
#: (bm, bn, k_unroll) tiles compiled into csrc/logmatmul.cu: skinny tiles
#: (LOGMATMUL_SKINNY_TILES: bm = 4 or 8 rows x 128 columns, 8 warps, bm x 4
#: accumulators a thread), which serve the decode step's M = 4 and the
#: prefill's M = 2048 alike, and the earlier square tiles (LOGMATMUL_TILES,
#: 256 threads, a 4 x 4 or 1 x 4 register tile each: 64 x 64 and 16 x 64),
#: still compiled and callable with ``block=`` but no longer offered to the
#: autotune: on an H100 a skinny block beat them at every (M, K, N) of the
#: serving path
TILES = frozenset({(64, 64, 4), (16, 64, 4),
                   (4, SKINNY_BN, 4), (8, SKINNY_BN, 4)})
DEFAULT_K_UNROLL = 4
#: (bm, bn, bk, k_unroll, depth)
DEFAULT_BLOCK = (8, SKINNY_BN, 256, 4, 0)
BLOCK_CANDIDATES = (
    (8, SKINNY_BN, 256, 4, 0),
    (4, SKINNY_BN, 256, 4, 0),
    (4, SKINNY_BN, 256, 4, 2),
)
#: shared memory a block may use on Hopper, less the static coefficient
#: table (kMaxTable ints) the kernel keeps beside the dynamic slab ring
_SMEM_LIMIT = 232448 - 512 * 4
_MAX_DEPTH = 4                 # cp.async.wait_group takes an immediate
_MAX_INDEX_BITS = 4            # the kernel packs both region halves in 8 bits
#: bits of a log value a square tile's encoded operand word holds
_SQUARE_LOG_BITS = 20
#: elements of one (rows, K chunk, N) product slab in the plain version
_REF_BUDGET = 1 << 24


def split_block(block) -> tuple[tuple[int, int, int], int, int]:
    """``((bm, bn, bk), k_unroll, depth)`` of a 3-, 4- or 5-tuple block;
    the shorter forms mean the default unroll and the depth-0 schedule."""
    if len(block) == 5:
        return tuple(int(b) for b in block[:3]), int(block[3]), int(block[4])
    if len(block) == 4:
        return tuple(int(b) for b in block[:3]), int(block[3]), 0
    if len(block) == 3:
        return tuple(int(b) for b in block), DEFAULT_K_UNROLL, 0
    raise ValueError(f"a matmul block has 3, 4 or 5 components, got {block}")


def is_skinny(block) -> bool:
    """Whether ``block`` names a skinny-M tile (``bn`` = :data:`SKINNY_BN`)."""
    return split_block(block)[0][1] == SKINNY_BN


def smem_bytes(block, wide: bool = False) -> int:
    """Dynamic shared memory of one CUDA block, at most.

    Square tiles: ``max(depth, 1)`` slab slots of an x slab (bm rows of
    bk + 1 words: the pad keeps the column reads conflict-free) and a w
    slab (bk x bn words). Skinny tiles: three words per x element of the
    block's K range (bm x bk), the 8 warps' partial sums (8 x bm x 128
    words, two words each in the ``wide`` form) and, at depth ``D >= 1``,
    the weight ring (8 warps x D slots x k_unroll rows x 128 words); no w
    slab at depth 0.
    """
    (bm, bn, bk), ku, depth = split_block(block)
    if bn == SKINNY_BN:
        return (3 * bm * bk + _SKINNY_WARPS * bm * bn * (2 if wide else 1)
                + _SKINNY_WARPS * depth * ku * bn) * 4
    return max(depth, 1) * (bm * (bk + 1) + bk * bn) * 4


def needs_wide(K: int, width: int) -> bool:
    """Whether a sum of ``K`` signed products at ``width`` can leave int32:
    each product is at most the bus maximum ``2^(2 width) - 1`` (a
    saturated one), so the int32 sum is exact only below
    ``K * (2^(2 width) - 1) < 2^31`` — K <= 32,768 at width 8, never at
    width 16."""
    return K * ((1 << (2 * width)) - 1) >= 1 << 31


def check_block(block, wide: bool = False
                ) -> tuple[tuple[int, int, int], int, int]:
    """Raise ``ValueError`` unless the kernel can run ``block`` (in the
    ``wide`` form, when asked)."""
    (bm, bn, bk), ku, depth = split_block(block)
    if (bm, bn, ku) not in TILES:
        raise ValueError(f"matmul block {tuple(block)}: (bm, bn, k_unroll) = "
                         f"{(bm, bn, ku)} is not a compiled tile "
                         f"{sorted(TILES)}")
    if bk <= 0 or bk % ku:
        raise ValueError(f"matmul block {tuple(block)}: bk must be a positive "
                         f"multiple of k_unroll {ku}")
    if not 0 <= depth <= _MAX_DEPTH:
        raise ValueError(f"matmul block {tuple(block)}: depth must be in "
                         f"[0, {_MAX_DEPTH}]")
    if smem_bytes(block, wide) > _SMEM_LIMIT:
        raise ValueError(f"matmul block {tuple(block)} needs "
                         f"{smem_bytes(block, wide)} bytes of shared memory, "
                         f"more than the {_SMEM_LIMIT} an H100 block can "
                         "have")
    return (bm, bn, bk), ku, depth


# ---------------------------------------------------------- plain version --
def _partial(xk: torch.Tensor, wk: torch.Tensor, tab: torch.Tensor,
             spec: SimdiveSpec, wide: bool = False) -> torch.Tensor:
    """int64 sum over one K chunk — the tile math of the reference's
    ``_tile_partial``: sign split and LOD/log once per operand chunk, then
    the fused correct + anti-log stage over the (m, kc, n) products, each
    signed as ``sign_join`` does (int32) or, ``wide``, as the int64 of the
    unsigned product times its sign."""
    width = spec.width
    xm, sx = dp.sign_split(xk, width)
    wm, sw = dp.sign_split(wk, width)
    lx = dp.lod_log(xm, width)[:, :, None]
    lw = dp.lod_log(wm, width)[None]
    zero = (xm == 0)[:, :, None] | (wm == 0)[None]
    p = dp.log_mul(lx, lw, tab, width, spec.index_bits,
                   round_out=spec.round_output, zero=zero)
    s = sx[:, :, None] * sw[None]
    return (p * s if wide else dp.sign_join(p, s)).sum(dim=1)


def _ref_sum(x: torch.Tensor, w: torch.Tensor, spec: SimdiveSpec,
             wide: bool) -> torch.Tensor:
    """The int64 sum of both plain versions, chunked over rows and K so
    that one (rows, chunk, N) product slab stays under ``_REF_BUDGET``
    elements."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    check_matmul_width(spec.width, "matmul_emul" if wide else "matmul_int")
    M, K = x.shape
    N = w.shape[1]
    tab = dp.op_table("mul", spec.width, spec.coeff_bits, spec.index_bits,
                      device=x.device)
    acc = torch.zeros((M, N), dtype=torch.int64, device=x.device)
    mb = max(1, min(M, _REF_BUDGET // max(N, 1)))
    kc = max(1, min(K, _REF_BUDGET // max(mb * N, 1)))
    for m0 in range(0, M, mb):
        for k0 in range(0, K, kc):
            acc[m0:m0 + mb] += _partial(x[m0:m0 + mb, k0:k0 + kc],
                                        w[k0:k0 + kc], tab, spec, wide)
    return acc


def logmatmul_ref(x: torch.Tensor, w: torch.Tensor,
                  spec: SimdiveSpec) -> torch.Tensor:
    """Plain PyTorch version: signed (M, K) @ (K, N) -> int32 (M, N).

    The chunk sums are added in int64 and wrapped to int32 once at the end,
    which is the reference's int32 wrap-around sum (addition mod 2^32 does
    not depend on the order).
    """
    return dp.wrap_int32(_ref_sum(x, w, spec, False)).to(torch.int32)


def logmatmul_wide_ref(x: torch.Tensor, w: torch.Tensor,
                       spec: SimdiveSpec) -> torch.Tensor:
    """Plain version of the wide form: signed (M, K) @ (K, N) -> the exact
    int64 (M, N) sum of the unsigned products times their signs — on
    magnitudes and signs from ``quantize_sign_magnitude``, the reference's
    ``_matmul_emul_ref`` at every width the port takes."""
    return _ref_sum(x, w, spec, True)


#: why the reference leaves width 32 out of each matmul
#: (repro.kernels.ops._matmul_int_analysis / _matmul_emul_analysis)
_WIDTH32_REASONS = {
    "matmul_int": "width-32 matmul is not shipped; the 64-bit product bus "
                  "exceeds every accumulator the kernel offers",
    "matmul_emul": "width-32 emulated matmul is not shipped (64-bit product "
                   "bus exceeds the int64 accumulator)",
}


def check_matmul_width(width: int, kernel: str = "matmul_int") -> None:
    """Raise ``ValueError`` on a width the datapath does not define and
    ``NotImplementedError`` at width 32, with the reference's reason."""
    check_width(width)
    if width == 32:
        raise NotImplementedError(f"{kernel} width 32: "
                                  f"{_WIDTH32_REASONS[kernel]}")


# ---------------------------------------------------------------- kernels --
def check_faults(block, width: int) -> None:
    """Raise ``ValueError`` when an armed log fault could set a bit of the
    log value that ``block``'s kernel cannot hold. A square tile packs a
    log value in the low 20 bits of its operand word (bits 20..31 hold
    the region index, the zero flag and the sign); a skinny tile keeps a
    whole 32-bit word and takes every fault."""
    if is_skinny(block):
        return
    for s in active_faults():
        if (s.site == "log" and s.kind != "stuck0"
                and s.bit >= _SQUARE_LOG_BITS
                and s.width in (None, width)):
            raise ValueError(
                f"matmul block {tuple(block)}: the armed {s} sets bit "
                f"{s.bit} of the log value, which a square tile's operand "
                f"word does not hold (bits 0..{_SQUARE_LOG_BITS - 1}); "
                "use a skinny block")


def _operand(t: torch.Tensor, name: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"logmatmul CUDA kernel: {name} lies on {t.device}, "
                         "not on a CUDA device")
    if t.dtype != torch.int32 or t.ndim != 2:
        raise TypeError(f"logmatmul CUDA kernel takes 2-D int32 operands; "
                        f"{name} is {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _launch(x, w, spec: SimdiveSpec, block, wide: bool) -> torch.Tensor:
    (bm, bn, bk), ku, depth = check_block(block, wide)
    check_matmul_width(spec.width, "matmul_emul" if wide else "matmul_int")
    check_faults(block, spec.width)
    if not 1 <= spec.index_bits <= _MAX_INDEX_BITS:
        raise ValueError(f"logmatmul kernel takes index_bits 1..4, got "
                         f"{spec.index_bits}")
    x, w = _operand(x, "x"), _operand(w, "w")
    if x.shape[1] != w.shape[0] or x.device != w.device:
        raise ValueError(f"logmatmul: x {tuple(x.shape)} on {x.device} and "
                         f"w {tuple(w.shape)} on {w.device} do not multiply")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.int64 if wide else torch.int32,
                      device=x.device)
    tab = dp.op_table("mul", spec.width, spec.coeff_bits, spec.index_bits,
                      device=x.device, dtype=torch.int32)
    lib = build.load(x.device)
    with torch.cuda.device(x.device):
        code = lib.simdive_logmatmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
            tab.data_ptr(), tab.numel(), spec.width, spec.index_bits,
            int(spec.round_output), bm, bn, bk, ku, depth, int(wide),
            build.current_stream())
    build.check(code, "simdive_logmatmul")
    if wide:
        logmatmul_cuda.wide_launches += 1
    return out


def logmatmul_cuda(x: torch.Tensor, w: torch.Tensor, spec: SimdiveSpec,
                   block=DEFAULT_BLOCK, *, wide: bool = False
                   ) -> torch.Tensor:
    """Launch the kernel on int32 ``x (M, K)``, ``w (K, N)`` -> int32, or
    with ``wide`` the exact int64 sum (:func:`logmatmul_wide_ref`).

    ``block``'s depth picks the schedule: 0 runs (and counts) here, ``>= 1``
    goes to :func:`logmatmul_pipelined_cuda`. Launches on the current
    stream and does not synchronise. Raises on CPU tensors, on a block the
    kernel was not compiled for, on width 32 and on a failed build or
    launch — it never gives way to the plain version. A square block
    refuses an armed log fault it cannot hold (:func:`check_faults`).
    """
    if split_block(block)[2]:
        return logmatmul_pipelined_cuda(x, w, spec, block, wide=wide)
    out = _launch(x, w, spec, block, wide)
    logmatmul_cuda.launches += 1
    return out


def logmatmul_pipelined_cuda(x: torch.Tensor, w: torch.Tensor,
                             spec: SimdiveSpec, block, *,
                             wide: bool = False) -> torch.Tensor:
    """The ``cp.async`` ring schedule (``block`` depth >= 1); bit-identical
    to the depth-0 schedule at every depth and unroll."""
    if not split_block(block)[2]:
        raise ValueError(f"block {tuple(block)} has depth 0: that is "
                         "logmatmul_cuda's schedule")
    out = _launch(x, w, spec, block, wide)
    logmatmul_pipelined_cuda.launches += 1
    return out


#: kernel launches made through each schedule's wrapper
logmatmul_cuda.launches = 0
logmatmul_pipelined_cuda.launches = 0
#: of those, the launches of the wide form (either schedule)
logmatmul_cuda.wide_launches = 0
