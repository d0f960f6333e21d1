"""Approximate log-domain matmul: kernel wrappers and plain version.

    C[m,n] = sum_k  sign(x[m,k]) * sign(w[k,n]) * SIMDive(|x[m,k]|, |w[k,n]|)

Counterpart of ``repro.kernels.logmatmul`` (``logmatmul_pallas``, its
depth-0 ``_kernel`` and pipelined ``_kernel_pipelined`` schedules over the
tile math of ``_tile_partial``) and of ``repro.kernels.ref.logmatmul_ref``.
The CUDA kernel is ``csrc/logmatmul.cu`` (its templates in
``csrc/logmatmul.cuh``; the skinny tiles' wide form instantiated in
``csrc/logmatmul_wide.cu``, the large tiles in ``csrc/logmatmul_large.cu``
and ``csrc/logmatmul_large_wide.cu``); its plain PyTorch versions are
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

Two tile families, both 128 columns wide (``bn`` = :data:`SKINNY_BN`):

* A **skinny** block (``bm`` = 4 or 8 rows: the decode step) has all
  ``bm`` rows in registers, 128 columns across a warp's lanes and 8 warps
  splitting K; it is the default block below 64 rows. Its ``bk`` is the most K rows one
  CUDA block covers — the kernel splits K across blocks in ranges of at
  most ``bk`` (fewer when that fills the card) and stages x for that range
  in shared memory; the weights do not pass through shared memory at
  depth 0, and at depth ``D >= 1`` each warp streams ``k_unroll`` weight
  rows a step through a ``D``-slot ring.
* A **large** block (``bm`` = 64 rows: the prefill, the training
  products, the studies) owns a ``bm x 128`` output tile over its whole K
  range; ``bk`` (a multiple of 16, at most 64) is the K slab both operands
  are converted in, once per block, into shared memory; at depth ``D >=
  1`` the raw slabs come through a ``D``-slot ``cp.async`` ring. At width
  8 with rounding (and nothing armed, a clean table) its product is float
  arithmetic (``csrc/logmatmul.cuh``, the FLOAT form; :func:`large_tile_sum`
  is its plain model); elsewhere it takes the datapath's own anti-log.

The autotune times the registered blocks :func:`blocks_for` gives the
call's M and keeps the fastest per shape bucket: below
:data:`LARGE_MIN_M` rows the skinny ones only, from there on both
families. Untimed (``SIMDIVE_AUTOTUNE=0``) the registry takes
:func:`default_block` of M: the skinny :data:`DEFAULT_BLOCK` below
:data:`LARGE_MIN_M` rows, the large :data:`LARGE_DEFAULT_BLOCK` from
there on.

Each schedule's wrapper counts its own launches (``logmatmul_cuda`` for
depth 0, ``logmatmul_pipelined_cuda`` for the ring), so a run's launch
counts show which schedule served it.
"""
from __future__ import annotations

import torch

from repro_torch.core.mitchell import check_width
from repro_torch.core.simdive import SimdiveSpec
from . import build
from . import datapath as dp

__all__ = ["TILES", "SKINNY_BN", "SKINNY_ROWS", "LARGE_ROWS",
           "DEFAULT_K_UNROLL", "DEFAULT_BLOCK", "LARGE_DEFAULT_BLOCK",
           "LARGE_MIN_M", "default_block", "blocks_for", "BLOCK_CANDIDATES",
           "split_block", "is_skinny", "is_large", "smem_bytes",
           "check_block", "check_matmul_width", "needs_wide",
           "logmatmul_ref", "logmatmul_wide_ref", "large_tile_sum",
           "logmatmul_cuda", "logmatmul_pipelined_cuda"]

#: columns of either tile family: 32 lanes x 4 adjacent columns
SKINNY_BN = 128
_SKINNY_WARPS = 8
#: rows of the skinny tiles (LOGMATMUL_SKINNY_TILES) and the large ones
#: (LOGMATMUL_LARGE_TILES)
SKINNY_ROWS = (4, 8)
LARGE_ROWS = (64,)
#: (bm, bn, k_unroll) tiles compiled from csrc/logmatmul.cuh: the skinny
#: tiles (8 warps, bm x 4 accumulators a thread), made for the decode
#: step's M = 4, and the large-M tile (8 warps of bm / 8 rows, a (bm / 8)
#: x 4 register tile a thread), made for M = 2048
TILES = frozenset({(4, SKINNY_BN, 4), (8, SKINNY_BN, 4),
                   (64, SKINNY_BN, 2)})
DEFAULT_K_UNROLL = 4
#: (bm, bn, bk, k_unroll, depth): the untimed block below LARGE_MIN_M rows
#: and from there on (:func:`default_block`)
DEFAULT_BLOCK = (8, SKINNY_BN, 256, 4, 0)
LARGE_DEFAULT_BLOCK = (64, SKINNY_BN, 32, 2, 0)
LARGE_MIN_M = 64
BLOCK_CANDIDATES = (
    (8, SKINNY_BN, 256, 4, 0),
    (4, SKINNY_BN, 256, 4, 0),
    (4, SKINNY_BN, 256, 4, 2),
    LARGE_DEFAULT_BLOCK,
    (64, SKINNY_BN, 32, 2, 2),
)
#: shared memory a block may use on Hopper, less the static coefficient
#: table (kMaxTable ints) the kernel keeps beside the dynamic slab ring
_SMEM_LIMIT = 232448 - 512 * 4
_MAX_DEPTH = 4                 # cp.async.wait_group takes an immediate
_MAX_INDEX_BITS = 4            # the kernel packs both region halves in 8 bits
#: a large block's slab: a multiple of 16 (the staging's bank-free
#: layout), at most 64 (the float partial sums' span)
_LARGE_BK_STEP, _LARGE_MAX_BK = 16, 64
#: padding words of a large block's staged x rows and raw x rows
_LARGE_XPAD, _LARGE_RAWPAD = 4, 8
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


def default_block(M: int) -> tuple:
    """The untimed block for ``M`` rows: a large tile fills its rows from
    :data:`LARGE_MIN_M` on, where the skinny tile converts each weight
    again for every 8 of them."""
    return LARGE_DEFAULT_BLOCK if M >= LARGE_MIN_M else DEFAULT_BLOCK


def blocks_for(M: int) -> tuple:
    """The registered blocks worth timing at ``M`` rows, the untimed one
    (:func:`default_block`) first: below :data:`LARGE_MIN_M` rows only the
    skinny ones (a large tile would compute mostly dead rows), from there
    on both families."""
    first = default_block(M)
    return (first,) + tuple(b for b in BLOCK_CANDIDATES if b != first and (
        M >= LARGE_MIN_M or not is_large(b)))


def is_skinny(block) -> bool:
    """Whether ``block`` names a skinny-M tile (4 or 8 rows x 128)."""
    (bm, bn, _), _, _ = split_block(block)
    return bn == SKINNY_BN and bm in SKINNY_ROWS


def is_large(block) -> bool:
    """Whether ``block`` names a large-M tile (64 rows x 128)."""
    (bm, bn, _), _, _ = split_block(block)
    return bn == SKINNY_BN and bm in LARGE_ROWS


def smem_bytes(block, wide: bool = False) -> int:
    """Dynamic shared memory of one CUDA block, at most.

    Skinny tiles: three words per x element of the block's K range (bm x
    bk), the 8 warps' partial sums (8 x bm x 128 words, two words each in
    the ``wide`` form) and, at depth ``D >= 1``, the weight ring (8 warps x
    D slots x k_unroll rows x 128 words); no w slab at depth 0. Large
    tiles (any other ``bm``): two staged words per element of a slab of
    both operands (x: bk rows of bm + 4 words, w: bk x bn) and, at depth
    ``D >= 1``, D raw slabs (x: bm rows of bk + 8 words, w: bk x bn); the
    sums live in registers, so the ``wide`` form takes no more.
    """
    (bm, bn, bk), ku, depth = split_block(block)
    if bm in SKINNY_ROWS:
        return (3 * bm * bk + _SKINNY_WARPS * bm * bn * (2 if wide else 1)
                + _SKINNY_WARPS * depth * ku * bn) * 4
    return (2 * bk * (bm + _LARGE_XPAD) + 2 * bk * bn
            + depth * (bm * (bk + _LARGE_RAWPAD) + bk * bn)) * 4


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
    if bm in LARGE_ROWS and (bk % _LARGE_BK_STEP or bk > _LARGE_MAX_BK):
        raise ValueError(f"matmul block {tuple(block)}: a large tile's bk "
                         f"must be a multiple of {_LARGE_BK_STEP} up to "
                         f"{_LARGE_MAX_BK}")
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
             wide: bool, tab: torch.Tensor | None = None) -> torch.Tensor:
    """The int64 sum of both plain versions, chunked over rows and K so
    that one (rows, chunk, N) product slab stays under ``_REF_BUDGET``
    elements; ``tab`` in place of the spec's table (a test's)."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    check_matmul_width(spec.width, "matmul_emul" if wide else "matmul_int")
    M, K = x.shape
    N = w.shape[1]
    if tab is None:
        tab = dp.op_table("mul", spec.width, spec.coeff_bits,
                          spec.index_bits, device=x.device)
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


#: the large tile's FLOAT form (csrc/logmatmul.cuh): 1.0f plus the
#: tie-breaking ulp, less the staged table's 64 << 16 bias; the float
#: partial sums' base 1.5 * 2^23 and its bits
_KEY_BIAS = 0x3F800001 - (64 << 16)
_PARTIAL_BASE, _PARTIAL_BASE_BITS = 12582912.0, 0x4B400000


def _as_float32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words on the int64 carrier, read as float32."""
    return dp.wrap_int32(bits).to(torch.int32).view(torch.float32)


def large_tile_sum(x: torch.Tensor, w: torch.Tensor, spec: SimdiveSpec,
                   chunk: int = _LARGE_MAX_BK,
                   tab: torch.Tensor | None = None) -> torch.Tensor:
    """The large tile's width-8 sum as it forms it where nothing is armed
    and the table's entries lie in (-64, 64) — the signed (M, K) @ (K, N)
    int64 sum, for the plain tests to hold against the datapath. ``tab``:
    the table to use in place of the spec's (a test's).

    With rounding, the FLOAT form (``csrc/logmatmul.cuh``): each operand
    is staged as its key word — x: ``sign << 31 | ((la << 16) +
    _KEY_BIAS)``, w: ``sign << 31 | lb << 16``, a zero magnitude 0 — and
    its index half; the table as ``(corr + 64) << 16`` with a zero row (x
    = 0: 0) and a zero column (w = 0: ``-_KEY_BIAS``). A product is the
    float32 whose bits are the uint32 sum of the three words, clamped to
    +-65535 and added in float32 round-to-nearest to a partial sum that
    starts at 1.5 * 2^23; every ``chunk`` k (a slab) the partial sum's
    bits less those of its start go into the int64 sum. Without rounding
    the kernel takes the datapath's own anti-log (the GENERAL form), which
    is :func:`logmatmul_wide_ref`'s arithmetic."""
    if spec.width != 8:
        raise ValueError("the large tile's FLOAT form is width 8")
    ib = spec.index_bits
    if tab is None:
        tab = dp.op_table("mul", 8, spec.coeff_bits, ib, device=x.device)
    if int(tab.min()) <= -64 or int(tab.max()) >= 64:
        raise ValueError("the FLOAT form takes entries in (-64, 64)")
    if not spec.round_output:
        return _ref_sum(x, w, spec, True, tab)
    S = (1 << ib) + 1
    ext = torch.zeros((S, S), dtype=torch.int64, device=x.device)
    ext[:-1, :-1] = (tab.reshape(S - 1, S - 1) + 64) << 16
    ext[:-1, -1] = -_KEY_BIAS

    def stage(v, bias):
        mag, sign = dp.sign_split(v, 8)
        L = dp.lod_log(mag, 8)
        key = ((sign < 0).to(torch.int64) << 31) | ((L << 16) + bias)
        half = (L & 127) >> (7 - ib)
        return (torch.where(mag == 0, 0, key),
                torch.where(mag == 0, S - 1, half))

    xk, xi = stage(x, _KEY_BIAS)
    wk, wi = stage(w, 0)
    M, K = x.shape
    N = w.shape[1]
    acc = torch.zeros((M, N), dtype=torch.int64, device=x.device)
    part = torch.full((M, N), _PARTIAL_BASE, dtype=torch.float32,
                      device=x.device)
    for k in range(K):
        bits = (xk[:, k, None] + wk[None, k, :]
                + ext[xi[:, k, None], wi[None, k, :]]) & 0xFFFFFFFF
        part = part + _as_float32(bits).clamp(-65535.0, 65535.0)
        if (k + 1) % chunk == 0 or k == K - 1:
            acc += part.view(torch.int32).to(torch.int64) \
                - _PARTIAL_BASE_BITS
            part.fill_(_PARTIAL_BASE)
    return acc


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
    launch — it never gives way to the plain version. Every compiled tile
    takes every armed fault (whole 32-bit log words).
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
