// SIMDive log-domain matmul for Hopper: depth-0 and cp.async-ring schedules.
//
//   C[m,n] = sum_k sign(x[m,k]) * sign(w[k,n]) * SIMDive(|x[m,k]|, |w[k,n]|)
//
// Replaces the TPU kernels of repro/kernels/logmatmul.py: the tile math of
// _tile_partial with the depth-0 schedule (_kernel, pallas_call in
// logmatmul_pallas, grid over K with the output tile accumulating) and the
// pipelined schedule (_kernel_pipelined, operands streamed through a
// depth-slot DMA ring). Both are instantiations of one kernel template here
// (PIPE), selected by the block's 5th component. Signed int32 in, int32 out
// with wrap-around: the sum is carried in uint32, whose addition is the
// reference's int32 wrap-around bit for bit (signed overflow would be
// undefined in C++), in any order — which is why both schedules, every
// k_unroll and the split of K across blocks below give identical bits.
//
// The wide form (template Acc = unsigned long long, the C entry's `wide`):
// the same products, each unsigned SIMDive product (up to 2^32 - 1 at width
// 16) widened to 64 bits before its sign is applied, summed mod 2^64 and
// written as int64 — the exact int64 sum of the reference's _matmul_emul_ref,
// which the int32 form cannot give once K * (2^(2w) - 1) >= 2^31 (every
// width-16 call). Every tile, both schedules and the split of K take it;
// only the accumulators, the warps' partial sums in shared memory and the
// output are twice as wide (the large tile's width-8 sums stay 32-bit:
// see logmatmul.cuh). The templates live in logmatmul.cuh; this source
// instantiates the skinny tiles' int32 form and holds the C entry, which
// hands the wide form to logmatmul_wide.cu and the large tiles to
// logmatmul_large.cu / logmatmul_large_wide.cu, so that four nvcc
// processes build them side by side.
//
// Bound on an H100 (chip_smoke.py, LOGMATMUL_PIPES): the products. A signed
// width-8 product needs at least one table read (a shared-memory load:
// 32 lanes an SM a clock), two integer adds (table offset, ternary sum:
// the INT32 lanes, 64) and one rounding accumulate (the FP32 lanes, 128),
// four issue slots of the SM's 128 lanes a clock: 1/32 of an SM clock a
// product, whichever of the three binds. The products are shifts, adds
// and a data-dependent table gather, not multiplies, so there is no
// tensor-core part: this is a CUDA-core kernel.
//
// Two tile families, both for both schedules; the registry's autotune
// picks among their registered blocks per shape bucket.
//
// The large-M tile (64 rows x 128 columns, 8 warps; the prefill's
// and the training step's M = 2048, the studies' 1,000 rows, the mesh's
// shards). What held the skinny tile back there, and what this one does:
// * every weight was converted again by each 8-row group and served 8
//   products; here each K slab of both operands is converted ONCE per
//   block into shared memory (the "sign split + LOD/log once per tile" of
//   _tile_partial) and a thread's (BM/8) x 4 register tile reads each
//   staged word for 4 or BM/8 products: x as warp-uniform broadcasts, w
//   one 16-byte load a lane, the table reads of a warp in one row of the
//   table (consecutive words: no bank conflicts);
// * the width-8 product ran ~12 integer instructions, most on the 64
//   INT32 lanes; here (rounding, clean table, nothing armed: the served
//   and trained paths) the operand words are float-ready, one IADD3 of
//   x, w and the staged table entry gives the product's float bits, and
//   one round-to-nearest FADD into a partial sum held in [2^23, 2^24)
//   both rounds it half up and accumulates it (logmatmul.cuh: the FLOAT
//   form; the clamp to the bus maximum is two FMNMX): 6 instructions, two
//   of them on the INT32 lanes;
// * K was split at every large-M call (memset + one atomic an output a
//   range); here a block owns its tile over the whole of K and writes it
//   once, splitting K only where the tiles leave the card's resident
//   blocks unfilled (the narrow wk / wv);
// * depth 0 loads each raw slab synchronously; depth D >= 1 keeps a
//   D-slot ring of 16-byte cp.async copies (4-byte where K or N is not a
//   multiple of 4), converted after they land — the reference's semaphore
//   order; both give the same bits, as every form, split and unroll does;
// * ragged M, N and K are masked by loading 0 (a zero magnitude adds 0).
// Width 16, width 8 without rounding, an armed lane fault (whole 32-bit
// log words) and a table entry outside the clean tables' range take the
// datapath's own anti-log on staged (log value, index half, sign) words
// (the GENERAL form).
//
// The skinny-M tiles (MR = 4 or 8 rows x 128 columns, 8 warps), made for
// the decode step, where a large tile computes mostly dead rows and
// stages every weight through shared memory for 4 products:
// * all MR rows of a row group are in registers, uint32 acc[MR][4]: each
//   lane owns 4 adjacent columns; rows past M are neither computed nor
//   stored (grid y walks row groups, so every M is served);
// * x is converted once per block into shared memory as three int words an
//   element (log value, index half as a table byte offset, sign as -1 / 0 /
//   +1), [k][field][MR], read as warp-uniform 16-byte broadcasts; with the
//   x half warp-uniform, a warp's table gathers fall in one run of
//   2^index_bits consecutive words: distinct banks or one broadcast, no
//   conflicts (by construction; the H100 machine has no profiler that
//   counts them, so the card has not confirmed it);
// * each weight is read once, 16 bytes a lane (scalar loads when N % 4 or
//   w's alignment forbid it), converted once in registers and used MR
//   times; the signed product is p * (sign_x * sign_w) in uint32;
// * depth 0 loads k_unroll weight rows straight into registers; depth D >=
//   1 streams them through a D-slot ring of cp.async copies per lane (zero
//   fill past N and the warp's K range), each lane reading back only the 16
//   bytes it copied, so the ring needs no barrier; its warm-up flies while
//   x is converted. Both then run the same product code: bit-identical;
// * the 8 warps split the block's K range and meet in shared memory;
//   blocks split K (grid z) until there are two blocks an SM, and meet by
//   atomicAdd after a memset.
#include <cstdint>

#include "cp_async.cuh"
#include "logmatmul.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_logmatmul)

// The skinny tiles' wide form (logmatmul_wide.cu) and the large tiles'
// two forms (logmatmul_large.cu, logmatmul_large_wide.cu).
LOGMATMUL_ENTRY(simdive_logmatmul_wide);
LOGMATMUL_ENTRY(simdive_logmatmul_large);
LOGMATMUL_ENTRY(simdive_logmatmul_large_wide);

// x (M, K), w (K, N): contiguous int32; out (M, N): int32 (wide = 0, the
// wrap-around sum) or int64 (wide = 1, the exact sum); tab: tab_len int32
// mul coefficients. depth 0 = synchronous slabs, 1..4 = cp.async ring.
// Returns cudaGetLastError() of the launch (or the error that stopped it).
extern "C" int simdive_logmatmul(const void* x, const void* w, void* out,
                                 int M, int K, int N, const void* tab,
                                 int tab_len, int width, int index_bits,
                                 int round_out, int bm, int bn, int bk,
                                 int k_unroll, int depth, int wide,
                                 void* stream) {
  if (wide != 0 && wide != 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* entry = is_large_tile(bm, bn)
                    ? (wide ? simdive_logmatmul_large_wide
                            : simdive_logmatmul_large)
                    : (wide ? simdive_logmatmul_wide : nullptr);
  if (entry)
    return entry(x, w, out, M, K, N, tab, tab_len, width, index_bits,
                 round_out, bm, bn, bk, k_unroll, depth, stream);
  return logmatmul_entry<uint32_t, false>(x, w, out, M, K, N, tab, tab_len,
                                          width, index_bits, round_out, bm,
                                          bn, bk, k_unroll, depth, stream);
}
