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
// output are twice as wide. The templates live in logmatmul.cuh; this
// source instantiates the int32 form and holds the C entry, and
// logmatmul_wide.cu the wide one, so that two nvcc processes build them
// side by side.
//
// Bound on an H100: integer operations at the prefill (M = 2048: 644 G
// products for smollm-360m's 224 linears; the function needs at least 11
// integer operations per signed product at width 8, 7 of them ones that
// only the 64 INT32 lanes of an SM take and 4 that also issue as IMAD on
// the FMA pipe — listed with the operand conversion in chip_smoke.py,
// LOGMATMUL_OPS_PER_PRODUCT), and operations ahead of the weight bytes at
// the decode step too (M = 4: each int32 weight is read once and converted
// once, 4 products per weight). The products are shifts and adds with a
// data-dependent table gather, not multiplies, so there is no tensor-core
// part: this is a CUDA-core integer kernel.
//
// Two tile families, both for both schedules. The registry's autotune
// picks among the skinny blocks per shape bucket; the square tiles are
// still compiled and callable, but a skinny block beat them at every shape
// of the serving path on an H100, so none is registered.
//
// The square tiles (64 x 64, 16 x 64), against the operations bound:
// * each element is converted ONCE per slab to one packed word (log value,
//   its half of the region index, zero flag, sign: encode()), the "sign
//   split + LOD/log once per tile" of _tile_partial, so the inner loop does
//   only the fused correct + anti-log of simdive_datapath.cuh per product;
//   OR-ing an x word with a w word yields the region index and the zero
//   flag in one instruction;
// * one CUDA block per bm x bn output tile, 256 threads, each holding a
//   TM x TN register tile of uint32 accumulators; slabs of bk along K in
//   shared memory (x slab padded to bk + 1 words a row: conflict-free column
//   reads), the coefficient table in shared memory;
// * depth 0: load slab (global -> encode -> shared), __syncthreads, compute.
//   depth D >= 1: a D-slot ring filled by 4-byte cp.async with zero fill;
//   warm-up issues slabs 0..D-2, step c issues slab c+D-1 into the slot
//   slab c-1 vacated, waits for slab c, encodes it in place, computes — the
//   reference's semaphore order;
// * when the output tiles alone cannot fill the card (the decode step's
//   M = 4, or the prefill's narrow wk / wv), K is split across blocks
//   (grid z) and the partial sums meet by atomicAdd on uint32 — exact and
//   order-free, as above;
// * the ragged edges of M, N and K are masked in the kernel by loading 0:
//   a zero magnitude adds 0, so there is no pad-to-block copy.
// k_unroll is the unroll factor of the in-slab K loop (template KU); only 4
// is compiled (an unroll of 8 never won the autotune on an H100), and the
// reference's 4- and 5-tuple block encodings are kept.
//
// The skinny-M tiles (MR = 4 or 8 rows x 128 columns, 8 warps), made for
// the decode step, where a square tile computes mostly dead rows and
// stages every weight through shared memory for 4 products; the 8-row tile
// also serves the prefill faster than the 64 x 64 tile:
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
//   atomicAdd after a memset, as the square tiles do.
#include <cstdint>

#include "cp_async.cuh"
#include "logmatmul.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_logmatmul)

// The wide form, compiled in logmatmul_wide.cu.
extern "C" int simdive_logmatmul_wide(const void* x, const void* w,
                                      void* out, int M, int K, int N,
                                      const void* tab, int tab_len,
                                      int width, int index_bits,
                                      int round_out, int bm, int bn, int bk,
                                      int k_unroll, int depth, void* stream);

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
  if (wide)
    return simdive_logmatmul_wide(x, w, out, M, K, N, tab, tab_len, width,
                                  index_bits, round_out, bm, bn, bk, k_unroll,
                                  depth, stream);
  return logmatmul_entry<uint32_t>(x, w, out, M, K, N, tab, tab_len, width,
                                   index_bits, round_out, bm, bn, bk,
                                   k_unroll, depth, stream);
}
