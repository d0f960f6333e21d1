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
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"
#include "simdive_datapath.cuh"

namespace {

using simdive::cp_async4;
using simdive::cp_async_commit;
using simdive::cp_async_wait;

// Encoded operand word:
//   bits  0..19  log value L = (k << F) | frac  (< 2^19 at width 16)
//   bits 20..27  this operand's half of the region index: x's fraction MSBs
//                shifted up by index_bits, w's MSBs as they are — the OR of
//                an x word and a w word is the whole index
//   bit  30      zero magnitude
//   bit  31      sign
constexpr uint32_t kLogMask = 0xFFFFFu;
constexpr int kIdxShift = 20;
constexpr uint32_t kZero = 1u << 30;

// sign_split (|INT32_MIN| included, clamped to the lane) + LOD/log.
template <int W, bool IS_X>
__device__ __forceinline__ uint32_t encode(int32_t v, int ib) {
  constexpr int F = W - 1;
  const uint32_t neg = v < 0 ? 1u : 0u;
  uint32_t mag = neg ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  mag = min(mag, (1u << W) - 1u);
  if (mag == 0u) return kZero;
  const uint32_t L = simdive::lod_log(mag, F);
  uint32_t half = (L & ((1u << F) - 1u)) >> (F - ib);
  if (IS_X) half <<= ib;
  return (neg << 31) | (half << kIdxShift) | L;
}

// One signed product, as sign_join(log_mul(...), sign) makes it: the uint32
// product (2^32 - 1 when a width-16 product saturates) negated mod 2^32.
template <int W>
__device__ __forceinline__ uint32_t signed_product(uint32_t ex, uint32_t ew,
                                                   const int* tab,
                                                   bool round_out) {
  const uint32_t o = ex | ew;
  const int corr = tab[(o >> kIdxShift) & 0xFFu];
  uint32_t p = simdive::antilog_mul(ex & kLogMask, ew & kLogMask, corr, W,
                                    round_out);
  p = (o & kZero) ? 0u : p;
  return ((ex ^ ew) >> 31) ? 0u - p : p;
}

template <int W, int BM, int BN, int TM, int TN, int KU>
__device__ __forceinline__ void slab_products(const uint32_t* xs,
                                              const uint32_t* ws, int bk,
                                              int tx, int ty, const int* tab,
                                              bool round_out,
                                              uint32_t (&acc)[TM][TN]) {
  constexpr int TX = BN / TN, TY = BM / TM;
  const int xs_ld = bk + 1;
  for (int k0 = 0; k0 < bk; k0 += KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int k = k0 + u;
      uint32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + i * TY) * xs_ld + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k * BN + tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += signed_product<W>(a[i], b[j], tab, round_out);
    }
  }
}

// Issue one slab's raw int32 words into a ring slot (zero outside M, N, K).
template <int BM, int BN, int NT>
__device__ __forceinline__ void issue_slab(uint32_t* slot,
                                           const int32_t* __restrict__ x,
                                           const int32_t* __restrict__ w,
                                           int M, int K, int N, int m0, int n0,
                                           int k0, int bk, int tid) {
  const int xs_ld = bk + 1;
  uint32_t* xs = slot;
  uint32_t* ws = slot + BM * xs_ld;
  for (int i = tid; i < BM * bk; i += NT) {
    const int r = i / bk, c = i - r * bk;
    const int gm = m0 + r, gk = k0 + c;
    const bool ok = gm < M && gk < K;
    cp_async4(xs + r * xs_ld + c,
              ok ? x + static_cast<size_t>(gm) * K + gk : x, ok ? 4 : 0);
  }
  for (int i = tid; i < bk * BN; i += NT) {
    const int r = i / BN, c = i - r * BN;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < K && gn < N;
    cp_async4(ws + r * BN + c,
              ok ? w + static_cast<size_t>(gk) * N + gn : w, ok ? 4 : 0);
  }
}

// Encode an arrived slab in place.
template <int W, int BM, int BN, int NT>
__device__ __forceinline__ void encode_slab(uint32_t* slot, int bk, int ib,
                                            int tid) {
  const int xs_ld = bk + 1;
  uint32_t* xs = slot;
  uint32_t* ws = slot + BM * xs_ld;
  for (int i = tid; i < BM * bk; i += NT) {
    const int r = i / bk, c = i - r * bk;
    uint32_t* p = xs + r * xs_ld + c;
    *p = encode<W, true>(static_cast<int32_t>(*p), ib);
  }
  for (int i = tid; i < bk * BN; i += NT)
    ws[i] = encode<W, false>(static_cast<int32_t>(ws[i]), ib);
}

template <int W, int BM, int BN, int TM, int TN, int KU, bool PIPE>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    logmatmul_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ w, uint32_t* __restrict__ out,
                     int M, int K, int N, const int* __restrict__ tab,
                     int tab_len, int ib, int round_out, int bk, int depth,
                     int slabs_per_split, int accumulate) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  extern __shared__ uint32_t ring[];
  __shared__ int s_tab[simdive::kMaxTable];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + bk - 1) / bk;
  const int kt0 = blockIdx.z * slabs_per_split;
  const int kt1 = min(nk, kt0 + slabs_per_split);
  const int xs_ld = bk + 1;
  const bool rnd = round_out != 0;
  for (int i = tid; i < tab_len; i += NT) s_tab[i] = tab[i];

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  if (!PIPE) {
    uint32_t* xs = ring;
    uint32_t* ws = ring + BM * xs_ld;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * bk;
      for (int i = tid; i < BM * bk; i += NT) {
        const int r = i / bk, c = i - r * bk;
        const int gm = m0 + r, gk = k0 + c;
        const int32_t v =
            (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
        xs[r * xs_ld + c] = encode<W, true>(v, ib);
      }
      for (int i = tid; i < bk * BN; i += NT) {
        const int r = i / BN, c = i - r * BN;
        const int gk = k0 + r, gn = n0 + c;
        const int32_t v =
            (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0;
        ws[r * BN + c] = encode<W, false>(v, ib);
      }
      __syncthreads();  // slab (and, first time, the table) in place
      slab_products<W, BM, BN, TM, TN, KU>(xs, ws, bk, tx, ty, s_tab, rnd,
                                           acc);
      __syncthreads();  // slab consumed before the next one overwrites it
    }
  } else {
    const int slot_words = BM * xs_ld + bk * BN;
    const int n = kt1 - kt0;
    // warm-up: slabs 0..D-2, one commit group each (empty past the end, so
    // that slab c is always group c)
    for (int c = 0; c < depth - 1; ++c) {
      if (c < n)
        issue_slab<BM, BN, NT>(ring + (c % depth) * slot_words, x, w, M, K, N,
                               m0, n0, (kt0 + c) * bk, bk, tid);
      cp_async_commit();
    }
    for (int c = 0; c < n; ++c) {
      const int nxt = c + depth - 1;  // into the slot slab c-1 vacated
      if (nxt < n)
        issue_slab<BM, BN, NT>(ring + (nxt % depth) * slot_words, x, w, M, K,
                               N, m0, n0, (kt0 + nxt) * bk, bk, tid);
      cp_async_commit();
      cp_async_wait(depth - 1);  // every group up to slab c has landed
      __syncthreads();
      uint32_t* slot = ring + (c % depth) * slot_words;
      encode_slab<W, BM, BN, NT>(slot, bk, ib, tid);
      __syncthreads();
      slab_products<W, BM, BN, TM, TN, KU>(slot, slot + BM * xs_ld, bk, tx, ty,
                                           s_tab, rnd, acc);
      __syncthreads();  // slot free for the prefetch of the next step
    }
    cp_async_wait(0);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + j * TX;
      if (r < M && c < N) {
        uint32_t* o = out + static_cast<size_t>(r) * N + c;
        if (accumulate)
          atomicAdd(o, acc[i][j]);
        else
          *o = acc[i][j];
      }
    }
  }
}

// ---- skinny-M tile: the decode step (M = 4 at batch 4) ----------------
//
// A block holds all MR rows of one row group in registers and spreads 128
// columns across the 32 lanes of a warp, 4 adjacent columns a lane (one
// 16-byte weight load); its 8 warps split the block's K range and meet in
// shared memory. x is converted once per block into shared memory and read
// back as warp-uniform broadcasts; each weight goes from global memory
// straight to registers (depth 0) or through a per-lane cp.async ring
// (depth >= 1), is converted once and used for MR products.
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyTN = 4;                  // columns a lane owns
constexpr int kSkinnyBN = 32 * kSkinnyTN;     // columns a block owns

// One operand split into what the products read: log value, this
// operand's half of the region index as a byte offset into the table (x's
// half shifted up by index_bits, as encode() does), and sign / zero as
// -1, 0 or +1.
template <int W, bool IS_X>
__device__ __forceinline__ void split_operand(int32_t v, int ib, int& l,
                                              int& h4, int& c) {
  constexpr int F = W - 1;
  const bool neg = v < 0;
  uint32_t mag = neg ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  mag = min(mag, (1u << W) - 1u);
  const uint32_t L = simdive::lod_log(mag, F);
  uint32_t half = (L & ((1u << F) - 1u)) >> (F - ib);
  if (IS_X) half <<= ib;
  l = static_cast<int>(L);
  h4 = static_cast<int>(half << 2);
  c = mag == 0u ? 0 : (neg ? -1 : 1);
}

// One unsigned product from split operands. Width 8: the anti-log is one
// shift up by the integer part, the rounding add and one shift down by F,
// which is the reference's exact left shift (I >= F: the low F bits are 0)
// and its round-half-up right shift (I < F) alike; the clamp is its
// saturation at I >= 16 (below that the product is < 2^16). The tables
// keep |corr| < 2^(F-1) (core/error_lut.py), so I <= 16 and mant << I <
// 2^24. Width 16 takes the datapath's own anti-log.
template <int W>
__device__ __forceinline__ uint32_t split_product(int la, int hx4, int lb,
                                                  int hw4, const int* tab,
                                                  uint32_t bias, bool rnd) {
  const int corr = *reinterpret_cast<const int*>(
      reinterpret_cast<const char*>(tab) + (hx4 + hw4));
  if constexpr (W == 8) {
    constexpr int F = W - 1;
    const int ls = max(la + lb + corr, 0);
    const uint32_t mant =
        (static_cast<uint32_t>(ls) & ((1u << F) - 1u)) | (1u << F);
    return min(((mant << (ls >> F)) + bias) >> F, (1u << (2 * W)) - 1u);
  } else {
    return simdive::antilog_mul(static_cast<uint32_t>(la),
                                static_cast<uint32_t>(lb), corr, W, rnd);
  }
}

// The MR x 4 products of one weight row slice (4 raw int32 weights) with
// the staged x words of that row; rows past M (live) are skipped.
template <int W, int MR>
__device__ __forceinline__ void skinny_row(const int4 raw, const int* xs_row,
                                           int live, int ib, const int* tab,
                                           uint32_t bias, bool rnd,
                                           uint32_t (&acc)[MR][kSkinnyTN]) {
  int lb[kSkinnyTN], hw4[kSkinnyTN], cw[kSkinnyTN];
  split_operand<W, false>(raw.x, ib, lb[0], hw4[0], cw[0]);
  split_operand<W, false>(raw.y, ib, lb[1], hw4[1], cw[1]);
  split_operand<W, false>(raw.z, ib, lb[2], hw4[2], cw[2]);
  split_operand<W, false>(raw.w, ib, lb[3], hw4[3], cw[3]);
  // [log value x MR | index half x MR | sign x MR], 16-byte aligned
  int xv[3 * MR];
  const int4* x4 = reinterpret_cast<const int4*>(xs_row);
#pragma unroll
  for (int q = 0; q < 3 * MR / 4; ++q) {
    const int4 t = x4[q];
    xv[4 * q] = t.x;
    xv[4 * q + 1] = t.y;
    xv[4 * q + 2] = t.z;
    xv[4 * q + 3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < live) {
#pragma unroll
      for (int j = 0; j < kSkinnyTN; ++j) {
        const uint32_t p = split_product<W>(xv[i], xv[MR + i], lb[j], hw4[j],
                                            tab, bias, rnd);
        acc[i][j] += p * static_cast<uint32_t>(xv[2 * MR + i] * cw[j]);
      }
    }
  }
}

// 4 weights of row k from column col on: one 16-byte load (VEC: N % 4 ==
// 0 and w 16-byte aligned), else 4 masked scalar loads; 0 past N.
template <bool VEC>
__device__ __forceinline__ int4 load_w4(const int32_t* __restrict__ w, int k,
                                        int col, int N) {
  const int32_t* p = w + static_cast<size_t>(k) * N + col;
  if (VEC) {
    return col < N ? __ldg(reinterpret_cast<const int4*>(p))
                   : make_int4(0, 0, 0, 0);
  }
  return make_int4(col < N ? __ldg(p) : 0, col + 1 < N ? __ldg(p + 1) : 0,
                   col + 2 < N ? __ldg(p + 2) : 0,
                   col + 3 < N ? __ldg(p + 3) : 0);
}

// The same 4 weights into this lane's 16 bytes of a ring slot, zero past N
// and past the warp's K range (ok = false).
template <bool VEC>
__device__ __forceinline__ void issue_w4(int4* dst, const int32_t* w, int k,
                                         int col, int N, bool ok) {
  const int32_t* p = w + static_cast<size_t>(k) * N + col;
  if (VEC) {
    const bool in = ok && col < N;
    simdive::cp_async16(dst, in ? p : w, in ? 16 : 0);
  } else {
    int* d = reinterpret_cast<int*>(dst);
#pragma unroll
    for (int j = 0; j < kSkinnyTN; ++j) {
      const bool in = ok && col + j < N;
      cp_async4(d + j, in ? p + j : w, in ? 4 : 0);
    }
  }
}

// Dynamic shared memory: x words [per][3][MR] ints, the warps' partial
// sums [warps][MR][128] uint32, then (ring) [warps][depth][KU][32 lanes]
// int4 — each lane copies and reads back only its own 16 bytes of a slot.
template <int W, int MR, int KU, bool PIPE, bool VEC>
__global__ void __launch_bounds__(kSkinnyWarps * 32, 2)
    logmatmul_skinny_kernel(const int32_t* __restrict__ x,
                            const int32_t* __restrict__ w,
                            uint32_t* __restrict__ out, int M, int K, int N,
                            const int* __restrict__ tab, int tab_len, int ib,
                            int round_out, int depth, int per,
                            int accumulate) {
  static_assert(MR % 4 == 0, "x words are read 4 at a time");
  constexpr int NT = kSkinnyWarps * 32, BN = kSkinnyBN, TN = kSkinnyTN;
  extern __shared__ __align__(16) uint32_t skinny_smem[];
  __shared__ int s_tab[simdive::kMaxTable];
  int* xs = reinterpret_cast<int*>(skinny_smem);
  uint32_t* red = skinny_smem + 3 * MR * per;
  int4* ring = reinterpret_cast<int4*>(red + kSkinnyWarps * MR * BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MR, n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.z * per, kb1 = min(K, kb0 + per);
  const int live = min(MR, M - m0);
  const int wper = (per + kSkinnyWarps - 1) / kSkinnyWarps;
  const int kw0 = min(kb0 + warp * wper, kb1), kw1 = min(kw0 + wper, kb1);
  const int steps = (kw1 - kw0 + KU - 1) / KU;
  const int col = n0 + lane * TN;
  const bool rnd = round_out != 0;
  const uint32_t bias = rnd ? 1u << (W - 2) : 0u;    // 2^(F-1)
  int4* my_ring = ring + warp * depth * KU * 32 + lane;

  // ring warm-up first: its copies fly while x is converted
  if (PIPE) {
    for (int c = 0; c < depth - 1; ++c) {
      if (c < steps)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = kw0 + c * KU + u;
          issue_w4<VEC>(my_ring + ((c % depth) * KU + u) * 32, w, k, col, N,
                        k < kw1);
        }
      cp_async_commit();
    }
  }
  for (int i = tid; i < tab_len; i += NT) s_tab[i] = tab[i];
  for (int e = tid; e < MR * per; e += NT) {
    const int i = e / per, kl = e - i * per;
    const int gm = m0 + i, gk = kb0 + kl;
    int l = 0, h4 = 0, c = 0;
    if (gm < M && gk < kb1)
      split_operand<W, true>(x[static_cast<size_t>(gm) * K + gk], ib, l, h4,
                             c);
    int* p = xs + kl * 3 * MR + i;
    p[0] = l;
    p[MR] = h4;
    p[2 * MR] = c;
  }
  __syncthreads();  // table and x words in place

  uint32_t acc[MR][TN];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int c = 0; c < steps; ++c) {
    int4 raw[KU];
    if (!PIPE) {
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = kw0 + c * KU + u;
        raw[u] = k < kw1 ? load_w4<VEC>(w, k, col, N) : make_int4(0, 0, 0, 0);
      }
    } else {
      __syncwarp();  // this lane's reads of the slot reused below are done
      const int nxt = c + depth - 1;  // into the slot step c-1 vacated
      if (nxt < steps)
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = kw0 + nxt * KU + u;
          issue_w4<VEC>(my_ring + ((nxt % depth) * KU + u) * 32, w, k, col,
                        N, k < kw1);
        }
      cp_async_commit();
      cp_async_wait(depth - 1);  // every group up to step c has landed
#pragma unroll
      for (int u = 0; u < KU; ++u)
        raw[u] = my_ring[((c % depth) * KU + u) * 32];
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int k = kw0 + c * KU + u;
      if (k < kw1)
        skinny_row<W, MR>(raw[u], xs + (k - kb0) * 3 * MR, live, ib, s_tab,
                          bias, rnd, acc);
    }
  }
  if (PIPE) cp_async_wait(0);

  // the warps' partial sums meet in shared memory (uint32: order-free)
  uint32_t* mine = red + warp * MR * BN + lane * TN;
#pragma unroll
  for (int i = 0; i < MR; ++i)
    *reinterpret_cast<uint4*>(mine + i * BN) =
        make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int o = tid; o < live * BN; o += NT) {
    const int i = o / BN, cc = n0 + (o - i * BN);
    if (cc >= N) continue;
    uint32_t s = 0u;
#pragma unroll
    for (int wp = 0; wp < kSkinnyWarps; ++wp) s += red[wp * MR * BN + o];
    uint32_t* dst = out + static_cast<size_t>(m0 + i) * N + cc;
    if (accumulate)
      atomicAdd(dst, s);
    else
      *dst = s;
  }
}

// Dynamic shared memory a block gets without opting in: 48 KB less the
// static coefficient table both kernels keep.
constexpr size_t kDefaultDynSmem =
    48 * 1024 - simdive::kMaxTable * sizeof(int);

struct Args {
  const int32_t* x;
  const int32_t* w;
  uint32_t* out;
  int M, K, N;
  const int* tab;
  int tab_len, ib, round_out, bk, depth;
};

int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cache[dev]) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev >= 0 && dev < 64) cache[dev] = n;
  return n;
}

template <int W, int BM, int BN, int TM, int TN, int KU, bool PIPE>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(BM % TM == 0 && BN % TN == 0 && NT <= 1024, "tile");
  auto kern = logmatmul_kernel<W, BM, BN, TM, TN, KU, PIPE>;
  const int slots = PIPE ? a.depth : 1;
  const size_t smem =
      static_cast<size_t>(slots) * (BM * (a.bk + 1) + a.bk * BN) * 4;
  static size_t opted_in = kDefaultDynSmem;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const long long gm = (a.M + BM - 1) / BM, gn = (a.N + BN - 1) / BN;
  const int nk = (a.K + a.bk - 1) / a.bk;
  if (gm > 65535) return cudaErrorInvalidValue;
  // fill the card: split K when the output tiles are fewer than two
  // blocks per SM
  const long long tiles = gm * gn, target = 2LL * sm_count();
  int splits = 1;
  if (tiles < target)
    splits = static_cast<int>(
        std::min<long long>(nk, (target + tiles - 1) / tiles));
  const int per = (nk + splits - 1) / splits;
  splits = (nk + per - 1) / per;
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(
        a.out, 0, static_cast<size_t>(a.M) * a.N * sizeof(uint32_t), s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm),
                  static_cast<unsigned>(splits));
  kern<<<grid, NT, smem, s>>>(a.x, a.w, a.out, a.M, a.K, a.N, a.tab,
                              a.tab_len, a.ib, a.round_out, a.bk, a.depth, per,
                              splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

// The skinny tile's split of K: blocks (grid z) split it until the row
// groups x column blocks x splits reach two blocks an SM, in ranges of a
// multiple of the 8 warps and at most bk rows (the x words the block
// stages); the warps split each range again.
template <int W, int MR, int KU, bool PIPE, bool VEC>
cudaError_t launch_skinny(const Args& a, cudaStream_t s) {
  auto kern = logmatmul_skinny_kernel<W, MR, KU, PIPE, VEC>;
  const long long gm = (a.M + MR - 1) / MR;
  const long long gn = (a.N + kSkinnyBN - 1) / kSkinnyBN;
  if (gm > 65535) return cudaErrorInvalidValue;
  const long long tiles = gm * gn, target = 2LL * sm_count();
  const long long want = tiles < target ? (target + tiles - 1) / tiles : 1;
  int per = static_cast<int>((a.K + want - 1) / want);
  per = (per + kSkinnyWarps - 1) / kSkinnyWarps * kSkinnyWarps;
  per = std::min(per, a.bk);
  const int splits = (a.K + per - 1) / per;
  const size_t smem =
      static_cast<size_t>(3 * MR * per + kSkinnyWarps * MR * kSkinnyBN) * 4 +
      (PIPE ? static_cast<size_t>(kSkinnyWarps) * a.depth * KU * 32 * 16 : 0);
  static size_t opted_in = kDefaultDynSmem;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(
        a.out, 0, static_cast<size_t>(a.M) * a.N * sizeof(uint32_t), s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm),
                  static_cast<unsigned>(splits));
  kern<<<grid, kSkinnyWarps * 32, smem, s>>>(
      a.x, a.w, a.out, a.M, a.K, a.N, a.tab, a.tab_len, a.ib, a.round_out,
      PIPE ? a.depth : 0, per, splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

template <int W, int MR, int KU>
cudaError_t dispatch_skinny(const Args& a, cudaStream_t s) {
  // 16-byte weight loads need whole 4-column groups and an aligned base
  const bool vec =
      a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (a.depth)
    return vec ? launch_skinny<W, MR, KU, true, true>(a, s)
               : launch_skinny<W, MR, KU, true, false>(a, s);
  return vec ? launch_skinny<W, MR, KU, false, true>(a, s)
             : launch_skinny<W, MR, KU, false, false>(a, s);
}

}  // namespace

// The compiled tiles: (BM, BN, TM, TN, k_unroll). Keep in step with
// TILES in kernels/logmatmul.py.
#define LOGMATMUL_TILES(X) \
  X(64, 64, 4, 4, 4)       \
  X(16, 64, 1, 4, 4)
// The skinny-M tiles: (MR, k_unroll), each MR rows x 128 columns; blocks
// (MR, 128, bk, k_unroll, depth).
#define LOGMATMUL_SKINNY_TILES(X) \
  X(4, 4)                         \
  X(8, 4)

// x (M, K), w (K, N): contiguous int32; out (M, N) int32; tab: tab_len int32
// mul coefficients. depth 0 = synchronous slabs, 1..4 = cp.async ring.
// Returns cudaGetLastError() of the launch (or the error that stopped it).
extern "C" int simdive_logmatmul(const void* x, const void* w, void* out,
                                 int M, int K, int N, const void* tab,
                                 int tab_len, int width, int index_bits,
                                 int round_out, int bm, int bn, int bk,
                                 int k_unroll, int depth, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (tab_len > simdive::kMaxTable || tab_len != (1 << (2 * index_bits)) ||
      index_bits < 1 || index_bits > 4 || (width != 8 && width != 16) ||
      bk <= 0 || k_unroll <= 0 || bk % k_unroll || depth < 0 || depth > 4 ||
      K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(M) * N * sizeof(uint32_t), s));
  const Args a{static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
               static_cast<uint32_t*>(out), M, K, N,
               static_cast<const int*>(tab), tab_len, index_bits, round_out,
               bk, depth};
#define X(BM_, BN_, TM_, TN_, KU_)                                         \
  if (bm == BM_ && bn == BN_ && k_unroll == KU_) {                         \
    if (width == 8)                                                        \
      return static_cast<int>(                                             \
          depth ? launch<8, BM_, BN_, TM_, TN_, KU_, true>(a, s)           \
                : launch<8, BM_, BN_, TM_, TN_, KU_, false>(a, s));        \
    return static_cast<int>(                                               \
        depth ? launch<16, BM_, BN_, TM_, TN_, KU_, true>(a, s)            \
              : launch<16, BM_, BN_, TM_, TN_, KU_, false>(a, s));         \
  }
  LOGMATMUL_TILES(X)
#undef X
#define X(MR_, KU_)                                                        \
  if (bm == MR_ && bn == kSkinnyBN && k_unroll == KU_)                     \
    return static_cast<int>(width == 8 ? dispatch_skinny<8, MR_, KU_>(a, s) \
                                       : dispatch_skinny<16, MR_, KU_>(a, s));
  LOGMATMUL_SKINNY_TILES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}
