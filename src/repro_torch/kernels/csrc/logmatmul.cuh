// The SIMDive log-domain matmul's tiles, schedules and launchers, for both
// accumulator widths and both tile families, instantiated by four sources,
// each compiled by its own nvcc so that the build compiles them side by
// side: logmatmul.cu (the skinny tiles, uint32 sums: the int32 form; it
// holds the C entry), logmatmul_wide.cu (the skinny tiles, 64-bit sums:
// the wide form), logmatmul_large.cu and logmatmul_large_wide.cu (the
// large-M tiles, each form). Each holds its own copy of the fault register
// (simdive_datapath.cuh). The design note is in logmatmul.cu.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "simdive_datapath.cuh"

namespace {

using simdive::cp_async4;
using simdive::cp_async_commit;
using simdive::cp_async_wait;

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
// half shifted up by index_bits, so that the two halves add to the whole
// index), and sign / zero as -1, 0 or +1.
template <int W, bool IS_X, bool FAULTS>
__device__ __forceinline__ void split_operand(int32_t v, int ib, int& l,
                                              int& h4, int& c) {
  constexpr int F = W - 1;
  const bool neg = v < 0;
  uint32_t mag = neg ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  mag = min(mag, (1u << W) - 1u);
  const uint32_t L = simdive::lod_log<FAULTS>(mag, F);
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
// 2^24. Width 16, and width 8 under an upset table entry or an armed lane
// fault (GENERAL: the block found one, see the kernel), take the
// datapath's own anti-log, which holds for any operands.
template <int W, bool GENERAL>
__device__ __forceinline__ uint32_t split_product(int la, int hx4, int lb,
                                                  int hw4, const int* tab,
                                                  uint32_t bias, bool rnd) {
  const int corr = *reinterpret_cast<const int*>(
      reinterpret_cast<const char*>(tab) + (hx4 + hw4));
  if constexpr (W == 8 && !GENERAL) {
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
// the staged x words of that row; rows past M (live) are skipped. The sign
// product (-1, 0 or +1; 0 where a magnitude is 0) goes through int64 to
// Acc, so that the wide form widens the unsigned product before signing
// it. (A select-and-negate in place of the wide form's 64-bit multiply
// measured slower at depth 0 on an H100.)
template <int W, int MR, bool GENERAL, typename Acc>
__device__ __forceinline__ void skinny_row(const int4 raw, const int* xs_row,
                                           int live, int ib, const int* tab,
                                           uint32_t bias, bool rnd,
                                           Acc (&acc)[MR][kSkinnyTN]) {
  int lb[kSkinnyTN], hw4[kSkinnyTN], cw[kSkinnyTN];
  split_operand<W, false, GENERAL>(raw.x, ib, lb[0], hw4[0], cw[0]);
  split_operand<W, false, GENERAL>(raw.y, ib, lb[1], hw4[1], cw[1]);
  split_operand<W, false, GENERAL>(raw.z, ib, lb[2], hw4[2], cw[2]);
  split_operand<W, false, GENERAL>(raw.w, ib, lb[3], hw4[3], cw[3]);
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
        const uint32_t p = split_product<W, GENERAL>(
            xv[i], xv[MR + i], lb[j], hw4[j], tab, bias, rnd);
        acc[i][j] += static_cast<Acc>(p) *
                     static_cast<Acc>(static_cast<long long>(xv[2 * MR + i] *
                                                             cw[j]));
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

// x's MR x per elements of the block, converted once into shared memory
// as [k][log value | index half | sign][MR] words (0 past M and K).
template <int W, int MR, bool FAULTS>
__device__ __forceinline__ void skinny_stage_x(const int32_t* __restrict__ x,
                                               int* xs, int M, int K, int m0,
                                               int kb0, int kb1, int per,
                                               int ib, int tid) {
  constexpr int NT = kSkinnyWarps * 32;
  for (int e = tid; e < MR * per; e += NT) {
    const int i = e / per, kl = e - i * per;
    const int gm = m0 + i, gk = kb0 + kl;
    int l = 0, h4 = 0, c = 0;
    if (gm < M && gk < kb1)
      split_operand<W, true, FAULTS>(x[static_cast<size_t>(gm) * K + gk], ib,
                                     l, h4, c);
    int* p = xs + kl * 3 * MR + i;
    p[0] = l;
    p[MR] = h4;
    p[2 * MR] = c;
  }
}

// The warp's K steps: weight rows (straight to registers at depth 0,
// through the lane's cp.async ring slots at depth >= 1) times the staged
// x words, into acc.
template <int W, int MR, int KU, bool PIPE, bool VEC, bool GENERAL,
          typename Acc>
__device__ __forceinline__ void skinny_steps(
    const int32_t* __restrict__ w, int N, int col, int kw0, int kw1, int kb0,
    int steps, int depth, int4* my_ring, const int* xs, int live, int ib,
    const int* tab, uint32_t bias, bool rnd, Acc (&acc)[MR][kSkinnyTN]) {
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
        skinny_row<W, MR, GENERAL, Acc>(raw[u], xs + (k - kb0) * 3 * MR,
                                        live, ib, tab, bias, rnd, acc);
    }
  }
}

// Dynamic shared memory: x words [per][3][MR] ints, the warps' partial
// sums [warps][MR][128] Acc, then (ring) [warps][depth][KU][32 lanes]
// int4 — each lane copies and reads back only its own 16 bytes of a slot.
// The wide form's 64-bit accumulators take twice the registers, so it asks
// for one resident block an SM, not two.
template <int W, int MR, int KU, bool PIPE, bool VEC, typename Acc>
__global__ void __launch_bounds__(kSkinnyWarps * 32, sizeof(Acc) == 4 ? 2 : 1)
    logmatmul_skinny_kernel(const int32_t* __restrict__ x,
                            const int32_t* __restrict__ w,
                            Acc* __restrict__ out, int M, int K, int N,
                            const int* __restrict__ tab, int tab_len, int ib,
                            int round_out, int depth, int per,
                            int accumulate) {
  static_assert(MR % 4 == 0, "x words are read 4 at a time");
  constexpr int NT = kSkinnyWarps * 32, BN = kSkinnyBN, TN = kSkinnyTN;
  extern __shared__ __align__(16) uint32_t skinny_smem[];
  __shared__ int s_tab[simdive::kMaxTable];
  int* xs = reinterpret_cast<int*>(skinny_smem);
  // 3 * MR * per words: a multiple of 16 bytes (MR % 4 == 0)
  Acc* red = reinterpret_cast<Acc*>(skinny_smem + 3 * MR * per);
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
  // the general form (see split_product) under an armed lane fault, or
  // at width 8 under an entry outside the clean tables' |c| < 2^(F-1); a
  // uniform choice, which gives the short form's bits where that holds
  const bool faults = simdive::lane_faults_armed();

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
  bool odd = false;
  for (int i = tid; i < tab_len; i += NT) {
    const int v = tab[i];
    s_tab[i] = v;
    odd |= W == 8 && (v <= -(1 << (W - 2)) || v >= (1 << (W - 2)));
  }
  if (faults)
    skinny_stage_x<W, MR, true>(x, xs, M, K, m0, kb0, kb1, per, ib, tid);
  else
    skinny_stage_x<W, MR, false>(x, xs, M, K, m0, kb0, kb1, per, ib, tid);
  // table and x words in place
  const bool general = __syncthreads_or(odd) != 0 || faults;

  Acc acc[MR][TN];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  if (general)
    skinny_steps<W, MR, KU, PIPE, VEC, true, Acc>(
        w, N, col, kw0, kw1, kb0, steps, depth, my_ring, xs, live, ib, s_tab,
        bias, rnd, acc);
  else
    skinny_steps<W, MR, KU, PIPE, VEC, false, Acc>(
        w, N, col, kw0, kw1, kb0, steps, depth, my_ring, xs, live, ib, s_tab,
        bias, rnd, acc);
  if (PIPE) cp_async_wait(0);

  // the warps' partial sums meet in shared memory (unsigned: order-free)
  Acc* mine = red + warp * MR * BN + lane * TN;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if constexpr (sizeof(Acc) == 4) {
      *reinterpret_cast<uint4*>(mine + i * BN) =
          make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      *reinterpret_cast<ulonglong2*>(mine + i * BN) =
          make_ulonglong2(acc[i][0], acc[i][1]);
      *reinterpret_cast<ulonglong2*>(mine + i * BN + 2) =
          make_ulonglong2(acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  for (int o = tid; o < live * BN; o += NT) {
    const int i = o / BN, cc = n0 + (o - i * BN);
    if (cc >= N) continue;
    Acc s = Acc(0);
#pragma unroll
    for (int wp = 0; wp < kSkinnyWarps; ++wp) s += red[wp * MR * BN + o];
    Acc* dst = out + static_cast<size_t>(m0 + i) * N + cc;
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
  void* out;
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

// The skinny tile's split of K: blocks (grid z) split it until the row
// groups x column blocks x splits reach two blocks an SM, in ranges of a
// multiple of the 8 warps and at most bk rows (the x words the block
// stages); the warps split each range again.
template <int W, int MR, int KU, bool PIPE, bool VEC, typename Acc>
cudaError_t launch_skinny(const Args& a, cudaStream_t s) {
  auto kern = logmatmul_skinny_kernel<W, MR, KU, PIPE, VEC, Acc>;
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
      static_cast<size_t>(3 * MR * per) * 4 +
      static_cast<size_t>(kSkinnyWarps * MR * kSkinnyBN) * sizeof(Acc) +
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
        a.out, 0, static_cast<size_t>(a.M) * a.N * sizeof(Acc), s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm),
                  static_cast<unsigned>(splits));
  kern<<<grid, kSkinnyWarps * 32, smem, s>>>(
      a.x, a.w, static_cast<Acc*>(a.out), a.M, a.K, a.N, a.tab, a.tab_len, a.ib, a.round_out,
      PIPE ? a.depth : 0, per, splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

template <int W, int MR, int KU, typename Acc>
cudaError_t dispatch_skinny(const Args& a, cudaStream_t s) {
  // 16-byte weight loads need whole 4-column groups and an aligned base
  const bool vec =
      a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (a.depth)
    return vec ? launch_skinny<W, MR, KU, true, true, Acc>(a, s)
               : launch_skinny<W, MR, KU, true, false, Acc>(a, s);
  return vec ? launch_skinny<W, MR, KU, false, true, Acc>(a, s)
             : launch_skinny<W, MR, KU, false, false, Acc>(a, s);
}


// ---- large-M tile: the prefill, the training products, the studies ----
//
// A block owns a BM x 128 output tile over its whole K range (one range
// unless the tiles leave the card's resident blocks unfilled): 8 warps of
// BM / 8 rows each, a lane 4 adjacent columns, so a thread holds a
// (BM / 8) x 4 register tile. Each K slab of bk is converted ONCE per
// block into shared memory, both operands, two words an element: x as
// [k][row] (warp-uniform broadcasts: a warp's rows are its own), w as
// [k][col] (one 16-byte load a lane). The raw int32 slabs come straight
// from global memory (depth 0) or through a depth-slot ring of cp.async
// copies (depth >= 1), converted after they land.
//
// Two product forms, one uniform choice a block:
// * FLOAT (width 8, rounding, a clean table, no lane fault): the operand
//   words are float-ready — x: sign << 31 | ((la << 16) + kKeyBias), w:
//   sign << 31 | lb << 16 — and the table is staged as (corr + 64) << 16
//   with a zero row and column for zero magnitudes, so one IADD3 of x, w
//   and table words gives the bits of the signed float s * 2^I * (1 +
//   f / 2^7), one ulp larger in magnitude (2^I = 1/2 where the ternary
//   sum is negative, which rounds to the clip's 1): the exponent
//   construction is exact, the sign bits XOR (nothing carries into bit 31)
//   and the extra ulp breaks the round-half-up ties away from zero. Clamped to +-65535
//   (the bus maximum: I = 16), each is added in round-to-nearest to a
//   float partial sum kept in [2^23, 2^24) (1.5 * 2^23 plus the sum), where
//   the add rounds to the integer grid, so it IS floor(v + 0.5) with the
//   sign applied: one IADD, one LDS, one IADD3, two FMNMX and one FADD a
//   product. The partial sum holds 64 products (64 * 65535 < 2^22) and is
//   flushed into the uint32 sum at the end of each slab (bk <= 64).
// * GENERAL (width 16, width 8 without rounding, an armed lane fault, or
//   an entry outside the clean tables' |c| < 2^(F-1)): the datapath's own
//   anti-log on (log value, index half | sign << 16) words, one x word
//   pair read a row at a time.
// Width 8 products never exceed 2^16 - 1, so the width-8 sums are uint32
// in both forms; the wide form sign-extends them at the store and keeps a
// block's K range under 2^15 (kMaxK32), where that sum is exact.
constexpr int kLargeWarps = 8;
constexpr int kLargeThreads = kLargeWarps * 32;
constexpr int kLargeTN = 4;                    // columns a lane owns
constexpr int kLargeBN = 32 * kLargeTN;        // columns a block owns
constexpr int kLargeXPad = 4;   // x words a k row: BM + 4 (conflict-free)
constexpr int kLargeRawPad = 8; // raw x words a row: bk + 8 (16-byte rows)
constexpr int kMaxK32 = 32768;  // width 8: K a block sums in 32 bits
// FLOAT form: 0x3F800000 (1.0f) + the tie-breaking ulp, less the table's
// 64 << 16 bias
constexpr uint32_t kKeyBias = 0x3F800001u - (64u << 16);
constexpr float kPartialBase = 12582912.0f;     // 1.5 * 2^23
constexpr uint32_t kPartialBaseBits = 0x4B400000u;
constexpr float kBusMax8 = 65535.0f;

// One raw element of either operand staged as the form's two words: FLOAT
// (key word above, byte offset into the extended table: row stride S =
// 2^ib + 1 words, the zero row / column at index S - 1) or GENERAL (log
// value, index half as a byte offset | sign << 16; the armed lane faults
// applied to the log value where ``faults``).
template <int W, bool FLOAT, bool IS_X>
__device__ __forceinline__ void large_stage(int32_t v, int ib, bool faults,
                                            uint32_t& key, int& h) {
  if constexpr (FLOAT) {
    const int S = (1 << ib) + 1;
    const bool neg = v < 0;
    uint32_t mag =
        neg ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
    mag = min(mag, 255u);
    if (mag == 0u) {
      key = 0u;
      h = (IS_X ? (S - 1) * S : S - 1) * 4;
      return;
    }
    const uint32_t L = simdive::lod_log<false>(mag, 7);
    const int half = static_cast<int>((L & 127u) >> (7 - ib));
    key = (static_cast<uint32_t>(neg) << 31) |
          ((L << 16) + (IS_X ? kKeyBias : 0u));
    h = (IS_X ? half * S : half) * 4;
  } else {
    int l, h4, c;
    if (faults)
      split_operand<W, IS_X, true>(v, ib, l, h4, c);
    else
      split_operand<W, IS_X, false>(v, ib, l, h4, c);
    key = static_cast<uint32_t>(l);
    h = h4 | static_cast<int>(static_cast<uint32_t>(c) << 16);
  }
}

// Issue one slab's raw int32 words into a ring slot: x (BM rows of bk,
// row stride bk + kLargeRawPad), then w (bk rows of 128); zero outside M,
// K and N. 16-byte copies where the rows allow them (vec_x / vec_w), the
// K and N tails zero-filled by the copy itself.
template <int BM>
__device__ __forceinline__ void large_issue(uint32_t* slot,
                                            const int32_t* __restrict__ x,
                                            const int32_t* __restrict__ w,
                                            int M, int K, int N, int m0,
                                            int n0, int k0, int bk, int tid,
                                            bool vec_x, bool vec_w) {
  constexpr int NT = kLargeThreads, BN = kLargeBN;
  const int xld = bk + kLargeRawPad;
  uint32_t* xr = slot;
  uint32_t* wr = slot + BM * xld;
  if (vec_x) {
    const int cpr = bk / 4;
    for (int i = tid; i < BM * cpr; i += NT) {
      const int r = i / cpr, q = i - r * cpr;
      const int gm = m0 + r, gk = k0 + q * 4;
      const int n = gm < M ? 4 * max(0, min(4, K - gk)) : 0;
      simdive::cp_async16(xr + r * xld + q * 4,
                          n ? x + static_cast<size_t>(gm) * K + gk : x, n);
    }
  } else {
    for (int i = tid; i < BM * bk; i += NT) {
      const int r = i / bk, c = i - r * bk;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async4(xr + r * xld + c,
                ok ? x + static_cast<size_t>(gm) * K + gk : x, ok ? 4 : 0);
    }
  }
  if (vec_w) {
    for (int i = tid; i < bk * (BN / 4); i += NT) {
      const int r = i / (BN / 4), q = i - r * (BN / 4);
      const int gk = k0 + r, gn = n0 + q * 4;
      const int n = gk < K ? 4 * max(0, min(4, N - gn)) : 0;
      simdive::cp_async16(wr + r * BN + q * 4,
                          n ? w + static_cast<size_t>(gk) * N + gn : w, n);
    }
  } else {
    for (int i = tid; i < bk * BN; i += NT) {
      const int r = i / BN, c = i - r * BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async4(wr + r * BN + c,
                ok ? w + static_cast<size_t>(gk) * N + gn : w, ok ? 4 : 0);
    }
  }
}

// Convert one slab into the staged words: from a landed ring slot (RAW)
// or straight from global memory. A warp takes x in blocks of 4 rows x 8
// k, which reads the raw rows (stride bk + 8) and writes the [k][row]
// words (stride BM + 4) without bank conflicts.
template <int W, int BM, bool FLOAT, bool RAW>
__device__ __forceinline__ void large_convert(
    const uint32_t* slot, const int32_t* __restrict__ x,
    const int32_t* __restrict__ w, int M, int K, int N, int m0, int n0,
    int k0, int bk, int ib, bool faults, int tid, uint32_t* xk, int* xh,
    uint32_t* wk, int* wh) {
  constexpr int NT = kLargeThreads, BN = kLargeBN, XLD = BM + kLargeXPad;
  const int rld = bk + kLargeRawPad;
  const int cblocks = bk / 8;
  for (int e = tid; e < BM * bk; e += NT) {
    const int blk = e >> 5, l = e & 31;
    const int cb = blk % cblocks, rb = blk / cblocks;
    const int r = rb * 4 + (l >> 3), c = cb * 8 + (l & 7);
    int32_t v;
    if (RAW) {
      v = static_cast<int32_t>(slot[r * rld + c]);
    } else {
      const int gm = m0 + r, gk = k0 + c;
      v = gm < M && gk < K ? __ldg(x + static_cast<size_t>(gm) * K + gk) : 0;
    }
    large_stage<W, FLOAT, true>(v, ib, faults, xk[c * XLD + r],
                                xh[c * XLD + r]);
  }
  const uint32_t* wr = slot + BM * rld;
  for (int e = tid; e < bk * BN; e += NT) {
    const int r = e / BN, c = e - r * BN;
    int32_t v;
    if (RAW) {
      v = static_cast<int32_t>(wr[e]);
    } else {
      const int gk = k0 + r, gn = n0 + c;
      v = gk < K && gn < N ? __ldg(w + static_cast<size_t>(gk) * N + gn) : 0;
    }
    large_stage<W, FLOAT, false>(v, ib, faults, wk[e], wh[e]);
  }
}

// The products of one converted slab into this thread's TM x 4 tile.
template <int W, int BM, int KU, bool FLOAT, typename AccT>
__device__ __forceinline__ void large_products(
    const uint32_t* xk, const int* xh, const uint32_t* wk, const int* wh,
    int bk, int warp, int lane, const int* tab, uint32_t bias, bool rnd,
    float (&part)[BM / kLargeWarps][kLargeTN],
    AccT (&acc)[BM / kLargeWarps][kLargeTN]) {
  constexpr int TM = BM / kLargeWarps, TN = kLargeTN, BN = kLargeBN;
  constexpr int XLD = BM + kLargeXPad;
  const uint32_t* xk0 = xk + warp * TM;
  const int* xh0 = xh + warp * TM;
  const uint32_t* wk0 = wk + lane * TN;
  const int* wh0 = wh + lane * TN;
  if constexpr (FLOAT) {
    for (int k0 = 0; k0 < bk; k0 += KU) {
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k = k0 + u;
        uint32_t a[TM];
        int ah[TM];
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const uint4 t =
              *reinterpret_cast<const uint4*>(xk0 + k * XLD + 4 * q);
          const int4 th =
              *reinterpret_cast<const int4*>(xh0 + k * XLD + 4 * q);
          a[4 * q] = t.x, a[4 * q + 1] = t.y, a[4 * q + 2] = t.z,
          a[4 * q + 3] = t.w;
          ah[4 * q] = th.x, ah[4 * q + 1] = th.y, ah[4 * q + 2] = th.z,
          ah[4 * q + 3] = th.w;
        }
        const uint4 bt = *reinterpret_cast<const uint4*>(wk0 + k * BN);
        const int4 bth = *reinterpret_cast<const int4*>(wh0 + k * BN);
        const uint32_t b[TN] = {bt.x, bt.y, bt.z, bt.w};
        const int bh[TN] = {bth.x, bth.y, bth.z, bth.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int corr = *reinterpret_cast<const int*>(
                reinterpret_cast<const char*>(tab) + (ah[i] + bh[j]));
            const float v =
                __uint_as_float(a[i] + b[j] + static_cast<uint32_t>(corr));
            part[i][j] += fminf(fmaxf(v, -kBusMax8), kBusMax8);
          }
      }
    }
    // the float partial sums into the 32-bit ones; both in one binade
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] += __float_as_uint(part[i][j]) - kPartialBaseBits;
        part[i][j] = kPartialBase;
      }
  } else {
#pragma unroll 1
    for (int k = 0; k < bk; ++k) {
      const uint4 bt = *reinterpret_cast<const uint4*>(wk0 + k * BN);
      const int4 bth = *reinterpret_cast<const int4*>(wh0 + k * BN);
      const int b[TN] = {static_cast<int>(bt.x), static_cast<int>(bt.y),
                         static_cast<int>(bt.z), static_cast<int>(bt.w)};
      const int bh[TN] = {bth.x, bth.y, bth.z, bth.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // 64-bit sums leave no registers for the x words of later rows:
        // keep their loads in the row that reads them
        if constexpr (sizeof(AccT) == 8) asm volatile("" ::: "memory");
        const int a = static_cast<int>(xk0[k * XLD + i]);
        const int ah = xh0[k * XLD + i];
        const int hx4 = ah & 0xFFFF, sx = ah >> 16;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const uint32_t p = split_product<W, true>(
              a, hx4, b[j], bh[j] & 0xFFFF, tab, bias, rnd);
          acc[i][j] += static_cast<AccT>(p) *
                       static_cast<AccT>(static_cast<long long>(
                           sx * (bh[j] >> 16)));
        }
      }
    }
  }
}

// The block's slabs in one form and schedule, then its tile written once
// (or added, where K is split across blocks).
template <int W, int BM, int KU, bool PIPE, bool FLOAT, typename Acc>
__device__ __forceinline__ void large_run(
    const int32_t* __restrict__ x, const int32_t* __restrict__ w,
    Acc* __restrict__ out, int M, int K, int N, int ib, bool rnd,
    bool faults, int bk, int depth, int kt0, int n, int accumulate,
    bool vec_x, bool vec_w, uint32_t* smem, const int* tab) {
  constexpr int TM = BM / kLargeWarps, TN = kLargeTN, BN = kLargeBN;
  constexpr int XLD = BM + kLargeXPad;
  // width-8 sums are uint32 in either form (products < 2^16)
  using AccT = std::conditional_t<W == 8, uint32_t, Acc>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  uint32_t* xk = smem;
  int* xh = reinterpret_cast<int*>(smem + bk * XLD);
  uint32_t* wk = smem + 2 * bk * XLD;
  int* wh = reinterpret_cast<int*>(wk + bk * BN);
  uint32_t* ring = smem + 2 * bk * XLD + 2 * bk * BN;
  const int slot_words = BM * (bk + kLargeRawPad) + bk * BN;
  const uint32_t bias = rnd ? 1u << (W - 2) : 0u;

  AccT acc[TM][TN];
  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = AccT(0);
      part[i][j] = kPartialBase;
    }

  for (int c = 0; c < n; ++c) {
    const int k0 = (kt0 + c) * bk;
    if (PIPE) {
      const int nxt = c + depth - 1;  // into the slot slab c-1 vacated
      if (nxt < n)
        large_issue<BM>(ring + (nxt % depth) * slot_words, x, w, M, K, N, m0,
                        n0, (kt0 + nxt) * bk, bk, tid, vec_x, vec_w);
      cp_async_commit();
      cp_async_wait(depth - 1);  // every group up to slab c has landed
    }
    // slab c's copies landed; slab c-1's products done (staged words free)
    __syncthreads();
    large_convert<W, BM, FLOAT, PIPE>(
        ring + (PIPE ? (c % depth) * slot_words : 0), x, w, M, K, N, m0, n0,
        k0, bk, ib, faults, tid, xk, xh, wk, wh);
    __syncthreads();
    large_products<W, BM, KU, FLOAT, AccT>(xk, xh, wk, wh, bk, warp, lane,
                                           tab, bias, rnd, part, acc);
  }
  if (PIPE) cp_async_wait(0);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + warp * TM + i;
    if (r >= M) continue;
    const int c = n0 + lane * TN;
    Acc v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if constexpr (W == 8 && sizeof(Acc) == 8)
        v[j] = static_cast<Acc>(static_cast<long long>(
            static_cast<int32_t>(acc[i][j])));
      else
        v[j] = static_cast<Acc>(acc[i][j]);
    }
    Acc* o = out + static_cast<size_t>(r) * N + c;
    if (!accumulate && c + TN <= N && N % 4 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      if constexpr (sizeof(Acc) == 4) {
        *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(v[0], v[1]);
        *reinterpret_cast<ulonglong2*>(o + 2) = make_ulonglong2(v[2], v[3]);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (c + j >= N) continue;
      if (accumulate)
        atomicAdd(o + j, v[j]);
      else
        o[j] = v[j];
    }
  }
}

// Two resident blocks an SM, one for width 16's 64-bit sums (twice the
// accumulator registers).
template <int W, int BM, int KU, bool PIPE, typename Acc>
__global__ void __launch_bounds__(
    kLargeThreads, W == 16 && sizeof(Acc) == 8 ? 1 : 2)
    logmatmul_large_kernel(const int32_t* __restrict__ x,
                           const int32_t* __restrict__ w,
                           Acc* __restrict__ out, int M, int K, int N,
                           const int* __restrict__ tab, int tab_len, int ib,
                           int round_out, int bk, int depth,
                           int slabs_per_split, int accumulate, int vec_x,
                           int vec_w) {
  constexpr int NT = kLargeThreads, BN = kLargeBN;
  constexpr int XLD = BM + kLargeXPad;
  extern __shared__ __align__(16) uint32_t large_smem[];
  __shared__ int s_tab[simdive::kMaxTable];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + bk - 1) / bk;
  const int kt0 = blockIdx.z * slabs_per_split;
  const int n = max(0, min(nk, kt0 + slabs_per_split) - kt0);
  const bool rnd = round_out != 0;
  uint32_t* ring = large_smem + 2 * bk * XLD + 2 * bk * BN;
  const int slot_words = BM * (bk + kLargeRawPad) + bk * BN;

  // ring warm-up first: its copies fly while the table is staged
  if (PIPE) {
    for (int c = 0; c < depth - 1; ++c) {
      if (c < n)
        large_issue<BM>(ring + (c % depth) * slot_words, x, w, M, K, N, m0,
                        n0, (kt0 + c) * bk, bk, tid, vec_x != 0,
                        vec_w != 0);
      cp_async_commit();
    }
  }
  // the form, one uniform choice: FLOAT at width 8 with rounding, a clean
  // table and nothing armed; else GENERAL
  const bool faults = simdive::lane_faults_armed();
  bool odd = false;
  for (int i = tid; i < tab_len; i += NT) {
    const int v = tab[i];
    odd |= W == 8 && (v <= -(1 << (W - 2)) || v >= (1 << (W - 2)));
  }
  const bool general = __syncthreads_or(odd) != 0 || faults || W == 16;
  const bool flt = !general && rnd;
  if (flt) {
    // (corr + 64) << 16, a zero row (x = 0: the word sum is w's alone)
    // and a zero column (w = 0: cancels x's bias), row stride 2^ib + 1
    const int S = (1 << ib) + 1;
    for (int i = tid; i < S * S; i += NT) {
      const int hx = i / S, hw = i - hx * S;
      int v = 0;
      if (hx < S - 1)
        v = hw == S - 1 ? -static_cast<int>(kKeyBias)
                        : (tab[(hx << ib) | hw] + 64) * 65536;
      s_tab[i] = v;
    }
  } else {
    for (int i = tid; i < tab_len; i += NT) s_tab[i] = tab[i];
  }
  // (the first slab's barrier puts the table in place)

  const bool vx = vec_x != 0, vw = vec_w != 0;
  if constexpr (W == 8) {
    if (flt) {
      large_run<W, BM, KU, PIPE, true, Acc>(
          x, w, out, M, K, N, ib, rnd, false, bk, depth, kt0, n, accumulate,
          vx, vw, large_smem, s_tab);
      return;
    }
  }
  large_run<W, BM, KU, PIPE, false, Acc>(
      x, w, out, M, K, N, ib, rnd, faults, bk, depth, kt0, n, accumulate, vx,
      vw, large_smem, s_tab);
}

// Dynamic shared memory of a large-M block: the staged words (two a
// element: x bk x (BM + 4), w bk x 128) and, at depth >= 1, the ring's
// raw slabs (x BM x (bk + 8), w bk x 128 words a slot). Kept in step with
// smem_bytes in kernels/logmatmul.py.
template <int BM>
size_t large_smem_bytes(int bk, int depth) {
  return 4 * (static_cast<size_t>(2 * bk * (BM + kLargeXPad) +
                                  2 * bk * kLargeBN) +
              static_cast<size_t>(depth) *
                  (BM * (bk + kLargeRawPad) + bk * kLargeBN));
}

// The large tile's split of K: none while the output tiles fill the
// blocks the card holds at once (SMs x resident blocks an SM); below
// that, the count of ranges that gives the fewest slab-steps on the
// busiest SM (waves x slabs a range), the smaller on a tie. The wide
// form's width-8 sums also cap a range at kMaxK32.
template <int W, int BM, int KU, bool PIPE, typename Acc>
cudaError_t launch_large(const Args& a, cudaStream_t s) {
  auto kern = logmatmul_large_kernel<W, BM, KU, PIPE, Acc>;
  if (a.bk % 16 || a.bk > 64) return cudaErrorInvalidValue;
  const int depth = PIPE ? a.depth : 0;
  const size_t smem = large_smem_bytes<BM>(a.bk, depth);
  static size_t opted_in = kDefaultDynSmem;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  static size_t occ_smem = 0;
  static int occ = 1;
  if (occ_smem != smem) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, kLargeThreads, smem);
    if (e != cudaSuccess) return e;
    occ = std::max(n, 1);
    occ_smem = smem;
  }
  const long long gm = (a.M + BM - 1) / BM;
  const long long gn = (a.N + kLargeBN - 1) / kLargeBN;
  if (gm > 65535) return cudaErrorInvalidValue;
  const int nk = (a.K + a.bk - 1) / a.bk;
  const long long tiles = gm * gn, target = 1LL * occ * sm_count();
  int splits = 1;
  if (tiles < target) {
    long long best = -1;
    for (int sp = 1; sp <= std::min(nk, 64); ++sp) {
      const long long cost = (tiles * sp + target - 1) / target *
                             ((nk + sp - 1) / sp);
      if (best < 0 || cost < best) best = cost, splits = sp;
    }
  }
  if (W == 8 && sizeof(Acc) == 8) {
    const int cap = std::max(1, kMaxK32 / a.bk);
    splits = std::max(splits, (nk + cap - 1) / cap);
  }
  const int per = (nk + splits - 1) / splits;
  splits = (nk + per - 1) / per;
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(
        a.out, 0, static_cast<size_t>(a.M) * a.N * sizeof(Acc), s);
    if (e != cudaSuccess) return e;
  }
  const int vec_x =
      a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int vec_w =
      a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm),
                  static_cast<unsigned>(splits));
  kern<<<grid, kLargeThreads, smem, s>>>(
      a.x, a.w, static_cast<Acc*>(a.out), a.M, a.K, a.N, a.tab, a.tab_len,
      a.ib, a.round_out, a.bk, depth, per, splits > 1 ? 1 : 0, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace


// The skinny-M tiles: (MR, k_unroll), each MR rows x 128 columns; blocks
// (MR, 128, bk, k_unroll, depth). Keep in step with TILES in
// kernels/logmatmul.py.
#define LOGMATMUL_SKINNY_TILES(X) \
  X(4, 4)                         \
  X(8, 4)
// The large-M tile: (BM, k_unroll), BM rows x 128 columns; blocks
// (BM, 128, bk, k_unroll, depth), bk a multiple of 16 up to 64. Keep in
// step with TILES in kernels/logmatmul.py.
#define LOGMATMUL_LARGE_TILES(X) \
  X(64, 2)

namespace {

// Whether (bm, bn) names a large tile: its blocks go to the sources that
// instantiate it (logmatmul_large.cu, logmatmul_large_wide.cu).
inline bool is_large_tile(int bm, int bn) {
#define X(BM_, KU_) \
  if (bm == BM_ && bn == kLargeBN) return true;
  LOGMATMUL_LARGE_TILES(X)
#undef X
  return false;
}

// One accumulator width over one tile family's tiles, widths and
// schedules.
template <typename Acc, bool LARGE>
cudaError_t dispatch(const Args& a, int width, int bm, int bn, int k_unroll,
                     cudaStream_t s) {
  if constexpr (LARGE) {
#define X(BM_, KU_)                                                         \
  if (bm == BM_ && bn == kLargeBN && k_unroll == KU_) {                     \
    if (width == 8)                                                         \
      return a.depth ? launch_large<8, BM_, KU_, true, Acc>(a, s)           \
                     : launch_large<8, BM_, KU_, false, Acc>(a, s);         \
    return a.depth ? launch_large<16, BM_, KU_, true, Acc>(a, s)            \
                   : launch_large<16, BM_, KU_, false, Acc>(a, s);          \
  }
    LOGMATMUL_LARGE_TILES(X)
#undef X
  } else {
#define X(MR_, KU_)                                                 \
  if (bm == MR_ && bn == kSkinnyBN && k_unroll == KU_)              \
    return width == 8 ? dispatch_skinny<8, MR_, KU_, Acc>(a, s)     \
                      : dispatch_skinny<16, MR_, KU_, Acc>(a, s);
    LOGMATMUL_SKINNY_TILES(X)
#undef X
  }
  return cudaErrorInvalidValue;
}

// The C entries' argument checks and dispatch, at one accumulator width
// and tile family: out (M, N) holds sizeof(Acc)-byte sums.
template <typename Acc, bool LARGE>
int logmatmul_entry(const void* x, const void* w, void* out, int M, int K,
                    int N, const void* tab, int tab_len, int width,
                    int index_bits, int round_out, int bm, int bn, int bk,
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
        out, 0, static_cast<size_t>(M) * N * sizeof(Acc), s));
  const Args a{static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
               out, M, K, N, static_cast<const int*>(tab), tab_len,
               index_bits, round_out, bk, depth};
  return static_cast<int>(
      dispatch<Acc, LARGE>(a, width, bm, bn, k_unroll, s));
}

}  // namespace

// The C entries of the four sources, one signature: x (M, K), w (K, N)
// contiguous int32; out (M, N); tab: tab_len int32 mul coefficients;
// depth 0 = synchronous slabs, 1..4 = cp.async ring.
#define LOGMATMUL_ENTRY(name)                                               \
  extern "C" int name(const void* x, const void* w, void* out, int M,       \
                      int K, int N, const void* tab, int tab_len, int width, \
                      int index_bits, int round_out, int bm, int bn, int bk, \
                      int k_unroll, int depth, void* stream)
