// The SIMDive log-domain matmul's tiles, schedules and launchers, for both
// accumulator widths: logmatmul.cu instantiates them with uint32 sums (the
// int32 form), logmatmul_wide.cu with 64-bit ones (the wide form). Two
// sources, each compiled by its own nvcc, so that the build compiles the
// two forms side by side; each holds its own copy of the fault register
// (simdive_datapath.cuh). The design note is in logmatmul.cu.
#pragma once

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

// sign_split (|INT32_MIN| included, clamped to the lane) + LOD/log. The
// square tiles read the fault register for each element (they serve no
// path; the wrapper refuses a log fault above the 20-bit field).
template <int W, bool IS_X>
__device__ __forceinline__ uint32_t encode(int32_t v, int ib) {
  constexpr int F = W - 1;
  const uint32_t neg = v < 0 ? 1u : 0u;
  uint32_t mag = neg ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  mag = min(mag, (1u << W) - 1u);
  if (mag == 0u) return kZero;
  const uint32_t L = simdive::lane_faults_armed()
                         ? simdive::lod_log<true>(mag, F)
                         : simdive::lod_log<false>(mag, F);
  uint32_t half = (L & ((1u << F) - 1u)) >> (F - ib);
  if (IS_X) half <<= ib;
  return (neg << 31) | (half << kIdxShift) | L;
}

// One signed product, as sign_join(log_mul(...), sign) makes it: the uint32
// product (2^32 - 1 when a width-16 product saturates), widened to Acc and
// negated mod 2^(8 sizeof(Acc)).
template <int W, typename Acc>
__device__ __forceinline__ Acc signed_product(uint32_t ex, uint32_t ew,
                                              const int* tab, bool round_out) {
  const uint32_t o = ex | ew;
  const int corr = tab[(o >> kIdxShift) & 0xFFu];
  uint32_t p = simdive::antilog_mul(ex & kLogMask, ew & kLogMask, corr, W,
                                    round_out);
  const Acc wp = (o & kZero) ? Acc(0) : static_cast<Acc>(p);
  return ((ex ^ ew) >> 31) ? Acc(0) - wp : wp;
}

template <int W, int BM, int BN, int TM, int TN, int KU, typename Acc>
__device__ __forceinline__ void slab_products(const uint32_t* xs,
                                              const uint32_t* ws, int bk,
                                              int tx, int ty, const int* tab,
                                              bool round_out,
                                              Acc (&acc)[TM][TN]) {
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
          acc[i][j] += signed_product<W, Acc>(a[i], b[j], tab, round_out);
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

template <int W, int BM, int BN, int TM, int TN, int KU, bool PIPE,
          typename Acc>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    logmatmul_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ w, Acc* __restrict__ out,
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

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

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
      slab_products<W, BM, BN, TM, TN, KU, Acc>(xs, ws, bk, tx, ty, s_tab,
                                                rnd, acc);
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
      slab_products<W, BM, BN, TM, TN, KU, Acc>(slot, slot + BM * xs_ld, bk,
                                                tx, ty, s_tab, rnd, acc);
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
        Acc* o = out + static_cast<size_t>(r) * N + c;
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

template <int W, int BM, int BN, int TM, int TN, int KU, bool PIPE,
          typename Acc>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int NT = (BM / TM) * (BN / TN);
  static_assert(BM % TM == 0 && BN % TN == 0 && NT <= 1024, "tile");
  auto kern = logmatmul_kernel<W, BM, BN, TM, TN, KU, PIPE, Acc>;
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
        a.out, 0, static_cast<size_t>(a.M) * a.N * sizeof(Acc), s);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(gn), static_cast<unsigned>(gm),
                  static_cast<unsigned>(splits));
  kern<<<grid, NT, smem, s>>>(a.x, a.w, static_cast<Acc*>(a.out), a.M, a.K,
                              a.N, a.tab,
                              a.tab_len, a.ib, a.round_out, a.bk, a.depth, per,
                              splits > 1 ? 1 : 0);
  return cudaGetLastError();
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

namespace {

// One accumulator width over every tile, width and schedule.
template <typename Acc>
cudaError_t dispatch(const Args& a, int width, int bm, int bn, int k_unroll,
                     cudaStream_t s) {
#define X(BM_, BN_, TM_, TN_, KU_)                                          \
  if (bm == BM_ && bn == BN_ && k_unroll == KU_) {                          \
    if (width == 8)                                                         \
      return a.depth ? launch<8, BM_, BN_, TM_, TN_, KU_, true, Acc>(a, s)  \
                     : launch<8, BM_, BN_, TM_, TN_, KU_, false, Acc>(a, s); \
    return a.depth ? launch<16, BM_, BN_, TM_, TN_, KU_, true, Acc>(a, s)   \
                   : launch<16, BM_, BN_, TM_, TN_, KU_, false, Acc>(a, s); \
  }
  LOGMATMUL_TILES(X)
#undef X
#define X(MR_, KU_)                                                 \
  if (bm == MR_ && bn == kSkinnyBN && k_unroll == KU_)              \
    return width == 8 ? dispatch_skinny<8, MR_, KU_, Acc>(a, s)     \
                      : dispatch_skinny<16, MR_, KU_, Acc>(a, s);
  LOGMATMUL_SKINNY_TILES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // namespace

namespace {

// The C entry's argument checks and dispatch, at one accumulator width:
// out (M, N) holds sizeof(Acc)-byte sums.
template <typename Acc>
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
  return static_cast<int>(dispatch<Acc>(a, width, bm, bn, k_unroll, s));
}

}  // namespace
