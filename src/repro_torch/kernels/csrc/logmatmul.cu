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
// products for smollm-360m's 224 linears; the function needs at least 14
// integer operations per signed product at width 8 — listed with the
// operand conversion in chip_smoke.py, LOGMATMUL_OPS_PER_PRODUCT — over
// 132 SMs x 64 INT32 lanes x the SM clock, ~16.7e12/s), weight bytes plus
// operations at the decode step (M = 4: each int32 weight is read once and
// converted once, 4 products per weight). The
// products are shifts and adds with a data-dependent table gather, not
// multiplies, so there is no tensor-core part: this is a CUDA-core integer
// kernel.
//
// Design, against that bound:
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
  static size_t opted_in = 48 * 1024;  // default dynamic shared memory cap
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

}  // namespace

// The compiled tiles: (BM, BN, TM, TN, k_unroll). Keep in step with
// TILES in kernels/logmatmul.py.
#define LOGMATMUL_TILES(X) \
  X(64, 64, 4, 4, 4)       \
  X(16, 64, 1, 4, 4)

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
  return static_cast<int>(cudaErrorInvalidValue);
}
