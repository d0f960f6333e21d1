// The flash-attention kernels of flash_attention.cu (the design note is
// there), templated on the divider's lane word L: uint32_t (widths 8 and
// 16) in flash_attention.cu, uint64_t (width 32) in flash_attention_w32.cu.
// Each source that includes this header compiles its own copy of what it
// instantiates (an anonymous namespace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
// the f32 body's thread layout (the bf16 body's is MMA_WARPS below)
constexpr int TX = 16;        // threads across a tile's columns
constexpr int TY = 16;        // threads across a tile's rows
constexpr int NT = TX * TY;   // 256 threads
constexpr int RPT = BQ / TY;  // rows per thread (4)
constexpr int CPT = BK / TX;  // score columns per thread (4)
constexpr int kDivTable = 256;  // div table at index_bits <= 4
constexpr int kMaxDepth = 4;    // cp.async.wait_group takes an immediate

struct AttnParams {
  int Sq, Skv, kv_len, q_offset, causal, window, approx_div, kv_group, nq;
  float scale, lim;
  LaneCfg cfg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// ---------------------------------------------------- f32: CUDA-core body --
// max / sum over the 16 threads (consecutive lanes) that share a q row
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// depth 0: sQ, sK (padded rows), sV, sP, all f32
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

// Row stride of a ring slot's k and v tiles, in T: one 4-byte word of pad
// keeps the QK^T loop's column reads conflict-free, and every 4-byte copy
// lands 4-byte aligned.
template <typename T, int DH>
__host__ __device__ constexpr int ring_stride() {
  return DH + static_cast<int>(4 / sizeof(T));
}

// depth D >= 1: sQ and sP in f32, then D slots of raw T k and v tiles
template <typename T, int DH>
size_t smem_bytes_pipe(int depth) {
  return sizeof(float) * (BQ * (DH + 1) + BQ * (BK + 1)) +
         static_cast<size_t>(depth) * 2 * BK * ring_stride<T, DH>() *
             sizeof(T);
}

// Issue one kv tile's raw k and v rows into a ring slot by 4-byte cp.async.
// Rows past Skv are zero-filled (src-size 0 from the base address): a
// stale word there would give p = 0 times Inf / NaN.
template <typename T, int DH>
__device__ __forceinline__ void issue_kv(T* slot, const T* __restrict__ kb,
                                         const T* __restrict__ vb, int k0,
                                         int Skv, int tid) {
  constexpr int EPC = static_cast<int>(4 / sizeof(T));  // elements a copy
  constexpr int CPR = DH / EPC;                          // copies a row
  constexpr int KS = ring_stride<T, DH>();
  T* sk = slot;
  T* sv = slot + BK * KS;
  for (int i = tid; i < BK * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * EPC;
    const bool in = k0 + r < Skv;
    const long long g = static_cast<long long>(k0 + r) * DH + c;
    simdive::cp_async4(sk + r * KS + c, in ? kb + g : kb, in ? 4 : 0);
    simdive::cp_async4(sv + r * KS + c, in ? vb + g : vb, in ? 4 : 0);
  }
}

template <typename T, int DH, bool PIPE, typename L>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ tab, int tab_len, AttnParams p,
                 int depth) {
  constexpr int QS = DH + 1;     // padded strides: conflict-free row reads
  constexpr int PS = BK + 1;
  constexpr int DPT = DH / TX;   // output columns per thread
  // k / v tiles as the loop reads them: f32 staged by the synchronous load
  // (depth 0), or the raw T rows the ring landed, converted when read
  using KV = std::conditional_t<PIPE, T, float>;
  constexpr int KS = PIPE ? ring_stride<T, DH>() : QS;  // k row stride
  constexpr int VS = PIPE ? ring_stride<T, DH>() : DH;  // v row stride
  constexpr int SLOT = 2 * BK * ring_stride<T, DH>();   // ring slot, in T
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][QS]
  float* sKf = sQ + BQ * QS;     // depth 0: [BK][QS]
  float* sVf = sKf + BK * QS;    // depth 0: [BK][DH]
  // [BQ][PS]; the ring follows it
  float* sP = PIPE ? sQ + BQ * QS : sVf + BK * DH;
  T* ring = reinterpret_cast<T*>(sP + BQ * PS);
  __shared__ int s_tab[kDivTable];
  // read at the start: the load of the register overlaps the kernel
  const bool faults = simdive::lane_faults_armed();

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x / p.nq;
  // heaviest (latest) causal q tiles are scheduled first
  const int qi = p.nq - 1 - static_cast<int>(blockIdx.x % p.nq);
  const int q0 = qi * BQ;
  const long long kvh = bh / p.kv_group;
  const T* qb = q + static_cast<long long>(bh) * p.Sq * DH;
  const T* kb = k + kvh * p.Skv * DH;
  const T* vb = v + kvh * p.Skv * DH;

  if (p.approx_div)
    for (int i = tid; i < tab_len; i += NT) s_tab[i] = tab[i];
  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, c = i % DH;
    sQ[r * QS + c] =
        (q0 + r < p.Sq) ? to_f32(qb[static_cast<long long>(q0 + r) * DH + c])
                        : 0.0f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;
  }

  // kv range any row of this q tile can see
  const int q_lo = q0 + p.q_offset, q_hi = q_lo + BQ - 1;
  int k_end = min(p.Skv, p.kv_len);
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (p.window) k_begin = max(0, q_lo - p.window + 1);
  const int kj_lo = k_begin / BK;
  const int kj_hi = (k_end + BK - 1) / BK;  // exclusive; <= kj_lo when empty
  const int n = kj_hi - kj_lo;              // kv tiles visited, both schedules

  if constexpr (PIPE) {
    // warm-up: tiles 0..D-2, one commit group each (empty past the end, so
    // that tile c is always group c); an empty loop issues nothing
    if (n > 0)
      for (int c = 0; c < depth - 1; ++c) {
        if (c < n)
          issue_kv<T, DH>(ring + (c % depth) * SLOT, kb, vb,
                          (kj_lo + c) * BK, p.Skv, tid);
        simdive::cp_async_commit();
      }
  }

  for (int step = 0; step < n; ++step) {
    const int k0 = (kj_lo + step) * BK;
    const KV* sK;
    const KV* sV;
    if constexpr (PIPE) {
      // tile step-1 fully consumed (and sQ / s_tab written): its slot,
      // where tile step+D-1 goes, and sP are free
      __syncthreads();
      const int nxt = step + depth - 1;
      if (nxt < n)
        issue_kv<T, DH>(ring + (nxt % depth) * SLOT, kb, vb,
                        (kj_lo + nxt) * BK, p.Skv, tid);
      simdive::cp_async_commit();
      simdive::cp_async_wait(depth - 1);  // this thread's copies landed
      __syncthreads();                    // ... and every thread's
      sK = ring + (step % depth) * SLOT;
      sV = sK + BK * KS;
    } else {
      __syncthreads();  // previous tile fully consumed (and sQ/s_tab written)
      for (int i = tid; i < BK * DH; i += NT) {
        const int r = i / DH, cc = i % DH;
        const bool in = k0 + r < p.Skv;
        const long long g = static_cast<long long>(k0 + r) * DH + cc;
        sKf[r * QS + cc] = in ? to_f32(kb[g]) : 0.0f;
        sVf[r * DH + cc] = in ? to_f32(vb[g]) : 0.0f;
      }
      __syncthreads();
      sK = sKf;
      sV = sVf;
    }

    // s = (q . k) * scale on a 4x4 micro-tile: rows i*TY+ty, cols j*TX+tx
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(i * TY + ty) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kv[j] = to_f32(sK[(j * TX + tx) * KS + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float cfac[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_lo + i * TY + ty;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + j * TX + tx;
        bool ok = kpos < p.kv_len && kpos < p.Skv;
        if (p.causal) ok = ok && (kpos <= qpos);
        if (p.window) ok = ok && (kpos > qpos - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      float m_new = fmaxf(m[i], rmax);
      if (!isfinite(m_new)) m_new = 0.0f;  // fully-masked-row guard
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pe = expf(s[i][j] - m_new);
        psum += pe;
        // p rounded to v's type before the PV product
        sP[(i * TY + ty) * PS + j * TX + tx] = to_f32(from_f32<T>(pe));
      }
      psum = row_sum16(psum);
      cfac[i] = expf(m[i] - m_new);
      l[i] = l[i] * cfac[i] + psum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * c + p @ v: rows i*TY+ty, output cols c*TX+tx
    float pv[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) pv[i][c] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pr[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = sP[(i * TY + ty) * PS + t];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = to_f32(sV[t * VS + c * TX + tx]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) pv[i][c] = fmaf(pr[i], vv[c], pv[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = acc[i][c] * cfac[i] + pv[i][c];
  }
  __syncthreads();  // s_tab visible even when the kv loop was empty

  // finalize: exact divide, or the SIMDive divider on a per-row exponent
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + i * TY + ty;
    const float li = fmaxf(l[i], 1e-30f);
    float outv[DPT];
    if (p.approx_div) {
      float amax = 0.0f;
#pragma unroll
      for (int c = 0; c < DPT; ++c) amax = fmaxf(amax, fabsf(acc[i][c]));
      amax = row_max16(amax);
      const simdive::RowQuant<L> rq =
          simdive::softmax_row_quant<L>(amax, li, p.cfg.width, p.lim);
      if (faults) {
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          outv[c] = simdive::softmax_div_elem<true, L>(acc[i][c], rq, s_tab,
                                                       p.cfg, p.lim, nullptr);
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          outv[c] = simdive::softmax_div_elem<false, L>(acc[i][c], rq, s_tab,
                                                        p.cfg, p.lim, nullptr);
      }
    } else {
#pragma unroll
      for (int c = 0; c < DPT; ++c) outv[c] = acc[i][c] / li;
    }
    if (row < p.Sq) {
      T* orow = o + (static_cast<long long>(bh) * p.Sq + row) * DH;
#pragma unroll
      for (int c = 0; c < DPT; ++c) orow[c * TX + tx] = from_f32<T>(outv[c]);
    }
  }
}

// ------------------------------------------------- bf16: tensor-core body --
using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;            // 16 q rows each
constexpr int MMA_NT = 32 * MMA_WARPS;  // 128 threads
static_assert(BQ == 16 * MMA_WARPS && BQ == BK, "one 64-row tile shape");

// Row stride of every bf16 tile (q, k, v), in elements: one 16-byte pad
// puts the eight 16-byte rows an ldmatrix reads in distinct banks.
template <int DH>
__host__ __device__ constexpr int mma_stride() {
  return DH + 8;
}

// the q tile, then depth 0: one k and one v tile; depth D: D slots of them
template <int DH>
size_t smem_bytes_mma(int depth) {
  const int tiles = 1 + 2 * (depth > 0 ? depth : 1);
  return sizeof(bf16) * static_cast<size_t>(tiles) * BQ * mma_stride<DH>();
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a (16 x 16 bf16, row) . b (16 x 8 bf16, col), accumulated in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 in one instruction (round to nearest even, as
// the reference casts p and o), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows r0..r0+63 of a (rows, DH) bf16 matrix into a padded tile by 16-byte
// loads, zeros past `rows`; every load is issued before the first store.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int rows, int tid) {
  constexpr int CPR = DH / 8;             // 16-byte chunks a row
  constexpr int PER = BQ * CPR / MMA_NT;  // chunks a thread
  uint4 val[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * MMA_NT, r = c / CPR;
    val[i] = r0 + r < rows
                 ? *reinterpret_cast<const uint4*>(
                       src + static_cast<long long>(r0 + r) * DH +
                       (c % CPR) * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + i * MMA_NT;
    *reinterpret_cast<uint4*>(dst + (c / CPR) * mma_stride<DH>() +
                              (c % CPR) * 8) = val[i];
  }
}

// Issue one kv tile's k and v rows into a ring slot by 16-byte cp.async,
// zero-filled past Skv from the base address (as issue_kv).
template <int DH>
__device__ __forceinline__ void issue_kv16(bf16* slot,
                                           const bf16* __restrict__ kb,
                                           const bf16* __restrict__ vb,
                                           int k0, int Skv, int tid) {
  constexpr int CPR = DH / 8;
  constexpr int S = mma_stride<DH>();
#pragma unroll
  for (int i = 0; i < BK * CPR / MMA_NT; ++i) {
    const int c = tid + i * MMA_NT, r = c / CPR, cc = (c % CPR) * 8;
    const bool in = k0 + r < Skv;
    const long long g = static_cast<long long>(k0 + r) * DH + cc;
    simdive::cp_async16(slot + r * S + cc, in ? kb + g : kb, in ? 16 : 0);
    simdive::cp_async16(slot + (BK + r) * S + cc, in ? vb + g : vb,
                        in ? 16 : 0);
  }
}

template <int DH, bool PIPE, typename L>
__global__ void __launch_bounds__(MMA_NT)
    flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const int* __restrict__ tab, int tab_len, AttnParams p,
                     int depth) {
  constexpr int S = mma_stride<DH>();
  constexpr int TILE = BK * S;     // one k or v tile, in elements
  constexpr int KSTEPS = DH / 16;  // k-steps of Q K^T
  constexpr int NS = BK / 8;       // n8 tiles of the scores
  constexpr int NO = DH / 8;       // n8 tiles of acc
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
  bf16* kv_tiles = sQ + BQ * S;  // depth 0: k, v; depth D: D (k, v) slots
  __shared__ int s_tab[kDivTable];
  // read at the start: the load of the register overlaps the kernel
  const bool faults = simdive::lane_faults_armed();

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row, column pair
  // heaviest (latest) causal q tiles are scheduled first, of every head:
  // the blocks that run last are the shortest
  const int BH = static_cast<int>(gridDim.x) / p.nq;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int qi = p.nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int q0 = qi * BQ;
  const long long kvh = bh / p.kv_group;
  const bf16* qb = q + static_cast<long long>(bh) * p.Sq * DH;
  const bf16* kb = k + kvh * p.Skv * DH;
  const bf16* vb = v + kvh * p.Skv * DH;

  if (p.approx_div)
    for (int i = tid; i < tab_len; i += MMA_NT) s_tab[i] = tab[i];

  // kv range any row of this q tile can see
  const int q_lo = q0 + p.q_offset, q_hi = q_lo + BQ - 1;
  const int k_lim = min(p.Skv, p.kv_len);
  int k_end = k_lim;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (p.window) k_begin = max(0, q_lo - p.window + 1);
  const int kj_lo = k_begin / BK;
  const int kj_hi = (k_end + BK - 1) / BK;  // exclusive; <= kj_lo when empty
  const int n = kj_hi - kj_lo;              // kv tiles visited, both schedules

  if constexpr (PIPE) {
    // warm-up: tiles 0..D-2, one commit group each (empty past the end, so
    // that tile c is always group c); an empty loop issues nothing
    if (n > 0)
      for (int c = 0; c < depth - 1; ++c) {
        if (c < n)
          issue_kv16<DH>(kv_tiles + (c % depth) * 2 * TILE, kb, vb,
                         (kj_lo + c) * BK, p.Skv, tid);
        simdive::cp_async_commit();
      }
  }
  load_tile<DH>(sQ, qb, q0, p.Sq, tid);
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per k-step, for the whole loop
  uint32_t qf[KSTEPS][4];
  {
    const bf16* src = sQ + (16 * warp + lane % 8 + (lane / 8 % 2) * 8) * S +
                      (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      ldmatrix_x4(qf[ks], smem_addr(src + 16 * ks));
  }

  // a thread's two rows: r = 0 is the warp's row g, r = 1 row g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share, summed over the quad last
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int qpos0 = q_lo + 16 * warp + g;

  for (int step = 0; step < n; ++step) {
    const int k0 = (kj_lo + step) * BK;
    const bf16* sK;
    if constexpr (PIPE) {
      // tile step-1 fully consumed: its slot, where tile step+D-1 goes, is
      // free
      __syncthreads();
      const int nxt = step + depth - 1;
      if (nxt < n)
        issue_kv16<DH>(kv_tiles + (nxt % depth) * 2 * TILE, kb, vb,
                       (kj_lo + nxt) * BK, p.Skv, tid);
      simdive::cp_async_commit();
      simdive::cp_async_wait(depth - 1);  // this thread's copies landed
      __syncthreads();                    // ... and every thread's
      sK = kv_tiles + (step % depth) * 2 * TILE;
    } else {
      __syncthreads();  // previous tile fully consumed
      load_tile<DH>(kv_tiles, kb, k0, p.Skv, tid);
      load_tile<DH>(kv_tiles + TILE, vb, k0, p.Skv, tid);
      __syncthreads();
      sK = kv_tiles;
    }
    const bf16* sV = sK + TILE;

    // s = q . k on the tensor cores; n8 tile j holds kv columns 8j..8j+7
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    {
      const bf16* src =
          sK + (lane % 8 + (lane / 16) * 8) * S + (lane / 8 % 2) * 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(src + 16 * jp * S + 16 * ks));
          mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
          mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
        }
    }

    // scale and mask (a tile that no mask reaches skips the tests), row max
    const bool whole = k0 + BK <= k_lim &&
                       (!p.causal || k0 + BK - 1 <= q_lo) &&
                       (!p.window || k0 > q_hi - p.window);
    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        bool ok = true;
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * t4 + e % 2;
          const int qpos = qpos0 + 8 * r;
          ok = kpos < k_lim;
          if (p.causal) ok = ok && (kpos <= qpos);
          if (p.window) ok = ok && (kpos > qpos - p.window);
        }
        s[j][e] = ok ? s[j][e] * p.scale : -INFINITY;
        rmax[r] = fmaxf(rmax[r], s[j][e]);
      }
    float m_new[2], cfac[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold one row
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      m_new[r] = fmaxf(m[r], rmax[r]);
      if (!isfinite(m_new[r])) m_new[r] = 0.0f;  // fully-masked-row guard
      cfac[r] = expf(m[r] - m_new[r]);
      m[r] = m_new[r];
    }

    // p = exp(s - m_new): l sums it in f32; rounded to bf16 it becomes the
    // A fragment of the PV product (k-step kk: kv columns 16kk..16kk+15)
    float psum[2] = {0.0f, 0.0f};
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = expf(s[j][e] - m_new[e / 2]);
        psum[e / 2] += pe[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(pe[0], pe[1]);      // row g
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);  // row g + 8
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * cfac[r] + psum[r];

    // acc = acc * c + p @ v
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= cfac[0];
      acc[j][1] *= cfac[0];
      acc[j][2] *= cfac[1];
      acc[j][3] *= cfac[1];
    }
    {
      const bf16* src =
          sV + (lane % 8 + (lane / 8 % 2) * 8) * S + (lane / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(src + 16 * kk * S + 16 * jp));
          mma_bf16(acc[2 * jp], pa[kk], b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], pa[kk], b[2], b[3]);
        }
    }
  }
  __syncthreads();  // s_tab visible even when the kv loop was empty

  // finalize: exact divide, or the SIMDive divider on a per-row exponent
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float li = fmaxf(l[r], 1e-30f);
    float outv[NO][2];
    if (p.approx_div) {
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        amax = fmaxf(amax, fmaxf(fabsf(acc[j][2 * r]),
                                 fabsf(acc[j][2 * r + 1])));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const simdive::RowQuant<L> rq =
          simdive::softmax_row_quant<L>(amax, li, p.cfg.width, p.lim);
      if (faults) {
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            outv[j][e] = simdive::softmax_div_elem<true, L>(
                acc[j][2 * r + e], rq, s_tab, p.cfg, p.lim, nullptr);
      } else {
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            outv[j][e] = simdive::softmax_div_elem<false, L>(
                acc[j][2 * r + e], rq, s_tab, p.cfg, p.lim, nullptr);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) outv[j][e] = acc[j][2 * r + e] / li;
    }
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row < p.Sq) {
      bf16* orow =
          o + (static_cast<long long>(bh) * p.Sq + row) * DH + 2 * t4;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(outv[j][0], outv[j][1]);
    }
  }
}

// ------------------------------------------------------------- launching --
template <typename T, int DH, bool PIPE, typename L>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const void* tab, int tab_len, int BH, const AttnParams& p,
                 int depth, cudaStream_t stream) {
  constexpr bool MMA = std::is_same_v<T, bf16>;
  void (*kern)(const T*, const T*, const T*, T*, const int*, int, AttnParams,
               int);
  size_t smem;
  int threads;
  if constexpr (MMA) {
    kern = flash_kernel_mma<DH, PIPE, L>;
    smem = smem_bytes_mma<DH>(depth);
    threads = MMA_NT;
  } else {
    kern = flash_kernel<T, DH, PIPE, L>;
    smem = PIPE ? smem_bytes_pipe<T, DH>(depth) : smem_bytes<DH>();
    threads = NT;
  }
  // opt in to > 48 KB of dynamic shared memory, up to the largest size this
  // instantiation has launched with (the ring grows with the depth)
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  const unsigned blocks = static_cast<unsigned>(BH) * p.nq;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(tab), tab_len, p, depth);
  return static_cast<int>(cudaGetLastError());
}

template <bool PIPE, typename L>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const void* tab, int tab_len, int BH, int dh, int dtype,
             const AttnParams& p, int depth, cudaStream_t s) {
  if (dtype == 0 && dh == 64)
    return launch_flash<float, 64, PIPE, L>(q, k, v, o, tab, tab_len, BH, p,
                                         depth, s);
  if (dtype == 0 && dh == 128)
    return launch_flash<float, 128, PIPE, L>(q, k, v, o, tab, tab_len, BH, p,
                                          depth, s);
  if (dtype == 0 && dh == 80)
    return launch_flash<float, 80, PIPE, L>(q, k, v, o, tab, tab_len, BH, p,
                                         depth, s);
  if (dtype == 1 && dh == 64)
    return launch_flash<__nv_bfloat16, 64, PIPE, L>(q, k, v, o, tab, tab_len,
                                                 BH, p, depth, s);
  if (dtype == 1 && dh == 80)
    return launch_flash<__nv_bfloat16, 80, PIPE, L>(q, k, v, o, tab, tab_len,
                                                 BH, p, depth, s);
  if (dtype == 1 && dh == 128)
    return launch_flash<__nv_bfloat16, 128, PIPE, L>(q, k, v, o, tab, tab_len,
                                                  BH, p, depth, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The finalize alone, on given (acc, l): one warp per row. A hook for
// holding the in-kernel divider bit-equal to its plain version.
template <typename L>
__global__ void softmax_div_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ l,
                                   float* __restrict__ out,
                                   L* __restrict__ quot, int rows, int dh,
                                   const int* __restrict__ tab, int tab_len,
                                   LaneCfg cfg, float lim) {
  __shared__ int s_tab[kDivTable];
  const bool faults = simdive::lane_faults_armed();
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const float* arow = acc + static_cast<long long>(row) * dh;
  float amax = 0.0f;
  for (int c = lane; c < dh; c += 32) amax = fmaxf(amax, fabsf(arow[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const simdive::RowQuant<L> rq =
      simdive::softmax_row_quant<L>(amax, l[row], cfg.width, lim);
  for (int c = lane; c < dh; c += 32) {
    L qq;
    out[static_cast<long long>(row) * dh + c] =
        faults ? simdive::softmax_div_elem<true, L>(arow[c], rq, s_tab, cfg,
                                                    lim, &qq)
               : simdive::softmax_div_elem<false, L>(arow[c], rq, s_tab, cfg,
                                                     lim, &qq);
    quot[static_cast<long long>(row) * dh + c] = qq;
  }
}

// Both schedules' entry: check the arguments, fill the parameters, launch
// the instantiation for (dtype, d_head, depth > 0) and lane word L.
template <typename L>
int attention(const void* q, const void* k, const void* v, void* o,
              const void* tab, int tab_len, int BH, int Sq, int Skv, int dh,
              int dtype, int kv_group, int kv_len, int q_offset, int causal,
              int window, int approx_div, float scale, int width,
              int index_bits, int frac_out, int round_out, float lim,
              int depth, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (tab_len > kDivTable || kv_group <= 0 || Skv < 0 || depth < 0 ||
      depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnParams p;
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  p.causal = causal;
  p.window = window;
  p.approx_div = approx_div;
  p.kv_group = kv_group;
  p.nq = (Sq + BQ - 1) / BQ;
  p.scale = scale;
  p.lim = lim;
  p.cfg = LaneCfg{width, index_bits, frac_out, round_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return depth ? dispatch<true, L>(q, k, v, o, tab, tab_len, BH, dh, dtype,
                                   p, depth, s)
               : dispatch<false, L>(q, k, v, o, tab, tab_len, BH, dh, dtype,
                                    p, 0, s);
}

// The finalize-alone entry: acc (rows, dh) f32, l (rows,) f32 -> out (rows,
// dh) f32 and the raw quotient lanes quot (rows, dh) of L.
template <typename L>
int softmax_div(const void* acc, const void* l, void* out, void* quot,
                int rows, int dh, const void* tab, int tab_len, int width,
                int index_bits, int frac_out, int round_out, float lim,
                void* stream) {
  if (rows <= 0 || dh <= 0) return 0;
  if (tab_len > kDivTable) return static_cast<int>(cudaErrorInvalidValue);
  const LaneCfg cfg{width, index_bits, frac_out, round_out};
  const int warps = 4;
  const unsigned blocks = (rows + warps - 1) / warps;
  softmax_div_kernel<L><<<blocks, warps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(l),
      static_cast<float*>(out), static_cast<L*>(quot), rows, dh,
      static_cast<const int*>(tab), tab_len, cfg, lim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
