// The decode-attention kernel of decode_attention.cu (the design note is
// there), templated on the finalize's lane word L: uint32_t (widths 8 and
// 16) in decode_attention.cu, uint64_t (width 32) in
// decode_attention_w32.cu. Each source that includes this header compiles
// its own copy of what it instantiates (an anonymous namespace).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "simdive_datapath.cuh"

namespace cg = cooperative_groups;

namespace {

using simdive::LaneCfg;
using bf16 = __nv_bfloat16;

constexpr int NW = 4;                   // warps a block
constexpr int NT = 32 * NW;             // 128 threads
constexpr int kMaxG = 8;                // q heads a kv head, at most
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kScoreFloats = 8192;      // a block's scores a round
constexpr int kStageBytes = 96 * 1024;  // k and v tiles staged (both buffers)
constexpr int kDivTable = 256;          // div table at index_bits <= 4
constexpr int UNR = 2;                  // row steps a loop iteration

struct DecodeParams {
  int Smax, KVH, G, C;
  int chunk;                      // slots a block a round (its scores)
  int tile;                       // rows a stage buffer holds
  int stage_bytes;                // the stage's bytes, then the warps' acc
  long long pos, slot;            // used where the pointer is null
  const void* pos_ptr;            // (B,) int32 / int64, or null
  const void* slot_ptr;
  long long pos_stride, slot_stride;
  int pos_is64, slot_is64;
  int ring_full, window, approx_div;
  float scale, lim;
  LaneCfg cfg;
};

template <typename T>
struct Vec;
// f32: 4 values a 16-byte vector
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
// bf16: 8 values a 16-byte vector
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ long long read_index(const void* ptr, int is64,
                                                long long stride, int b,
                                                long long scalar) {
  if (ptr == nullptr) return scalar;
  const long long i = static_cast<long long>(b) * stride;
  return is64 ? static_cast<const long long*>(ptr)[i]
              : static_cast<long long>(static_cast<const int*>(ptr)[i]);
}

__device__ __forceinline__ int clamp_ll(long long x, long long lo,
                                        long long hi) {
  return static_cast<int>(x < lo ? lo : (x > hi ? hi : x));
}

// the least power of two >= n
__host__ __device__ constexpr int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// GM: the register arrays' size, G <= GM (1, 2, 4 or 8); L: the divider's
// lane word (uint32_t, or uint64_t at width 32).
template <typename T, int DH, int GM, typename L>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const T* __restrict__ kn,
                            const T* __restrict__ vn, T* __restrict__ o,
                            const int* __restrict__ tab, int tab_len,
                            DecodeParams p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = DH / VEC;   // a cache row's 16-byte pieces
  // lanes a row takes in a warp: LPR, rounded up to a power of two so that
  // a row's lanes meet by xor shuffles. At d_head 64 / 128 that is LPR
  // itself; at 80 (10 pieces in bf16, 20 in f32) lanes LPR..LP-1 of a row
  // idle: they hold zeros, load nothing and store nothing
  constexpr int LP = pow2_ceil(LPR);
  constexpr int RPW = 32 / LP;    // rows a warp step
  constexpr int RPB = NW * RPW;   // rows a block step
  // finalize: outputs a lane, the last of them guarded where 32 does not
  // divide DH (80: 3 a lane, lanes 16..31 idle in the third)
  constexpr int DPL = (DH + 31) / 32;
  constexpr bool kWholeLanes = DH % 32 == 0;
  static_assert(DH % VEC == 0 && LP <= 32, "a row is at most a warp");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sQ[GM * DH];
  __shared__ float sKn[DH], sVn[DH];
  __shared__ float sAcc[GM * DH];   // the block's partial acc (cluster-read)
  __shared__ float sL[GM];          // the block's partial l (cluster-read)
  __shared__ float sMx[2][GM];      // the block's max a round, by parity
  __shared__ float sM[GM], sC[GM], sSelf[GM];
  __shared__ float sPart[NW][GM];
  __shared__ int s_tab[kDivTable];
  // read at the start: the load of the register overlaps the kernel
  const bool faults = simdive::lane_faults_armed();

  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x / C;
  const int b = row / p.KVH, kvh = row % p.KVH;
  const int G = p.G, CH = p.chunk, TR = p.tile;
  const long long bk = static_cast<long long>(b) * p.KVH + kvh;
  const T* qb = q + bk * G * DH;
  const T* knb = kn + bk * DH;
  const T* vnb = vn + bk * DH;
  const long long rs = static_cast<long long>(p.KVH) * DH;  // slot stride
  const T* kb = kc + static_cast<long long>(b) * p.Smax * rs + kvh * DH;
  const T* vb = vc + static_cast<long long>(b) * p.Smax * rs + kvh * DH;
  // two stage buffers of TR rows, packed DH values a row; the scores after
  auto stage = [&](int i) {
    return reinterpret_cast<T*>(smem) + (i & 1) * TR * DH;
  };
  float* const sS = reinterpret_cast<float*>(smem + p.stage_bytes);

  // this row's history: [lo, hi) minus the slot being replaced; the same in
  // every rank of the cluster, so every rank runs the same rounds
  const long long P =
      read_index(p.pos_ptr, p.pos_is64, p.pos_stride, b, p.pos);
  int lo = 0, hi, skip = -1;
  if (p.ring_full && P >= p.Smax) {
    // wrapped ring: every slot but the one the new token takes
    hi = p.Smax;
    const long long S =
        read_index(p.slot_ptr, p.slot_is64, p.slot_stride, b, p.slot);
    if (S >= 0 && S < p.Smax) skip = static_cast<int>(S);
  } else {
    hi = clamp_ll(P, 0, p.Smax);
    if (!p.ring_full && p.window > 0 && p.Smax > p.window)
      lo = clamp_ll(P - p.window + 1, 0, hi);
  }

  // a round's share: rank_range(base, rh, rank, C) = [a, a + n) in nt
  // tiles; its loads: k tiles 0..nt-1, then v tiles nt..2nt-1, load i into
  // stage(i), one commit group each, at most two in flight
  const int span = C * CH;
  int a = 0, n = 0, nt = 0;
  auto share = [&](int base) {
    const int rh = min(hi, base + span), m = rh - base;
    a = base + static_cast<int>(static_cast<long long>(m) * rank / C);
    n = base + static_cast<int>(static_cast<long long>(m) * (rank + 1) / C) - a;
    nt = (n + TR - 1) / TR;
  };
  auto issue = [&](int i) {
    const bool is_k = i < nt;
    const int r0 = (is_k ? i : i - nt) * TR, rows = min(TR, n - r0);
    const T* src = (is_k ? kb : vb) + static_cast<long long>(a + r0) * rs;
    T* dst = stage(i);
    for (int c = tid; c < rows * LPR; c += NT) {
      const int r = c / LPR, piece = (c % LPR) * VEC;
      simdive::cp_async16(dst + r * DH + piece, src + r * rs + piece, 16);
    }
    simdive::cp_async_commit();
  };
  auto start_round = [&](int base) {  // the share's first two loads fly
    share(base);
    if (nt > 0) {
      issue(0);
      issue(1);
    }
  };
  // load i landed in stage(i), for every thread of the block
  auto land = [&](int i) {
    simdive::cp_async_wait(i + 1 < 2 * nt ? 1 : 0);
    __syncthreads();
  };
  // load i consumed: its buffer takes load i + 2
  auto consumed = [&](int i) {
    __syncthreads();
    if (i + 2 < 2 * nt) issue(i + 2);
  };

  // q, k_new, v_new and the table are loaded into registers first, so
  // that they lead the memory queue; the first round's k and v follow
  constexpr int QPT = (GM * DH + NT - 1) / NT;
  static_assert(DH <= NT && kDivTable <= 2 * NT, "one pass of loads");
  const bool finalizes = rank < G;  // the combine gives this rank a head
  T qv[QPT], knv = from_f32<T>(0.0f), vnv = from_f32<T>(0.0f);
  int tv[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * NT;
    qv[k] = i < G * DH ? qb[i] : from_f32<T>(0.0f);
  }
  if (tid < DH) {
    knv = knb[tid];
    vnv = vnb[tid];
  }
  if (p.approx_div && finalizes) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tid + k * NT < tab_len) tv[k] = tab[tid + k * NT];
  }
  if (lo < hi) start_round(lo);
#pragma unroll
  for (int k = 0; k < QPT; ++k)
    if (tid + k * NT < G * DH) sQ[tid + k * NT] = to_f32(qv[k]);
  if (tid < DH) {
    sKn[tid] = to_f32(knv);
    sVn[tid] = to_f32(vnv);
  }
  if (p.approx_div && finalizes) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tid + k * NT < tab_len) s_tab[tid + k * NT] = tv[k];
  }
  __syncthreads();

  // the self term's score seeds the running max, the same in every rank;
  // l counts this block's share only (the combine adds the self term once)
  for (int g = warp; g < G; g += NW) {
    float part = 0.0f;
    for (int d = lane; d < DH; d += 32)
      part = fmaf(sQ[g * DH + d], sKn[d], part);
    part = warp_sum(part);
    if (lane == 0) {
      sSelf[g] = part * p.scale;
      sM[g] = part * p.scale;
      sL[g] = 0.0f;
    }
  }
  // (sSelf / sM / sL are first read after the barriers below)

  const int rl = lane % LP, rp = lane / LP;
  const bool live = rl < LPR;  // the lane holds a piece of the row
  const int d0 = rl * VEC;
  float acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.0f;

  int par = 0;
  for (int base = lo; base < hi; base += span, par ^= 1) {
    if (base != lo) start_round(base);
    // (1) scores of the share, tile by tile; the block's max a head
    float qr[GM][VEC], mx[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      mx[g] = -INFINITY;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        qr[g][j] = g < G && live ? sQ[g * DH + d0 + j] : 0.0f;
    }
    for (int t = 0; t < nt; ++t) {
      land(t);
      const T* tb = stage(t);
      const int r0 = t * TR, rows = min(TR, n - r0);
      // UNR row steps a loop, their chains interleaved
      for (int rb = warp * RPW; rb < rows; rb += UNR * RPB) {  // warp-uniform
        float kv[UNR][VEC], s[UNR][GM];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int r = rb + u * RPB + rp;
          if (r < rows && live) {
            Vec<T>::load(tb + r * DH + d0, kv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) kv[u][j] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            s[u][g] = 0.0f;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              s[u][g] = fmaf(qr[g][j], kv[u][j], s[u][g]);
          }
#pragma unroll
        for (int off = LP / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < UNR; ++u)
#pragma unroll
            for (int g = 0; g < GM; ++g)
              s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int r = rb + u * RPB + rp;
          if (r < rows) {
            const bool masked = a + r0 + r == skip;
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              if (g < G) {
                const float v = masked ? -INFINITY : s[u][g] * p.scale;
                mx[g] = fmaxf(mx[g], v);
                if (rl == 0) sS[g * CH + r0 + r] = v;
              }
            }
          }
        }
      }
      consumed(t);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m = warp_max(mx[g]);
      if (lane == 0 && g < G) sPart[warp][g] = m;
    }
    __syncthreads();
    if (tid < G) {
      float m = sPart[0][tid];
      for (int w = 1; w < NW; ++w) m = fmaxf(m, sPart[w][tid]);
      sMx[par][tid] = m;
    }
    cluster.sync();  // every rank's max of this round visible

    // (2) the round's cluster-wide max; p = exp(s - m) rounded to the
    // cache's type; this block's share of l
    if (tid < G) {
      float mr[kMaxCluster];  // every rank's load in flight at once
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        mr[r] = r < C ? cluster.map_shared_rank(&sMx[par][0], r)[tid]
                      : -INFINITY;
      float m = mr[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) m = fmaxf(m, mr[r]);
      const float m_old = sM[tid];
      const float m_new = fmaxf(m_old, m);  // finite: starts at the self term
      sC[tid] = expf(m_old - m_new);
      sM[tid] = m_new;
    }
    __syncthreads();
    float sum[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sum[g] = 0.0f;
    for (int r = tid; r < n; r += NT) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float* e = sS + g * CH + r;
          const float x = expf(*e - sM[g]);
          sum[g] += x;
          *e = to_f32(from_f32<T>(x));  // p rounded to the cache's type
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float s = warp_sum(sum[g]);
      if (lane == 0 && g < G) sPart[warp][g] = s;
    }
    __syncthreads();  // p and the warps' sums written
    if (tid < G) {
      float s = sPart[0][tid];
      for (int w = 1; w < NW; ++w) s += sPart[w][tid];
      sL[tid] = sL[tid] * sC[tid] + s;
    }

    // (3) acc = acc * exp(m_old - m_new) + p . V, tile by tile
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float c = g < G ? sC[g] : 1.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= c;
    }
    for (int t = 0; t < nt; ++t) {
      land(nt + t);
      const T* tb = stage(nt + t);
      const int r0 = t * TR, rows = min(TR, n - r0);
      for (int rb = warp * RPW + rp; rb < rows; rb += UNR * RPB) {
        float vv[UNR][VEC], pg[UNR][GM];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int r = rb + u * RPB;
          if (r < rows) {
            if (live) {
              Vec<T>::load(tb + r * DH + d0, vv[u]);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) vv[u][j] = 0.0f;
            }
#pragma unroll
            for (int g = 0; g < GM; ++g)
              pg[u][g] = g < G ? sS[g * CH + r0 + r] : 0.0f;
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) vv[u][j] = 0.0f;
#pragma unroll
            for (int g = 0; g < GM; ++g) pg[u][g] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[g][j] = fmaf(pg[u][g], vv[u][j], acc[g][j]);
      }
      consumed(nt + t);
    }
    __syncthreads();  // sPart / sS free for the next round
  }

  // the row positions of a warp meet by shuffles, the warps in shared
  // memory (the stage, free now), then the block's partial acc in sAcc
#pragma unroll
  for (int off = LP; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
  float* const sRed = reinterpret_cast<float*>(smem);
  if (rp == 0 && live)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          sRed[(warp * GM + g) * DH + d0 + j] = acc[g][j];
  __syncthreads();
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    float s = sRed[g * DH + d];
    for (int w = 1; w < NW; ++w) s += sRed[(w * GM + g) * DH + d];
    sAcc[i] = s;
  }
  cluster.sync();  // every rank's sAcc / sL visible

  // the combine, one warp a head, heads spread over the ranks: the ranks'
  // partials in rank order, the self term, the finalize
  for (int g = rank + C * warp; g < G; g += C * NW) {
    float xr[kMaxCluster][DPL], lr[kMaxCluster];  // all loads in flight
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float* ra = cluster.map_shared_rank(sAcc, r);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          xr[r][i] = kWholeLanes || lane + 32 * i < DH
                         ? ra[g * DH + lane + 32 * i]
                         : 0.0f;
        lr[r] = cluster.map_shared_rank(sL, r)[g];
      }
    }
    float x[DPL], l = lr[0];
#pragma unroll
    for (int i = 0; i < DPL; ++i) x[i] = xr[0][i];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < C) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) x[i] += xr[r][i];
        l += lr[r];
      }
    }
    const float ps = expf(sSelf[g] - sM[g]);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (kWholeLanes || lane + 32 * i < DH) x[i] += ps * sVn[lane + 32 * i];
    l += ps;
    T* orow = o + (bk * G + g) * DH;
    if (p.approx_div) {
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) amax = fmaxf(amax, fabsf(x[i]));
      const simdive::RowQuant<L> rq = simdive::softmax_row_quant<L>(
          warp_max(amax), l, p.cfg.width, p.lim);
      if (faults) {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (kWholeLanes || lane + 32 * i < DH)
            orow[lane + 32 * i] =
                from_f32<T>(simdive::softmax_div_elem<true, L>(
                    x[i], rq, s_tab, p.cfg, p.lim, nullptr));
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (kWholeLanes || lane + 32 * i < DH)
            orow[lane + 32 * i] = from_f32<T>(
                simdive::softmax_div_elem<false, L>(x[i], rq, s_tab, p.cfg,
                                                    p.lim, nullptr));
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (kWholeLanes || lane + 32 * i < DH)
          orow[lane + 32 * i] = from_f32<T>(x[i] / l);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Tag<T>, Int<DH>, Int<GM>) for the instantiation serving (dtype, dh, G)
template <typename T, int DH, typename F>
int by_group(int G, F& f) {
  if (G <= 1) return f(Tag<T>{}, Int<DH>{}, Int<1>{});
  if (G <= 2) return f(Tag<T>{}, Int<DH>{}, Int<2>{});
  if (G <= 4) return f(Tag<T>{}, Int<DH>{}, Int<4>{});
  return f(Tag<T>{}, Int<DH>{}, Int<8>{});
}
template <typename F>
int dispatch(int dtype, int dh, int G, F&& f) {
  if (dtype == 0 && dh == 64) return by_group<float, 64>(G, f);
  if (dtype == 0 && dh == 80) return by_group<float, 80>(G, f);
  if (dtype == 0 && dh == 128) return by_group<float, 128>(G, f);
  if (dtype == 1 && dh == 64) return by_group<bf16, 64>(G, f);
  if (dtype == 1 && dh == 80) return by_group<bf16, 80>(G, f);
  if (dtype == 1 && dh == 128) return by_group<bf16, 128>(G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan: chunk = slots a block a round (a history of up to
// C * chunk slots is one round), tile = rows a stage buffer holds, and the
// dynamic shared memory: the two stage buffers (also the warps' acc at the
// end) and the scores.
struct Plan {
  int chunk, tile, stage_bytes;
  size_t smem;
};
Plan make_plan(int Smax, int G, int GM, int C, int dh, int itemsize) {
  Plan pl;
  pl.chunk = std::min(kScoreFloats / G, (Smax + C - 1) / C);
  const int row_bytes = dh * itemsize;
  pl.tile = std::min(pl.chunk, kStageBytes / (2 * row_bytes));
  pl.stage_bytes = std::max(2 * pl.tile * row_bytes, NW * GM * dh * 4);
  pl.smem = static_cast<size_t>(pl.stage_bytes) +
            static_cast<size_t>(G) * pl.chunk * sizeof(float);
  return pl;
}

// Opt the instantiation in to > 48 KB of dynamic shared memory, up to the
// largest size it has been asked for.
template <typename T, int DH, int GM, typename L>
cudaError_t opt_in(size_t smem) {
  static size_t opted = 48 * 1024;
  if (smem <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<T, DH, GM, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) opted = smem;
  return e;
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int C, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The launch entry for lane word L (see simdive_decode_attention).
template <typename L>
int decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, void* o, const void* tab, int tab_len, int B, int Smax,
    int KVH, int G, int dh, int dtype, int cluster, long long pos,
    const void* pos_ptr, int pos_is64, long long pos_stride, long long slot,
    const void* slot_ptr, int slot_is64, long long slot_stride, int ring_full,
    int window, int approx_div, float scale, int width, int index_bits,
    int frac_out, int round_out, float lim, void* stream) {
  if (B <= 0 || KVH <= 0) return 0;
  const long long blocks = static_cast<long long>(B) * KVH * cluster;
  if (G < 1 || G > kMaxG || Smax < 1 || tab_len > kDivTable || window < 0 ||
      cluster < 1 || cluster > kMaxCluster || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  p.Smax = Smax;
  p.KVH = KVH;
  p.G = G;
  p.C = cluster;
  p.pos = pos;
  p.slot = slot;
  p.pos_ptr = pos_ptr;
  p.slot_ptr = slot_ptr;
  p.pos_stride = pos_stride;
  p.slot_stride = slot_stride;
  p.pos_is64 = pos_is64;
  p.slot_is64 = slot_is64;
  p.ring_full = ring_full;
  p.window = window;
  p.approx_div = approx_div;
  p.scale = scale;
  p.lim = lim;
  p.cfg = LaneCfg{width, index_bits, frac_out, round_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, dh, G, [&](auto tag, auto dhc, auto gm) {
    using T = typename decltype(tag)::type;
    constexpr int DH = decltype(dhc)::value, GM = decltype(gm)::value;
    auto kern = decode_attention_kernel<T, DH, GM, L>;
    const Plan pl = make_plan(Smax, G, GM, cluster, DH, sizeof(T));
    p.chunk = pl.chunk;
    p.tile = pl.tile;
    p.stage_bytes = pl.stage_bytes;
    cudaError_t e = opt_in<T, DH, GM, L>(pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        static_cast<unsigned>(blocks), cluster, pl.smem, s, &attr);
    e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                           static_cast<const T*>(k_cache),
                           static_cast<const T*>(v_cache),
                           static_cast<const T*>(k_new),
                           static_cast<const T*>(v_new), static_cast<T*>(o),
                           static_cast<const int*>(tab), tab_len, p);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}

// How many clusters of `cluster` blocks of the lane-word-L instantiation
// serving (dtype, dh, G) at cache length Smax the card can hold at once
// (cudaOccupancyMaxActiveClusters); -(CUDA error code) on failure.
template <typename L>
int max_clusters(int Smax, int G, int dh, int dtype, int cluster) {
  if (G < 1 || G > kMaxG || Smax < 1 || cluster < 1 || cluster > kMaxCluster)
    return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dh, G, [&](auto tag, auto dhc, auto gm) {
    using T = typename decltype(tag)::type;
    constexpr int DH = decltype(dhc)::value, GM = decltype(gm)::value;
    auto kern = decode_attention_kernel<T, DH, GM, L>;
    const Plan pl = make_plan(Smax, G, GM, cluster, DH, sizeof(T));
    cudaError_t e = opt_in<T, DH, GM, L>(pl.smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        static_cast<unsigned>(cluster), cluster, pl.smem, nullptr, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    return e == cudaSuccess ? n : -static_cast<int>(e);
  });
}

}  // namespace
