// One decode step's attention for Hopper: the scores of one kv head's G
// query heads over a read-only cache, the masks, the new token's self term,
// the softmax, p . V and the finalize (exact divide or the SIMDive divider)
// in one launch.
//
// Replaces no TPU kernel of its own: on the TPU, repro/models/layers.py
// decode_attention_append is plain jnp (one XLA fusion) around one Pallas
// call, the elemwise divider of repro/core/approx.py attention_div
// (repro/kernels/elemwise.py elemwise_pallas). In eager PyTorch the same
// function is ~55 launches a layer (f32 copies of the cache, three batched
// products, masks, max, exp, the quantizer around the elemwise kernel, the
// fold back); here it is one. The plain version it must equal is
// repro_torch/kernels/decode_attention.py decode_attention_ref, the body
// of repro_torch/models/layers.py decode_attention_append.
//
// Contract: q (B, KVH, G, dh); caches (B, Smax, KVH, dh), contiguous and
// 16-byte aligned; k_new / v_new (B, 1, KVH, dh); all f32 or all bf16 ->
// o (B, KVH, G, dh) in the same type. dh 64 or 128, G <= kMaxG. pos / slot
// are each a scalar argument or a (B,) int32 / int64 device array read by
// the block of each batch row, so neither costs a launch or a host sync.
//
// Bound on an H100: bytes. The work is the valid cache slots' k and v rows
// (read once) against 4 * G * dh flops a slot; at the serving shape (batch
// 4, 5 kv heads, G 3, dh 64, bf16, ~528 valid slots) that is ~2.7 MB,
// ~0.8 us at 3.35 TB/s, far under what one launch costs: the kernel is
// launch-latency bound, and replaces ~55 launches a layer with one.
//
// Design: one block of 8 warps per (b, kv head), 20 blocks at the serving
// shape. The history is walked in chunks of kScoreFloats / G slots (one
// chunk up to 2,730 slots at G = 3). Per chunk: (1) scores — a cache row
// is read as 16-byte vectors by DH / VEC lanes, each lane keeping its
// slice of the G q rows in registers; the lanes of a row meet by shuffles,
// and (q . k) * scale lands in shared memory (-inf at a masked slot); (2)
// one warp a head takes the chunk's max, the new running max, exp(s - m),
// the sum l, and p rounded to the cache's type, as the plain version
// rounds p before its PV product; (3) p . V on the same row mapping, each
// lane accumulating G x VEC outputs in registers, rescaled by
// exp(m_old - m_new) first. The running state starts at the self term:
// m = (q . k_new) * scale, l = 1, acc = v_new. So the max is always
// finite (an empty history or an all-masked chunk gives p = 0, never
// exp(-inf + inf)), and with one chunk every p is taken relative to the
// global max exactly as in the plain version: the two differ only in f32
// summation order. The warps then meet in shared memory, and one warp a
// head runs the finalize: the exact divide, or the shared datapath's
// softmax_row_quant / softmax_div_elem with the div table in shared memory
// (the same device functions as flash_attention.cu's epilogue). expf and
// IEEE division throughout, no fast-math intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;
using bf16 = __nv_bfloat16;

constexpr int NW = 8;               // warps a block
constexpr int NT = 32 * NW;         // 256 threads
constexpr int kMaxG = 8;            // q heads a kv head (the wrapper refuses more)
constexpr int kMaxDH = 128;
constexpr int kScoreFloats = 8192;  // a chunk's scores: kScoreFloats / G slots
constexpr int kDivTable = 256;      // div table at index_bits <= 4
constexpr int UNR = 4;              // row steps whose loads are in flight together
static_assert(NW * kMaxG * kMaxDH <= kScoreFloats,
              "the warps' partial sums reuse the score buffer");

struct DecodeParams {
  int Smax, KVH, G, chunk;
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

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const T* __restrict__ kn,
                            const T* __restrict__ vn, T* __restrict__ o,
                            const int* __restrict__ tab, int tab_len,
                            DecodeParams p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = DH / VEC;   // lanes a cache row
  constexpr int RPW = 32 / LPR;   // rows a warp step
  constexpr int RPB = NW * RPW;   // rows a block step
  constexpr int DPL = DH / 32;    // finalize: outputs a lane
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row is a power-of-two lanes");

  __shared__ float sQ[kMaxG * DH];
  __shared__ float sVn[DH];
  // scores, then p, of one chunk; at the end the warps' partial acc
  __shared__ float sS[kScoreFloats];
  __shared__ float sM[kMaxG], sL[kMaxG], sC[kMaxG];
  __shared__ int s_tab[kDivTable];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int G = p.G, CHL = p.chunk;
  const long long bk = static_cast<long long>(b) * p.KVH + kvh;
  const T* qb = q + bk * G * DH;
  const T* knb = kn + bk * DH;
  const T* vnb = vn + bk * DH;
  const long long rs = static_cast<long long>(p.KVH) * DH;  // slot stride
  const T* kb = kc + static_cast<long long>(b) * p.Smax * rs + kvh * DH;
  const T* vb = vc + static_cast<long long>(b) * p.Smax * rs + kvh * DH;

  if (p.approx_div)
    for (int i = tid; i < tab_len; i += NT) s_tab[i] = tab[i];
  for (int i = tid; i < G * DH; i += NT) sQ[i] = to_f32(qb[i]);
  for (int i = tid; i < DH; i += NT) sVn[i] = to_f32(vnb[i]);
  __syncthreads();

  // the self term seeds the running state: m = (q . k_new) * scale, l = 1
  for (int g = warp; g < G; g += NW) {
    float part = 0.0f;
    for (int d = lane; d < DH; d += 32)
      part = fmaf(sQ[g * DH + d], to_f32(knb[d]), part);
    part = warp_sum(part);
    if (lane == 0) {
      sM[g] = part * p.scale;
      sL[g] = 1.0f;
    }
  }

  // this row's history: [lo, hi) minus the slot being replaced
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

  const int rl = lane % LPR, rp = lane / LPR;
  const int d0 = rl * VEC;
  // acc starts at v_new (p_self = 1 relative to m = s_self): one lane group
  // carries it, the others start at zero
  float acc[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[g][j] = (warp == 0 && rp == 0 && g < G) ? sVn[d0 + j] : 0.0f;

  for (int c0 = lo; c0 < hi; c0 += CHL) {
    const int n = min(CHL, hi - c0);
    // (1) scores of this chunk
    {
      float qr[kMaxG][VEC];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          qr[g][j] = g < G ? sQ[g * DH + d0 + j] : 0.0f;
      for (int r0 = warp * RPW; r0 < n; r0 += UNR * RPB) {  // warp-uniform
        float kv[UNR][VEC];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int r = r0 + u * RPB + rp;
          if (r < n) {
            Vec<T>::load(kb + (c0 + r) * rs + d0, kv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) kv[u][j] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (r0 + u * RPB >= n) break;  // warp-uniform
          float s[kMaxG];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            s[g] = 0.0f;
#pragma unroll
            for (int j = 0; j < VEC; ++j) s[g] = fmaf(qr[g][j], kv[u][j], s[g]);
          }
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
          const int r = r0 + u * RPB + rp;
          if (rl == 0 && r < n) {
            const bool masked = c0 + r == skip;
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) sS[g * CHL + r] = masked ? -INFINITY : s[g] * p.scale;
          }
        }
      }
    }
    __syncthreads();  // scores written (and, at the first chunk, sM / sL)

    // (2) one warp a head: running max, p = exp(s - m_new), l, p rounded
    for (int g = warp; g < G; g += NW) {
      float* row = sS + g * CHL;
      const float m_old = sM[g];
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
      // finite: the running max starts at the self term's score
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.0f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(row[r] - m_new);
        sum += e;
        row[r] = to_f32(from_f32<T>(e));  // p rounded to the cache's type
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sC[g] = c;
        sL[g] = sL[g] * c + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * exp(m_old - m_new) + p . V
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float c = g < G ? sC[g] : 1.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= c;
    }
    for (int r0 = warp * RPW; r0 < n; r0 += UNR * RPB) {
      float vv[UNR][VEC];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int r = r0 + u * RPB + rp;
        if (r < n) {
          Vec<T>::load(vb + (c0 + r) * rs + d0, vv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) vv[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int r = r0 + u * RPB + rp;
        if (r >= n) continue;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pg = sS[g * CHL + r];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(pg, vv[u][j], acc[g][j]);
          }
        }
      }
    }
    __syncthreads();  // p read by every warp before the next chunk's scores
  }
  __syncthreads();  // sM / sL visible when the history was empty

  // the row positions of a warp meet by shuffles, the warps in shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
  if (rp == 0)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          sS[(warp * kMaxG + g) * DH + d0 + j] = acc[g][j];
  __syncthreads();

  // finalize, one warp a head: acc / l, exact or on the SIMDive divider
  for (int g = warp; g < G; g += NW) {
    float a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      float sum = sS[g * DH + d];
#pragma unroll
      for (int w = 1; w < NW; ++w) sum += sS[(w * kMaxG + g) * DH + d];
      a[i] = sum;
    }
    T* orow = o + (bk * G + g) * DH;
    const float l = sL[g];
    if (p.approx_div) {
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) amax = fmaxf(amax, fabsf(a[i]));
      const simdive::RowQuant rq =
          simdive::softmax_row_quant(warp_max(amax), l, p.cfg.width, p.lim);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        orow[lane + 32 * i] = from_f32<T>(simdive::softmax_div_elem(
            a[i], rq, s_tab, p.cfg, p.lim, nullptr));
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = from_f32<T>(a[i] / l);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const void* kn,
           const void* vn, void* o, const void* tab, int tab_len, int blocks,
           const DecodeParams& p, cudaStream_t stream) {
  decode_attention_kernel<T, DH><<<blocks, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(o),
      static_cast<const int*>(tab), tab_len, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh 64 or 128; 1 <= G <= 8. q, k_new,
// v_new and o contiguous; the caches contiguous and 16-byte aligned. pos /
// slot: the scalar, or a (B,) int32 (is64 = 0) / int64 (is64 = 1) device
// array read at b * stride when its pointer is not null. Returns
// cudaGetLastError() of the launch.
extern "C" int simdive_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, void* o, const void* tab, int tab_len, int B, int Smax,
    int KVH, int G, int dh, int dtype, long long pos, const void* pos_ptr,
    int pos_is64, long long pos_stride, long long slot, const void* slot_ptr,
    int slot_is64, long long slot_stride, int ring_full, int window,
    int approx_div, float scale, int width, int index_bits, int frac_out,
    int round_out, float lim, void* stream) {
  if (B <= 0 || KVH <= 0) return 0;
  const long long blocks = static_cast<long long>(B) * KVH;
  if (G < 1 || G > kMaxG || Smax < 1 || tab_len > kDivTable || window < 0 ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p;
  p.Smax = Smax;
  p.KVH = KVH;
  p.G = G;
  p.chunk = kScoreFloats / G;
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
  const int nb = static_cast<int>(blocks);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k_cache, v_cache, k_new, v_new, o, tab,
                             tab_len, nb, p, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k_cache, v_cache, k_new, v_new, o, tab,
                              tab_len, nb, p, s);
  if (dtype == 1 && dh == 64)
    return launch<bf16, 64>(q, k_cache, v_cache, k_new, v_new, o, tab,
                            tab_len, nb, p, s);
  if (dtype == 1 && dh == 128)
    return launch<bf16, 128>(q, k_cache, v_cache, k_new, v_new, o, tab,
                             tab_len, nb, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
