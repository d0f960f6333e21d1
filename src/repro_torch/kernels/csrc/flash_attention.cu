// Online-softmax flash attention with the SIMDive divider in its finalize,
// for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_kernel /
// flash_attention_pallas, the depth-0 schedule): q (BH, Sq, dh), k and v
// (BH / kv_group, Skv, dh), f32 or bf16 -> o (BH, Sq, dh) in q's type, with
// causal / sliding-window / kv_len masks and a q_offset. The final acc / l
// is either an exact divide or, per row, a shared-exponent quantization into
// width-bit lanes and simdive::lane_div from the shared datapath header.
//
// What the TPU kernel carries from one sequential grid step to the next in
// scratch memory (m, l, acc) lives here in registers across a loop over kv
// tiles inside the block; one block owns one (bh, 64-row q tile). The QK^T
// and PV products are computed in this kernel's body with FMA loops over
// shared-memory tiles held in f32 (a bf16 x bf16 product is exact in f32, so
// this equals tensor-core accumulation up to summation order); p is rounded
// to v's type before the PV product as the reference does. kv tiles that the
// causal / window / kv_len masks exclude whole are skipped: for those the
// reference's step leaves (m, l, acc) unchanged up to its masked-row guard.
// GQA: kv is read at head bh / kv_group; no repeated copy is materialised.
//
// Bound on an H100: bytes, narrowly. At the serving shape (q BH 60, kv heads
// 20, S 512, dh 64, bf16, causal) the kernel needs 4*dh per causal (q, k)
// pair = 2.0 GFLOP, 0.0020 ms at the bf16 tensor-core peak, against 10.5 MB
// of q/k/v/o traffic (kv read once per kv head, not per q head), 0.0031 ms
// at the HBM rate. This first version is far from either: it runs the
// products as f32 FMAs on the CUDA cores from padded (conflict-free)
// shared-memory tiles, 4x4 register micro-tiles per thread; mma/wgmma and
// an asynchronous kv ring are the later steps toward the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int TX = 16;        // threads across a tile's columns
constexpr int TY = 16;        // threads across a tile's rows
constexpr int NT = TX * TY;   // 256 threads
constexpr int RPT = BQ / TY;  // rows per thread (4)
constexpr int CPT = BK / TX;  // score columns per thread (4)
constexpr int kDivTable = 256;  // div table at index_bits <= 4

struct AttnParams {
  int Sq, Skv, kv_len, q_offset, causal, window, approx_div, kv_group, nq;
  float scale, lim;
  LaneCfg cfg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ tab, int tab_len, AttnParams p) {
  constexpr int QS = DH + 1;     // padded strides: conflict-free row reads
  constexpr int PS = BK + 1;
  constexpr int DPT = DH / TX;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][QS]
  float* sK = sQ + BQ * QS;      // [BK][QS]
  float* sV = sK + BK * QS;      // [BK][DH]
  float* sP = sV + BK * DH;      // [BQ][PS]
  __shared__ int s_tab[kDivTable];

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
  const int kj_hi = (k_end + BK - 1) / BK;  // exclusive; <= 0 when empty

  for (int kj = kj_lo; kj < kj_hi; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();  // previous tile fully consumed (and sQ/s_tab written)
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < p.Skv;
      const long long g = static_cast<long long>(k0 + r) * DH + c;
      sK[r * QS + c] = in ? to_f32(kb[g]) : 0.0f;
      sV[r * DH + c] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

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
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(j * TX + tx) * QS + d];
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
      for (int c = 0; c < DPT; ++c) vv[c] = sV[t * DH + c * TX + tx];
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
      const simdive::RowQuant rq =
          simdive::softmax_row_quant(amax, li, p.cfg.width, p.lim);
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        outv[c] = simdive::softmax_div_elem(acc[i][c], rq, s_tab, p.cfg, p.lim,
                                            nullptr);
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

template <typename T, int DH>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const void* tab, int tab_len, int BH, const AttnParams& p,
                 cudaStream_t stream) {
  static bool configured = false;  // opt in to > 48 KB dynamic shared memory
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<DH>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const unsigned blocks = static_cast<unsigned>(BH) * p.nq;
  flash_kernel<T, DH><<<blocks, NT, smem_bytes<DH>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(tab), tab_len, p);
  return static_cast<int>(cudaGetLastError());
}

// The finalize alone, on given (acc, l): one warp per row. A hook for
// holding the in-kernel divider bit-equal to its plain version.
__global__ void softmax_div_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ l,
                                   float* __restrict__ out,
                                   uint32_t* __restrict__ quot, int rows,
                                   int dh, const int* __restrict__ tab,
                                   int tab_len, LaneCfg cfg, float lim) {
  __shared__ int s_tab[kDivTable];
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
  const simdive::RowQuant rq =
      simdive::softmax_row_quant(amax, l[row], cfg.width, lim);
  for (int c = lane; c < dh; c += 32) {
    uint32_t qq;
    out[static_cast<long long>(row) * dh + c] =
        simdive::softmax_div_elem(arow[c], rq, s_tab, cfg, lim, &qq);
    quot[static_cast<long long>(row) * dh + c] = qq;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh must be 64 or 128. All tensors
// contiguous. Returns cudaGetLastError() of the launch (or the error of the
// shared-memory opt-in).
extern "C" int simdive_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (tab_len > kDivTable || kv_group <= 0 || Skv < 0)
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
  if (dtype == 0 && dh == 64)
    return launch_flash<float, 64>(q, k, v, o, tab, tab_len, BH, p, s);
  if (dtype == 0 && dh == 128)
    return launch_flash<float, 128>(q, k, v, o, tab, tab_len, BH, p, s);
  if (dtype == 1 && dh == 64)
    return launch_flash<__nv_bfloat16, 64>(q, k, v, o, tab, tab_len, BH, p, s);
  if (dtype == 1 && dh == 128)
    return launch_flash<__nv_bfloat16, 128>(q, k, v, o, tab, tab_len, BH, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// acc (rows, dh) f32, l (rows,) f32 -> out (rows, dh) f32 and the raw
// quotient lanes quot (rows, dh) uint32.
extern "C" int simdive_softmax_div(const void* acc, const void* l, void* out,
                                   void* quot, int rows, int dh,
                                   const void* tab, int tab_len, int width,
                                   int index_bits, int frac_out, int round_out,
                                   float lim, void* stream) {
  if (rows <= 0 || dh <= 0) return 0;
  if (tab_len > kDivTable) return static_cast<int>(cudaErrorInvalidValue);
  const LaneCfg cfg{width, index_bits, frac_out, round_out};
  const int warps = 4;
  const unsigned blocks = (rows + warps - 1) / warps;
  softmax_div_kernel<<<blocks, warps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(l),
      static_cast<float*>(out), static_cast<uint32_t*>(quot), rows, dh,
      static_cast<const int*>(tab), tab_len, cfg, lim);
  return static_cast<int>(cudaGetLastError());
}
