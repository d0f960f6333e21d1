// Online-softmax flash attention with the SIMDive divider in its finalize,
// for Hopper: a depth-0 schedule and a cp.async kv-ring schedule.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _kernel
// (flash_attention_pallas, the depth-0 schedule, kv tiles streamed by the
// grid) and _kernel_pipelined (the depth-D schedule, k/v left in HBM and
// copied through a D-slot ring by the kernel itself). Both are
// instantiations of one kernel template here (PIPE), selected by the
// block's 3rd component. q (BH, Sq, dh), k and v (BH / kv_group, Skv, dh),
// f32 or bf16 -> o (BH, Sq, dh) in q's type, with causal / sliding-window /
// kv_len masks and a q_offset. The final acc / l is either an exact divide
// or, per row, a shared-exponent quantization into width-bit lanes and
// simdive::lane_div from the shared datapath header.
//
// What the TPU kernel carries from one sequential grid step to the next in
// scratch memory (m, l, acc) lives here in registers across a loop over kv
// tiles inside the block; one block owns one (bh, 64-row q tile). The QK^T
// and PV products are computed in this kernel's body with FMA loops over
// shared-memory tiles read as f32 (a bf16 x bf16 product is exact in f32, so
// this equals tensor-core accumulation up to summation order); p is rounded
// to v's type before the PV product as the reference does. kv tiles that the
// causal / window / kv_len masks exclude whole are skipped: for those the
// reference's step leaves (m, l, acc) unchanged up to its masked-row guard.
// GQA: kv is read at head bh / kv_group; no repeated copy is materialised.
//
// Schedules. Depth 0 loads each kv tile synchronously (global -> f32 ->
// shared memory) between two barriers. Depth D >= 1 issues k/v tiles with
// 4-byte cp.async into a D-slot ring of raw T rows (zero fill past Skv,
// never an out-of-bounds address) and converts them to f32 when read: the
// warm-up issues tiles 0..D-2, step c issues tile c+D-1 into the slot tile
// c-1 vacated, waits for tile c, computes — the reference's DMA order. Both
// visit the same kv tiles in the same order and run the same float ops on
// the same values (bf16 -> f32 is exact), so every depth is bit-identical
// to depth 0, as the reference requires of its schedules.
//
// Blocks. The tile is compiled: 64 q rows x 64 kv rows, 256 threads, each
// holding a 4 x 4 score micro-tile. The reference's TPU blocks (256..1024
// rows, VMEM of many MB) do not fit an SM: one 512 x 512 f32 score tile
// alone is 1 MB against 227 KB of shared memory. A block is (64, 64) or
// (64, 64, D) with D <= 4 (cp.async.wait_group takes an immediate); the
// ring's shared memory grows with D, dtype and d_head
// (kernels/flash_attention.py smem_bytes mirrors smem_bytes_pipe below):
// f32 at d_head 128 fits D <= 2 only.
//
// Bound on an H100: bytes, narrowly. At the serving shape (q BH 60, kv heads
// 20, S 512, dh 64, bf16, causal) the kernel needs 4*dh per causal (q, k)
// pair = 2.0 GFLOP, 0.0020 ms at the bf16 tensor-core peak, against 10.5 MB
// of q/k/v/o traffic (kv read once per kv head, not per q head), 0.0031 ms
// at the HBM rate. This version is far from either: it runs the products as
// f32 FMAs on the CUDA cores from padded (conflict-free) shared-memory
// tiles, 4x4 register micro-tiles per thread; mma/wgmma on the tensor cores
// is a later performance step.
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

template <typename T, int DH, bool PIPE>
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

template <typename T, int DH, bool PIPE>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const void* tab, int tab_len, int BH, const AttnParams& p,
                 int depth, cudaStream_t stream) {
  auto kern = flash_kernel<T, DH, PIPE>;
  const size_t smem = PIPE ? smem_bytes_pipe<T, DH>(depth) : smem_bytes<DH>();
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
  kern<<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(tab), tab_len, p, depth);
  return static_cast<int>(cudaGetLastError());
}

template <bool PIPE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const void* tab, int tab_len, int BH, int dh, int dtype,
             const AttnParams& p, int depth, cudaStream_t s) {
  if (dtype == 0 && dh == 64)
    return launch_flash<float, 64, PIPE>(q, k, v, o, tab, tab_len, BH, p,
                                         depth, s);
  if (dtype == 0 && dh == 128)
    return launch_flash<float, 128, PIPE>(q, k, v, o, tab, tab_len, BH, p,
                                          depth, s);
  if (dtype == 1 && dh == 64)
    return launch_flash<__nv_bfloat16, 64, PIPE>(q, k, v, o, tab, tab_len,
                                                 BH, p, depth, s);
  if (dtype == 1 && dh == 128)
    return launch_flash<__nv_bfloat16, 128, PIPE>(q, k, v, o, tab, tab_len,
                                                  BH, p, depth, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// Both schedules' entry: check the arguments, fill the parameters, launch
// the instantiation for (dtype, d_head, depth > 0).
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
  return depth ? dispatch<true>(q, k, v, o, tab, tab_len, BH, dh, dtype, p,
                                depth, s)
               : dispatch<false>(q, k, v, o, tab, tab_len, BH, dh, dtype, p,
                                 0, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh must be 64 or 128. All tensors
// contiguous. Returns cudaGetLastError() of the launch (or the error of the
// shared-memory opt-in). The depth-0 schedule.
extern "C" int simdive_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, void* stream) {
  return attention(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh, dtype,
                   kv_group, kv_len, q_offset, causal, window, approx_div,
                   scale, width, index_bits, frac_out, round_out, lim, 0,
                   stream);
}

// The same arguments, plus the ring depth 1..4: the cp.async kv-ring
// schedule. k and v must be 4-byte aligned (the wrapper checks).
extern "C" int simdive_flash_attention_pipelined(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, int depth, void* stream) {
  if (depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  return attention(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh, dtype,
                   kv_group, kv_len, q_offset, causal, window, approx_div,
                   scale, width, index_bits, frac_out, round_out, lim, depth,
                   stream);
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
