// Fused SIMDive element-wise multiplier / divider / mixed unit for Hopper.
//
// Replaces the TPU kernel repro/kernels/elemwise.py (_kernel /
// elemwise_pallas): one pass per lane through LOD -> log -> region
// correction -> ternary add -> anti-log, for op in {mul, div, mixed}.
//
// Bound on an H100: memory. Each lane moves 12 bytes of device memory (two
// uint32 reads, one uint32 write; 16 with a mode operand) against a few
// dozen integer operations, so the least time is bytes / 3.35 TB/s. At
// width 32 the lanes are 8 bytes (the reference's uint64: the 64-bit
// product bus), 24 bytes a lane (28 with the uint32 mode operand). At
// small shapes (the decode finalize's 3840 lanes = 46 KB: ~14 ns) the
// kernel is launch-latency bound; so the decode step's divider now runs
// fused into decode_attention.cu, and this kernel serves the error sweeps
// (tuning.frontier.measure_error) and simdive_elemwise.
//
// Design: one thread per 16 bytes of consecutive lanes (four uint32 lanes,
// or two uint64 lanes at width 32) with 16-byte loads and stores (the
// wrapper guarantees 16-byte aligned, contiguous operands), a scalar path
// for the ragged tail masked in-kernel (no pad-to-block copies as on the
// TPU), and the 64..512-entry coefficient table staged once per block into
// shared memory. The lane word is a template parameter (U = uint32_t or
// uint64_t) over the one datapath of simdive_datapath.cuh; the entries
// pick it from the width. The width-32 forms are few (three ops and the
// square root, each with and without faults) and share this source.
//
// sqrt_kernel, below, replaces no TPU kernel: the reference computes its
// log-domain square root (repro/core/simdive.py simdive_sqrt) in jnp and
// registers the op for its oracle alone. It is here so that the approximate
// RMSNorm's sqrt (core/approx.py approx_rmsnorm) has a kernel on the card:
// LOD -> log -> L >> 1 -> quotient anti-log with a zero divisor log, no
// correction, no rounding. Bound on an H100: memory, 8 bytes a lane (one
// uint32 read, one written; 16 at width 32) over 3.35 TB/s; at the norm's
// shapes (one lane a row: 2,048 a prefill, 4 a decode step) launch
// latency. The same layout
// as the lane ops, with no table; it shares this source, so the build adds
// no compile unit.
#include <cuda_runtime.h>

#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;
using simdive::lane_op;

// The lanes one thread takes: 16 bytes of U, loaded and stored at once.
template <typename U>
struct alignas(16) LaneVec {
  static constexpr int N = 16 / static_cast<int>(sizeof(U));
  U v[N];
};
// The mixed mode's uint32 words beside N lanes.
template <int N>
struct alignas(4 * N) ModeVec {
  uint32_t v[N];
};

// This thread's lanes from i0 on (a scalar tail past n - N).
template <int OP, bool FAULTS, typename U>
__device__ __forceinline__ void elemwise_lanes(
    const U* __restrict__ a, const U* __restrict__ b,
    const uint32_t* __restrict__ mode, U* __restrict__ out, long long n,
    long long i0, const int* tab, const LaneCfg& cfg) {
  constexpr int N = LaneVec<U>::N;
  if (i0 + N <= n) {
    const LaneVec<U> va = *reinterpret_cast<const LaneVec<U>*>(a + i0);
    const LaneVec<U> vb = *reinterpret_cast<const LaneVec<U>*>(b + i0);
    ModeVec<N> vm = {};
    if (OP == simdive::kOpMixed)
      vm = *reinterpret_cast<const ModeVec<N>*>(mode + i0);
    LaneVec<U> vo;
#pragma unroll
    for (int j = 0; j < N; ++j)
      vo.v[j] = lane_op<OP, FAULTS>(va.v[j], vb.v[j], vm.v[j], tab, cfg);
    *reinterpret_cast<LaneVec<U>*>(out + i0) = vo;
  } else {
    for (long long i = i0; i < n; ++i) {
      const uint32_t m = (OP == simdive::kOpMixed) ? mode[i] : 0u;
      out[i] = lane_op<OP, FAULTS>(a[i], b[i], m, tab, cfg);
    }
  }
}

// The armed path out of line: its calls leave the disarmed path's code and
// registers as they are.
template <int OP, typename U>
__device__ __noinline__ void elemwise_lanes_armed(
    const U* a, const U* b, const uint32_t* mode, U* out, long long n,
    long long i0, const int* tab, LaneCfg cfg) {
  elemwise_lanes<OP, true>(a, b, mode, out, n, i0, tab, cfg);
}

template <int OP, typename U>
__global__ void elemwise_kernel(const U* __restrict__ a,
                                const U* __restrict__ b,
                                const uint32_t* __restrict__ mode,
                                U* __restrict__ out, long long n,
                                const int* __restrict__ tab, int tab_len,
                                LaneCfg cfg) {
  __shared__ int s_tab[simdive::kMaxTable];
  const bool faults = simdive::lane_faults_armed();  // overlaps the staging
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();

  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      LaneVec<U>::N;
  if (i0 >= n) return;
  if (faults)
    elemwise_lanes_armed<OP>(a, b, mode, out, n, i0, s_tab, cfg);
  else
    elemwise_lanes<OP, false>(a, b, mode, out, n, i0, s_tab, cfg);
}

// The square root unit: halve the Mitchell log, then the quotient anti-log
// against a zero divisor log (no correction, no rounding); 0 -> 0, the
// numerator-zero flag. Operands < 2^width.
template <bool FAULTS, typename U>
__device__ __forceinline__ U lane_sqrt(U a, const LaneCfg& c) {
  const U half = simdive::lod_log<FAULTS>(a, c.width - 1) >> 1;
  const U q = simdive::antilog_div<U>(half, U(0), 0, c.width, c.frac_out,
                                      false);
  return a ? q : U(0);
}

template <bool FAULTS, typename U>
__device__ __forceinline__ void sqrt_lanes(const U* __restrict__ a,
                                           U* __restrict__ out, long long n,
                                           long long i0, const LaneCfg& cfg) {
  constexpr int N = LaneVec<U>::N;
  if (i0 + N <= n) {
    const LaneVec<U> va = *reinterpret_cast<const LaneVec<U>*>(a + i0);
    LaneVec<U> vo;
#pragma unroll
    for (int j = 0; j < N; ++j) vo.v[j] = lane_sqrt<FAULTS>(va.v[j], cfg);
    *reinterpret_cast<LaneVec<U>*>(out + i0) = vo;
  } else {
    for (long long i = i0; i < n; ++i) out[i] = lane_sqrt<FAULTS>(a[i], cfg);
  }
}

template <typename U>
__device__ __noinline__ void sqrt_lanes_armed(const U* a, U* out, long long n,
                                              long long i0, LaneCfg cfg) {
  sqrt_lanes<true>(a, out, n, i0, cfg);
}

template <typename U>
__global__ void sqrt_kernel(const U* __restrict__ a, U* __restrict__ out,
                            long long n, LaneCfg cfg) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      LaneVec<U>::N;
  if (i0 >= n) return;
  if (simdive::lane_faults_armed())
    sqrt_lanes_armed(a, out, n, i0, cfg);
  else
    sqrt_lanes<false>(a, out, n, i0, cfg);
}

template <typename U>
int launch_elemwise(const void* a, const void* b, const void* mode, void* out,
                    long long n, const int* tab, int tab_len, int op,
                    int threads, const LaneCfg& cfg, cudaStream_t s) {
  const long long per_block = static_cast<long long>(LaneVec<U>::N) * threads;
  const unsigned blocks =
      static_cast<unsigned>((n + per_block - 1) / per_block);
  const U* pa = static_cast<const U*>(a);
  const U* pb = static_cast<const U*>(b);
  const uint32_t* pm = static_cast<const uint32_t*>(mode);
  U* po = static_cast<U*>(out);
  switch (op) {
    case simdive::kOpMul:
      elemwise_kernel<simdive::kOpMul, U>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, tab, tab_len, cfg);
      break;
    case simdive::kOpDiv:
      elemwise_kernel<simdive::kOpDiv, U>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, tab, tab_len, cfg);
      break;
    case simdive::kOpMixed:
      elemwise_kernel<simdive::kOpMixed, U>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, tab, tab_len, cfg);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch_sqrt(const void* a, void* out, long long n, const LaneCfg& cfg,
                cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long per_block =
      static_cast<long long>(LaneVec<U>::N) * kThreads;
  const unsigned blocks =
      static_cast<unsigned>((n + per_block - 1) / per_block);
  sqrt_kernel<U><<<blocks, kThreads, 0, s>>>(static_cast<const U*>(a),
                                             static_cast<U*>(out), n, cfg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_elemwise)

// a, b, out: n contiguous lanes, uint32 (width 8 / 16) or uint64 (width 32),
// 16-byte aligned; mode (op 2): n contiguous uint32, 16-byte aligned; tab:
// tab_len int32 coefficients. Returns cudaGetLastError() of the launch.
extern "C" int simdive_elemwise(const void* a, const void* b, const void* mode,
                                void* out, long long n, const void* tab,
                                int tab_len, int width, int index_bits, int op,
                                int frac_out, int round_out, int threads,
                                void* stream) {
  if (n <= 0) return 0;
  if (tab_len > simdive::kMaxTable || threads <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaneCfg cfg{width, index_bits, frac_out, round_out};
  const int* pt = static_cast<const int*>(tab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 32)
    return launch_elemwise<uint64_t>(a, b, mode, out, n, pt, tab_len, op,
                                     threads, cfg, s);
  return launch_elemwise<uint32_t>(a, b, mode, out, n, pt, tab_len, op,
                                   threads, cfg, s);
}

// a, out: n contiguous lanes (uint32, or uint64 at width 32), 16-byte
// aligned; launched at a fixed 256 threads a block, 16 bytes of lanes a
// thread. Returns cudaGetLastError() of the launch.
extern "C" int simdive_sqrt(const void* a, void* out, long long n, int width,
                            int frac_out, void* stream) {
  if (n <= 0) return 0;
  const LaneCfg cfg{width, 0, frac_out, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 32) return launch_sqrt<uint64_t>(a, out, n, cfg, s);
  return launch_sqrt<uint32_t>(a, out, n, cfg, s);
}
