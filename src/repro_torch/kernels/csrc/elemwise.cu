// Fused SIMDive element-wise multiplier / divider / mixed unit for Hopper.
//
// Replaces the TPU kernel repro/kernels/elemwise.py (_kernel /
// elemwise_pallas): one pass per lane through LOD -> log -> region
// correction -> ternary add -> anti-log, for op in {mul, div, mixed}.
//
// Bound on an H100: memory. Each lane moves 12 bytes of device memory (two
// uint32 reads, one uint32 write; 16 with a mode operand) against a few
// dozen integer operations, so the least time is bytes / 3.35 TB/s. At
// small shapes (the decode finalize's 3840 lanes = 46 KB: ~14 ns) the
// kernel is launch-latency bound; so the decode step's divider now runs
// fused into decode_attention.cu, and this kernel serves the error sweeps
// (tuning.frontier.measure_error) and simdive_elemwise.
//
// Design: one thread per four consecutive lanes with 16-byte loads and
// stores (the wrapper guarantees 16-byte aligned, contiguous operands), a
// scalar path for the ragged tail masked in-kernel (no pad-to-block copies
// as on the TPU), and the 64..512-entry coefficient table staged once per
// block into shared memory.
//
// sqrt_kernel, below, replaces no TPU kernel: the reference computes its
// log-domain square root (repro/core/simdive.py simdive_sqrt) in jnp and
// registers the op for its oracle alone. It is here so that the approximate
// RMSNorm's sqrt (core/approx.py approx_rmsnorm) has a kernel on the card:
// LOD -> log -> L >> 1 -> quotient anti-log with a zero divisor log, no
// correction, no rounding. Bound on an H100: memory, 8 bytes a lane (one
// uint32 read, one written) over 3.35 TB/s; at the norm's shapes (one lane
// a row: 2,048 a prefill, 4 a decode step) launch latency. The same layout
// as the lane ops, with no table; it shares this source, so the build adds
// no compile unit.
#include <cuda_runtime.h>

#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;
using simdive::lane_op;

// This thread's four lanes from i0 on (a scalar tail past n - 4).
template <int OP, bool FAULTS>
__device__ __forceinline__ void elemwise_lanes(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint32_t* __restrict__ mode, uint32_t* __restrict__ out,
    long long n, long long i0, const int* tab, const LaneCfg& cfg) {
  if (i0 + 4 <= n) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + i0);
    const uint4 vb = *reinterpret_cast<const uint4*>(b + i0);
    uint4 vm = make_uint4(0u, 0u, 0u, 0u);
    if (OP == simdive::kOpMixed)
      vm = *reinterpret_cast<const uint4*>(mode + i0);
    uint4 vo;
    vo.x = lane_op<OP, FAULTS>(va.x, vb.x, vm.x, tab, cfg);
    vo.y = lane_op<OP, FAULTS>(va.y, vb.y, vm.y, tab, cfg);
    vo.z = lane_op<OP, FAULTS>(va.z, vb.z, vm.z, tab, cfg);
    vo.w = lane_op<OP, FAULTS>(va.w, vb.w, vm.w, tab, cfg);
    *reinterpret_cast<uint4*>(out + i0) = vo;
  } else {
    for (long long i = i0; i < n; ++i) {
      const uint32_t m = (OP == simdive::kOpMixed) ? mode[i] : 0u;
      out[i] = lane_op<OP, FAULTS>(a[i], b[i], m, tab, cfg);
    }
  }
}

// The armed path out of line: its calls leave the disarmed path's code and
// registers as they are.
template <int OP>
__device__ __noinline__ void elemwise_lanes_armed(
    const uint32_t* a, const uint32_t* b, const uint32_t* mode, uint32_t* out,
    long long n, long long i0, const int* tab, LaneCfg cfg) {
  elemwise_lanes<OP, true>(a, b, mode, out, n, i0, tab, cfg);
}

template <int OP>
__global__ void elemwise_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                const uint32_t* __restrict__ mode,
                                uint32_t* __restrict__ out, long long n,
                                const int* __restrict__ tab, int tab_len,
                                LaneCfg cfg) {
  __shared__ int s_tab[simdive::kMaxTable];
  const bool faults = simdive::lane_faults_armed();  // overlaps the staging
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();

  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= n) return;
  if (faults)
    elemwise_lanes_armed<OP>(a, b, mode, out, n, i0, s_tab, cfg);
  else
    elemwise_lanes<OP, false>(a, b, mode, out, n, i0, s_tab, cfg);
}

// The square root unit: halve the Mitchell log, then the quotient anti-log
// against a zero divisor log (no correction, no rounding); 0 -> 0, the
// numerator-zero flag. Operands < 2^width.
template <bool FAULTS>
__device__ __forceinline__ uint32_t lane_sqrt(uint32_t a, const LaneCfg& c) {
  const uint32_t half = simdive::lod_log<FAULTS>(a, c.width - 1) >> 1;
  const uint32_t q =
      simdive::antilog_div(half, 0u, 0, c.width, c.frac_out, false);
  return a ? q : 0u;
}

template <bool FAULTS>
__device__ __forceinline__ void sqrt_lanes(const uint32_t* __restrict__ a,
                                           uint32_t* __restrict__ out,
                                           long long n, long long i0,
                                           const LaneCfg& cfg) {
  if (i0 + 4 <= n) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + i0);
    uint4 vo;
    vo.x = lane_sqrt<FAULTS>(va.x, cfg);
    vo.y = lane_sqrt<FAULTS>(va.y, cfg);
    vo.z = lane_sqrt<FAULTS>(va.z, cfg);
    vo.w = lane_sqrt<FAULTS>(va.w, cfg);
    *reinterpret_cast<uint4*>(out + i0) = vo;
  } else {
    for (long long i = i0; i < n; ++i) out[i] = lane_sqrt<FAULTS>(a[i], cfg);
  }
}

__device__ __noinline__ void sqrt_lanes_armed(const uint32_t* a,
                                              uint32_t* out, long long n,
                                              long long i0, LaneCfg cfg) {
  sqrt_lanes<true>(a, out, n, i0, cfg);
}

__global__ void sqrt_kernel(const uint32_t* __restrict__ a,
                            uint32_t* __restrict__ out, long long n,
                            LaneCfg cfg) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= n) return;
  if (simdive::lane_faults_armed())
    sqrt_lanes_armed(a, out, n, i0, cfg);
  else
    sqrt_lanes<false>(a, out, n, i0, cfg);
}

}  // namespace

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_elemwise)

// a, b, out (and mode for op 2): n contiguous uint32 lanes, 16-byte aligned;
// tab: tab_len int32 coefficients. Returns cudaGetLastError() of the launch.
extern "C" int simdive_elemwise(const void* a, const void* b, const void* mode,
                                void* out, long long n, const void* tab,
                                int tab_len, int width, int index_bits, int op,
                                int frac_out, int round_out, int threads,
                                void* stream) {
  if (n <= 0) return 0;
  if (tab_len > simdive::kMaxTable || threads <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaneCfg cfg{width, index_bits, frac_out, round_out};
  const long long per_block = 4LL * threads;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  const uint32_t* pm = static_cast<const uint32_t*>(mode);
  uint32_t* po = static_cast<uint32_t*>(out);
  const int* pt = static_cast<const int*>(tab);
  switch (op) {
    case simdive::kOpMul:
      elemwise_kernel<simdive::kOpMul>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, pt, tab_len, cfg);
      break;
    case simdive::kOpDiv:
      elemwise_kernel<simdive::kOpDiv>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, pt, tab_len, cfg);
      break;
    case simdive::kOpMixed:
      elemwise_kernel<simdive::kOpMixed>
          <<<blocks, threads, 0, s>>>(pa, pb, pm, po, n, pt, tab_len, cfg);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, out: n contiguous uint32 lanes, 16-byte aligned; launched at a fixed
// 256 threads a block, 4 lanes a thread. Returns cudaGetLastError() of the
// launch.
extern "C" int simdive_sqrt(const void* a, void* out, long long n, int width,
                            int frac_out, void* stream) {
  constexpr int kThreads = 256;
  if (n <= 0) return 0;
  const LaneCfg cfg{width, 0, frac_out, 0};
  const long long per_block = 4LL * kThreads;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  sqrt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t*>(out), n, cfg);
  return static_cast<int>(cudaGetLastError());
}
