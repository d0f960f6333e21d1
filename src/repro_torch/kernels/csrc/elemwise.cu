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
#include <cuda_runtime.h>

#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;
using simdive::lane_op;

template <int OP>
__global__ void elemwise_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                const uint32_t* __restrict__ mode,
                                uint32_t* __restrict__ out, long long n,
                                const int* __restrict__ tab, int tab_len,
                                LaneCfg cfg) {
  __shared__ int s_tab[simdive::kMaxTable];
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();

  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= n) return;
  if (i0 + 4 <= n) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + i0);
    const uint4 vb = *reinterpret_cast<const uint4*>(b + i0);
    uint4 vm = make_uint4(0u, 0u, 0u, 0u);
    if (OP == simdive::kOpMixed)
      vm = *reinterpret_cast<const uint4*>(mode + i0);
    uint4 vo;
    vo.x = lane_op<OP>(va.x, vb.x, vm.x, s_tab, cfg);
    vo.y = lane_op<OP>(va.y, vb.y, vm.y, s_tab, cfg);
    vo.z = lane_op<OP>(va.z, vb.z, vm.z, s_tab, cfg);
    vo.w = lane_op<OP>(va.w, vb.w, vm.w, s_tab, cfg);
    *reinterpret_cast<uint4*>(out + i0) = vo;
  } else {
    for (long long i = i0; i < n; ++i) {
      const uint32_t m = (OP == simdive::kOpMixed) ? mode[i] : 0u;
      out[i] = lane_op<OP>(a[i], b[i], m, s_tab, cfg);
    }
  }
}

}  // namespace

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
