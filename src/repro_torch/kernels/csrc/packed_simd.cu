// Packed sub-word SIMDive unit for Hopper: 4 x 8-bit or 2 x 16-bit lanes in
// every uint32 word (the paper's Fig. 2a SIMD decomposition).
//
// Replaces the TPU kernel repro/kernels/packed_simd.py (packed_word_op +
// _kernel / packed_pallas): operands cross device memory packed, every
// lane is expanded by shift and mask, runs the one shared SISD unit
// (simdive::lane_op, the same device functions the elementwise kernel
// runs) and is repacked onto the doubled output bus: at width 8 the 16-bit
// results of lanes (0, 1) of input word k go to output word 2k and those of
// lanes (2, 3) to word 2k + 1, little-endian; at width 16 each 32-bit
// result is one output word. The armed 'pack' faults of width 2W strike
// each output word, as lane_repack's hook does in the plain body.
//
// Bound on an H100: integer operations. A 4-lane word at width 8 moves 16
// bytes of device memory (a, b and two output words; 20 with a mode word),
// 4 bytes a lane, against some 32 integer operations a lane (the count is
// written out in chip_smoke.py), so the INT32 rate, not the 3.35 TB/s of
// memory, sets the least time — the reverse of the elementwise kernel,
// which moves 12 bytes a lane.
//
// Design: one thread per four consecutive input words, read with 16-byte
// loads of a, b (and mode) — 16 lanes at width 8 — and written as eight
// output words with two 16-byte stores (the wrapper guarantees 16-byte
// aligned, contiguous operands). The word mapping is flat (output words
// 2i, 2i + 1 belong to input word i), so any rank and word count work
// without a 2-D grid; the ragged tail is a scalar loop masked in-kernel,
// with no pad words. The 64..512-entry coefficient table is staged once
// per block in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "simdive_datapath.cuh"

namespace {

using simdive::LaneCfg;

// The i-th W-bit lane of a word (W is 8 or 16, so the shift is < 32).
template <int W>
__device__ __forceinline__ uint32_t lane_field(uint32_t w, int i) {
  return (w >> (W * i)) & ((1u << W) - 1u);
}

// One input word -> its two output words on the doubled bus. A lane
// multiplies in mixed mode when its whole W-bit mode field is nonzero.
template <int OP, int W, bool FAULTS>
__device__ __forceinline__ uint2 word_op(uint32_t a, uint32_t b, uint32_t m,
                                         const int* tab, const LaneCfg& c) {
  constexpr int kLanes = 32 / W;
  uint32_t r[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i)
    r[i] = simdive::lane_op<OP, FAULTS>(
        lane_field<W>(a, i), lane_field<W>(b, i),
        OP == simdive::kOpMixed ? lane_field<W>(m, i) : 0u, tab, c);
  uint2 o;
  if constexpr (W == 8) {
    // 16-bit output lanes: x / 0 (all-ones) reads back as 0xFFFF, and no
    // result spills into its neighbour
    o = make_uint2((r[0] & 0xFFFFu) | ((r[1] & 0xFFFFu) << 16),
                   (r[2] & 0xFFFFu) | ((r[3] & 0xFFFFu) << 16));
  } else {
    // owidth 32: one whole result a word (a 32-bit mask, never 1u << 32)
    o = make_uint2(r[0], r[1]);
  }
  if constexpr (FAULTS) {  // upsets on the output bus words
    o.x = simdive::apply_lane_faults(o.x, simdive::kSitePack, 2 * W);
    o.y = simdive::apply_lane_faults(o.y, simdive::kSitePack, 2 * W);
  }
  return o;
}

// This thread's four words from i0 on (a scalar tail past n - 4).
template <int OP, int W, bool FAULTS>
__device__ __forceinline__ void packed_words(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint32_t* __restrict__ mode, uint32_t* __restrict__ out,
    long long n, long long i0, const int* tab, const LaneCfg& cfg) {
  if (i0 + 4 <= n) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + i0);
    const uint4 vb = *reinterpret_cast<const uint4*>(b + i0);
    uint4 vm = make_uint4(0u, 0u, 0u, 0u);
    if (OP == simdive::kOpMixed)
      vm = *reinterpret_cast<const uint4*>(mode + i0);
    const uint2 o0 = word_op<OP, W, FAULTS>(va.x, vb.x, vm.x, tab, cfg);
    const uint2 o1 = word_op<OP, W, FAULTS>(va.y, vb.y, vm.y, tab, cfg);
    const uint2 o2 = word_op<OP, W, FAULTS>(va.z, vb.z, vm.z, tab, cfg);
    const uint2 o3 = word_op<OP, W, FAULTS>(va.w, vb.w, vm.w, tab, cfg);
    uint4* po = reinterpret_cast<uint4*>(out + 2 * i0);
    po[0] = make_uint4(o0.x, o0.y, o1.x, o1.y);
    po[1] = make_uint4(o2.x, o2.y, o3.x, o3.y);
  } else {
    for (long long i = i0; i < n; ++i) {
      const uint32_t m = (OP == simdive::kOpMixed) ? mode[i] : 0u;
      const uint2 o = word_op<OP, W, FAULTS>(a[i], b[i], m, tab, cfg);
      out[2 * i] = o.x;
      out[2 * i + 1] = o.y;
    }
  }
}

// The armed path out of line: its calls leave the disarmed path's code and
// registers as they are.
template <int OP, int W>
__device__ __noinline__ void packed_words_armed(
    const uint32_t* a, const uint32_t* b, const uint32_t* mode, uint32_t* out,
    long long n, long long i0, const int* tab, LaneCfg cfg) {
  packed_words<OP, W, true>(a, b, mode, out, n, i0, tab, cfg);
}

template <int OP, int W>
__global__ void packed_kernel(const uint32_t* __restrict__ a,
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
    packed_words_armed<OP, W>(a, b, mode, out, n, i0, s_tab, cfg);
  else
    packed_words<OP, W, false>(a, b, mode, out, n, i0, s_tab, cfg);
}

template <int W>
cudaError_t launch(int op, unsigned blocks, int threads, cudaStream_t s,
                   const uint32_t* a, const uint32_t* b, const uint32_t* m,
                   uint32_t* o, long long n, const int* tab, int tab_len,
                   const LaneCfg& cfg) {
  switch (op) {
    case simdive::kOpMul:
      packed_kernel<simdive::kOpMul, W>
          <<<blocks, threads, 0, s>>>(a, b, m, o, n, tab, tab_len, cfg);
      break;
    case simdive::kOpDiv:
      packed_kernel<simdive::kOpDiv, W>
          <<<blocks, threads, 0, s>>>(a, b, m, o, n, tab, tab_len, cfg);
      break;
    case simdive::kOpMixed:
      packed_kernel<simdive::kOpMixed, W>
          <<<blocks, threads, 0, s>>>(a, b, m, o, n, tab, tab_len, cfg);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_packed_simd)

// a, b (and mode for op 2): n contiguous uint32 words, 16-byte aligned;
// out: 2 n words, 16-byte aligned; tab: tab_len int32 coefficients; width
// 8 or 16. Returns cudaGetLastError() of the launch.
extern "C" int simdive_packed(const void* a, const void* b, const void* mode,
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
  cudaError_t err;
  if (width == 8)
    err = launch<8>(op, blocks, threads, s, pa, pb, pm, po, n, pt, tab_len,
                    cfg);
  else if (width == 16)
    err = launch<16>(op, blocks, threads, s, pa, pb, pm, po, n, pt, tab_len,
                     cfg);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
