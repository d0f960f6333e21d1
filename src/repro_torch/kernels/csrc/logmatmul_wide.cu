// The skinny tiles' wide (int64-sum) form of the SIMDive log-domain
// matmul: logmatmul.cuh's skinny templates instantiated with 64-bit
// accumulators, in a source of its own so that nvcc compiles it beside the
// int32 form. Entered through simdive_logmatmul (logmatmul.cu) with wide =
// 1; the design note is in logmatmul.cu.
#include "logmatmul.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_logmatmul_wide)

LOGMATMUL_ENTRY(simdive_logmatmul_wide) {
  return logmatmul_entry<unsigned long long, false>(
      x, w, out, M, K, N, tab, tab_len, width, index_bits, round_out, bm, bn,
      bk, k_unroll, depth, stream);
}
