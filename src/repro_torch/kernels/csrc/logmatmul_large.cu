// The large-M tiles of the SIMDive log-domain matmul, int32 form:
// logmatmul.cuh's large templates instantiated with uint32 sums, in a
// source of its own so that nvcc compiles it beside the skinny tiles and
// the wide form (logmatmul_large_wide.cu). Entered through
// simdive_logmatmul (logmatmul.cu) for a large block; the design note is in
// logmatmul.cu.
#include "logmatmul.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_logmatmul_large)

LOGMATMUL_ENTRY(simdive_logmatmul_large) {
  return logmatmul_entry<uint32_t, true>(x, w, out, M, K, N, tab, tab_len,
                                         width, index_bits, round_out, bm, bn,
                                         bk, k_unroll, depth, stream);
}
