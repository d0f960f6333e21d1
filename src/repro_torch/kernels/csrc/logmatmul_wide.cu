// The wide (int64-sum) form of the SIMDive log-domain matmul: the tiles and
// schedules of logmatmul.cuh instantiated with 64-bit accumulators, in a
// source of its own so that nvcc compiles it beside the int32 form. Entered
// through simdive_logmatmul (logmatmul.cu) with wide = 1; the design note
// is in logmatmul.cu.
#include "logmatmul.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_logmatmul_wide)

extern "C" int simdive_logmatmul_wide(const void* x, const void* w,
                                      void* out, int M, int K, int N,
                                      const void* tab, int tab_len,
                                      int width, int index_bits,
                                      int round_out, int bm, int bn, int bk,
                                      int k_unroll, int depth, void* stream) {
  return logmatmul_entry<unsigned long long>(
      x, w, out, M, K, N, tab, tab_len, width, index_bits, round_out, bm, bn,
      bk, k_unroll, depth, stream);
}
