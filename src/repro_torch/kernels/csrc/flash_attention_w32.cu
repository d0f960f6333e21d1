// The width-32 forms of the flash-attention kernels: the templates of
// flash_attention.cuh with the divider's lane word L = uint64_t (the 64-bit
// bus; the reference's uint64 lanes at width 32), in a source of their own
// so that nvcc compiles them beside the width-8 / 16 forms of
// flash_attention.cu, whose design note covers these too. Only the
// finalize differs: per row, |acc| and l are quantized into 8-byte lanes
// (clipped at lane_max_float(32) = 2^32 - 2^8, not at float(2^32 - 1),
// which rounds up past the lane) and divided on the 64-bit datapath. The
// entries take the arguments of flash_attention.cu's, at width 32 only.
#include "flash_attention.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_flash_attention_w32)

extern "C" int simdive_flash_attention_w32(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, void* stream) {
  if (width != 32) return static_cast<int>(cudaErrorInvalidValue);
  return attention<uint64_t>(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh,
                             dtype, kv_group, kv_len, q_offset, causal,
                             window, approx_div, scale, width, index_bits,
                             frac_out, round_out, lim, 0, stream);
}

extern "C" int simdive_flash_attention_pipelined_w32(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, int depth, void* stream) {
  if (depth < 1 || width != 32) return static_cast<int>(cudaErrorInvalidValue);
  return attention<uint64_t>(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh,
                             dtype, kv_group, kv_len, q_offset, causal,
                             window, approx_div, scale, width, index_bits,
                             frac_out, round_out, lim, depth, stream);
}

// quot (rows, dh) uint64.
extern "C" int simdive_softmax_div_w32(const void* acc, const void* l,
                                       void* out, void* quot, int rows, int dh,
                                       const void* tab, int tab_len, int width,
                                       int index_bits, int frac_out,
                                       int round_out, float lim, void* stream) {
  if (width != 32) return static_cast<int>(cudaErrorInvalidValue);
  return softmax_div<uint64_t>(acc, l, out, quot, rows, dh, tab, tab_len,
                               width, index_bits, frac_out, round_out, lim,
                               stream);
}
