// The width-32 form of the decode-attention kernel: the template of
// decode_attention.cuh with the finalize's lane word L = uint64_t (the
// 64-bit bus; the reference's uint64 lanes at width 32), in a source of its
// own so that nvcc compiles it beside the width-8 / 16 form of
// decode_attention.cu, whose design note covers it too. Only the finalize
// differs: per row, |acc| and l are quantized into 8-byte lanes (clipped at
// lane_max_float(32) = 2^32 - 2^8) and divided on the 64-bit datapath. The
// entry takes the arguments of decode_attention.cu's, at width 32 only.
#include "decode_attention.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_decode_attention_w32)

extern "C" int simdive_decode_attention_w32(
    const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, void* o, const void* tab, int tab_len, int B, int Smax,
    int KVH, int G, int dh, int dtype, int cluster, long long pos,
    const void* pos_ptr, int pos_is64, long long pos_stride, long long slot,
    const void* slot_ptr, int slot_is64, long long slot_stride, int ring_full,
    int window, int approx_div, float scale, int width, int index_bits,
    int frac_out, int round_out, float lim, void* stream) {
  if (width != 32) return static_cast<int>(cudaErrorInvalidValue);
  return decode_attention<uint64_t>(
      q, k_cache, v_cache, k_new, v_new, o, tab, tab_len, B, Smax, KVH, G, dh,
      dtype, cluster, pos, pos_ptr, pos_is64, pos_stride, slot, slot_ptr,
      slot_is64, slot_stride, ring_full, window, approx_div, scale, width,
      index_bits, frac_out, round_out, lim, stream);
}
