// One decode step's attention for Hopper: the scores of one kv head's G
// query heads over a read-only cache, the masks, the new token's self term,
// the softmax, p . V and the finalize (exact divide or the SIMDive divider)
// in one launch.
//
// Replaces no TPU kernel of its own: on the TPU, repro/models/layers.py
// decode_attention_append is plain jnp (one XLA fusion) around one Pallas
// call, the elemwise divider of repro/core/approx.py attention_div
// (repro/kernels/elemwise.py elemwise_pallas). In eager PyTorch the same
// function is ~55 launches a layer (f32 copies of the cache, three batched
// products, masks, max, exp, the quantizer around the elemwise kernel, the
// fold back); here it is one. The plain version it must equal is
// repro_torch/kernels/decode_attention.py decode_attention_ref, the body
// of repro_torch/models/layers.py decode_attention_append.
//
// Contract: q (B, KVH, G, dh); caches (B, Smax, KVH, dh), contiguous and
// 16-byte aligned; k_new / v_new (B, 1, KVH, dh); all f32 or all bf16 ->
// o (B, KVH, G, dh) in the same type. dh 64, 80 or 128, G <= kMaxG. pos / slot
// are each a scalar argument or a (B,) int32 / int64 device array read by
// every block of its batch row, so neither costs a launch or a host sync.
//
// Bound on an H100: bytes. The work is the valid cache slots' k and v rows
// (read once) against 4 * G * dh flops a slot: at G <= 8 that is at most
// ~6 flops a byte in bf16, far under the ~295 at which the bf16 tensor
// cores, not the memory, would be the limit, so the products stay on the
// CUDA cores. At the serving shape (batch 4, 5 kv heads, G 3, dh 64, bf16,
// ~528 valid slots) the rows are ~2.7 MB, ~0.8 us at 3.35 TB/s.
//
// Design: one thread-block cluster of C blocks (1 <= C <= 8, planned on the
// host from B, KVH and the SM count, never from pos) per (b, kv head); each
// block of 4 warps takes a contiguous share of that row's history, so
// B * KVH * C blocks walk the cache together instead of B * KVH. Each block
// reads pos / slot itself, forms [lo, hi) and the masked slot, and takes
// its rank's share of each round of C * chunk slots by rank_range (the
// Python mirror in decode_attention.py); chunk = min(kScoreFloats / G,
// ceil(Smax / C)), so a history of up to C * 8192 / G slots is one round.
// Per round: (1) the share's k rows, then its v rows, are issued at once as
// 16-byte cp.async copies into a two-buffer stage (tiles of up to
// kStageBytes / 2 a buffer, double-buffered when a share needs more); in
// the first round the loads of q, k_new, v_new and the div table go ahead
// of them, so that the block's setup lands while its rows fly; (2)
// scores (q . k) * scale into shared memory (-inf at a masked slot), a
// cache row read as 16-byte vectors by DH / VEC lanes (a power of two of
// lanes a row: at d_head 80 the row's 10 or 20 pieces take 16 or 32
// lanes, the rest idle, and the finalize's third output a lane is
// guarded), each lane holding its slice of the G q rows in registers, the
// lanes of a row meeting by shuffles (taken for all GM heads: a shuffle
// under a G test compiles to a divergence check each), UNR row steps
// interleaved; the block's max a head; (3) cluster barrier, then every
// block reads all C ranks' maxima through distributed shared memory and
// forms the round's cluster-wide max m, so p = exp(s - m) is rounded to the
// cache's type relative to the same max as in the plain version (one
// round) — per-split maxima with a rescaling combine would round p against
// a local max instead; (4) p . V into registers, rescaled by
// exp(m_old - m_new) first. The running state starts at the self term's
// score (m = (q . k_new) * scale, identical in every rank), so the max is
// always finite and an empty share or history gives p = 0. At the end each
// block sums its warps' acc into shared memory, a cluster barrier, and the
// combine: heads are spread over the ranks, and one warp a head sums the C
// ranks' partial acc and l in rank order 0..C-1 through distributed shared
// memory (deterministic), adds the self term p_self = exp(s_self - m) and
// v_new, and runs the finalize: the exact divide, or the shared datapath's
// softmax_row_quant / softmax_div_elem with the div table in shared memory
// (the same device functions as flash_attention.cu's epilogue). A last
// cluster barrier keeps every block's shared memory alive until the others
// have read it. The two differ from the plain version in f32 summation
// order alone (one round). expf and IEEE division throughout, no fast-math
// intrinsics. Launched with cudaLaunchKernelEx and a cluster-dimension
// attribute; its error code is returned, never retried at another C.
//
// Width 32. The finalize's lane word is a template parameter L of the
// kernel (uint32_t at widths 8 and 16, uint64_t at width 32: the 64-bit
// bus of simdive_datapath.cuh); nothing else reads it. The kernel lives
// in decode_attention.cuh: this source instantiates the uint32_t forms
// and holds their C entries, decode_attention_w32.cu the uint64_t forms
// and theirs (the *_w32 entries), so that two nvcc processes build them
// side by side and the width-16 kernel is the code it was.
#include "cp_async.cuh"
#include "decode_attention.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_decode_attention)

// dtype: 0 = float32, 1 = bfloat16; dh 64, 80 or 128; 1 <= G <= 8; 1 <= cluster
// <= 8 blocks per (b, kv head). q, k_new, v_new and o contiguous; the caches
// contiguous and 16-byte aligned. pos / slot: the scalar, or a (B,) int32
// (is64 = 0) / int64 (is64 = 1) device array read at b * stride when its
// pointer is not null. width 8 or 16 (width 32: simdive_decode_attention_w32).
// Returns the launch's CUDA error code (0 on success).
extern "C" int simdive_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, void* o, const void* tab, int tab_len, int B, int Smax,
    int KVH, int G, int dh, int dtype, int cluster, long long pos,
    const void* pos_ptr, int pos_is64, long long pos_stride, long long slot,
    const void* slot_ptr, int slot_is64, long long slot_stride, int ring_full,
    int window, int approx_div, float scale, int width, int index_bits,
    int frac_out, int round_out, float lim, void* stream) {
  if (width > 16) return static_cast<int>(cudaErrorInvalidValue);
  return decode_attention<uint32_t>(
      q, k_cache, v_cache, k_new, v_new, o, tab, tab_len, B, Smax, KVH, G, dh,
      dtype, cluster, pos, pos_ptr, pos_is64, pos_stride, slot, slot_ptr,
      slot_is64, slot_stride, ring_full, window, approx_div, scale, width,
      index_bits, frac_out, round_out, lim, stream);
}

// How many clusters of `cluster` blocks of the instantiation serving
// (dtype, dh, G) at cache length Smax the card can hold at once
// (cudaOccupancyMaxActiveClusters); -(CUDA error code) on failure.
extern "C" int simdive_decode_attention_max_clusters(int Smax, int G, int dh,
                                                     int dtype, int cluster) {
  return max_clusters<uint32_t>(Smax, G, dh, dtype, cluster);
}
