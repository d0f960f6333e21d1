// cp.async helpers (sm_80+) shared by the kernels that stream operands
// through a shared-memory ring: 4- and 16-byte copies with zero fill,
// commit, and a wait whose depth is dispatched to the immediate the
// instruction takes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace simdive {

// Copy 4 bytes from global src to shared dst; src_bytes 0 writes zeros and
// reads nothing (src must still be a valid address: pass the base pointer).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Copy 16 bytes (dst and src 16-byte aligned), bypassing L1; src_bytes 0
// writes zeros and reads nothing, as cp_async4.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` commit groups are in flight. wait_group takes
// an immediate, so a ring is at most 4 deep (pending <= 3).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

}  // namespace simdive
