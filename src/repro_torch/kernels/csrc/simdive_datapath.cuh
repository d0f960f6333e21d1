// SIMDive log datapath, device side — written once, included by every kernel.
//
// The device counterpart of repro_torch/kernels/datapath.py (which mirrors
// repro/kernels/datapath.py of the JAX reference): LOD -> log conversion ->
// region index + coefficient table -> ternary add -> anti-log, for mul, div
// and the mixed mode, plus the per-row quantizer of the softmax divider.
// Every function is bit-identical to its plain PyTorch version on the same
// integer operands; the tests and chip_smoke.py hold them equal.
//
// Lanes are native uint32 (widths 8 and 16: every intermediate fits 32 bits;
// width 32 would need a 64-bit bus and is refused by the wrappers). A shift
// by >= 32 is undefined in CUDA, so every data-dependent shift is clipped
// first, exactly where the reference clips its barrel shifter. The ternary
// adds are taken in uint32 and read as int32: the reference's wrapping
// uint32 / int32 sums, which only upset operands (below) ever wrap.
//
// Fault injection (repro_torch/faults/inject.py): the armed lane faults
// live in g_fault_register, which set_faults writes on the stream through
// the setter every source exports (simdive_faults_<source>, defined with
// SIMDIVE_FAULT_SETTER below; each source compiled alone holds its own
// copy of this __constant__). lod_log applies the 'log' specs to its
// output, packed_simd.cu the 'pack' specs to its output words, in arming
// order, as repro_torch.faults.inject.apply_lane_faults does on the host.
// The lane functions take FAULTS as a template argument: a kernel reads
// lane_faults_armed() once (a uniform branch on a zero count) and runs
// the FAULTS = false instantiation, with no fault code at all, when the
// register is empty. Table faults need nothing here: the kernels read the
// tables set_faults rewrites in place.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace simdive {

// ---- the fault register (faults/inject.py lane_register) -----------------
constexpr int kMaxLaneFaults = 8;  // faults.inject.MAX_LANE_FAULTS
constexpr uint32_t kSiteLog = 1, kSitePack = 2;
constexpr uint32_t kKindFlip = 0, kKindStuck0 = 1, kKindStuck1 = 2;

struct LaneFault {
  uint32_t site;       // kSiteLog | kSitePack
  uint32_t width;      // lane width it strikes; 0 = any
  uint32_t kind;       // kKindFlip | kKindStuck0 | kKindStuck1
  uint32_t mask;       // 1 << bit
  uint32_t transient;  // 0: every element; 1: where the strike hash fires
  uint32_t thresh;     // min(int(rate * 2^32), 2^32 - 1)
  uint32_t seed;       // (seed * 0x9E3779B9 + 0x6A09E667) mod 2^32
  uint32_t pad;
};

struct FaultRegister {
  uint32_t n, pad[3];  // lane specs armed
  LaneFault f[kMaxLaneFaults];
};

static __constant__ FaultRegister g_fault_register;

// The armed specs of one site and width applied to x, in arming order;
// a transient spec strikes where the reference's murmur-style hash of the
// current lane value falls under its threshold. Out of line: the disarmed
// callers keep only the branch on the count.
static __device__ __noinline__ uint32_t apply_lane_faults(uint32_t x,
                                                          uint32_t site,
                                                          uint32_t width) {
  const uint32_t n = g_fault_register.n;
  for (uint32_t i = 0; i < n; ++i) {
    const LaneFault f = g_fault_register.f[i];
    if (f.site != site || (f.width != 0u && f.width != width)) continue;
    const uint32_t y = f.kind == kKindFlip     ? (x ^ f.mask)
                       : f.kind == kKindStuck1 ? (x | f.mask)
                                               : (x & ~f.mask);
    if (f.transient) {
      uint32_t h = x ^ f.seed;
      h *= 0x85EBCA6Bu;
      h = (h ^ (h >> 13)) * 0xC2B2AE35u;
      h ^= h >> 16;
      x = h < f.thresh ? y : x;
    } else {
      x = y;
    }
  }
  return x;
}

// Whether any lane fault is armed: the one branch a disarmed kernel pays.
__device__ __forceinline__ bool lane_faults_armed() {
  return g_fault_register.n != 0u;
}

// Host side: copy a register (the words of faults.inject.lane_register)
// into this source's copy, ordered on stream s.
static inline cudaError_t write_fault_register(const void* reg,
                                              cudaStream_t s) {
  return cudaMemcpyToSymbolAsync(g_fault_register, reg,
                                 sizeof(FaultRegister), 0,
                                 cudaMemcpyHostToDevice, s);
}

// Every source defines its setter with this, named simdive_faults_<stem>
// (kernels/build.py derives the names from the file names).
#define SIMDIVE_FAULT_SETTER(name)                                      \
  extern "C" int name(const void* reg, void* stream) {                  \
    return static_cast<int>(simdive::write_fault_register(              \
        reg, static_cast<cudaStream_t>(stream)));                       \
  }

struct LaneCfg {
  int width;       // lane width: 8 or 16
  int index_bits;  // MSBs of each fraction in the region index (3 or 4)
  int frac_out;    // fraction bits kept on quotients
  int round_out;   // half-LSB rounding carry at the anti-log output
};

constexpr int kOpMul = 0;
constexpr int kOpDiv = 1;
constexpr int kOpMixed = 2;
// largest table: mixed [mul | div] at index_bits 4
constexpr int kMaxTable = 512;

// Stage 1: LOD + log conversion, L = (k << F) | ((a ^ 2^k) << (F - k)).
// a must be < 2^width. a == 0 yields the same don't-care value as the
// plain version (k = 0); callers bypass it with their zero flags. With
// FAULTS, the armed 'log' faults of width F + 1 strike L (false: the
// caller found the register empty).
template <bool FAULTS>
__device__ __forceinline__ uint32_t lod_log(uint32_t a, int F) {
  const int k = a ? 31 - __clz(a) : 0;
  const uint32_t frac = a ^ (1u << k);
  const uint32_t L = (static_cast<uint32_t>(k) << F) | (frac << (F - k));
  if constexpr (FAULTS) return apply_lane_faults(L, kSiteLog, F + 1);
  return L;
}

// Stage 2: region index from the index_bits MSBs of both fractions.
__device__ __forceinline__ int region_index(uint32_t la, uint32_t lb, int F,
                                            int index_bits) {
  const uint32_t m = (1u << F) - 1u;
  const int sh = F - index_bits;
  return static_cast<int>((((la & m) >> sh) << index_bits) | ((lb & m) >> sh));
}

// Stage 3a: ternary add (clipped at zero) + product anti-log with floor
// semantics; saturates to the 2*width-bit bus maximum when I >= 2*width.
__device__ __forceinline__ uint32_t antilog_mul(uint32_t la, uint32_t lb,
                                                int corr, int width,
                                                bool round_out) {
  const int F = width - 1;
  int lsi = static_cast<int>(la + lb + static_cast<uint32_t>(corr));
  if (lsi < 0) lsi = 0;
  const uint32_t ls = static_cast<uint32_t>(lsi);
  const int I = static_cast<int>(ls >> F);
  uint32_t mant = (1u << F) + (ls & ((1u << F) - 1u));  // 1.Xs, F+1 bits
  if (I >= 2 * width)
    return (2 * width == 32) ? 0xFFFFFFFFu : ((1u << (2 * width)) - 1u);
  if (I >= F) return mant << (I - F);  // I - F <= width <= 16
  const int shr = F - I;               // 1 .. F
  if (round_out) mant += 1u << (shr - 1);
  return mant >> shr;
}

// Stage 3b: signed ternary subtract + quotient anti-log,
// round_down(Q * 2^frac_out); both shift directions clipped to 31.
__device__ __forceinline__ uint32_t antilog_div(uint32_t la, uint32_t lb,
                                                int corr, int width,
                                                int frac_out, bool round_out) {
  const int F = width - 1;
  const int ls = static_cast<int>(la - lb + static_cast<uint32_t>(corr));
  const int I = ls >> F;  // arithmetic shift: floors
  uint32_t mant = (static_cast<uint32_t>(ls) & ((1u << F) - 1u)) + (1u << F);
  const int sh = I + frac_out - F;
  if (sh >= 0) return mant << (sh < 31 ? sh : 31);
  const int negsh = (-sh < 31) ? -sh : 31;
  if (round_out) mant += 1u << (negsh - 1);
  return mant >> negsh;
}

// Whole SISD unit, multiplier half: x * 0 = 0.
template <bool FAULTS>
__device__ __forceinline__ uint32_t lane_mul(uint32_t a, uint32_t b,
                                             const int* tab,
                                             const LaneCfg& c) {
  const int F = c.width - 1;
  const uint32_t la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != 0u) && (b != 0u);
  const int corr = nz ? tab[region_index(la, lb, F, c.index_bits)] : 0;
  const uint32_t p = antilog_mul(la, lb, corr, c.width, c.round_out != 0);
  return nz ? p : 0u;
}

// Whole SISD unit, divider half: x / 0 = all-ones, then 0 / x = 0.
template <bool FAULTS>
__device__ __forceinline__ uint32_t lane_div(uint32_t a, uint32_t b,
                                             const int* tab,
                                             const LaneCfg& c) {
  const int F = c.width - 1;
  const uint32_t la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != 0u) && (b != 0u);
  const int corr = nz ? tab[region_index(la, lb, F, c.index_bits)] : 0;
  uint32_t q = antilog_div(la, lb, corr, c.width, c.frac_out,
                           c.round_out != 0);
  if (b == 0u) q = 0xFFFFFFFFu;
  if (a == 0u) q = 0u;
  return q;
}

// Mixed mode: tab is [mul | div]; mode != 0 selects the product. Both
// halves share the LOD + log front end and the region index.
template <bool FAULTS>
__device__ __forceinline__ uint32_t lane_mixed(uint32_t a, uint32_t b,
                                               uint32_t mode, const int* tab,
                                               const LaneCfg& c) {
  const int F = c.width - 1;
  const int T = 1 << (2 * c.index_bits);
  const uint32_t la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != 0u) && (b != 0u);
  const int idx = region_index(la, lb, F, c.index_bits);
  if (mode != 0u) {
    const uint32_t p = antilog_mul(la, lb, nz ? tab[idx] : 0, c.width,
                                   c.round_out != 0);
    return nz ? p : 0u;
  }
  uint32_t q = antilog_div(la, lb, nz ? tab[T + idx] : 0, c.width, c.frac_out,
                           c.round_out != 0);
  if (b == 0u) q = 0xFFFFFFFFu;
  if (a == 0u) q = 0u;
  return q;
}

// One SISD unit of a compile-time op: the elementwise and the packed
// kernels both run their lanes through this.
template <int OP, bool FAULTS>
__device__ __forceinline__ uint32_t lane_op(uint32_t a, uint32_t b,
                                            uint32_t mode, const int* tab,
                                            const LaneCfg& c) {
  if (OP == kOpMul) return lane_mul<FAULTS>(a, b, tab, c);
  if (OP == kOpDiv) return lane_div<FAULTS>(a, b, tab, c);
  return lane_mixed<FAULTS>(a, b, mode, tab, c);
}

// ---- softmax divider: per-row shared-exponent quantization + lane_div ----

struct RowQuant {
  float sc;     // 2^(width - 2 - floor(log2 top))
  uint32_t qd;  // quantized denominator, in [1, lane max]
};

// Round-half-even quantization of x * sc into [lo, lim].
__device__ __forceinline__ uint32_t quantize_lane(float x, float sc, float lo,
                                                  float lim) {
  return __float2uint_rn(fminf(fmaxf(rintf(x * sc), lo), lim));
}

// Row scale from top = max(rowmax|acc|, l): floor(log2 top) is read from
// the float's exponent field (top >= 1e-30 is a normal number), the same
// way the plain version reads it with frexp, so the two cannot disagree
// just below a power of two as two log2 implementations can.
__device__ __forceinline__ RowQuant softmax_row_quant(float rowmax_abs,
                                                      float l, int width,
                                                      float lim) {
  const float den = fmaxf(l, 1e-30f);
  const float top = fmaxf(fmaxf(rowmax_abs, den), 1e-30f);
  const int ex = static_cast<int>((__float_as_uint(top) >> 23) & 0xFFu) - 127;
  RowQuant rq;
  rq.sc = scalbnf(1.0f, width - 2 - ex);
  rq.qd = quantize_lane(den, rq.sc, 1.0f, lim);
  return rq;
}

// One element of acc / l on the divider: quantize |acc|, divide, fold the
// quotient back to float and re-apply the sign. *quot gets the raw lane.
template <bool FAULTS>
__device__ __forceinline__ float softmax_div_elem(float acc,
                                                  const RowQuant& rq,
                                                  const int* tab,
                                                  const LaneCfg& c, float lim,
                                                  uint32_t* quot) {
  const uint32_t qn = quantize_lane(fabsf(acc), rq.sc, 0.0f, lim);
  const uint32_t qq = lane_div<FAULTS>(qn, rq.qd, tab, c);
  if (quot) *quot = qq;
  const float out = scalbnf(__uint2float_rn(qq), -c.frac_out);
  return acc < 0.0f ? -out : out;
}

}  // namespace simdive
