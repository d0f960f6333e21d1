// SIMDive log datapath, device side — written once, included by every kernel.
//
// The device counterpart of repro_torch/kernels/datapath.py (which mirrors
// repro/kernels/datapath.py of the JAX reference): LOD -> log conversion ->
// region index + coefficient table -> ternary add -> anti-log, for mul, div
// and the mixed mode, plus the per-row quantizer of the softmax divider.
// Every function is bit-identical to its plain PyTorch version on the same
// integer operands; the tests and chip_smoke.py hold them equal.
//
// Lanes are native unsigned words of a template type U: uint32_t at widths 8
// and 16 (every intermediate fits 32 bits), uint64_t at width 32 (the 64-bit
// product bus; log words take 36 bits), as the reference computes in uint32
// and uint64. One template serves both; LaneBits<U> gives the signed work
// type and the barrel shifter's clip (31 or 63). A shift by the word's size
// or more is undefined in CUDA, so every data-dependent shift is clipped
// first, exactly where the reference clips its barrel shifter. The ternary
// adds are taken in U and read as the signed type: the reference's wrapping
// uint32 / int32 sums (width 32: int64, where nothing in range wraps),
// which only upset operands (below) ever wrap.
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
// current lane value falls under its threshold. A 64-bit word keeps its
// high bits and hashes its low 32, as the reference's x.astype(uint32)
// does. Out of line: the disarmed callers keep only the branch on the
// count.
template <typename U>
static __device__ __noinline__ U apply_lane_faults(U x, uint32_t site,
                                                   uint32_t width) {
  const uint32_t n = g_fault_register.n;
  for (uint32_t i = 0; i < n; ++i) {
    const LaneFault f = g_fault_register.f[i];
    if (f.site != site || (f.width != 0u && f.width != width)) continue;
    const U m = f.mask;
    const U y = f.kind == kKindFlip     ? (x ^ m)
                : f.kind == kKindStuck1 ? (x | m)
                                        : (x & ~m);
    if (f.transient) {
      uint32_t h = static_cast<uint32_t>(x) ^ f.seed;
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
  int width;       // lane width: 8 or 16 (uint32_t lanes), 32 (uint64_t)
  int index_bits;  // MSBs of each fraction in the region index (3 or 4)
  int frac_out;    // fraction bits kept on quotients
  int round_out;   // half-LSB rounding carry at the anti-log output
};

constexpr int kOpMul = 0;
constexpr int kOpDiv = 1;
constexpr int kOpMixed = 2;
// largest table: mixed [mul | div] at index_bits 4
constexpr int kMaxTable = 512;

// The signed work type and the barrel shifter's clip of a lane word.
template <typename U>
struct LaneBits;
template <>
struct LaneBits<uint32_t> {
  using S = int32_t;
  static constexpr int kClip = 31;
  __device__ static int clz(uint32_t a) { return __clz(a); }
  __device__ static float to_float(uint32_t a) { return __uint2float_rn(a); }
  __device__ static uint32_t from_float(float x) { return __float2uint_rn(x); }
};
template <>
struct LaneBits<uint64_t> {
  using S = long long;
  static constexpr int kClip = 63;
  __device__ static int clz(uint64_t a) { return __clzll(a); }
  __device__ static float to_float(uint64_t a) { return __ull2float_rn(a); }
  __device__ static uint64_t from_float(float x) { return __float2ull_rn(x); }
};

// Stage 1: LOD + log conversion, L = (k << F) | ((a ^ 2^k) << (F - k)).
// a must be < 2^width. a == 0 yields the same don't-care value as the
// plain version (k = 0); callers bypass it with their zero flags. With
// FAULTS, the armed 'log' faults of width F + 1 strike L (false: the
// caller found the register empty).
template <bool FAULTS, typename U>
__device__ __forceinline__ U lod_log(U a, int F) {
  constexpr int kTop = 8 * static_cast<int>(sizeof(U)) - 1;
  const int k = a ? kTop - LaneBits<U>::clz(a) : 0;
  const U frac = a ^ (U(1) << k);
  const U L = (static_cast<U>(k) << F) | (frac << (F - k));
  if constexpr (FAULTS) return apply_lane_faults<U>(L, kSiteLog, F + 1);
  return L;
}

// Stage 2: region index from the index_bits MSBs of both fractions.
template <typename U>
__device__ __forceinline__ int region_index(U la, U lb, int F,
                                            int index_bits) {
  const U m = (U(1) << F) - U(1);
  const int sh = F - index_bits;
  return static_cast<int>((((la & m) >> sh) << index_bits) | ((lb & m) >> sh));
}

// Stage 3a: ternary add (clipped at zero) + product anti-log with floor
// semantics; saturates to the 2*width-bit bus maximum when I >= 2*width.
template <typename U>
__device__ __forceinline__ U antilog_mul(U la, U lb, int corr, int width,
                                         bool round_out) {
  using S = typename LaneBits<U>::S;
  const int F = width - 1;
  S lsi = static_cast<S>(la + lb + static_cast<U>(static_cast<S>(corr)));
  if (lsi < 0) lsi = 0;
  const U ls = static_cast<U>(lsi);
  const int I = static_cast<int>(ls >> F);
  U mant = (U(1) << F) + (ls & ((U(1) << F) - U(1)));  // 1.Xs, F+1 bits
  if (I >= 2 * width)
    return (2 * width == 8 * static_cast<int>(sizeof(U)))
               ? ~U(0)
               : ((U(1) << (2 * width)) - U(1));
  if (I >= F) return mant << (I - F);  // I - F <= width
  const int shr = F - I;               // 1 .. F
  if (round_out) mant += U(1) << (shr - 1);
  return mant >> shr;
}

// Stage 3b: signed ternary subtract + quotient anti-log,
// round_down(Q * 2^frac_out); both shift directions clipped to the bus
// (31, or 63 on the 64-bit bus).
template <typename U>
__device__ __forceinline__ U antilog_div(U la, U lb, int corr, int width,
                                         int frac_out, bool round_out) {
  using S = typename LaneBits<U>::S;
  constexpr int kClip = LaneBits<U>::kClip;
  const int F = width - 1;
  const S ls = static_cast<S>(la - lb + static_cast<U>(static_cast<S>(corr)));
  const int I = static_cast<int>(ls >> F);  // arithmetic shift: floors
  U mant = (static_cast<U>(ls) & ((U(1) << F) - U(1))) + (U(1) << F);
  const int sh = I + frac_out - F;
  if (sh >= 0) return mant << (sh < kClip ? sh : kClip);
  const int negsh = (-sh < kClip) ? -sh : kClip;
  if (round_out) mant += U(1) << (negsh - 1);
  return mant >> negsh;
}

// Whole SISD unit, multiplier half: x * 0 = 0.
template <bool FAULTS, typename U>
__device__ __forceinline__ U lane_mul(U a, U b, const int* tab,
                                      const LaneCfg& c) {
  const int F = c.width - 1;
  const U la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != U(0)) && (b != U(0));
  const int corr = nz ? tab[region_index(la, lb, F, c.index_bits)] : 0;
  const U p = antilog_mul(la, lb, corr, c.width, c.round_out != 0);
  return nz ? p : U(0);
}

// Whole SISD unit, divider half: x / 0 = all-ones, then 0 / x = 0.
template <bool FAULTS, typename U>
__device__ __forceinline__ U lane_div(U a, U b, const int* tab,
                                      const LaneCfg& c) {
  const int F = c.width - 1;
  const U la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != U(0)) && (b != U(0));
  const int corr = nz ? tab[region_index(la, lb, F, c.index_bits)] : 0;
  U q = antilog_div(la, lb, corr, c.width, c.frac_out, c.round_out != 0);
  if (b == U(0)) q = ~U(0);
  if (a == U(0)) q = U(0);
  return q;
}

// Mixed mode: tab is [mul | div]; mode != 0 selects the product. Both
// halves share the LOD + log front end and the region index.
template <bool FAULTS, typename U>
__device__ __forceinline__ U lane_mixed(U a, U b, uint32_t mode,
                                        const int* tab, const LaneCfg& c) {
  const int F = c.width - 1;
  const int T = 1 << (2 * c.index_bits);
  const U la = lod_log<FAULTS>(a, F), lb = lod_log<FAULTS>(b, F);
  const bool nz = (a != U(0)) && (b != U(0));
  const int idx = region_index(la, lb, F, c.index_bits);
  if (mode != 0u) {
    const U p = antilog_mul(la, lb, nz ? tab[idx] : 0, c.width,
                            c.round_out != 0);
    return nz ? p : U(0);
  }
  U q = antilog_div(la, lb, nz ? tab[T + idx] : 0, c.width, c.frac_out,
                    c.round_out != 0);
  if (b == U(0)) q = ~U(0);
  if (a == U(0)) q = U(0);
  return q;
}

// One SISD unit of a compile-time op: the elementwise and the packed
// kernels both run their lanes through this.
template <int OP, bool FAULTS, typename U>
__device__ __forceinline__ U lane_op(U a, U b, uint32_t mode, const int* tab,
                                     const LaneCfg& c) {
  if (OP == kOpMul) return lane_mul<FAULTS>(a, b, tab, c);
  if (OP == kOpDiv) return lane_div<FAULTS>(a, b, tab, c);
  return lane_mixed<FAULTS>(a, b, mode, tab, c);
}

// ---- softmax divider: per-row shared-exponent quantization + lane_div ----
// U = uint32_t at widths 8 / 16, uint64_t at width 32; lim is the float
// lane_max_float(width) (2^32 - 2^8 at width 32: float(2^32 - 1) rounds
// up past the lane).

template <typename U>
struct RowQuant {
  float sc;  // 2^(width - 2 - floor(log2 top))
  U qd;      // quantized denominator, in [1, lane max]
};

// Round-half-even quantization of x * sc into [lo, lim].
template <typename U>
__device__ __forceinline__ U quantize_lane(float x, float sc, float lo,
                                           float lim) {
  return LaneBits<U>::from_float(fminf(fmaxf(rintf(x * sc), lo), lim));
}

// Row scale from top = max(rowmax|acc|, l): floor(log2 top) is read from
// the float's exponent field (top >= 1e-30 is a normal number), the same
// way the plain version reads it with frexp, so the two cannot disagree
// just below a power of two as two log2 implementations can.
template <typename U>
__device__ __forceinline__ RowQuant<U> softmax_row_quant(float rowmax_abs,
                                                         float l, int width,
                                                         float lim) {
  const float den = fmaxf(l, 1e-30f);
  const float top = fmaxf(fmaxf(rowmax_abs, den), 1e-30f);
  const int ex = static_cast<int>((__float_as_uint(top) >> 23) & 0xFFu) - 127;
  RowQuant<U> rq;
  rq.sc = scalbnf(1.0f, width - 2 - ex);
  rq.qd = quantize_lane<U>(den, rq.sc, 1.0f, lim);
  return rq;
}

// One element of acc / l on the divider: quantize |acc|, divide, fold the
// quotient back to float (rounded once, to nearest even) and re-apply the
// sign. *quot gets the raw lane.
template <bool FAULTS, typename U>
__device__ __forceinline__ float softmax_div_elem(float acc,
                                                  const RowQuant<U>& rq,
                                                  const int* tab,
                                                  const LaneCfg& c, float lim,
                                                  U* quot) {
  const U qn = quantize_lane<U>(fabsf(acc), rq.sc, 0.0f, lim);
  const U qq = lane_div<FAULTS>(qn, rq.qd, tab, c);
  if (quot) *quot = qq;
  const float out = scalbnf(LaneBits<U>::to_float(qq), -c.frac_out);
  return acc < 0.0f ? -out : out;
}

}  // namespace simdive
