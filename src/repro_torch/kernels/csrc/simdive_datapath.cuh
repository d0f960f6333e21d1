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
// first, exactly where the reference clips its barrel shifter.
#pragma once

#include <cstdint>

namespace simdive {

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
// plain version (k = 0); callers bypass it with their zero flags.
__device__ __forceinline__ uint32_t lod_log(uint32_t a, int F) {
  const int k = a ? 31 - __clz(a) : 0;
  const uint32_t frac = a ^ (1u << k);
  return (static_cast<uint32_t>(k) << F) | (frac << (F - k));
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
  int lsi = static_cast<int>(la + lb) + corr;
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
  const int ls = static_cast<int>(la) - static_cast<int>(lb) + corr;
  const int I = ls >> F;  // arithmetic shift: floors
  uint32_t mant = (static_cast<uint32_t>(ls) & ((1u << F) - 1u)) + (1u << F);
  const int sh = I + frac_out - F;
  if (sh >= 0) return mant << (sh < 31 ? sh : 31);
  const int negsh = (-sh < 31) ? -sh : 31;
  if (round_out) mant += 1u << (negsh - 1);
  return mant >> negsh;
}

// Whole SISD unit, multiplier half: x * 0 = 0.
__device__ __forceinline__ uint32_t lane_mul(uint32_t a, uint32_t b,
                                             const int* tab,
                                             const LaneCfg& c) {
  const int F = c.width - 1;
  const uint32_t la = lod_log(a, F), lb = lod_log(b, F);
  const bool nz = (a != 0u) && (b != 0u);
  const int corr = nz ? tab[region_index(la, lb, F, c.index_bits)] : 0;
  const uint32_t p = antilog_mul(la, lb, corr, c.width, c.round_out != 0);
  return nz ? p : 0u;
}

// Whole SISD unit, divider half: x / 0 = all-ones, then 0 / x = 0.
__device__ __forceinline__ uint32_t lane_div(uint32_t a, uint32_t b,
                                             const int* tab,
                                             const LaneCfg& c) {
  const int F = c.width - 1;
  const uint32_t la = lod_log(a, F), lb = lod_log(b, F);
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
__device__ __forceinline__ uint32_t lane_mixed(uint32_t a, uint32_t b,
                                               uint32_t mode, const int* tab,
                                               const LaneCfg& c) {
  const int F = c.width - 1;
  const int T = 1 << (2 * c.index_bits);
  const uint32_t la = lod_log(a, F), lb = lod_log(b, F);
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
template <int OP>
__device__ __forceinline__ uint32_t lane_op(uint32_t a, uint32_t b,
                                            uint32_t mode, const int* tab,
                                            const LaneCfg& c) {
  if (OP == kOpMul) return lane_mul(a, b, tab, c);
  if (OP == kOpDiv) return lane_div(a, b, tab, c);
  return lane_mixed(a, b, mode, tab, c);
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
__device__ __forceinline__ float softmax_div_elem(float acc,
                                                  const RowQuant& rq,
                                                  const int* tab,
                                                  const LaneCfg& c, float lim,
                                                  uint32_t* quot) {
  const uint32_t qn = quantize_lane(fabsf(acc), rq.sc, 0.0f, lim);
  const uint32_t qq = lane_div(qn, rq.qd, tab, c);
  if (quot) *quot = qq;
  const float out = scalbnf(__uint2float_rn(qq), -c.frac_out);
  return acc < 0.0f ? -out : out;
}

}  // namespace simdive
