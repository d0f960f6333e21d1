// Online-softmax flash attention with the SIMDive divider in its finalize,
// for Hopper: a depth-0 schedule and a cp.async kv-ring schedule.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py: _kernel
// (flash_attention_pallas, the depth-0 schedule, kv tiles streamed by the
// grid) and _kernel_pipelined (the depth-D schedule, k/v left in HBM and
// copied through a D-slot ring by the kernel itself). Both are
// instantiations of one kernel template here (PIPE), selected by the
// block's 3rd component. q (BH, Sq, dh), k and v (BH / kv_group, Skv, dh),
// f32 or bf16 -> o (BH, Sq, dh) in q's type, with causal / sliding-window /
// kv_len masks and a q_offset. The final acc / l is either an exact divide
// or, per row, a shared-exponent quantization into width-bit lanes and
// simdive::lane_div from the shared datapath header.
//
// What the TPU kernel carries from one sequential grid step to the next in
// scratch memory (m, l, acc) lives here in registers across a loop over kv
// tiles inside the block; one block owns one (bh, 64-row q tile) and walks
// 64-row kv tiles. kv tiles that the causal / window / kv_len masks exclude
// whole are skipped: for those the reference's step leaves (m, l, acc)
// unchanged up to its masked-row guard. GQA: kv is read at head
// bh / kv_group; no repeated copy is materialised. The heaviest (latest)
// causal q tiles are scheduled first.
//
// Bound on an H100: bytes, narrowly. At the serving shape (q BH 60, kv heads
// 20, S 512, dh 64, bf16, causal) the kernel needs 4*dh per causal (q, k)
// pair = 2.0 GFLOP, 0.0020 ms at the bf16 tensor-core peak, against 10.5 MB
// of q/k/v/o traffic (kv read once per kv head, not per q head), 0.0031 ms
// at the HBM rate. What holds the kernel above both (PERF.md): the
// heaviest causal block walks 8 kv tiles one after another, so the blocks
// are scheduled heaviest first across all heads; and the SIMDive finalize,
// run at the end of every block, takes about a third of the time.
//
// Design, bf16 (flash_kernel_mma): the reference's two products are
// dot_generals on bf16 operands with f32 accumulation — the tensor-core
// contract — so both run as mma.sync.m16n8k16 (bf16 x bf16 -> f32). Four
// warps (128 threads) a block; each warp owns 16 q rows, loaded once as
// ldmatrix.x4 A fragments kept in registers for the whole kv loop.
// S = Q K^T is one m16n8 f32 C fragment per 8 kv columns (B fragments of
// k by ldmatrix.x4); masking, scaling, the row max (a quad shuffle: the 4
// lanes of a quad hold one row) and expf run on those fragments. p is
// rounded to bf16 (__float2bfloat16_rn, as the reference casts p to v's
// type) straight into the A fragments of the PV product, and l sums the
// unrounded f32 p; acc stays as m16n8 C fragments over dh (dh / 8 of them),
// rescaled by exp(m - m_new) before V's B fragments (ldmatrix.x4.trans) are
// multiplied in. A bf16 x bf16 product is exact in f32, so this differs
// from the reference only in f32 summation order. k, v and q tiles stay
// bf16 in shared memory, rows padded by 16 bytes so that the eight row
// addresses of an ldmatrix hit distinct banks. The finalize takes each
// row's max |acc| over the quad, then the shared datapath's
// softmax_row_quant / softmax_div_elem unchanged, and stores bf16 pairs.
//
// Design, f32 (flash_kernel): no products on the tensor cores — TF32 would
// keep 10 mantissa bits of each operand, far outside what the f32 path
// promises. 256 threads, a 4 x 4 score micro-tile each, FMA loops over
// shared-memory tiles read as f32 (padded rows, conflict-free), p through
// a shared tile. No served path runs f32 attention.
//
// Schedules. Depth 0 loads each kv tile synchronously between two barriers
// (bf16: 16-byte loads into the padded bf16 tiles; f32: element loads into
// f32 tiles). Depth D >= 1 issues k/v tiles with cp.async into a D-slot
// ring (bf16: 16-byte copies; f32: 4-byte copies), zero-filled past Skv
// from the base address (a stale word there would give p = 0 times Inf /
// NaN): the warm-up issues tiles 0..D-2, step c issues tile c+D-1 into the
// slot tile c-1 vacated, waits for tile c, computes — the reference's DMA
// order. Both schedules visit the same kv tiles in the same order, see the
// same shared-memory values and run the same instructions on them, so every
// depth is bit-identical to depth 0, as the reference requires of its
// schedules. The bf16 kernel's 16-byte loads need q, k and v 16-byte
// aligned; the f32 ring's copies need 4 (the wrapper checks both).
//
// Blocks. The tile is compiled: 64 q rows x 64 kv rows. The reference's TPU
// blocks (256..1024 rows, VMEM of many MB) do not fit an SM: one 512 x 512
// f32 score tile alone is 1 MB against 227 KB of shared memory. A block is
// (64, 64) or (64, 64, D) with D <= 4 (cp.async.wait_group takes an
// immediate); shared memory grows with D, dtype and d_head
// (kernels/flash_attention.py smem_bytes mirrors smem_bytes_mma /
// smem_bytes / smem_bytes_pipe below): every depth fits for bf16, and for
// f32 at d_head 64 and 80 (203,264 bytes at 80, depth 4); f32 at d_head
// 128 fits D <= 2 only.
//
// Width 32. The divider's lane word is a template parameter L of every
// kernel (uint32_t at widths 8 and 16, uint64_t at width 32: the 64-bit
// bus of simdive_datapath.cuh); only the finalize reads it. The kernels
// live in flash_attention.cuh: this source instantiates the uint32_t forms
// and holds their C entries, flash_attention_w32.cu the uint64_t forms
// and theirs (the *_w32 entries), so that two nvcc processes build them
// side by side and the width-16 kernels are the code they were.
//
// Head sizes: 64, 80 (zamba2) and 128, each an instantiation. Every loop
// holds at 80: the bf16 body's KSTEPS = DH / 16 = 5 k-steps of Q K^T and NO
// = DH / 8 = 10 n8 tiles of acc (NO / 2 = 5 ldmatrix.x4.trans a k-step of
// P V); its tile loads move CPR = DH / 8 = 10 16-byte chunks a row, 640 a
// 64-row tile, 5 a thread of 128; mma_stride = 88 bf16 = 176-byte rows,
// 44 words, so the eight rows an ldmatrix reads start in banks 0, 12, 24,
// 4, 16, 28, 8, 20 and their 16-byte reads hit distinct banks; global
// rows are 160 bytes, 16-byte aligned. The f32 body's DPT = DH / 16 = 5
// output columns a thread.
#include "cp_async.cuh"
#include "flash_attention.cuh"

// This source's copy of the fault register (simdive_datapath.cuh).
SIMDIVE_FAULT_SETTER(simdive_faults_flash_attention)

// dtype: 0 = float32, 1 = bfloat16. dh must be 64, 80 or 128. All tensors
// contiguous; bf16 q, k and v 16-byte aligned. width 8 or 16 (width 32:
// simdive_flash_attention_w32). Returns cudaGetLastError() of the launch
// (or the error of the shared-memory opt-in). The depth-0 schedule.
extern "C" int simdive_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, void* stream) {
  if (width > 16) return static_cast<int>(cudaErrorInvalidValue);
  return attention<uint32_t>(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh,
                             dtype, kv_group, kv_len, q_offset, causal,
                             window, approx_div, scale, width, index_bits,
                             frac_out, round_out, lim, 0, stream);
}

// The same arguments, plus the ring depth 1..4: the cp.async kv-ring
// schedule. bf16 q, k and v must be 16-byte aligned, f32 k and v 4-byte
// aligned (the wrapper checks; bf16 depth 0 needs the same).
extern "C" int simdive_flash_attention_pipelined(
    const void* q, const void* k, const void* v, void* o, const void* tab,
    int tab_len, int BH, int Sq, int Skv, int dh, int dtype, int kv_group,
    int kv_len, int q_offset, int causal, int window, int approx_div,
    float scale, int width, int index_bits, int frac_out, int round_out,
    float lim, int depth, void* stream) {
  if (depth < 1 || width > 16) return static_cast<int>(cudaErrorInvalidValue);
  return attention<uint32_t>(q, k, v, o, tab, tab_len, BH, Sq, Skv, dh,
                             dtype, kv_group, kv_len, q_offset, causal,
                             window, approx_div, scale, width, index_bits,
                             frac_out, round_out, lim, depth, stream);
}

// acc (rows, dh) f32, l (rows,) f32 -> out (rows, dh) f32 and the raw
// quotient lanes quot (rows, dh) uint32; width 8 or 16.
extern "C" int simdive_softmax_div(const void* acc, const void* l, void* out,
                                   void* quot, int rows, int dh,
                                   const void* tab, int tab_len, int width,
                                   int index_bits, int frac_out, int round_out,
                                   float lim, void* stream) {
  if (width > 16) return static_cast<int>(cudaErrorInvalidValue);
  return softmax_div<uint32_t>(acc, l, out, quot, rows, dh, tab, tab_len,
                               width, index_bits, frac_out, round_out, lim,
                               stream);
}
