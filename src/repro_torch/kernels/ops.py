"""Built-in SIMDive ops: registration + thin public entry points.

Counterpart of ``repro.kernels.ops``: ``elemwise``, ``packed``,
``attention``, ``matmul_int``, ``matmul_emul`` and ``sqrt`` (which the
reference registers for its oracle alone; here it has a kernel too, in
``csrc/elemwise.cu``), plus one op of the port's own,
``decode_attention`` (a decode step's attention and its divider; the
reference runs that function as jnp around ``elemwise``). Each registers
its plain PyTorch version and its CUDA kernel with
:mod:`repro_torch.kernels.registry`. The
kernels mask their ragged edges themselves, so there is no pad-to-block
step: any shape goes straight in, and the results equal the reference's
padded ones.
"""
from __future__ import annotations

import torch

from repro_torch.core.error_lut import table_for
from repro_torch.core.simdive import SimdiveSpec, simdive_mul, simdive_sqrt
from . import datapath as dp
from . import decode_attention as _da
from . import elemwise as _ew
from . import flash_attention as _fa
from . import logmatmul as _lm
from . import packed_simd as _ps
from .flash_attention import DEFAULT_DIV_SPEC, DEFAULT_FRAC_OUT
from .registry import get_op, register_op

__all__ = ["simdive_elemwise", "simdive_packed", "simdive_attention",
           "simdive_matmul_int"]


# --------------------------------------------------------------- elemwise --
def _elemwise_ref(a, b, *, spec, op="mul", mode=None, frac_out=0):
    return _ew.elemwise_ref(a, b, spec, op=op, mode=mode, frac_out=frac_out)


def _elemwise_cuda(a, b, *, spec, block, op="mul", mode=None, frac_out=0):
    return _ew.elemwise_cuda(a, b, spec, op=op, mode=mode, frac_out=frac_out,
                             block=block)


# -------------------------------------------------------------- attention --
def _attention_ref(q, k, v, *, spec, causal=True, window=0, approx_div=True,
                   frac_out=DEFAULT_FRAC_OUT, q_offset=0, kv_group=1):
    return _fa.flash_attention_ref(
        q, k, v, spec=spec, causal=causal, window=window,
        approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
        kv_group=kv_group)


def _attention_cuda(q, k, v, *, spec, block, causal=True, window=0,
                    approx_div=True, frac_out=DEFAULT_FRAC_OUT, q_offset=0,
                    kv_group=1):
    # block: (q_chunk, kv_chunk[, depth]) as in the reference; the tile is
    # the port's own (flash_attention.check_block)
    return _fa.flash_attention_cuda(
        q, k, v, spec=spec, causal=causal, window=window,
        approx_div=approx_div, frac_out=frac_out, q_offset=q_offset,
        kv_group=kv_group, block=block)


# ------------------------------------------------------------- matmul_int --
def _matmul_int_ref(x, w, *, spec):
    lead = x.shape[:-1]
    out = _lm.logmatmul_ref(x.reshape(-1, x.shape[-1]), w, spec)
    return out.reshape(*lead, w.shape[1])


def _matmul_int_cuda(x, w, *, spec, block):
    # block: (bm, bn, bk[, k_unroll[, depth]]) as in the reference; the
    # tiles are the port's own (logmatmul.split_block / check_block)
    lead = x.shape[:-1]
    out = _lm.logmatmul_cuda(x.reshape(-1, x.shape[-1]), w, spec, block)
    return out.reshape(*lead, w.shape[1])


# ------------------------------------------------------------ matmul_emul --
#: rows x K chunk x N products one step of the plain version holds
_EMUL_BUDGET = 1 << 24


def _matmul_emul_ref(qx, sx, qw, sw, *, spec, k_chunk=128):
    """Integer core of the model-facing emulated matmul: (M,K) x (K,N) with
    SIMDive scalar products over K chunks of ``k_chunk``, int64
    accumulation (the reference's ``_matmul_emul_ref``).

    Where ``2 * width <= 31`` the sign is joined into the int32 product
    (exact: |product| < 2^30) and the chunk is summed into int64, as the
    reference's fast path does; wider lanes multiply in int64. Rows are
    chunked too, so one (rows, k_chunk, N) slab stays under
    ``_EMUL_BUDGET`` elements — every addend and so every sum is the same.
    """
    _lm.check_matmul_width(spec.width, "matmul_emul")
    M, K = qx.shape
    N = qw.shape[1]
    fast = 2 * spec.width <= 31
    acc = torch.zeros((M, N), dtype=torch.int64, device=qx.device)
    mb = max(1, min(M, _EMUL_BUDGET // max(k_chunk * N, 1)))
    for m0 in range(0, M, mb):
        for k0 in range(0, K, k_chunk):
            xk, sxk = qx[m0:m0 + mb, k0:k0 + k_chunk], sx[m0:m0 + mb,
                                                         k0:k0 + k_chunk]
            wk, swk = qw[k0:k0 + k_chunk], sw[k0:k0 + k_chunk]
            p = simdive_mul(xk[:, :, None], wk[None], spec)     # (m, kc, N)
            s = sxk[:, :, None].to(torch.int64) * swk[None].to(torch.int64)
            if fast:
                sp = p.to(torch.int32) * s.to(torch.int32)
                acc[m0:m0 + mb] += sp.sum(dim=1, dtype=torch.int64)
            else:
                acc[m0:m0 + mb] += (p * s).sum(dim=1)
    return acc


def _matmul_emul_cuda(qx, sx, qw, sw, *, spec, block, k_chunk=128):
    """The kernel path of the emulated matmul: re-join the signs and run
    ``logmatmul`` — its int32 sum where that is exact (width 8 at K <=
    32,768: every served linear), widened to int64, else its wide form,
    whose int64 sum is the plain version's (``logmatmul.needs_wide``)."""
    del k_chunk  # the kernel's K slabs replace the host-side chunking
    _lm.check_matmul_width(spec.width, "matmul_emul")
    x = qx.to(torch.int32) * sx.to(torch.int32)
    w = qw.to(torch.int32) * sw.to(torch.int32)
    if _lm.needs_wide(x.shape[1], spec.width):
        return _lm.logmatmul_cuda(x, w, spec, block, wide=True)
    return _matmul_int_cuda(x, w, spec=spec, block=block).to(torch.int64)


# ------------------------------------------------------- widthcheck meta --
# Analysis metadata for repro_torch.analysis.widthcheck (the reference's,
# case for case): per op and width, the pure traceable functions + abstract
# operand domains that *are* the arithmetic the kernels execute (the plain
# integer stages each kernel mirrors, not the launch wrappers). The port
# has one integer form, so each reference pair "... kernel" / "... ref" is
# one case here. A returned string is a declared, auditable skip; None
# means the width is out of the op's domain. Each case names its bus: the
# lane word the CUDA kernel computes on.

_AN_IB = 3                                   # 64-region tables everywhere
#: coeff_bits exercised per width: the shipped BENCH/serve configs
#: (8b/cb6, 16b/cb8, 16b/cb0 zero-table, 32b/cb8)
_AN_COEFF = {8: (6,), 16: (8, 0), 32: (8,)}
_AN_DIV_FO = {8: 8, 16: 15, 32: 16}          # shipped div frac_out per width


def _bus(width):
    # simdive-lint: allow(unguarded-uint64): a case's declared bus, a dtype tag only
    return torch.uint64 if width > 16 else torch.uint32


def _lane_arg(width, shape=(8, 128)):
    from repro_torch.analysis.domain import ArgSpec

    return ArgSpec(tuple(shape), torch.int64, 0, (1 << width) - 1)


def _elemwise_analysis(width):
    from repro_torch.analysis.domain import ArgSpec, TraceCase

    if width not in (8, 16, 32):
        return None
    cases = []
    fo_div = _AN_DIV_FO[width]
    for cb in _AN_COEFF[width]:
        for op, fo in (("mul", 0), ("div", fo_div), ("mixed", min(fo_div, 8))):
            tab = dp.op_table(op, width, cb, _AN_IB)
            la = _lane_arg(width)
            args = (la, la)
            if op == "mixed":
                args += (ArgSpec(la.shape, torch.int64, 0, 1),)

            def fn(a, b, m=None, *, _t=tab, _o=op, _f=fo):
                return dp.lane_op(a, b, _t, width=width, index_bits=_AN_IB,
                                  op=_o, frac_out=_f, mode=m, round_out=True)

            cases.append(TraceCase(
                label=f"elemwise/{op} w{width} cb{cb} fo{fo}",
                fn=fn, args=args, bus=_bus(width),
                params=dict(op=op, width=width, coeff_bits=cb,
                            frac_out=fo)))
    return cases


def _packed_analysis(width):
    from repro_torch.analysis.domain import ArgSpec, TraceCase

    if width not in (8, 16):
        return ("packed lanes need >= 2 per 32-bit word; width 32 is the "
                "elemwise (full-word) path")
    cases = []
    cb = _AN_COEFF[width][0]
    word = ArgSpec((8, 64), torch.int64, 0, (1 << 32) - 1)
    for op, fo in (("mul", 0), ("div", 8), ("mixed", 8)):
        tab = dp.op_table(op, width, cb, _AN_IB)
        spec = SimdiveSpec(width=width, coeff_bits=cb, index_bits=_AN_IB)
        args = (word, word) + ((word,) if op == "mixed" else ())

        def fn(aw, bw, mw=None, *, _t=tab, _s=spec, _o=op, _f=fo):
            return _ps.packed_word_op(aw, bw, _t, mw, spec=_s, op=_o,
                                      frac_out=_f)

        cases.append(TraceCase(
            label=f"packed/{op} w{width} cb{cb} fo{fo}", fn=fn, args=args,
            bus=torch.uint32,
            note="ref path shares dp.lane_op (proved under elemwise)",
            params=dict(op=op, width=width, coeff_bits=cb, frac_out=fo)))
    return cases


def _matmul_int_analysis(width):
    from repro_torch.analysis.domain import ArgSpec, TraceCase

    if width == 8:
        cases = []
        cb = _AN_COEFF[8][0]
        tab = dp.op_table("mul", 8, cb, _AN_IB)
        spec = SimdiveSpec(width=8, coeff_bits=cb, index_bits=_AN_IB)
        lane = (1 << 8) - 1
        for K in (32, 128, 512):             # the BENCH K sweep
            x = ArgSpec((8, K), torch.int32, -lane, lane)
            w = ArgSpec((K, 128), torch.int32, -lane, lane)

            def fn(xt, wt, *, _t=tab, _s=spec):
                return dp.wrap_int32(_lm._partial(xt, wt, _t, _s)).to(
                    torch.int32)

            cases.append(TraceCase(
                label=f"matmul_int w8 cb{cb} K{K}", fn=fn, args=(x, w),
                bus=torch.int32,
                note="int32 accumulator; operands are lane-width "
                     "magnitudes with sign (sign_split clamps)",
                params=dict(width=8, coeff_bits=cb, K=K)))
        return cases
    if width == 16:
        return ("int32 accumulator is exact only while K * max_product < "
                "2^31; callers scale operands per the logmatmul.py "
                "contract — not provable width-generically")
    if width == 32:
        return ("width-32 matmul is not shipped; the 64-bit product bus "
                "exceeds every accumulator the kernel offers")
    return None


def _matmul_emul_analysis(width):
    from repro_torch.analysis.domain import ArgSpec, TraceCase

    if width not in (8, 16):
        if width == 32:
            return ("width-32 emulated matmul is not shipped (64-bit "
                    "product bus exceeds the int64 accumulator)")
        return None
    lane = (1 << width) - 1
    spec = SimdiveSpec(width=width, coeff_bits=_AN_COEFF[width][0],
                       index_bits=_AN_IB)
    M, K, N = 8, 256, 16
    qx = ArgSpec((M, K), torch.int64, 0, lane)
    sx = ArgSpec((M, K), torch.int32, -1, 1)
    qw = ArgSpec((K, N), torch.int64, 0, lane)
    sw = ArgSpec((K, N), torch.int32, -1, 1)

    def fn(a, b, c, d, *, _s=spec):
        return _matmul_emul_ref(a, b, c, d, spec=_s)

    return [TraceCase(
        label=f"matmul_emul w{width} K{K}", fn=fn, args=(qx, sx, qw, sw),
        bus=torch.int64,
        note="cuda path recombines signs into matmul_int (proved there)",
        params=dict(width=width, coeff_bits=spec.coeff_bits, K=K))]


def _softmax_div_cases(prefix, width, acc_shape, note):
    from repro_torch.analysis.domain import ArgSpec, TraceCase

    if width not in (8, 16, 32):
        return None
    cb = _AN_COEFF[width][0]
    tab = table_for("div", width, cb, _AN_IB)
    fo = min(_AN_DIV_FO[width], 15)
    acc = ArgSpec(acc_shape, torch.float32, -1e30, 1e30)
    l = ArgSpec(acc_shape[:-1], torch.float32, 0.0, 1e30)

    def fn(a, d, *, _t=tab):
        return _fa.softmax_div(a, d, _t, width=width, index_bits=_AN_IB,
                               frac_out=fo, round_out=True)

    return [TraceCase(
        label=f"{prefix}/softmax_div w{width} cb{cb} fo{fo}",
        fn=fn, args=(acc, l), bus=_bus(width), note=note,
        params=dict(width=width, coeff_bits=cb, frac_out=fo))]


def _attention_analysis(width):
    return _softmax_div_cases(
        "attention", width, (8, 64),
        "float accumulator stages are out of integer scope; the "
        "quantize-clip-divide ladder is what is proved")


def _decode_attention_analysis(width):
    return _softmax_div_cases(
        "decode_attention", width, (2, 2, 4, 64),
        "the decode step's finalize over (B, KVH, G, dh) rows; its float "
        "stages are out of integer scope")


def _sqrt_analysis(width):
    from repro_torch.analysis.domain import TraceCase

    if width not in (8, 16, 32):
        return None
    cases = []
    for fo in (0, 8):
        def fn(a, *, _f=fo):
            return simdive_sqrt(a, width, frac_out=_f)

        cases.append(TraceCase(
            label=f"sqrt w{width} fo{fo}", fn=fn,
            args=(_lane_arg(width),), bus=_bus(width),
            params=dict(width=width, frac_out=fo)))
    return cases


# each kernel that has a width-32 form (8-byte lanes, or the attention
# finalizes' 64-bit lanes: csrc/*_w32.cu) counts those launches apart as
# well, under <name>_w32
register_op("elemwise", ref=_elemwise_ref, cuda=_elemwise_cuda,
            default_block=_ew.DEFAULT_BLOCK,
            kernels={"elemwise": _ew.elemwise_cuda,
                     "elemwise_w32": _ew.elemwise_cuda.w32},
            analysis=_elemwise_analysis)
# sqrt: one launch shape, fixed in the C entry (256 threads of 16 bytes of
# lanes); both versions take (a, spec, frac_out) as they are
register_op("sqrt", ref=_ew.sqrt_ref, cuda=_ew.sqrt_cuda,
            kernels={"sqrt": _ew.sqrt_cuda, "sqrt_w32": _ew.sqrt_cuda.w32},
            analysis=_sqrt_analysis)
# packed: both versions take any rank and return (..., 2 * Nw) words, the
# shape the reference gets through its 2-D view and pad-to-block step (the
# kernel's word mapping is flat and masks its tail), so they register as
# they are
register_op("packed", ref=_ps.packed_ref, cuda=_ps.packed_cuda,
            default_block=_ps.DEFAULT_BLOCK,
            kernels={"packed": _ps.packed_cuda},
            analysis=_packed_analysis)
# attention blocks are (q_chunk, kv_chunk[, depth]); depth >= 1 runs the
# cp.async kv ring (bit-identical output). Each candidate is checked for the
# worst case the kernel takes (f32, d_head 128) when it is registered.
for _block in (_fa.DEFAULT_BLOCK, *_fa.BLOCK_CANDIDATES):
    _fa.check_block(_block)
register_op("attention", ref=_attention_ref, cuda=_attention_cuda,
            default_block=_fa.DEFAULT_BLOCK,
            block_candidates=_fa.BLOCK_CANDIDATES,
            kernels={"attention": _fa.flash_attention_cuda,
                     "attention_pipelined":
                         _fa.flash_attention_pipelined_cuda,
                     "attention_w32": _fa.flash_attention_cuda.w32,
                     "attention_pipelined_w32":
                         _fa.flash_attention_pipelined_cuda.w32},
            analysis=_attention_analysis)
# decode_attention: its launch shape (a cluster of C blocks of 4 warps per
# (b, kv head)) is planned by the wrapper from the shape and the card
# (decode_attention.cluster_size; cluster= pins it), so it registers no
# block and nothing is autotuned; pos / slot are keywords (ints or (B,)
# tensors), not positional tensors
register_op("decode_attention", ref=_da.decode_attention_ref,
            cuda=_da.decode_attention_cuda,
            kernels={"decode_attention": _da.decode_attention_cuda,
                     "decode_attention_w32": _da.decode_attention_cuda.w32},
            analysis=_decode_attention_analysis)
# matmul blocks carry k_unroll as a 4th and the pipeline depth as a 5th
# component; each candidate is checked against the compiled tiles and the
# shared-memory limit here, when it is registered
_MATMUL_KERNELS = {"matmul": _lm.logmatmul_cuda,
                   "matmul_pipelined": _lm.logmatmul_pipelined_cuda}
for _block in (_lm.DEFAULT_BLOCK, *_lm.BLOCK_CANDIDATES):
    _lm.check_block(_block)


def _matmul_blocks(x, *_):
    """The candidates for x's rows, the untimed one first
    (:func:`logmatmul.blocks_for`)."""
    return _lm.blocks_for(x.numel() // max(x.shape[-1], 1))


register_op("matmul_int", ref=_matmul_int_ref, cuda=_matmul_int_cuda,
            default_block=_lm.DEFAULT_BLOCK,
            block_candidates=_lm.BLOCK_CANDIDATES, kernels=_MATMUL_KERNELS,
            analysis=_matmul_int_analysis, blocks_for=_matmul_blocks)
register_op("matmul_emul", ref=_matmul_emul_ref, cuda=_matmul_emul_cuda,
            default_block=_lm.DEFAULT_BLOCK,
            block_candidates=_lm.BLOCK_CANDIDATES, kernels=_MATMUL_KERNELS,
            analysis=_matmul_emul_analysis, blocks_for=_matmul_blocks)


# ------------------------------------------------------------- public API --
def simdive_elemwise(a, b, spec: SimdiveSpec, op: str = "mul", mode=None,
                     frac_out: int = 0, backend: str = "auto", block=None):
    """Elementwise SIMDive mul/div/mixed over same-shape lane tensors."""
    return get_op("elemwise", spec, backend, block=block)(
        a, b, op=op, mode=mode, frac_out=frac_out)


def simdive_packed(aw, bw, spec: SimdiveSpec, op: str = "mul", mode=None,
                   frac_out: int = 0, backend: str = "auto", block=None):
    """Packed-lane SIMDive over uint32 word tensors (last dim = words):
    4 x 8-bit or 2 x 16-bit lanes a word in, ``(..., 2 * Nw)`` words of
    2*width-bit results out. ``mode`` (mixed): packed per-lane mode words,
    a nonzero lane field multiplies."""
    return get_op("packed", spec, backend, block=block)(
        aw, bw, op=op, mode=mode, frac_out=frac_out)


def simdive_attention(q, k, v, spec: SimdiveSpec | None = None, *,
                      causal: bool = True, window: int = 0,
                      approx_div: bool = True,
                      frac_out: int = DEFAULT_FRAC_OUT, q_offset: int = 0,
                      kv_group: int = 1, backend: str = "auto", block=None):
    """Flash attention with the SIMDive softmax divider.

    q: (BH, Sq, dh); k, v: (BH / kv_group, Skv, dh) — heads flattened.
    ``spec`` picks the divider config (defaults to the width-16 attention
    divider). ``block`` ``(q_chunk, kv_chunk[, depth])`` picks the kernel's
    schedule; None autotunes over the registered candidates. The plain
    version (CPU tensors) ignores it.
    """
    spec = DEFAULT_DIV_SPEC if spec is None else spec
    return get_op("attention", spec, backend, block=block)(
        q, k, v, causal=causal, window=window, approx_div=approx_div,
        frac_out=frac_out, q_offset=q_offset, kv_group=kv_group)


def simdive_matmul_int(x, w, spec: SimdiveSpec, backend: str = "auto",
                       blocks=None):
    """Signed int32 (..., K) @ (K, N) with SIMDive products (int32 result)."""
    return get_op("matmul_int", spec, backend, block=blocks)(x, w)
