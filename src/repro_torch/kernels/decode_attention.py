"""One decode step's attention with its SIMDive finalize: kernel wrapper and
plain version.

The function is the reference's ``repro.models.layers.decode_attention_append``:
single-token attention of ``q (B, KVH, G, dh)`` over a read-only cache
``(B, Smax, KVH, dh)`` plus the new token ``k_new / v_new (B, 1, KVH, dh)``,
whose self term is folded in analytically, then ``acc / l`` — exact, or on
the SIMDive divider with a per-row shared exponent. The reference has no
TPU kernel of its own for it: there it is jnp (one XLA fusion) around the
elemwise divider. On the card it is one launch of ``csrc/decode_attention.cu``
(:func:`decode_attention_cuda`) instead of ~55 small ones a layer: one
thread-block cluster of ``C`` blocks per (b, kv head), each block a
contiguous share of that row's history (:func:`rank_range`), the blocks of a
cluster meeting through distributed shared memory. ``C`` (1 to
:data:`MAX_CLUSTER`) is planned from the shape and the card's SM count alone
(:func:`cluster_size`), never from ``pos``, so a captured step replays at
any position; ``cluster=`` pins it.

The plain version is :func:`decode_attention_ref`: :func:`decode_attention_acc`
(the masks, the softmax and ``p . V``, as ``layers.decode_attention_append``
computes them) and the same divider stages the flash kernel's finalize is
held to (:func:`repro_torch.kernels.flash_attention.softmax_div`).

``pos`` / ``slot`` are each a Python int (a kernel argument) or a ``(B,)``
int32 / int64 tensor on q's device (read by the kernel through its
pointer): neither costs a launch or a host sync, so a captured step can
advance them in place. :func:`check_args` holds every condition the kernel
needs and refuses anything else before a launch: all tensors f32 or all
bf16, d_head 64, 80 or 128, ``1 <= G <=`` :data:`MAX_G`, caches contiguous
and 16-byte aligned (the kernel reads their rows as 16-byte vectors; at
d_head 80 a row is 10 or 20 of them, read by 16 or 32 lanes of a warp,
the rest idle).

Float order: with one round of history (up to ``C`` x
:func:`chunk_slots` valid slots: ``C x 2,730`` at G = 3) the blocks of a
cluster take the cluster-wide max before any ``p``, so every ``p`` is
relative to the global max and rounded to the cache's type before ``p . V``
as in the plain version; the ranks' partial sums are combined in rank
order, so the output is deterministic, and kernel and plain version differ
in f32 summation order alone. A longer history is walked in rounds with an
online-softmax rescale, which rounds ``p`` relative to each round's
cluster-wide max.

**Width 32.** A divider at width 32 runs the kernel's 64-bit-lane form
(``csrc/decode_attention_w32.cu`` over the template in
``csrc/decode_attention.cuh``, the ``*_w32`` C entries); only the finalize
differs, and each such launch also counts apart, in
``decode_attention_cuda.w32`` (``decode_attention_w32`` in
``launch_counts()``).
"""
from __future__ import annotations

import functools
import numbers
from types import SimpleNamespace

import torch

from repro_torch.core.error_lut import table_for
from repro_torch.core.mitchell import lane_max_float
from repro_torch.core.simdive import SimdiveSpec
from . import build
from .flash_attention import (
    DEFAULT_DIV_SPEC,
    DEFAULT_FRAC_OUT,
    entry_suffix,
    softmax_div,
)

__all__ = ["MAX_G", "MAX_CLUSTER", "decode_attention_acc",
           "decode_attention_ref", "cluster_size", "rank_range", "chunk_slots",
           "check_args", "check_cluster", "decode_attention_cuda",
           "max_active_clusters"]

#: most q heads a kv head the kernel takes (csrc/decode_attention.cu kMaxG)
MAX_G = 8
#: most blocks a cluster: the portable cluster size (kMaxCluster)
MAX_CLUSTER = 8
_SCORE_FLOATS = 8192           # a block's scores a round (kScoreFloats)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80, 128)
_INDEX_DTYPES = {torch.int32: 0, torch.int64: 1}
_ALIGN = 16
_MAX_INDEX_BITS = 4            # a 256-entry div table (kDivTable)
_INT64 = (-(1 << 63), (1 << 63) - 1)


# ---------------------------------------------------------- plain version --
def _pos4(pos):
    """Broadcast a decode position to score shape (B,KVH,G,Smax): scalars
    (Python ints) pass through, per-row (B,) tensors reshape to (B,1,1,1)."""
    if torch.is_tensor(pos) and pos.ndim:
        return pos.reshape(-1, 1, 1, 1)
    return int(pos)


def history_valid(Smax: int, pos, slot, *, ring_full=False, window=0,
                  device=None) -> torch.Tensor:
    """The cache slots a decode step reads, as a bool mask broadcastable
    to score shape (B, KVH, G, Smax): ``[0, pos)``, cut to the window when
    ``Smax > window``; under ``ring_full`` every slot but ``slot`` once
    the ring has wrapped."""
    idx = torch.arange(Smax, device=device)[None, None, None, :]
    pos, slot = _pos4(pos), _pos4(slot)
    if ring_full:
        # ring not yet wrapped: history is [0, pos); wrapped: every slot
        # except the one being replaced holds live history
        if torch.is_tensor(pos):
            return torch.where(pos < Smax, idx < pos, idx != slot)
        return idx < pos if pos < Smax else idx != slot
    valid = idx < pos
    if window and Smax > window:
        valid = valid & (idx > pos - window)
    return valid


def decode_attention_acc(q, k_cache, v_cache, k_new, v_new, pos, slot, *,
                         ring_full=False, window=0):
    """``(acc (B,KVH,G,dh), l (B,KVH,G))`` in float32: everything of the
    decode attention but its final ``acc / l``.

    A stale ``slot`` is masked only under ``ring_full`` (once the ring has
    wrapped); the window applies only when ``Smax > window``; each batch
    row may have its own ``pos``. ``p`` is rounded to the cache's dtype
    before ``p . V``; the self term's ``p`` is not.
    """
    B, Smax, KVH, dh = k_cache.shape
    scale = dh ** -0.5
    f32 = torch.float32
    qf = q.to(f32)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.to(f32)) * scale
    valid = history_valid(Smax, pos, slot, ring_full=ring_full,
                          window=window, device=q.device)
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    s_self = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, 0].to(f32)) * scale
    m = torch.maximum(s.amax(dim=-1), s_self)              # (B,KVH,G)
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1) + p_self
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    acc = acc + p_self[..., None] * v_new[:, 0].to(f32)[:, :, None, :]
    return acc, l


def decode_attention_ref(q, k_cache, v_cache, k_new, v_new, *, pos, slot,
                         spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                         ring_full=False, window=0, approx_div=False,
                         frac_out=DEFAULT_FRAC_OUT) -> torch.Tensor:
    """The plain version: :func:`decode_attention_acc`, then ``acc / l``
    exact or (``approx_div``) on the divider ``spec`` at ``frac_out``
    fraction bits. Returns ``(B, KVH, G, dh)`` in ``q.dtype``."""
    acc, l = decode_attention_acc(q, k_cache, v_cache, k_new, v_new, pos,
                                  slot, ring_full=ring_full, window=window)
    if approx_div:
        tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                        device=q.device)
        out = softmax_div(acc, l, tab, width=spec.width,
                          index_bits=spec.index_bits, frac_out=frac_out,
                          round_out=spec.round_output)
    else:
        out = acc / l[..., None]
    return out.to(q.dtype)


# ------------------------------------------------------------- the plan --
def cluster_size(B: int, KVH: int, sm_count: int) -> int:
    """Blocks a cluster (1 to :data:`MAX_CLUSTER`): the fewest that put at
    least ``sm_count`` blocks on the card, ``ceil(sm_count / (B * KVH))``;
    1 when the ``B * KVH`` rows alone fill it. So ``B * KVH * C`` stays
    under two blocks an SM, one wave where the card holds two (checked on
    the card with :func:`max_active_clusters`). Depends on the shape and
    the card, never on ``pos``."""
    rows = B * KVH
    if rows >= sm_count:
        return 1
    return min(MAX_CLUSTER, -(-sm_count // rows))


def rank_range(lo: int, hi: int, rank: int, C: int) -> tuple[int, int]:
    """The share ``[a, b)`` of ``[lo, hi)`` that block ``rank`` of a
    cluster of ``C`` takes, the kernel's integer formula: contiguous,
    in rank order, sizes differing by at most one, empty when
    ``hi - lo < C`` leaves a rank nothing."""
    n = hi - lo
    return lo + n * rank // C, lo + n * (rank + 1) // C


def chunk_slots(Smax: int, G: int, C: int) -> int:
    """Slots a block takes a round: ``min(8192 // G, ceil(Smax / C))``. A
    history of up to ``C`` times this is one round."""
    return min(_SCORE_FLOATS // G, -(-Smax // C))


def check_cluster(cluster) -> None:
    """Raise unless ``cluster`` is None (the planner's choice) or an int in
    1..:data:`MAX_CLUSTER`."""
    if cluster is None:
        return
    if isinstance(cluster, bool) or not isinstance(cluster, numbers.Integral):
        raise TypeError(f"decode_attention: cluster must be an int or None, "
                        f"got {type(cluster).__name__}")
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"decode_attention: cluster must be in 1.."
                         f"{MAX_CLUSTER} blocks, got {cluster}")


# ---------------------------------------------------------- kernel wrapper --
def _index_arg(x, name: str, B: int, device) -> tuple:
    """``(scalar, tensor or None)`` of a position argument: a Python int,
    or a (B,) int32 / int64 tensor on ``device``."""
    if isinstance(x, bool) or not (isinstance(x, numbers.Integral)
                                   or torch.is_tensor(x)):
        raise TypeError(f"decode_attention: {name} must be an int or a (B,) "
                        f"integer tensor, got {type(x).__name__}")
    if not torch.is_tensor(x):
        if not _INT64[0] <= int(x) <= _INT64[1]:
            raise ValueError(f"decode_attention: {name} {x} is outside int64")
        return int(x), None
    if x.ndim != 1 or x.shape[0] != B or x.dtype not in _INDEX_DTYPES:
        raise ValueError(f"decode_attention: a tensor {name} must be (B,) = "
                         f"({B},) int32 or int64, got {tuple(x.shape)} "
                         f"{x.dtype} (pass a scalar as a Python int)")
    if x.device != device:
        raise ValueError(f"decode_attention: {name} lies on {x.device}, q on "
                         f"{device}")
    return 0, x


def check_args(q, k_cache, v_cache, k_new, v_new, pos, slot, *,
               ring_full=False, window=0, cluster=None) -> tuple:
    """Raise unless the kernel takes these arguments; pure Python, so it
    runs on any device. Returns ``(B, Smax, KVH, G, dh)``."""
    check_cluster(cluster)
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention: expected q (B,KVH,G,dh) and "
                         f"caches (B,Smax,KVH,dh), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, Smax, KVH, dh = k_cache.shape
    G = q.shape[2]
    if (v_cache.shape != k_cache.shape or q.shape != (B, KVH, G, dh)
            or k_new.shape != (B, 1, KVH, dh)
            or v_new.shape != (B, 1, KVH, dh)):
        raise ValueError(
            f"decode_attention: shapes do not match: q {tuple(q.shape)}, "
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)}, new "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    dtypes = {t.dtype for t in (q, k_cache, v_cache, k_new, v_new)}
    if len(dtypes) != 1 or q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention kernel takes q, caches and new "
                        f"token all float32 or all bfloat16, got "
                        f"{sorted(map(str, dtypes))}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel is compiled for d_head in "
                         f"{_HEAD_DIMS}, got {dh}")
    if not 1 <= G <= MAX_G:
        raise ValueError(f"decode_attention kernel takes 1 to {MAX_G} q heads "
                         f"a kv head, got {G}")
    if min(B, Smax, KVH) < 1 or B * KVH >= 1 << 31:
        raise ValueError(f"decode_attention: B {B}, Smax {Smax}, KVH {KVH} "
                         "must be >= 1, B * KVH < 2^31")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"decode_attention kernel reads {name} rows as "
                             f"{_ALIGN}-byte vectors: it must be contiguous "
                             f"and {_ALIGN}-byte aligned")
    devices = {t.device for t in (q, k_cache, v_cache, k_new, v_new)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: tensors on {sorted(map(str, devices))}")
    _index_arg(pos, "pos", B, q.device)
    _index_arg(slot, "slot", B, q.device)
    if not isinstance(window, numbers.Integral) or not 0 <= window < 1 << 31:
        raise ValueError(f"decode_attention: window must be an int in "
                         f"[0, 2^31), got {window!r}")
    return B, Smax, KVH, G, dh


def decode_attention_cuda(q, k_cache, v_cache, k_new, v_new, *, pos, slot,
                          spec: SimdiveSpec = DEFAULT_DIV_SPEC,
                          ring_full=False, window=0, approx_div=False,
                          frac_out=DEFAULT_FRAC_OUT,
                          cluster=None) -> torch.Tensor:
    """Launch the CUDA kernel: one launch for the whole function, one
    cluster of ``cluster`` blocks of 4 warps per (b, kv head); None takes
    :func:`cluster_size` for the card, an int in 1..:data:`MAX_CLUSTER`
    pins it. Otherwise the same arguments as :func:`decode_attention_ref`.

    Launches on the current stream and does not synchronise. Raises on CPU
    tensors, on what :func:`check_args` refuses and on a failed build or
    launch — a cluster launch that fails is never retried at another size,
    and nothing gives way to the plain version. Width 32 runs the
    kernel's 64-bit-lane form.
    """
    B, Smax, KVH, G, dh = check_args(q, k_cache, v_cache, k_new, v_new, pos,
                                     slot, ring_full=ring_full, window=window,
                                     cluster=cluster)
    if not q.is_cuda:
        raise ValueError(f"decode_attention CUDA kernel: q lies on "
                         f"{q.device}, not on a CUDA device")
    sfx = entry_suffix(spec.width)
    if not 0 <= frac_out <= 31:
        raise ValueError(f"frac_out must be in [0, 31], got {frac_out}")
    if not 1 <= spec.index_bits <= _MAX_INDEX_BITS:
        raise ValueError(f"the kernel stages a div table of index_bits <= "
                         f"{_MAX_INDEX_BITS}, got {spec.index_bits}")
    if cluster is None:
        cluster = cluster_size(B, KVH, _sm_count(q.device))
    pos_s, pos_t = _index_arg(pos, "pos", B, q.device)
    slot_s, slot_t = _index_arg(slot, "slot", B, q.device)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits,
                    device=q.device, dtype=torch.int32)
    out = torch.empty_like(q)
    lib = build.load(q.device)

    def index(t):
        if t is None:
            return None, 0, 0
        return t.data_ptr(), _INDEX_DTYPES[t.dtype], t.stride(0)

    with torch.cuda.device(q.device):
        code = getattr(lib, "simdive_decode_attention" + sfx)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
            tab.data_ptr(), tab.numel(), B, Smax, KVH, G, dh,
            _DTYPES[q.dtype], int(cluster), pos_s, *index(pos_t), slot_s,
            *index(slot_t),
            int(bool(ring_full)), int(window), int(bool(approx_div)),
            dh ** -0.5, spec.width, spec.index_bits, int(frac_out),
            int(spec.round_output), lane_max_float(spec.width),
            build.current_stream())
    build.check(code, "simdive_decode_attention" + sfx)
    decode_attention_cuda.launches += 1
    decode_attention_cuda.w32.launches += bool(sfx)
    return out


#: kernel launches made through the wrapper (read by chip_smoke.py); of
#: them, ``w32.launches`` ran the width-32 form, counted apart too
decode_attention_cuda.launches = 0
decode_attention_cuda.w32 = SimpleNamespace(launches=0)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_active_clusters(Smax: int, G: int, dh: int, dtype: torch.dtype,
                        cluster: int) -> int:
    """How many clusters of ``cluster`` blocks the card holds at once for
    the kernel serving (dtype, dh, G) at cache length ``Smax``
    (``cudaOccupancyMaxActiveClusters``): ``B * KVH`` at most this many
    run in one wave. Raises on a CUDA error."""
    check_cluster(cluster)
    n = build.load().simdive_decode_attention_max_clusters(
        Smax, G, dh, _DTYPES[dtype], int(cluster))
    if n < 0:
        build.check(-n, "simdive_decode_attention_max_clusters")
    return n
