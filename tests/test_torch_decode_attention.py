"""Port vs reference: one decode step's attention (``decode_attention``).

* The plain version of the ``decode_attention`` kernel
  (``kernels.decode_attention.decode_attention_ref``) and the plain body of
  ``models.layers.decode_attention_append`` are held against the
  reference's ``repro.models.layers.decode_attention_append`` on the same
  numpy-seeded inputs, at the tolerances of
  ``test_torch_flash_attention.py``, for what its decode test leaves out:
  per-row positions at distinct depths (0 and Smax - 1 included), d_head
  128, G in {1, 3, 8} and bf16 caches. bf16 caches are compared with f32 q
  (so f32 outputs): ``p`` is still rounded to bf16 before ``p . V``, and
  the comparison is not blurred by the output's final bf16 rounding.
* The two plain versions are bit-equal to each other on the CPU.
* The wrapper's argument checks (``check_args``, pure Python) refuse what
  the kernel does not take before any launch, and routing has no fallback:
  the ``cuda`` route on CPU tensors raises, ``auto`` on the CPU takes the
  plain version. The kernel itself runs only on the card (``chip_smoke.py``
  phase 3 holds it against ``decode_attention_ref`` there).
* The kernel's cluster plan, in pure Python: the planner
  (``cluster_size``) stays in 1..8, takes 1 when ``B * KVH`` fills the
  card and keeps ``B * KVH * C`` within the resident blocks it assumes;
  ``rank_range`` covers a history exactly once against brute force; and a
  plain model of the kernel's cluster arithmetic (:func:`cluster_model`:
  rounds of ``C`` shares, the cluster-wide max from the ranks' maxima and
  the self score, ``p`` rounded to the cache's type, partials summed in
  rank order, the self term, the finalize) is held to the reference at
  the same tolerances for C in {1, 2, 3, 8}, with the ring's masked slot
  and a window's edge on rank boundaries, empty ranks, and several rounds.
  ``check_cluster`` refuses an illegal ``cluster`` before any launch.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx import ApproxConfig as RApprox
from repro.models import layers as r_layers
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.core.error_lut import table_for
from repro_torch.kernels import decode_attention as t_da
from repro_torch.kernels import get_op, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import softmax_div
from repro_torch.models import layers as t_layers

torch.set_num_threads(1)

# as test_torch_flash_attention.py: float32 summation order only; the
# SIMDive divider's operands may move by one unit of a 16-bit lane
EXACT_TOL = dict(rtol=3e-5, atol=3e-5)
APPROX_TOL = dict(rtol=0, atol=1.25e-3)

# (id, B, Smax, KVH, G, dh, cache dtype, pos, ring_full, window); a list
# pos is per-row ((B,) tensors), an int a scalar
CASES = [
    ("per-row depths 0..Smax-1", 4, 16, 2, 2, 16, "f32", [0, 5, 11, 15],
     False, 0),
    ("per-row ring, wrapped and not", 3, 16, 2, 2, 16, "f32", [4, 16, 23],
     True, 0),
    ("per-row window", 3, 16, 2, 2, 16, "f32", [0, 3, 15], False, 6),
    ("dh128", 2, 12, 2, 2, 128, "f32", 7, False, 0),
    ("G1", 2, 16, 3, 1, 32, "f32", [0, 13], False, 0),
    ("G3", 2, 16, 2, 3, 32, "f32", 9, False, 0),
    ("G8 per-row", 2, 16, 1, 8, 32, "f32", [15, 1], False, 0),
    ("bf16 caches per-row", 3, 16, 2, 3, 64, "bf16", [0, 9, 15], False, 0),
    ("bf16 caches ring wrapped", 2, 16, 2, 2, 64, "bf16", 21, True, 0),
    # zamba2-2.7b's d_head 80 (G 1): the kernel's row is 10 / 20 lanes
    ("dh80 G1 per-row", 2, 16, 3, 1, 80, "f32", [0, 11], False, 0),
    ("dh80 bf16 caches", 2, 16, 2, 1, 80, "bf16", 13, False, 0),
]


def _inputs(B, Smax, KVH, G, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, KVH, G, dh), dtype=np.float32),
            rng.standard_normal((B, Smax, KVH, dh), dtype=np.float32),
            rng.standard_normal((B, Smax, KVH, dh), dtype=np.float32),
            rng.standard_normal((B, 1, KVH, dh), dtype=np.float32),
            rng.standard_normal((B, 1, KVH, dh), dtype=np.float32))


def _positions(pos, ring_full, Smax, B):
    """(reference pos, slot), (port pos, slot)."""
    arr = np.asarray(pos if isinstance(pos, list) else [pos] * B)
    slot = arr % Smax if ring_full else arr
    if isinstance(pos, list):
        return ((jnp.asarray(arr, jnp.int32), jnp.asarray(slot, jnp.int32)),
                (torch.from_numpy(arr), torch.from_numpy(slot)))
    return ((jnp.int32(pos), jnp.int32(int(slot[0]))),
            (pos, int(slot[0])))


@pytest.mark.parametrize("mode", ["exact", "simdive"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_versions_match_reference(case, mode):
    _, B, Smax, KVH, G, dh, cdt, pos, ring_full, window = case
    q, kc, vc, kn, vn = _inputs(B, Smax, KVH, G, dh, seed=B * 100 + G + dh)
    (r_pos, r_slot), (t_pos, t_slot) = _positions(pos, ring_full, Smax, B)
    r_cache = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) \
        if cdt == "bf16" else jnp.asarray
    t_cache = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) \
        if cdt == "bf16" else torch.from_numpy
    want = np.asarray(r_layers.decode_attention_append(
        jnp.asarray(q), *map(r_cache, (kc, vc, kn, vn)), r_pos, r_slot,
        ring_full=ring_full, window=window,
        approx=RApprox(mode=mode, emulate=False)))
    t_args = (torch.from_numpy(q), *map(t_cache, (kc, vc, kn, vn)))
    approx = TApprox(mode=mode, emulate=False)
    body = t_layers.decode_attention_append(
        *t_args, t_pos, t_slot, ring_full=ring_full, window=window,
        approx=approx)
    spec, _, frac_out = approx.resolve_attention()
    reset_launch_counts()
    plain = get_op("decode_attention", spec, "ref")(
        *t_args, pos=t_pos, slot=t_slot, ring_full=ring_full, window=window,
        approx_div=approx.enabled, frac_out=frac_out)
    assert not any(launch_counts().values())
    assert plain.dtype == body.dtype == torch.float32
    assert plain.shape == (B, KVH, G, dh)
    tol = EXACT_TOL if mode == "exact" else APPROX_TOL
    np.testing.assert_allclose(body.numpy(), want, **tol)
    np.testing.assert_allclose(plain.numpy(), want, **tol)
    # the kernel's plain version is the layer's plain body, bit for bit
    assert torch.equal(plain, body)


def _valid(B=2, Smax=8, KVH=2, G=3, dh=64, dtype=torch.float32):
    q, kc, vc, kn, vn = (torch.from_numpy(a).to(dtype)
                         for a in _inputs(B, Smax, KVH, G, dh, seed=5))
    return dict(q=q, k_cache=kc, v_cache=vc, k_new=kn, v_new=vn, pos=5,
                slot=5)


def _call(args, **kw):
    a = dict(args)
    return t_da.check_args(a.pop("q"), a.pop("k_cache"), a.pop("v_cache"),
                           a.pop("k_new"), a.pop("v_new"), a.pop("pos"),
                           a.pop("slot"), **kw)


def test_check_args_takes_what_the_kernel_takes():
    assert _call(_valid()) == (2, 8, 2, 3, 64)
    # d_head 80 (zamba2-2.7b), f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        assert _call(_valid(G=1, dh=80, dtype=dtype)) == (2, 8, 2, 1, 80)
    assert _call(_valid(G=8, dh=128, dtype=torch.bfloat16),
                 ring_full=True) == (2, 8, 2, 8, 128)
    assert _call(_valid(G=1)) == (2, 8, 2, 1, 64)
    for pos in (torch.tensor([0, 7]), torch.tensor([0, 7], dtype=torch.int32),
                np.int64(3), 1 << 40):
        args = dict(_valid(), pos=pos, slot=pos)
        assert _call(args, window=4)[0] == 2


def _misaligned(args):
    flat = torch.zeros(args["k_cache"].numel() + 1)
    view = flat[1:].view(args["k_cache"].shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


REFUSED = [
    ("bf16 q, f32 caches", TypeError, "all float32 or all bfloat16",
     lambda a: dict(a, q=a["q"].to(torch.bfloat16))),
    ("float16", TypeError, "all float32 or all bfloat16",
     lambda a: {k: v.half() if torch.is_tensor(v) else v
                for k, v in a.items()}),
    ("d_head 32", ValueError, "d_head in",
     lambda a: {k: v[..., :32] if torch.is_tensor(v) else v
                for k, v in a.items()}),
    ("G 9", ValueError, "1 to 8 q heads",
     lambda a: dict(a, q=a["q"][:, :, :1].expand(2, 2, 9, 64).contiguous())),
    ("G 0", ValueError, "1 to 8 q heads",
     lambda a: dict(a, q=a["q"][:, :, :0])),
    ("q shape", ValueError, "shapes do not match",
     lambda a: dict(a, q=a["q"][:1])),
    ("new-token shape", ValueError, "shapes do not match",
     lambda a: dict(a, v_new=a["v_new"][:, :, :1])),
    ("strided cache", ValueError, "contiguous",
     lambda a: dict(a, k_cache=a["k_cache"].transpose(1, 2)
                    .contiguous().transpose(1, 2))),
    ("misaligned cache", ValueError, "16-byte aligned",
     lambda a: dict(a, v_cache=_misaligned(a))),
    ("0-d tensor pos", ValueError, "must be \\(B,\\)",
     lambda a: dict(a, pos=torch.tensor(5))),
    ("(B+1,) slot", ValueError, "must be \\(B,\\)",
     lambda a: dict(a, slot=torch.tensor([1, 2, 3]))),
    ("float pos tensor", ValueError, "int32 or int64",
     lambda a: dict(a, pos=torch.tensor([1.0, 2.0]))),
    ("float pos", TypeError, "an int or a \\(B,\\)",
     lambda a: dict(a, pos=5.0)),
    ("bool slot", TypeError, "an int or a \\(B,\\)",
     lambda a: dict(a, slot=True)),
    ("pos outside int64", ValueError, "outside int64",
     lambda a: dict(a, pos=1 << 64)),
    ("empty cache", ValueError, "must be >= 1",
     lambda a: dict(a, k_cache=a["k_cache"][:, :0],
                    v_cache=a["v_cache"][:, :0])),
]


@pytest.mark.parametrize("name,exc,match,bad", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_check_args_refuses_before_any_launch(name, exc, match, bad):
    args = bad(_valid())
    reset_launch_counts()
    with pytest.raises(exc, match=match):
        _call(args)
    a = dict(args)
    with pytest.raises(exc, match=match):
        t_da.decode_attention_cuda(a.pop("q"), a.pop("k_cache"),
                                   a.pop("v_cache"), a.pop("k_new"),
                                   a.pop("v_new"), **a)
    assert launch_counts()["decode_attention"] == 0


def test_check_args_refuses_a_negative_window():
    with pytest.raises(ValueError, match="window must be"):
        _call(_valid(), window=-1)


def test_routing_has_no_fallback():
    args = _valid()
    q, kc, vc, kn, vn = (args[k] for k in ("q", "k_cache", "v_cache", "k_new",
                                           "v_new"))
    reset_launch_counts()
    # the kernel wrapper on CPU tensors raises
    with pytest.raises(ValueError, match="not on a CUDA device"):
        t_da.decode_attention_cuda(q, kc, vc, kn, vn, pos=5, slot=5)
    # the cuda route asked of the layer on CPU tensors raises
    with pytest.raises(ValueError, match="backend 'cuda' was given"):
        t_layers.decode_attention_append(
            q, kc, vc, kn, vn, 5, 5,
            approx=TApprox(mode="simdive", emulate=False, backend="cuda"))
    # auto on the CPU takes the plain version
    approx = TApprox(mode="simdive", emulate=False)
    spec, backend, frac_out = approx.resolve_attention()
    assert backend == "auto"
    got = t_layers.decode_attention_append(q, kc, vc, kn, vn, 5, 5,
                                           approx=approx)
    want = t_da.decode_attention_ref(q, kc, vc, kn, vn, pos=5, slot=5,
                                     spec=spec, approx_div=True,
                                     frac_out=frac_out)
    assert torch.equal(got, want)
    # one compiled launch shape: no block, no autotune
    assert get_op("decode_attention", spec).entry.default_block is None
    with pytest.raises(ValueError, match="takes no block="):
        get_op("decode_attention", spec, block=(256,))
    assert not any(launch_counts().values())



# ------------------------------------------------------ the cluster plan --
@pytest.mark.parametrize("sm_count", [132, 114, 16])
@pytest.mark.parametrize("B,KVH", [(1, 1), (4, 5), (8, 5), (16, 5), (2, 64),
                                   (33, 4), (32, 5), (64, 8)])
def test_cluster_size_fills_the_card_within_its_budget(B, KVH, sm_count):
    C = t_da.cluster_size(B, KVH, sm_count)
    rows = B * KVH
    assert isinstance(C, int) and 1 <= C <= t_da.MAX_CLUSTER
    if rows >= sm_count:
        assert C == 1
    else:
        # the fewest blocks a row that reach every SM, up to the cap
        assert rows * C >= sm_count or C == t_da.MAX_CLUSTER
        assert C == 1 or rows * (C - 1) < sm_count
        # one wave at two blocks an SM (the card's own count is checked by
        # chip_smoke.py with cudaOccupancyMaxActiveClusters)
        assert rows * C < 2 * sm_count
    t_da.check_cluster(C)


def test_cluster_size_at_the_serving_shape():
    # smollm-360m, batch 4: 20 (b, kv head) rows on an H100's 132 SMs
    assert t_da.cluster_size(4, 5, 132) == 7
    assert t_da.cluster_size(132, 1, 132) == 1


RANGES = [(0, 0), (0, 1), (5, 5), (0, 7), (3, 10), (0, 527), (10, 15),
          (0, 544), (100, 2600)]


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("lo,hi", RANGES)
def test_rank_range_covers_the_history_once(lo, hi, C):
    shares = [t_da.rank_range(lo, hi, r, C) for r in range(C)]
    seen = [i for a, b in shares for i in range(a, b)]
    assert seen == list(range(lo, hi))             # once each, in rank order
    sizes = [b - a for a, b in shares]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    assert shares[0][0] == lo and shares[-1][1] == hi
    assert max(sizes) <= -(-(hi - lo) // C)         # fits one chunk of scores
    if hi - lo < C:
        assert sizes.count(0) == C - (hi - lo)      # empty ranks


@pytest.mark.parametrize("Smax,G,C,want", [(544, 3, 7, 78), (544, 3, 1, 544),
                                           (2048, 3, 8, 256),
                                           (2600, 8, 2, 1024),
                                           (2600, 8, 1, 1024), (16, 1, 3, 6)])
def test_chunk_slots(Smax, G, C, want):
    assert t_da.chunk_slots(Smax, G, C) == want
    assert want * C >= min(Smax, C * 8192 // G)


@pytest.mark.parametrize("bad,exc", [(0, ValueError), (9, ValueError),
                                     (-1, ValueError), (2.0, TypeError),
                                     ("2", TypeError), (True, TypeError)],
                         ids=["0", "9", "-1", "float", "str", "bool"])
def test_check_cluster_refuses_before_any_launch(bad, exc):
    with pytest.raises(exc, match="cluster must be"):
        t_da.check_cluster(bad)
    args = _valid()
    reset_launch_counts()
    with pytest.raises(exc, match="cluster must be"):
        _call(args, cluster=bad)
    a = dict(args)
    # refused before the device check: the cluster is judged first
    with pytest.raises(exc, match="cluster must be"):
        t_da.decode_attention_cuda(a.pop("q"), a.pop("k_cache"),
                                   a.pop("v_cache"), a.pop("k_new"),
                                   a.pop("v_new"), cluster=bad, **a)
    assert launch_counts()["decode_attention"] == 0


def test_check_cluster_takes_every_legal_size():
    for C in (None, *range(1, t_da.MAX_CLUSTER + 1), np.int64(4)):
        t_da.check_cluster(C)
        assert _call(_valid(), cluster=C) == (2, 8, 2, 3, 64)


def _history(P, S, Smax, ring_full, window):
    """One batch row's ``[lo, hi)`` and masked slot, as the kernel forms
    them from pos ``P`` and slot ``S``."""
    if ring_full and P >= Smax:
        return 0, Smax, S if 0 <= S < Smax else -1
    hi = min(max(P, 0), Smax)
    lo = 0
    if not ring_full and window > 0 and Smax > window:
        lo = min(max(P - window + 1, 0), hi)
    return lo, hi, -1


def cluster_model(q, k_cache, v_cache, k_new, v_new, pos, slot, *, C,
                  ring_full=False, window=0, approx_div=False, spec=None,
                  frac_out=15, chunk=None):
    """The decode kernel's cluster arithmetic in plain torch, from
    ``decode_attention_acc``'s own steps: per batch row, rounds of ``C *
    chunk`` slots, each split by ``rank_range``; each round's max is taken
    over the ranks' maxima and the running max, which starts at the self
    term's score; ``p = exp(s - m)`` is rounded to the cache's type and
    each rank keeps its own ``acc`` and ``l`` (rescaled across rounds); at
    the end the ranks' partials are summed in rank order, the self term is
    added and the finalize runs. ``pos`` / ``slot``: ints or (B,) tensors."""
    B, Smax, KVH, dh = k_cache.shape
    G = q.shape[2]
    f32 = torch.float32
    scale = dh ** -0.5
    CH = chunk or t_da.chunk_slots(Smax, G, C)
    qf = q.to(f32)
    s_all = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.to(f32)) * scale
    s_self = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, 0].to(f32)) * scale
    vf = v_cache.to(f32)
    rows = [int(x) for x in (pos if torch.is_tensor(pos) else [pos] * B)]
    slots = [int(x) for x in (slot if torch.is_tensor(slot) else [slot] * B)]
    accs, ls = [], []
    for b in range(B):
        lo, hi, skip = _history(rows[b], slots[b], Smax, ring_full, window)
        s = s_all[b].clone()                                  # (KVH, G, Smax)
        if skip >= 0:
            s[..., skip] = float("-inf")
        m = s_self[b].clone()
        acc = [torch.zeros(KVH, G, dh) for _ in range(C)]
        l = [torch.zeros(KVH, G) for _ in range(C)]
        for base in range(lo, hi, C * CH):
            rh = min(hi, base + C * CH)
            shares = [t_da.rank_range(base, rh, r, C) for r in range(C)]
            assert all(e - a <= CH for a, e in shares)
            maxima = [s[..., a:e].amax(-1) if e > a
                      else torch.full_like(m, float("-inf"))
                      for a, e in shares]
            m_new = torch.maximum(m, torch.stack(maxima).amax(0))
            c = torch.exp(m - m_new)
            for r, (a, e) in enumerate(shares):
                p = torch.exp(s[..., a:e] - m_new[..., None])
                l[r] = l[r] * c + p.sum(-1)
                pr = p.to(v_cache.dtype).to(f32)
                acc[r] = acc[r] * c[..., None] + torch.einsum(
                    "kgt,tkd->kgd", pr, vf[b, a:e])
            m = m_new
        acc_b, l_b = torch.zeros(KVH, G, dh), torch.zeros(KVH, G)
        for r in range(C):                                    # rank order
            acc_b = acc_b + acc[r]
            l_b = l_b + l[r]
        p_self = torch.exp(s_self[b] - m)
        accs.append(acc_b + p_self[..., None] * v_new[b, 0].to(f32)[:, None])
        ls.append(l_b + p_self)
    acc, l = torch.stack(accs), torch.stack(ls)
    if approx_div:
        tab = table_for("div", spec.width, spec.coeff_bits, spec.index_bits)
        out = softmax_div(acc, l, tab, width=spec.width,
                          index_bits=spec.index_bits, frac_out=frac_out,
                          round_out=spec.round_output)
    else:
        out = acc / l[..., None]
    return out.to(q.dtype)


# (id, B, Smax, KVH, G, dh, cache dtype, per-row pos, ring_full, window)
CLUSTER_CASES = [
    ("per-row depths, pos 0", 4, 16, 2, 2, 16, "f32", [0, 5, 11, 15],
     False, 0),
    # slots 5 / 8 / 2 / 0: a rank's first slot at C 3 / 2 / 8 / any C
    ("ring wrapped, skip on rank boundaries", 4, 16, 2, 2, 16, "f32",
     [21, 24, 18, 16], True, 0),
    # [10, 15), [3, 9), [0, 4): across ranks at C 2 and 3, empty ranks at 8
    ("window across ranks", 3, 16, 2, 2, 16, "f32", [15, 9, 4], False, 6),
    ("G1", 2, 16, 3, 1, 32, "f32", [0, 13], False, 0),
    ("G3 bf16 caches", 3, 16, 2, 3, 64, "bf16", [0, 9, 15], False, 0),
    ("G8, one slot", 2, 16, 1, 8, 32, "f32", [15, 1], False, 0),
    ("bf16 ring wrapped, skip on rank boundaries", 2, 16, 2, 2, 64, "bf16",
     [21, 24], True, 0),
]


@functools.lru_cache(maxsize=None)
def _cluster_case(case_id, mode):
    """(reference output, port arguments) of one CLUSTER_CASES case."""
    _, B, Smax, KVH, G, dh, cdt, pos, ring_full, window = next(
        c for c in CLUSTER_CASES + ROUNDS_CASES if c[0] == case_id)
    q, kc, vc, kn, vn = _inputs(B, Smax, KVH, G, dh, seed=B * 10 + G + dh)
    (r_pos, r_slot), (t_pos, t_slot) = _positions(pos, ring_full, Smax, B)
    r_cache = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) \
        if cdt == "bf16" else jnp.asarray
    t_cache = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) \
        if cdt == "bf16" else torch.from_numpy
    want = np.asarray(r_layers.decode_attention_append(
        jnp.asarray(q), *map(r_cache, (kc, vc, kn, vn)), r_pos, r_slot,
        ring_full=ring_full, window=window,
        approx=RApprox(mode=mode, emulate=False)))
    args = (torch.from_numpy(q), *map(t_cache, (kc, vc, kn, vn)))
    return want, args, dict(pos=t_pos, slot=t_slot, ring_full=ring_full,
                            window=window)


def _hold_model(case_id, mode, C, chunk=None, tol=None):
    want, args, kw = _cluster_case(case_id, mode)
    spec, _, frac_out = TApprox(mode=mode, emulate=False).resolve_attention()
    got = cluster_model(*args, **kw, C=C, approx_div=mode == "simdive",
                        spec=spec, frac_out=frac_out, chunk=chunk)
    plain = t_da.decode_attention_ref(*args, **kw, spec=spec,
                                      approx_div=mode == "simdive",
                                      frac_out=frac_out)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    tol = tol or (EXACT_TOL if mode == "exact" else APPROX_TOL)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol)


@pytest.mark.parametrize("mode", ["exact", "simdive"])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[c[0] for c in CLUSTER_CASES])
def test_cluster_model_matches_reference(case, C, mode):
    _hold_model(case[0], mode, C)


# a history walked in several rounds: chunk 2 at C 3 is a round of 6 slots.
# f32 caches: rounding p to f32 is exact, so the rounds change the f32 order
# alone and the tolerances above hold. bf16 caches: p is rounded relative to
# each round's max, not the final one, so the sums move by up to 2^-8 of
# sum(p |v|) / l <= max|v| (< 5 here) — the bound chip_smoke.py's TOL_BF16
# states for the same rounding in the attention kernels
ROUNDS_CASES = [("rounds f32", 3, 16, 2, 3, 64, "f32", [16, 7, 13], False, 0),
                ("rounds bf16", 3, 16, 2, 3, 64, "bf16", [16, 7, 13], False,
                 0)]
ROUNDS_BF16_TOL = dict(rtol=8e-3, atol=2e-2)


@pytest.mark.parametrize("mode", ["exact", "simdive"])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ROUNDS_CASES, ids=["f32", "bf16"])
def test_cluster_model_over_several_rounds(case, C, mode):
    _hold_model(case[0], mode, C, chunk=2,
                tol=ROUNDS_BF16_TOL if case[6] == "bf16" else None)
