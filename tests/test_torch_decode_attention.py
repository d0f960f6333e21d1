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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx import ApproxConfig as RApprox
from repro.models import layers as r_layers
from repro_torch.core.approx import ApproxConfig as TApprox
from repro_torch.kernels import decode_attention as t_da
from repro_torch.kernels import get_op, launch_counts, reset_launch_counts
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

