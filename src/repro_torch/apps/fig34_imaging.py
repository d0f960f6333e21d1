"""Fig. 3/4's imaging pipeline: multiplicative blend + Gaussian smoothing.

Counterpart of what the reference's tuner imports from
``benchmarks/fig34_imaging.py``: :func:`synth_image`, :func:`blend`,
:data:`GAUSS`, :data:`FO` and :func:`gaussian`, plus the accurate
arithmetic both stages are measured against (:func:`exact_mul`,
:func:`exact_div`). The images are numpy; the ``mul`` / ``div`` callables
take integer lane tensors (``elemwise``'s: on the card the kernel) on
``device`` and return lane tensors, ``uint32`` or int64.

The reference sums in ``np.uint64`` and divides through ``jnp.uint64``;
the port has no unsigned 64-bit arithmetic and carries those values in
int64, where each fits: a product is below 2^32, the Gaussian's 25 of
them below 2^37, and the accurate divider's ``a << FO`` below 2^40. The
window sum is truncated to 32 bits before the divider, as the reference's
``astype(np.uint32)`` does. Operands beyond a lane (the window sum reaches
255 x 273 = 69,615, past a 16-bit lane; an 8-bit lane holds neither it
nor 273) go to the datapath as they are, which clamps and detects the
leading one as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import require_device
from repro_torch.core.mitchell import from_lanes

__all__ = ["synth_image", "blend", "GAUSS", "FO", "gaussian", "exact_mul",
           "exact_div"]


def synth_image(seed, hw=256):
    rng = np.random.default_rng(seed)
    img = np.zeros((hw, hw))
    for scale in (4, 8, 16, 32, 64):
        base = rng.normal(size=(hw // scale + 1, hw // scale + 1))
        up = np.kron(base, np.ones((scale, scale)))[:hw, :hw]
        img += up * scale
    img = (img - img.min()) / np.ptp(img)
    return (img * 255).astype(np.uint32)


# classic 5x5 integer Gaussian (sigma~1); sum = 273 — deliberately NOT a
# power of two, so the normalization genuinely exercises the divider
GAUSS = np.asarray([
    [1, 4, 7, 4, 1],
    [4, 16, 26, 16, 4],
    [7, 26, 41, 26, 7],
    [4, 16, 26, 16, 4],
    [1, 4, 7, 4, 1]], np.uint32)
FO = 8  # divider fixed-point output bits


def _lanes(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64).ravel()).to(dev)


def _values(out: torch.Tensor) -> np.ndarray:
    return from_lanes(out).cpu().numpy()


def exact_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The accurate multiplier (operands below 2^16: the product fits)."""
    return from_lanes(a) * from_lanes(b)


def exact_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The accurate divider: ``(a << FO) // b`` truncated to 32 bits."""
    q = torch.div(from_lanes(a) << FO, from_lanes(b), rounding_mode="floor")
    return q & 0xFFFFFFFF


def blend(img1, img2, mul, device="cuda"):
    """Multiplicative blend: out = (img1 * img2) / 255."""
    dev = require_device(device)
    p = _values(mul(_lanes(img1, dev), _lanes(img2, dev)))
    out = p.astype(np.float64) / 255.0
    return np.clip(out.reshape(img1.shape), 0, 255)


def gaussian(img, mul, div, device="cuda"):
    """5x5 Gaussian: weighted sum via ``mul``, normalization via ``div``."""
    dev = require_device(device)
    H, W = img.shape
    acc = np.zeros((H - 4, W - 4), np.int64)
    for dy in range(5):
        for dx in range(5):
            patch = img[dy:dy + H - 4, dx:dx + W - 4]
            w = int(GAUSS[dy, dx])
            p = mul(_lanes(patch, dev),
                    torch.full((patch.size,), w, dtype=torch.int64,
                               device=dev))
            acc += _values(p).reshape(patch.shape)
    den = int(GAUSS.sum())
    q = div(_lanes(acc & 0xFFFFFFFF, dev),
            torch.full((acc.size,), den, dtype=torch.int64, device=dev))
    out = _values(q).astype(np.float64).reshape(acc.shape) / 2.0 ** FO
    return np.clip(out, 0, 255)
