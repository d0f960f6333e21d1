"""Image-quality metrics for the Fig. 3/4 pipelines: PSNR and SSIM.

Counterpart of ``repro.metrics.image``: the port's own copy of the same
pure-numpy definitions (the port imports nothing of ``repro``). Both
operate on host numpy in float64; ``peak`` defaults to the 8-bit grayscale
range the paper's imaging experiments use. SSIM is the standard Wang et
al. formulation with a uniform (box) local window, its window statistics
from an integral image, O(HW) regardless of window size.
"""
from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim"]


def psnr(a, b, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio (dB) of ``b`` against reference ``a``.

    Identical inputs report 99 dB (a finite sentinel, the benchmarks'
    convention) rather than infinity.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    return 99.0 if mse == 0 else float(10.0 * np.log10(peak**2 / mse))


def _box_mean(x: np.ndarray, win: int) -> np.ndarray:
    """Valid-mode ``win x win`` box mean via an integral image."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win])
    return s / float(win * win)


def ssim(a, b, peak: float = 255.0, win: int = 8) -> float:
    """Mean structural similarity of two single-channel images.

    Uniform ``win x win`` window, standard stabilizers C1=(0.01*peak)^2,
    C2=(0.03*peak)^2. Returns the map mean in [-1, 1] (1 = identical).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"ssim needs two equal-shape 2D images, got "
                         f"{a.shape} vs {b.shape}")
    if min(a.shape) < win:
        raise ValueError(f"image {a.shape} smaller than ssim window {win}")
    mu_a = _box_mean(a, win)
    mu_b = _box_mean(b, win)
    # E[x^2] - E[x]^2; clip tiny negatives from cancellation
    var_a = np.clip(_box_mean(a * a, win) - mu_a**2, 0, None)
    var_b = np.clip(_box_mean(b * b, win) - mu_b**2, 0, None)
    cov = _box_mean(a * b, win) - mu_a * mu_b
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())
