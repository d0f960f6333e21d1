"""Table 4's classifier: an MLP trained in float, run in 8-bit fixed point.

Counterpart of what the reference's fault campaign and tuner import from
``benchmarks/table4_ann.py``: :func:`make_dataset` (numpy, copied as it is:
its arrays equal the reference's), :func:`train_float` and
:func:`quantized_infer`. The paper trains 784-100(-100)-10 MLPs in float,
quantizes weights and activations to 8-bit sign-magnitude, and runs
inference with accurate, SIMDive and Mitchell multipliers. MNIST is not
available offline; the reference's synthetic 10-class problem of the same
geometry stands in.

Training is torch autograd in float32 with TF32 off (``torch.matmul``
keeps PyTorch's default, ``torch.get_float32_matmul_precision() ==
'highest'``): SGD with momentum 0.9, a cosine learning rate and batches of
256 whose indices come from the reference's ``np.random.default_rng(seed)``
draws. JAX's ``jax.random.normal`` draws cannot be reproduced in torch, so
the initial weights come from a ``torch.Generator`` seeded with ``seed``
(on the CPU, then moved: the same weights on every device), or from
``init=`` — a reference's weights carried across (:func:`to_torch`).

:func:`quantized_infer` runs ``mul`` on the re-signed int32 operands, which
on the card is ``get_op("matmul_int", spec, "auto")``: the ``logmatmul``
kernel. :func:`exact_matmul` is the accurate 8-bit baseline.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.approx import quantize_sign_magnitude
from repro_torch.core.device import require_device

__all__ = ["make_dataset", "train_float", "quantized_infer", "exact_matmul",
           "to_torch"]

BATCH = 256


def make_dataset(n_train=6000, n_test=1000, seed=0, shift=2, noise=4.0):
    """10-class 28x28 synthetic 'digits': smooth prototypes + shifts + noise.

    ``noise``/``shift`` are tuned so a 1-hidden-layer MLP lands in the
    MNIST-like 85-97% test-accuracy band (hard, but learnable)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 28, 28))
    # smooth the prototypes (separable box blur x3), unit contrast
    for _ in range(3):
        protos = (np.roll(protos, 1, 1) + protos + np.roll(protos, -1, 1)) / 3
        protos = (np.roll(protos, 1, 2) + protos + np.roll(protos, -1, 2)) / 3
    protos /= protos.std(axis=(1, 2), keepdims=True)

    def sample(n):
        y = rng.integers(0, 10, n)
        shift_x = rng.integers(-shift, shift + 1, n)
        shift_y = rng.integers(-shift, shift + 1, n)
        xs = np.empty((n, 28, 28), np.float32)
        for i in range(n):
            img = np.roll(np.roll(protos[y[i]], shift_x[i], 0), shift_y[i], 1)
            img = img + rng.normal(scale=noise, size=(28, 28))
            xs[i] = img
        # [0,1] image range like 8-bit grayscale (quantization-friendly)
        xs = (xs - xs.min()) / (np.ptp(xs) + 1e-9)
        return xs.reshape(n, 784), y

    return sample(n_train), sample(n_test)


def to_torch(ws, device="cuda") -> list[torch.Tensor]:
    """A list of weight arrays (numpy, a reference's, or tensors) as float32
    tensors on ``device``."""
    dev = require_device(device)
    return [(w if isinstance(w, torch.Tensor)
             else torch.from_numpy(np.array(w, np.float32)))
            .to(device=dev, dtype=torch.float32) for w in ws]


def _forward(ws, x):
    for w in ws[:-1]:
        x = torch.relu(x @ w)
    return x @ ws[-1]


def _loss(ws, x, y):
    lg = _forward(ws, x)
    return (torch.logsumexp(lg, -1)
            - lg.gather(1, y[:, None])[:, 0]).mean()


def train_float(xtr, ytr, hidden=(100,), steps=600, lr=0.03, seed=0, *,
                init=None, device="cuda"):
    """SGD + momentum with cosine decay — stable across dataset variants.

    Returns ``(ws, fwd)``: the trained float32 weights on ``device`` and the
    float forward pass ``fwd(ws, x)``. ``init`` (a list of arrays or
    tensors of the layers' shapes) replaces the seeded initial draw."""
    dev = require_device(device)
    sizes = (784,) + tuple(hidden) + (10,)
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        init = [torch.randn(sizes[i], sizes[i + 1], generator=gen)
                * (sizes[i] ** -0.5) for i in range(len(sizes) - 1)]
    ws = to_torch(init, dev)
    if [tuple(w.shape) for w in ws] != list(zip(sizes[:-1], sizes[1:])):
        raise ValueError(f"init shapes {[tuple(w.shape) for w in ws]} do not "
                         f"match the layer sizes {sizes}")
    vs = [torch.zeros_like(w) for w in ws]
    xtr_t = torch.as_tensor(np.asarray(xtr, np.float32)).to(dev)
    ytr_t = torch.as_tensor(np.asarray(ytr, np.int64)).to(dev)
    n = xtr_t.shape[0]
    rng = np.random.default_rng(seed)
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, BATCH)).to(dev)
        lr_t = lr * 0.5 * (1 + np.cos(np.pi * s / steps))
        params = [w.requires_grad_() for w in ws]
        grads = torch.autograd.grad(_loss(params, xtr_t[idx], ytr_t[idx]),
                                    params)
        with torch.no_grad():
            vs = [0.9 * v + g for v, g in zip(vs, grads)]
            ws = [w.detach() - float(np.float32(lr_t)) * v
                  for w, v in zip(ws, vs)]
    return ws, _forward


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The accurate 8-bit baseline: the exact integer product of int32
    operands, as int64. CUDA has no integer ``matmul``, so it multiplies in
    float64 on every device: exact while every partial sum stays below 2^53
    (784 x 255^2 < 5.1e7 here), which it checks."""
    K = a.shape[-1]
    bound = K * float(a.abs().max()) * float(b.abs().max()) if K else 0.0
    if bound >= 2.0 ** 53:
        raise ValueError(f"exact_matmul: sums up to {bound:.3g} are not "
                         "exact in float64")
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def quantized_infer(ws, x, mul):
    """8-bit fixed-point inference; ``mul(xq, wq) -> integer matmul`` of the
    re-signed int32 operands. ``x`` goes to the weights' device."""
    act = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                          else x, dtype=torch.float32).to(ws[0].device)
    for i, w in enumerate(ws):
        qa, sa, sca = quantize_sign_magnitude(act, 8)
        qw, sw, scw = quantize_sign_magnitude(w, 8)
        acc = mul(qa * sa, qw * sw)
        act = acc.to(torch.float32) * (sca * scw)
        if i < len(ws) - 1:
            act = torch.relu(act)
    return act
