"""Deterministic data pipeline: synthetic token streams + memmap corpora.

Counterpart of ``repro.data.pipeline``, copied (it is numpy only): batch
``i`` is a pure function of ``(seed, step, dp_rank)`` and equal, element
for element, to the reference's, so a restart replays exactly the batches
k, k+1, ... with no recorded iterator state, and both packages train on
the same data.

Two sources:
  * SyntheticLM — structured pseudo-text (Zipf-ish marginals + short-range
    repetition so a real model can actually reduce loss on it),
  * MemmapCorpus — flat uint16/uint32 token file, strided deterministically.

Per-rank sharding: each data-parallel rank materializes only its
``global_batch / dp`` rows. ``Prefetcher`` overlaps host batch synthesis
with device steps (a 2-deep background thread queue).
:func:`torch_batch` moves a numpy batch onto a device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticLM", "MemmapCorpus", "Prefetcher", "make_source",
           "torch_batch"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0
    mrope: bool = False
    vision_stub: bool = False
    d_model: int = 0
    n_patches: int = 8

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        b = self.global_batch // dp_size
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + dp_rank)
        shape = (b, self.seq_len + 1)
        if self.n_codebooks:
            shape = (b, self.seq_len + 1, self.n_codebooks)
        # Zipf marginals + periodic copying gives learnable structure
        zipf = rng.zipf(1.3, size=shape)
        toks = np.minimum(zipf, self.vocab_size - 1).astype(np.int32)
        per = 8
        idx = np.arange(self.seq_len + 1)
        copy_from = np.maximum(idx - per, 0)
        lane = toks[:, copy_from] if self.n_codebooks == 0 else toks[:, copy_from]
        mix = rng.random(shape) < 0.5
        toks = np.where(mix, lane, toks)
        out = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if self.mrope:
            pos = np.broadcast_to(
                np.arange(self.seq_len, dtype=np.int32)[None, :, None],
                (b, self.seq_len, 3)).copy()
            out["positions"] = pos
        if self.vision_stub:
            out["patch_embeds"] = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32)
            pm = np.zeros((b, self.seq_len), bool)
            pm[:, :self.n_patches] = True
            out["patch_mask"] = pm
        return out


@dataclass
class MemmapCorpus:
    """Flat binary token file; deterministic strided sampling."""
    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._data) - (self.seq_len + 1)
        if self._n <= 0:
            raise ValueError("corpus shorter than one sequence")

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        b = self.global_batch // dp_size
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + dp_rank)
        starts = rng.integers(0, self._n, size=b)
        rows = np.stack([
            np.asarray(self._data[s:s + self.seq_len + 1]) for s in starts
        ]).astype(np.int32)
        rows = np.minimum(rows, self.vocab_size - 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Depth-2 background prefetch of host batches."""

    def __init__(self, source, start_step: int, dp_rank=0, dp_size=1,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = source.batch(step, dp_rank, dp_size)
                while not self._stop.is_set():
                    try:
                        self.q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def make_source(cfg, shape, seed=0, path: str | None = None):
    """Build the right source for a model config + shape config."""
    if path:
        return MemmapCorpus(path, cfg.vocab_size, shape.seq_len,
                            shape.global_batch, seed=seed)
    return SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        n_codebooks=cfg.n_codebooks, mrope=cfg.mrope,
        vision_stub=cfg.vision_stub, d_model=cfg.d_model,
    )


def torch_batch(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: integer fields (tokens,
    labels, positions) as int64, the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out
