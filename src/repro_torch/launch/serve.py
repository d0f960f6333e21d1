"""Serving entry point: batched prefill + greedy decode.

Counterpart of ``repro.launch.serve`` for the slice ported so far: one
batched prefill, the prompt cache merged into a ``max_seq`` serving cache,
then a greedy per-token decode loop. ``--approx simdive`` serves the
divider-softmax (the linears stay plain matmuls): on the GPU the prefill
attention runs in the hand-written flash kernel and each decode step's
attention, its softmax normalization included, in the decode_attention
kernel, one launch a layer. ``--emulate`` adds the
bit-exact SIMDive linears: every linear of every layer (seven a layer, in
the prefill and in each decode step) runs the ``logmatmul`` kernel.
``--quantize`` swaps the linear weights for int8 ``QuantizedWeight``s;
with ``--emulate`` their magnitudes feed the emulated matmul directly.
rwkv6-1.6b (family ``ssm``) has no attention: divider-only it runs no
SIMDive kernel, ``--emulate`` sends its eight linears a layer through
``logmatmul``, and its serving cache is the recurrent carry (a nested
dict, :func:`cache_leaves`) that both graphs update in place.
zamba2-2.7b (family ``hybrid``) serves 54 Mamba2 layers and six
invocations of one shared attention block: divider-only it runs six
``flash_attention`` launches a prefill and six ``decode_attention`` a
step, ``--emulate`` its six linears a Mamba2 layer and six a shared block
on ``logmatmul``; its cache holds both the recurrent carry and the K/V
slabs. ``--quantize`` is refused for it: the shared block merges a LoRA
delta into ``wq`` on every call, which an int8 weight cannot take (the
reference's prefill raises ``TypeError`` there).

The prompt is served through one prefill (:func:`make_prefill`, the
reference's jitted ``LM.prefill``) and every token through one step
(:func:`make_decode_step`, the reference's jitted step): on the GPU each
is captured into a CUDA graph on first use — the prefill once per prompt
shape ``(B, P)``, the step once per ``(B, max_seq)`` — and replayed, so
the ~2,100 kernels of a prefill and the ~2,000 (``--emulate`` ~9,500) of a
step are one launch each from the host; on the CPU both run eagerly.

Entry points run on the GPU unless asked otherwise: ``device`` defaults to
``'cuda'`` and a host without one gets an error, not a CPU run.

Throughput is measured, not guessed: everything reported goes through
:func:`repro_torch.metrics.timing.time_callable` (warm-up, then
device-synchronised repetitions).

``--scheduler`` runs the continuous-batching load-shed drill instead
(:mod:`repro_torch.launch.scheduler`): ``--requests`` prompts flood the
queue, the ladder sheds to the Mitchell rung and recovers, and every rung's
prefill and decode step are captured once at warmup on one shared serving
cache (:meth:`DecodeStep.adopt_cache`, :func:`insert_cache`).
``--chaos`` runs that drill under a persistent correction-table fault
(:mod:`repro_torch.faults`), armed after the first tick: the scheduler's
table scrub must find it — on the card in the tables the captured graphs
read —, quarantine the work in flight, retry it on the exact recovery
rung, and complete every request; the process exits 1 on any violation.

``--policy PATH`` serves a ``simdive-policy/v1`` JSON (a
:class:`repro_torch.tuning.TuningPolicy`, written by either package): it
rides into ``ApproxConfig(policy=...)``, so every layer's matmul /
divider / attention dispatch config — width, coeff_bits, index_bits,
backend and the attention divider's ``frac_out`` — is resolved at load
time and printed as the serving plan, each row with the port's backend
(``pallas`` in the file serves as ``cuda``). Layer-scoped entries
(``layer='L3'``) split the layer loop into segments
(:func:`repro_torch.core.approx.serving_segments`); the captured prefill
and step hold every segment's kernels at that segment's spec. A policy
turns ``--approx exact`` into ``simdive``; it serves on every path
(generate, ``--scheduler``, ``--chaos``, ``--emulate [--quantize]``), the
shed and recovery rungs dropping it as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --approx simdive [--emulate [--quantize]] [--policy policy.json] \
      --batch 4 --prompt-len 512 --gen 32 [--scheduler [--requests 12] |
      --chaos]
  (CPU smoke: add --smoke --device cpu)
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import ApproxConfig, serving_segments
from repro_torch.kernels.registry import (add_launches, autotune_generation,
                                          launch_counts, launches_between)
from repro_torch.metrics.timing import (TimingStats, time_callable,
                                        wall_clock)
from repro_torch.models import build
from repro_torch.models.layers import QuantizedWeight, quantize_weight

# matmul-weight leaf names (stacked (L,K,N) / MoE (L,E,K,N) / flat (K,N));
# norms, embeddings (gather tables), convs and per-head vectors stay float.
_MATMUL_WEIGHTS = frozenset(
    "wq wk wv wo w1 w2 w3 head router wr wg wz wx wdt cm_wk cm_wr cm_wv "
    "out_proj".split())


_HYBRID_QUANTIZE = (
    "--quantize on a hybrid stack: the shared block merges a per-invocation "
    "LoRA delta into wq on every call, which an int8 wq cannot take (the "
    "reference's prefill raises TypeError)")


def quantize_params(params: dict) -> dict:
    """Swap every linear weight for an int8 QuantizedWeight (per-out-channel
    scale). Stacked per-layer weights keep their leading L axis, so the
    layer loop still indexes them. Weights narrower than 64 on either of
    their last two axes stay float, as in the reference. A hybrid tree
    (``stack.lora_a``) raises ``NotImplementedError``: its shared block
    adds a LoRA delta to ``wq`` on every call, which the reference cannot
    serve on an int8 ``wq`` either (its prefill raises ``TypeError``, its
    decode step would drop the delta)."""
    if "lora_a" in params.get("stack", {}):
        raise NotImplementedError(_HYBRID_QUANTIZE)

    def q(path, leaf):
        name = path[-1] if path else ""
        if "moe" in path:
            return leaf        # expert weights stay float, as in the reference
        if (name in _MATMUL_WEIGHTS and leaf.ndim >= 2
                and leaf.shape[-1] >= 64 and leaf.shape[-2] >= 64
                and leaf.dtype in (torch.float32, torch.bfloat16)):
            return quantize_weight(leaf)
        return leaf

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return q(path, tree)

    return walk(params)


# ---------------------------------------------------------------- caches --
def cache_leaves(cache: dict, path: tuple = ()):
    """``(path, tensor)`` for every leaf of a (nested) cache dict, in key
    order: ``(('k',), ...)`` for an attention stack's, ``(('ssm',
    'state'), ...)`` for the rwkv6 stack's."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from cache_leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _keystr(path: tuple) -> str:
    return "".join(f"['{k}']" for k in path)


def _recurrent(cache: dict) -> bool:
    return any(isinstance(v, dict) for v in cache.values())


def merge_cache(full: dict, cache: dict) -> dict:
    """Embed a prompt-length prefill cache into a max_seq serving cache.

    Every leaf of the (nested) tree is written **in place** into ``full``'s
    buffers, which come back as the merged cache: an equal-shape leaf is
    copied whole (the rwkv6 stack's token shifts and state), a longer-seq
    destination leaf takes the prefill slab at the front of axis 2 (the
    stacked K/V caches' seq axis). So a captured decode step that owns
    ``full``'s buffers serves the merged cache. Anything else raises with
    the leaf path (``['k']``, ``['ssm']['state']``) — a cache-layout drift
    must fail loudly, not serve an empty cache and generate garbage.
    """
    return _merge(full, cache, ())


def _merge(full: dict, cache: dict, path: tuple) -> dict:
    if set(full) != set(cache) or any(
            isinstance(full[k], dict) != isinstance(cache[k], dict)
            for k in full):
        raise ValueError(
            f"unmergeable cache{' at ' + _keystr(path) if path else ''}: "
            f"leaves {sorted(cache)} do not match the serving cache's "
            f"{sorted(full)}")
    out = {}
    for key, dst in full.items():
        src = cache[key]
        if isinstance(dst, dict):
            out[key] = _merge(dst, src, path + (key,))
        elif src.shape == dst.shape:
            out[key] = dst.copy_(src)
        elif (dst.ndim >= 3 and src.ndim == dst.ndim
                and dst.shape[:2] == src.shape[:2]
                and dst.shape[2] >= src.shape[2]
                and dst.shape[3:] == src.shape[3:]):
            dst[:, :, :src.shape[2]] = src.to(dst.dtype)
            out[key] = dst
        else:
            raise ValueError(
                f"unmergeable cache leaf {_keystr(path + (key,))}: prefill "
                f"{tuple(src.shape)} does not embed into serving cache "
                f"{tuple(dst.shape)} (cache layout drift between prefill "
                "and empty_cache?)")
    return out


def _copy_tree(cache: dict) -> dict:
    """A new (nested) dict holding ``cache``'s own tensors."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in cache.items()}


def insert_cache(full: dict, pre: dict, slots) -> dict:
    """Scatter a ``(B, P)`` prefill cache into the serving cache at per-row
    slot indices, **in place** (the reference's ``Scheduler._insert_impl``):
    row ``j`` of every leaf of ``pre`` goes to row ``slots[j]`` of
    ``full``'s, seq positions ``[0, P)``; a row whose index lies outside
    ``[0, full's rows)`` (a padding row) is dropped. It runs eagerly,
    outside any graph, so the captured decode steps that serve ``full``'s
    buffers see the admission. A leaf that does not embed raises with its
    path; a recurrent cache (the rwkv6 stack's, which has no seq axis and
    which the reference's scheduler refuses) raises. Returns ``full``."""
    if _recurrent(full) or _recurrent(pre):
        raise ValueError(
            "insert_cache serves the attention family's (L, B, S, ...) "
            "caches; a recurrent cache has no per-slot seq axis")
    if set(full) != set(pre):
        raise ValueError(f"unmergeable cache: leaves {sorted(pre)} do not "
                         f"match the serving cache's {sorted(full)}")
    slots = [int(s) for s in np.asarray(slots).reshape(-1)]
    for key, dst in full.items():
        src = pre[key]
        P = src.shape[2] if src.ndim >= 3 else 0
        if not (dst.ndim >= 3 and src.ndim == dst.ndim
                and dst.shape[0] == src.shape[0]
                and src.shape[1] == len(slots) and dst.shape[2] >= P
                and dst.shape[3:] == src.shape[3:]):
            raise ValueError(
                f"unmergeable cache leaf ['{key}']: prefill "
                f"{tuple(src.shape)} at {len(slots)} slot index(es) vs "
                f"serving cache {tuple(dst.shape)}")
        rows = [(j, s) for j, s in enumerate(slots) if 0 <= s < dst.shape[1]]
        if rows:
            take = torch.tensor([j for j, _ in rows], device=src.device)
            put = torch.tensor([s for _, s in rows], device=dst.device)
            dst[:, put, :P] = src[:, take].to(dst.dtype)
    return full


# ------------------------------------------------------------ decode step --
def decode_body(lm, params, cache, tok, pos):
    """One greedy decode step as the captured graph runs it: ``pos`` is a
    ``(B,)`` integer tensor on ``lm.device``, so nothing is read on the
    host (``LM.decode_step`` turns a scalar position into a Python int,
    which a capture cannot do). It runs eagerly as it is. Returns
    ``(logits (B, V) [(B, C, V)], cache)``; the cache is written in
    place."""
    if not (torch.is_tensor(pos) and pos.shape == tok.shape[:1]
            and not pos.is_floating_point() and pos.device == tok.device):
        raise ValueError(
            f"decode_body takes pos as a ({tok.shape[0]},) integer tensor on "
            f"{tok.device}, got {pos!r:.80}")
    return lm.decode_step(params, cache, tok, pos)


def _leaves(tree):
    """The tensors of a parameter tree, in a fixed order."""
    if torch.is_tensor(tree):
        return (tree,)
    if isinstance(tree, QuantizedWeight):
        return (tree.q, tree.scale)
    if isinstance(tree, dict):
        return tuple(t for k in sorted(tree) for t in _leaves(tree[k]))
    raise TypeError(f"unexpected parameter leaf {type(tree).__name__}")


class _Captured:
    """One CUDA graph of a call on buffers its owner keeps, and what it was
    captured under: the params object and its leaves (strong references,
    checked by ``is``) and the block autotune generation."""

    def __init__(self):
        self.graph = None
        self.out = None
        self.params = None
        self.leaves = ()
        self.generation = None
        self.launches = {}

    def captured_for(self, params) -> bool:
        """Whether the graph holds these params' addresses and blocks the
        autotune cache still serves."""
        if (self.graph is None or params is not self.params
                or self.generation != autotune_generation()):
            return False
        leaves = _leaves(params)
        return len(leaves) == len(self.leaves) and all(
            a is b for a, b in zip(leaves, self.leaves))

    def capture(self, body, params, device) -> None:
        """Run ``body()`` once eagerly, then capture it on PyTorch's own
        capture stream. The eager run does every first-use job outside the
        capture (nvcc, the block autotune, table uploads, launch setup) and
        counts its launches; the capture's launches are taken back, since a
        capture launches nothing. A capture that fails raises. The tensors
        of :meth:`advanced` are put back as they were before the eager run,
        so that the replay which follows the capture is the call's one
        run."""
        self.graph = self.out = None           # free the stale graph's pool
        saved = [(t, t.clone()) for t in self.advanced()]
        body()
        for t, before in saved:
            t.copy_(before)
        del saved
        generation = autotune_generation()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph):
                out = body()
        finally:
            captured = launches_between(before, launch_counts())
            add_launches(captured, -1)
        torch.cuda.synchronize(device)
        self.graph, self.out, self.launches = graph, out, captured
        self.params, self.leaves = params, _leaves(params)
        self.generation = generation

    def advanced(self) -> list:
        """The buffers a run of the body moves on, which a second run does
        not write again with the same values: none here."""
        return []

    def replay(self):
        """Replay the graph and add its launches; returns what the captured
        call returned (its buffers, rewritten by the next replay)."""
        self.graph.replay()
        add_launches(self.launches)
        return self.out


class _Slot(_Captured):
    """One ``(B, max_seq)`` of a :class:`DecodeStep`: the cache it serves
    (its own, or one it adopted), the token and position buffers it owns,
    and the graph captured on them. The token buffer has the shape of a
    step's tokens: ``(B,)``, or ``(B, C)`` for codebooks."""

    def __init__(self, lm, batch_size: int, max_seq: int,
                 cache: dict | None = None):
        super().__init__()
        self.cache = lm.empty_cache(batch_size, max_seq) if cache is None \
            else cache
        C = lm.cfg.n_codebooks
        self.tok = torch.zeros((batch_size, C) if C else (batch_size,),
                               dtype=torch.int64, device=lm.device)
        self.pos = torch.zeros(batch_size, dtype=torch.int64, device=lm.device)

    def advanced(self) -> list:
        """A recurrent cache's carry leaves (under ``['ssm']``: the rwkv6
        token shifts and state, the Mamba2 conv window and state): a step
        moves them on from what it read, where a K/V step rewrites its
        slot with the same values."""
        return [buf for path, buf in cache_leaves(self.cache)
                if len(path) > 1]

    def owns(self, cache: dict) -> bool:
        """Whether every leaf of ``cache`` is this slot's own buffer."""
        mine, theirs = (list(cache_leaves(c)) for c in (self.cache, cache))
        return len(mine) == len(theirs) and all(
            p == q and a is b for (p, a), (q, b) in zip(mine, theirs))


class _GraphFn:
    """What the served decode step and prefill share: their slots, one
    captured graph each, and how many captures they made and how long the
    latest took (its eager warm run included)."""

    def __init__(self, lm):
        self.lm = lm
        self.captures = 0            # graphs captured so far
        self.capture_s = None        # seconds of the latest, warm run included
        self._slots = {}

    def _replay(self, slot: _Captured, params, body):
        """Replay ``slot``'s graph, capturing ``body`` into it first when it
        holds none or one stale for ``params``."""
        if not slot.captured_for(params):
            t0 = wall_clock()
            slot.capture(body, params, self.lm.device)
            self.captures += 1
            self.capture_s = wall_clock() - t0
        return slot.replay()


class DecodeStep(_GraphFn):
    """The served decode step: ``step(params, cache, tok, pos) -> (logits,
    cache)``, the call signature of the reference's jitted step.

    On a CUDA device it captures one decode step (:func:`decode_body`) into
    a CUDA graph on first use and replays it on every later call. The
    graph holds addresses, so the step owns its buffers per ``(B,
    max_seq)``: the cache (:meth:`empty_cache`; :func:`generate` merges the
    prefill into it), the token and position the call's ``tok`` and
    ``pos`` are copied into, and the logits the replay writes. The logits
    returned are that buffer, rewritten by the next call: clone them to
    keep them. A cache other than the step's own raises. The graph is
    captured again when the params object or one of its leaves is not the
    one it was captured with (a strong reference is kept), or when the
    block autotune cache was cleared or preloaded since
    (:func:`~repro_torch.kernels.registry.autotune_generation`). A capture
    first runs the step once eagerly at the same shapes, which builds the
    kernels, times the blocks, uploads the tables and counts its launches
    (a recurrent cache, which that run moves on, is put back after it);
    then the capture, whose launches the counts give back, and the replay,
    which adds them (:func:`~repro_torch.kernels.registry.add_launches`).
    A capture that fails raises; the step never runs eagerly instead.
    :meth:`adopt_cache` makes the step serve a cache it did not make (the
    scheduler's one cache, shared by every rung's step) in place of its
    own.

    On the CPU, which has no CUDA graph, it is ``lm.decode_step``, eager:
    the counterpart of the reference's jit without donation there.

    The reference's ``donate`` has no counterpart: the port always writes
    the step's one cache slot in place, so running a step again at the
    same ``pos`` rewrites the same values.
    """

    def empty_cache(self, batch_size: int, max_seq: int) -> dict:
        """A zeroed serving cache: on the GPU the step's own buffers for
        ``(batch_size, max_seq)``, on the CPU a new one."""
        if self.lm.device.type != "cuda":
            return self.lm.empty_cache(batch_size, max_seq)
        slot = self._slots.get((batch_size, max_seq))
        if slot is None:
            slot = self._slots[batch_size, max_seq] = _Slot(
                self.lm, batch_size, max_seq)
        else:
            for _, buf in cache_leaves(slot.cache):
                buf.zero_()
        return _copy_tree(slot.cache)

    def adopt_cache(self, cache: dict) -> dict:
        """Serve ``cache``'s own buffers from now on: on the GPU the step's
        slot for their ``(B, max_seq)`` takes them, with no copy, in place
        of the buffers it held, and the next call captures its graph on
        them (a slot that already serves them keeps its graph). So several
        models' steps — the scheduler's rungs — replay on one cache, which
        the caller writes between calls (:func:`insert_cache`). A cache
        whose leaves are not this model's serving cache on its device
        raises, and so does a recurrent cache (the rwkv6 stack's: the
        scheduler serves the attention family alone), on either device.
        On the CPU a step takes any other cache, and this does nothing.
        Returns ``cache``."""
        lm = self.lm
        if _recurrent(cache):
            raise ValueError(
                "adopt_cache serves the scheduler's attention-family cache; "
                "a recurrent cache has no per-slot seq axis")
        if lm.device.type != "cuda":
            return cache
        k = cache.get("k")
        if k is None or k.ndim < 3:
            shapes = {n: tuple(v.shape) for n, v in cache.items()}
            raise ValueError("adopt_cache takes a serving cache "
                             f"(lm.empty_cache), got leaves {shapes}")
        key = (k.shape[1], k.shape[2])
        like = type(lm)(lm.cfg, torch.device("meta")).empty_cache(*key)
        dev = lm.device

        def fits(t, want):
            return (t.shape == want.shape and t.dtype == want.dtype
                    and t.device.type == dev.type and t.is_contiguous()
                    and dev.index in (None, t.device.index))

        if cache.keys() != like.keys() or not all(
                fits(cache[n], t) for n, t in like.items()):
            raise ValueError(
                "adopt_cache: the cache is not this model's serving cache "
                f"for (B, max_seq) = {key} on {lm.device}")
        slot = self._slots.get(key)
        if slot is None:
            self._slots[key] = _Slot(lm, *key, cache=dict(cache))
        elif not slot.owns(cache):
            slot.cache = dict(cache)
            slot.graph = slot.out = None       # captured on other buffers
        return cache

    def slot_cache(self, batch_size: int, max_seq: int) -> dict | None:
        """The cache buffers the step's ``(batch_size, max_seq)`` slot
        serves (None on the CPU or before the slot exists)."""
        slot = self._slots.get((batch_size, max_seq))
        return None if slot is None else _copy_tree(slot.cache)

    def __call__(self, params, cache, tok, pos):
        lm = self.lm
        if lm.device.type != "cuda":
            return lm.decode_step(params, cache, tok, pos)
        slot = next((s for s in self._slots.values() if s.owns(cache)), None)
        if slot is None:
            raise ValueError(
                "the captured decode step serves only its own cache buffers: "
                "merge the prefill cache into step.empty_cache(B, max_seq) "
                "(generate does)")
        if tok.shape != slot.tok.shape:
            raise ValueError(f"the decode step takes tokens of shape "
                             f"{tuple(slot.tok.shape)}, got {tuple(tok.shape)}")
        slot.tok.copy_(tok)
        if torch.is_tensor(pos):
            slot.pos.copy_(pos)
        else:
            slot.pos.fill_(pos)
        logits, _ = self._replay(slot, params, lambda: decode_body(
            lm, params, slot.cache, slot.tok, slot.pos))
        return logits, slot.cache


@lru_cache(maxsize=64)
def make_decode_step(lm) -> DecodeStep:
    """The decode step bound to ``lm`` (:class:`DecodeStep`), memoized per
    ``lm`` as the reference's is: repeated :func:`generate` calls replay one
    captured graph instead of capturing one per call."""
    return DecodeStep(lm)


# ---------------------------------------------------------------- prefill --
class _PrefillSlot(_Captured):
    """One prompt shape of a :class:`PrefillStep`, ``(B, P)`` or ``(B, P,
    C)``: the prompt buffer it owns and the graph captured on it."""

    def __init__(self, lm, *shape: int):
        super().__init__()
        self.tokens = torch.zeros(shape, dtype=torch.int64, device=lm.device)


class PrefillStep(_GraphFn):
    """The served prefill: ``prefill(params, {"tokens": (B, P)}) ->
    (logits (B, V), cache)``, the reference's jitted ``LM.prefill``, one
    executable per prompt shape (``(B, P, C)`` tokens and ``(B, C, V)``
    logits for codebooks).

    On a CUDA device it captures ``lm.prefill`` into a CUDA graph per
    prompt shape on first use and replays it on every later call at that
    shape. It takes tokens alone, as the reference's serving path passes
    them: a batch with positions or the vision stub's patches goes through
    ``lm.prefill``, eager. It owns a prompt buffer per shape, which the
    call's tokens are copied into. The logits and the cache returned are
    the graph's own buffers, rewritten by the next call at the same
    shape: merge the cache (:func:`merge_cache`, which copies) and clone
    the logits to keep them.
    It captures again, as :class:`DecodeStep` does, for another params
    object or leaf and after the block autotune cache was cleared or
    preloaded; a capture first runs the prefill once eagerly at the same
    shapes (kernels built, blocks timed, tables uploaded, its launches
    counted), and each replay adds the captured launches. A capture that
    fails raises; the prefill never runs eagerly instead. The graph's
    private memory pool keeps the prefill's activations for as long as the
    step holds the graph.

    On the CPU it is ``lm.prefill``, eager.
    """

    def __call__(self, params, batch):
        lm = self.lm
        if lm.device.type != "cuda":
            return lm.prefill(params, batch)
        ndim = 3 if lm.cfg.n_codebooks else 2
        if batch.keys() != {"tokens"} or batch["tokens"].ndim != ndim:
            want = "(B, P, C)" if ndim == 3 else "(B, P)"
            raise ValueError(
                f"the captured prefill takes {{'tokens': {want}}} alone, got "
                f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
        tokens = batch["tokens"]
        slot = self._slots.get(tuple(tokens.shape))
        if slot is None:
            slot = self._slots[tuple(tokens.shape)] = _PrefillSlot(
                lm, *tokens.shape)
        slot.tokens.copy_(tokens)
        return self._replay(slot, params, lambda: lm.prefill(
            params, {"tokens": slot.tokens}))


@lru_cache(maxsize=64)
def make_prefill(lm) -> PrefillStep:
    """The prefill bound to ``lm`` (:class:`PrefillStep`), memoized per
    ``lm`` as :func:`make_decode_step` is: repeated :func:`generate` calls at
    one prompt shape replay one captured graph."""
    return PrefillStep(lm)


# ------------------------------------------------------------ decode loop --
def generate(lm, params, prompts: torch.Tensor, max_seq: int, gen: int, *,
             prefill_fn=None, decode_fn=None, return_logits: bool = False):
    """prompts: (B, P) int64 on ``lm.device`` — (B, P, C) for codebooks.
    Greedy decode ``gen`` tokens.

    The prompt goes through one prefill, :func:`make_prefill` unless
    ``prefill_fn`` overrides it (``prefill_fn=lm.prefill`` is the eager
    prefill), and the per-token loop runs one step function,
    :func:`make_decode_step` unless ``decode_fn`` overrides it
    (``decode_fn=lm.decode_step`` is the eager loop), against the merged
    serving cache. Returns the tokens ``(B, gen)`` [(B, gen, C)]; with
    ``return_logits`` also the logits each token was picked from, ``(B,
    gen, V)`` [(B, gen, C, V)] float32. The reference's ``generate`` takes
    ``(B, P)`` prompts alone; a codebook prompt is greedy per codebook,
    as its ``decode_step`` takes ``(B, C)`` tokens.
    """
    B, P = prompts.shape[:2]
    prefill = prefill_fn if prefill_fn is not None else make_prefill(lm)
    step = decode_fn if decode_fn is not None else make_decode_step(lm)
    empty = step.empty_cache if isinstance(step, DecodeStep) \
        else lm.empty_cache
    logits, cache = prefill(params, {"tokens": prompts})
    # both graphs hold addresses: the prefill's cache buffers are copied
    # into the step's own cache here, before either graph replays again;
    # the prefill's logits buffer is not rewritten within this call
    cache = merge_cache(empty(B, max_seq), cache)
    tok = torch.argmax(logits, -1)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = step(params, cache, tok, P + i)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        if return_logits:
            # a captured step's logits are its buffer, rewritten next call
            all_logits.append(logits.clone())
    tokens = torch.stack(toks, dim=1)
    if return_logits:
        return tokens, torch.stack(all_logits, dim=1).to(torch.float32)
    return tokens


def measure_generate(lm, params, prompts, max_seq: int, gen: int, *,
                     iters: int = 3):
    """Measured serving numbers: (tokens, end-to-end stats, step stats).

    One warm pass (which also builds the kernels, times the blocks and
    captures the prefill and the decode step), then the full ``generate``
    timed ``iters`` times, and the steady-state decode step — on the GPU
    one replay of the captured step, its host work included — timed
    separately against the post-prompt cache: end-to-end tok/s amortizes
    prefill, the step timing is the per-token latency. The served prefill
    is timed by :func:`measure_prefill`.
    """
    B, P = prompts.shape[:2]
    prefill, step = make_prefill(lm), make_decode_step(lm)
    run = lambda: generate(lm, params, prompts, max_seq, gen,
                           prefill_fn=prefill, decode_fn=step)
    tokens = run()
    e2e = time_callable(run, iters=iters, items=B * gen, device=lm.device)
    logits, cache = prefill(params, {"tokens": prompts})
    cache = merge_cache(step.empty_cache(B, max_seq), cache)
    tok = torch.argmax(logits, -1)
    # the step rewrites slot P with the same values (a recurrent state
    # moves on each call, through the same work): re-runnable as is
    step_t = time_callable(step, params, cache, tok, P,
                           iters=max(iters, 5), items=B, device=lm.device)
    return tokens, e2e, step_t


@dataclass(frozen=True)
class PrefillTimes:
    """The served prefill's numbers (:func:`measure_prefill`)."""
    stats: TimingStats           # one call, host work included, synced
    host_s: float                # best host time of a call, no sync inside
    capture_s: float | None      # the latest capture, warm run included;
                                 # None where nothing is captured (CPU)


def measure_prefill(lm, params, prompts, *, iters: int = 3) -> PrefillTimes:
    """The served prefill (:func:`make_prefill`; on the GPU one replay of
    the captured prefill) at ``prompts``' shape: warmed (the first call at
    a shape captures), then timed ``iters`` times device-synchronised, and
    the host's own time a call with the device drained before each and no
    synchronise inside."""
    prefill = make_prefill(lm)
    batch = {"tokens": prompts}
    stats = time_callable(prefill, params, batch, iters=iters,
                          items=prompts.shape[0] * prompts.shape[1],
                          device=lm.device)
    sync = (lambda: torch.cuda.synchronize(lm.device)) \
        if lm.device.type == "cuda" else (lambda: None)
    host_s = float("inf")
    for _ in range(max(iters, 1)):
        sync()
        t0 = wall_clock()
        prefill(params, batch)
        host_s = min(host_s, wall_clock() - t0)
    sync()
    return PrefillTimes(stats, host_s, prefill.capture_s)


# ------------------------------------------------------------ serving plan --
_PLAN_OPS = ("matmul", "div", "attention")


@dataclass(frozen=True)
class ResolvedOp:
    """One row of the load-time serving plan: the concrete dispatch config
    serving logical ``op`` on layers ``[layer_lo, layer_hi)``."""
    op: str
    layer_lo: int
    layer_hi: int
    width: int
    coeff_bits: int
    index_bits: int
    backend: str
    frac_out: int | None
    source: str                  # 'policy' entry or the config's own knobs

    def label(self) -> str:
        layers = f"L{self.layer_lo}" if self.layer_hi == self.layer_lo + 1 \
            else f"L{self.layer_lo}..L{self.layer_hi - 1}"
        frac = f"/q{self.frac_out}" if self.frac_out is not None else ""
        return (f"{layers:>8} {self.op:<9} {self.width}b/cb{self.coeff_bits}"
                f"/ib{self.index_bits}{frac} {self.backend} [{self.source}]")


def resolve_serving_plan(cfg) -> tuple[ResolvedOp, ...]:
    """Resolve every layer's per-op dispatch config at load time: one row
    per (policy-resolved layer segment, logical op). Exact-mode configs
    yield an empty plan."""
    approx = cfg.approx
    if not approx.enabled:
        return ()
    rows = []
    for lo, hi, acfg in serving_segments(approx, cfg.n_layers):
        for op in _PLAN_OPS:
            if op == "attention":
                spec, backend, frac = acfg.resolve_attention()
            else:
                spec, backend = acfg.resolve(
                    op, acfg.div_width if op == "div" else None)
                frac = acfg.frac_out if op == "div" else None
            entry = approx.policy.lookup(op, acfg.layer) \
                if approx.policy is not None else None
            rows.append(ResolvedOp(
                op=op, layer_lo=lo, layer_hi=hi, width=spec.width,
                coeff_bits=spec.coeff_bits, index_bits=spec.index_bits,
                backend=backend, frac_out=frac,
                source="policy" if entry is not None else "config"))
    return tuple(rows)


def render_plan(plan, cfg) -> str:
    if not plan:
        lines = ["# serving plan: exact (no approximate dispatch)"]
    else:
        segs = serving_segments(cfg.approx, cfg.n_layers)
        lines = [f"# serving plan: {len(segs)} layer segment(s), "
                 f"{len(plan)} resolved op config(s)"]
        lines += [f"#   {row.label()}" for row in plan]
    if cfg.n_experts and cfg.family == "moe":
        # the reference's routed experts are exact einsums, emulated or not
        lines.append("# routed experts: exact batched matmuls in the "
                     "activation dtype (no SIMDive dispatch)")
    return "\n".join(lines)


# --------------------------------------------------------------------- cli --
def serving_config(arch: str, *, smoke: bool = False, approx: str = "exact",
                   backend: str = "auto", emulate: bool = False,
                   policy=None):
    """The ModelConfig the CLI serves: ``approx`` other than 'exact' turns
    on the divider-softmax; ``emulate`` adds the SIMDive linears;
    ``policy`` (a ``TuningPolicy``) resolves per-layer dispatch configs
    and, as in the reference, makes an 'exact' ``approx`` 'simdive'."""
    cfg = get_config(arch, smoke=smoke)
    if policy is not None and approx == "exact":
        approx = "simdive"     # shipping a policy means approximate serving
    if approx != "exact":
        cfg = cfg.with_approx(ApproxConfig(
            mode=approx, emulate=emulate, use_in_softmax=True,
            backend=backend, policy=policy))
    return cfg


#: the chaos drill's fault (the reference's): bit 20 of every div table
#: stuck at 1 — every divider the ladder reads, the attention's included
CHAOS_SPEC = dict(site="table", bit=20, kind="stuck1", op="div")


def chaos_violations(stats: dict, requests: int) -> list[str]:
    """The reference's four rules of the chaos drill; empty = PASS."""
    violations = []
    if stats["completed"] != requests:
        violations.append(f"completed {stats['completed']}/{requests}")
    if stats["failed"]:
        violations.append(f"{stats['failed']} request(s) failed")
    if stats["quarantines"] < 1:
        violations.append("watchdog never quarantined — the armed fault "
                          "went unnoticed")
    if stats["tokens_per_level"].get("recovery", 0) < 1:
        violations.append("no tokens attributed to the recovery rung")
    return violations


def run_drill(cfg, params, args, rng) -> dict:
    """``--scheduler``: the reference's load-shed drill, its lines printed
    as the reference prints them; ``--chaos``: the same drill with the
    table scrub on every tick and :data:`CHAOS_SPEC` armed after the first
    tick (disarmed however the drill ends). Returns the drill's stats."""
    from repro_torch.launch.scheduler import Scheduler, default_ladder

    sched = Scheduler(
        cfg, params=params, levels=default_ladder(cfg.approx),
        batch=args.batch, prompt_len=args.prompt_len,
        max_seq=args.prompt_len + args.gen, shed_depth=args.shed_depth,
        recover_depth=args.recover_depth,
        scrub_every=1 if args.chaos else 0, device=args.device)
    warmed = sched.warmup()
    captured = sum(f.captures for f in sched.prefills + sched.steps)
    print(f"# scheduler: warmed {warmed} executable(s) across "
          f"{len(sched.levels)} level(s), {captured} CUDA graph(s) "
          "captured")
    for _ in range(args.requests):
        sched.submit(rng.integers(0, cfg.vocab_size, args.prompt_len,
                                  dtype=np.int64), max_new=args.gen)
    t0 = wall_clock()
    if args.chaos:
        from repro_torch.faults.inject import FaultSpec, set_faults

        # armed mid-flight, after the first admission tick, so that the
        # scrub catches requests already in their decode loop
        sched.step()
        spec = FaultSpec(**CHAOS_SPEC)
        set_faults([spec])
        print(f"# chaos: armed {spec} at tick {sched.tick_no}")
        try:
            stats = sched.run()
        finally:
            set_faults([])
    else:
        stats = sched.run()
    wall_s = wall_clock() - t0
    during = sum(f.captures for f in sched.prefills + sched.steps) - captured
    step_t = sched.measure_decode()
    print(f"# drill: {stats['completed']} request(s) in "
          f"{stats['ticks']} tick(s); tokens/level="
          f"{stats['tokens_per_level']}; sheds={stats['sheds']} "
          f"recovers={stats['recovers']}; "
          f"{stats['tokens'] / wall_s:.1f} tok/s over {wall_s * 1e3:.1f}ms; "
          f"{during} CUDA graph(s) captured during the drill")
    print(f"# watchdog: guard_trips={stats['guard_trips']} "
          f"quarantines={stats['quarantines']} "
          f"retries={stats['retries']} "
          f"timeouts={stats['timeouts']} failed={stats['failed']}")
    print(f"decode step {step_t.best_s * 1e6:.0f}us best "
          f"({step_t.items_per_s:.1f} tok/s steady-state, "
          f"iters={step_t.iters}, synced)")
    if args.chaos:
        violations = chaos_violations(stats, args.requests)
        if violations:
            print("# chaos: FAIL — " + "; ".join(violations))
            sys.exit(1)
        print(f"# chaos: PASS — every admitted request completed; "
              f"{stats['tokens_per_level']['recovery']} token(s) re-served "
              "on the recovery rung")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="batched prefill + greedy decode on the PyTorch/CUDA port")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--approx", default="exact",
                    choices=["exact", "mitchell", "simdive"])
    ap.add_argument("--emulate", action="store_true",
                    help="bit-exact SIMDive linears (with --approx); "
                         "composes with --quantize")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 linear weights (QuantizedWeight)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; an error without a GPU) or 'cpu'")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "ref", "cuda"],
                    help="kernel backend of the approximate ops: 'auto' = "
                         "CUDA kernels for tensors on the GPU, plain "
                         "versions on the CPU")
    ap.add_argument("--policy", default=None, metavar="PATH",
                    help="a simdive-policy/v1 JSON; resolves per-layer/"
                         "per-op dispatch configs at load time (implies "
                         "--approx simdive unless set)")
    ap.add_argument("--scheduler", action="store_true",
                    help="run the continuous-batching load-shed drill "
                         "instead of a single batched generate")
    ap.add_argument("--chaos", action="store_true",
                    help="scheduler drill under a seeded persistent "
                         "correction-table fault: the watchdog must "
                         "quarantine, retry on the recovery rung, and "
                         "complete every admitted request (exit 1 on "
                         "any violation); implies --scheduler")
    ap.add_argument("--requests", type=int, default=12,
                    help="scheduler drill: how many requests to flood")
    ap.add_argument("--shed-depth", type=int, default=4)
    ap.add_argument("--recover-depth", type=int, default=1)
    args = ap.parse_args(argv)

    policy = None
    if args.policy:
        from repro_torch.tuning import TuningPolicy

        policy = TuningPolicy.load(args.policy)
        print(f"# policy: {args.policy} ({len(policy.entries)} entries, "
              f"{len(policy.distinct_configs())} distinct dispatch "
              "config(s))")
    cfg = serving_config(args.arch, smoke=args.smoke, approx=args.approx,
                         backend=args.backend, emulate=args.emulate,
                         policy=policy)
    if cfg.n_codebooks:
        # the reference's CLI draws (B, P) prompts, which a codebook
        # config's embedding cannot take: serve it through generate
        raise NotImplementedError(
            f"{cfg.name}: the serve CLI draws (B, P) prompts; a codebook "
            "config takes (B, P, C) — call generate with them")
    if args.quantize and cfg.family == "hybrid":
        # before any parameter or launch: the reference cannot serve it
        raise NotImplementedError(f"{cfg.name}: {_HYBRID_QUANTIZE}")
    lm = build(cfg, device=args.device)
    print(render_plan(resolve_serving_plan(cfg), cfg))
    params = lm.init(args.seed)
    if args.quantize:
        params = quantize_params(params)
    rng = np.random.default_rng(args.seed)
    if args.scheduler or args.chaos:
        run_drill(cfg, params, args, rng)
        return
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len),
        dtype=np.int64)).to(lm.device)
    max_seq = args.prompt_len + args.gen
    toks, e2e, step_t = measure_generate(lm, params, prompts, max_seq,
                                         args.gen)
    pre = measure_prefill(lm, params, prompts)
    how = "a CUDA-graph replay" if lm.device.type == "cuda" else "eager"
    captured = "" if pre.capture_s is None \
        else f", captured in {pre.capture_s:.2f}s"
    print(f"generated {tuple(toks.shape)} on {e2e.device}: "
          f"{args.batch * args.gen / e2e.best_s:.1f} tok/s end-to-end "
          f"(best of {e2e.iters} post-warmup, synced); "
          f"prefill {pre.stats.best_s * 1e3:.2f}ms ({how}, host "
          f"{pre.host_s * 1e3:.2f}ms{captured}); "
          f"decode step {step_t.best_s * 1e6:.0f}us ({how}, "
          f"{step_t.items_per_s:.1f} tok/s steady-state)")
    print(toks[:2].cpu().numpy())


if __name__ == "__main__":
    main()
