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

Entry points run on the GPU unless asked otherwise: ``device`` defaults to
``'cuda'`` and a host without one gets an error, not a CPU run.

Throughput is measured, not guessed: everything reported goes through
:func:`repro_torch.metrics.timing.time_callable` (warm-up, then
device-synchronised repetitions).

Not ported yet, and therefore not accepted on the command line:
``--policy``, ``--scheduler``, ``--chaos``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --approx simdive [--emulate [--quantize]] --batch 4 --prompt-len 512 \
      --gen 32
  (CPU smoke: add --smoke --device cpu)
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import ApproxConfig, serving_segments
from repro_torch.metrics.timing import time_callable
from repro_torch.models import build
from repro_torch.models.layers import quantize_weight

# matmul-weight leaf names (stacked (L,K,N) / MoE (L,E,K,N) / flat (K,N));
# norms, embeddings (gather tables), convs and per-head vectors stay float.
_MATMUL_WEIGHTS = frozenset(
    "wq wk wv wo w1 w2 w3 head router wr wg wz wx wdt cm_wk cm_wr cm_wv "
    "out_proj".split())


def quantize_params(params: dict) -> dict:
    """Swap every linear weight for an int8 QuantizedWeight (per-out-channel
    scale). Stacked per-layer weights keep their leading L axis, so the
    layer loop still indexes them. Weights narrower than 64 on either of
    their last two axes stay float, as in the reference."""
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
def merge_cache(full: dict, cache: dict) -> dict:
    """Embed a prompt-length prefill cache into a max_seq serving cache.

    Equal-shape leaves pass through; longer-seq destination leaves take the
    prefill slab at the front of axis 2 (the stacked caches' seq axis),
    written **in place** into ``full``'s buffers. Anything else raises with
    the leaf path — a cache-layout drift must fail loudly, not serve an
    empty cache and generate garbage.
    """
    if set(full) != set(cache):
        raise ValueError(f"unmergeable cache: leaves {sorted(cache)} do not "
                         f"match the serving cache's {sorted(full)}")
    out = {}
    for key, dst in full.items():
        src = cache[key]
        if src.shape == dst.shape:
            out[key] = src.to(dst.dtype)
        elif (dst.ndim >= 3 and src.ndim == dst.ndim
                and dst.shape[:2] == src.shape[:2]
                and dst.shape[2] >= src.shape[2]
                and dst.shape[3:] == src.shape[3:]):
            dst[:, :, :src.shape[2]] = src.to(dst.dtype)
            out[key] = dst
        else:
            raise ValueError(
                f"unmergeable cache leaf ['{key}']: prefill "
                f"{tuple(src.shape)} does not embed into serving cache "
                f"{tuple(dst.shape)} (cache layout drift between prefill "
                "and empty_cache?)")
    return out


# ------------------------------------------------------------ decode loop --
def generate(lm, params, prompts: torch.Tensor, max_seq: int, gen: int, *,
             return_logits: bool = False):
    """prompts: (B, P) int64 on ``lm.device``. Greedy decode ``gen`` tokens.

    Returns the tokens ``(B, gen)``; with ``return_logits`` also the logits
    each token was picked from, ``(B, gen, V)`` float32.
    """
    B, P = prompts.shape
    logits, cache = lm.prefill(params, {"tokens": prompts})
    cache = merge_cache(lm.empty_cache(B, max_seq), cache)
    tok = torch.argmax(logits, -1)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = lm.decode_step(params, cache, tok, P + i)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        all_logits.append(logits)
    tokens = torch.stack(toks, dim=1)
    if return_logits:
        return tokens, torch.stack(all_logits, dim=1).to(torch.float32)
    return tokens


def measure_generate(lm, params, prompts, max_seq: int, gen: int, *,
                     iters: int = 3):
    """Measured serving numbers: (tokens, end-to-end stats, step stats).

    One warm pass (which also builds the kernels), then the full
    ``generate`` timed ``iters`` times, and the steady-state decode step
    timed separately against the post-prompt cache — end-to-end tok/s
    amortizes prefill, the step timing is the per-token latency.
    """
    B, P = prompts.shape
    run = lambda: generate(lm, params, prompts, max_seq, gen)
    tokens = run()
    e2e = time_callable(run, iters=iters, items=B * gen, device=lm.device)
    logits, cache = lm.prefill(params, {"tokens": prompts})
    cache = merge_cache(lm.empty_cache(B, max_seq), cache)
    tok = torch.argmax(logits, -1)
    # the step rewrites slot P with the same values: re-runnable as is
    step_t = time_callable(lm.decode_step, params, cache, tok, P,
                           iters=max(iters, 5), items=B, device=lm.device)
    return tokens, e2e, step_t


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
        return "# serving plan: exact (no approximate dispatch)"
    segs = serving_segments(cfg.approx, cfg.n_layers)
    lines = [f"# serving plan: {len(segs)} layer segment(s), "
             f"{len(plan)} resolved op config(s)"]
    lines += [f"#   {row.label()}" for row in plan]
    return "\n".join(lines)


# --------------------------------------------------------------------- cli --
def serving_config(arch: str, *, smoke: bool = False, approx: str = "exact",
                   backend: str = "auto", emulate: bool = False):
    """The ModelConfig the CLI serves: ``approx`` other than 'exact' turns
    on the divider-softmax; ``emulate`` adds the SIMDive linears."""
    cfg = get_config(arch, smoke=smoke)
    if approx != "exact":
        cfg = cfg.with_approx(ApproxConfig(
            mode=approx, emulate=emulate, use_in_softmax=True,
            backend=backend))
    return cfg


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
    args = ap.parse_args(argv)

    cfg = serving_config(args.arch, smoke=args.smoke, approx=args.approx,
                         backend=args.backend, emulate=args.emulate)
    lm = build(cfg, device=args.device)
    print(render_plan(resolve_serving_plan(cfg), cfg))
    params = lm.init(args.seed)
    if args.quantize:
        params = quantize_params(params)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len),
        dtype=np.int64)).to(lm.device)
    max_seq = args.prompt_len + args.gen
    toks, e2e, step_t = measure_generate(lm, params, prompts, max_seq,
                                         args.gen)
    print(f"generated {tuple(toks.shape)} on {e2e.device}: "
          f"{args.batch * args.gen / e2e.best_s:.1f} tok/s end-to-end "
          f"(best of {e2e.iters} post-warmup, synced); "
          f"decode step {step_t.best_s * 1e6:.0f}us "
          f"({step_t.items_per_s:.1f} tok/s steady-state)")
    print(toks[:2].cpu().numpy())


if __name__ == "__main__":
    main()
