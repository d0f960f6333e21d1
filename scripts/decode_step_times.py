#!/usr/bin/env python3
"""Time one checkout's served prefill and decode step on the card, both
paths.

    python3 scripts/decode_step_times.py [--root DIR] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and prints one JSON line: the card as ``nvidia-smi
--query-gpu=name,power.limit`` gives it, and for smollm-360m at full width
(random weights, seed 0, batch 4, prompt 512, 32 tokens), divider-only
(``--approx simdive``) and ``--emulate``: the eager prefill
(``lm.prefill``) and its host time a call; where the checkout serves a
captured prefill (``serve.make_prefill``), the captured prefill (one
call, host work included, back-to-back replays, the host time a call,
the capture's time); the eager decode step (``lm.decode_step``), its
card time (eager steps replayed from one CUDA graph) and the kernels it
puts on the card; the eager generate (eager prefill and loop); and,
where the checkout serves a captured step (``serve.make_decode_step``),
the captured step (one call, host work included, and back-to-back
replays) and the served generate (``generate_captured_ms``: whatever the
checkout serves by default; where it serves a captured prefill, also
``generate_prefill_eager_ms``, its captured step behind the eager
prefill), and the eager step's card time again while the graphs live
and once they are released; then the kernels of an eager step
(divider-only: the costliest by name) from a profiler trace, and the card
time once more after the trace. Each timed call is recorded (``*_all``,
ms, in order) beside the best. Each path first serves one eager
generate, which times the block autotune's candidates (its picks are
printed). The
timing code is ``chip_smoke.py``'s from this script's checkout, so two
checkouts timed in turns in one call (A, B, B, A) are measured alike.
Needs one GPU; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402  (puts HERE/src on sys.path)


def _top_kernels(fn, n=8):
    """Device ms of one call of ``fn`` and its ``n`` costliest kernel
    names (count, ms), from a profiler trace."""
    prof = cs.device_time_by_kernel(fn)
    if prof is None:
        return None                         # the trace held no device event
    busy, by = prof
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return {"busy_ms": busy, "top": {name[:90]: rec for name, rec in top}}


def _times_ms(fn, iters):
    """Each of ``iters`` calls of ``fn`` after one warm call, host work
    included: CUDA events around each, synchronised (``time_callable``'s
    discipline), in ms and in order."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _record(out, key, times):
    out[key] = min(times)
    out[key + "_all"] = times


def time_path(lm, params, prompts, *, step_iters, graph_iters, gen_iters,
              trace):
    """One path's numbers, in this order: eager; then, where the checkout
    serves a captured step, the captured step, and the eager step's card
    time again while the step's graph lives and once it is released; then
    the profiler traces (``trace``: the costliest kernels too) and the card
    time once more after them."""
    import gc

    import torch
    from repro_torch.kernels import export_autotune_cache
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable

    max_seq = cs.PROMPT + cs.GEN
    captured = getattr(serve, "make_decode_step", None)
    captured_prefill = getattr(serve, "make_prefill", None)
    kw = {} if captured is None else {"decode_fn": lm.decode_step}
    if captured_prefill is not None:
        kw["prefill_fn"] = lm.prefill
    eager_gen = lambda: serve.generate(lm, params, prompts, max_seq, cs.GEN,
                                       **kw)
    eager_gen()                                    # autotune, first use
    out = {"picks": {repr(r["key"][2]): r["block"]
                     for r in export_autotune_cache()}}
    batch = {"tokens": prompts}
    _record(out, "prefill_ms", _times_ms(lambda: lm.prefill(params, batch),
                                         2 * gen_iters + 1))
    out["prefill_host_ms"] = cs.host_ms(lambda: lm.prefill(params, batch),
                                        gen_iters)
    if captured_prefill is not None:
        pstep = captured_prefill(lm)
        call = lambda: pstep(params, batch)
        _record(out, "prefill_captured_ms", _times_ms(call,
                                                      2 * gen_iters + 1))
        out["prefill_capture_s"] = pstep.capture_s
        out["prefill_captured_host_ms"] = cs.host_ms(call, gen_iters)
        out["prefill_replay_ms"] = cs.gpu_time_ms(call, iters=10)
        cs.require(pstep.captures == 1,
                   f"the prefill captured {pstep.captures} times, expected 1")
        del pstep, call
    logits, pre = lm.prefill(params, batch)
    cache = serve.merge_cache(lm.empty_cache(cs.BATCH, max_seq), pre)
    tok = logits.argmax(-1)
    step = lambda: lm.decode_step(params, cache, tok, cs.PROMPT)
    card_ms = lambda: cs.gpu_graph_time_ms(step, iters=graph_iters)
    out["decode_step_eager_ms"] = time_callable(
        lm.decode_step, params, cache, tok, cs.PROMPT, iters=step_iters,
        warmup=1).best_s * 1e3
    out["decode_step_device_ms"] = card_ms()
    _record(out, "generate_eager_ms", _times_ms(eager_gen, gen_iters))
    if captured is not None:
        dstep = captured(lm)
        serve.generate(lm, params, prompts, max_seq, cs.GEN)   # captures
        own = serve.merge_cache(dstep.empty_cache(cs.BATCH, max_seq), pre)
        call = lambda: dstep(params, own, tok, cs.PROMPT)
        out["decode_step_captured_ms"] = time_callable(
            call, iters=step_iters, warmup=1, device=lm.device).best_s * 1e3
        # back-to-back replays: the host runs ahead, the card sets the pace
        out["decode_step_replay_ms"] = cs.gpu_time_ms(call, iters=20)
        _record(out, "generate_captured_ms", _times_ms(
            lambda: serve.generate(lm, params, prompts, max_seq, cs.GEN),
            2 * gen_iters + 1))
        if captured_prefill is not None:
            _record(out, "generate_prefill_eager_ms", _times_ms(
                lambda: serve.generate(lm, params, prompts, max_seq, cs.GEN,
                                       prefill_fn=lm.prefill),
                2 * gen_iters + 1))
        out["decode_step_device_ms_graph_alive"] = card_ms()
        captured.cache_clear()
        if captured_prefill is not None:
            captured_prefill.cache_clear()
        del dstep, own, call
        gc.collect()
        out["decode_step_device_ms_graph_released"] = card_ms()
    out["decode_step_device_kernels"] = cs.count_device_kernels(step)
    if trace:
        out["decode_step_eager_trace"] = _top_kernels(step)
    out["decode_step_device_ms_after_trace"] = card_ms()
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_step_times: no GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import serve
    from repro_torch.models import build

    import repro_torch
    root = Path(repro_torch.__file__).resolve().parents[2]
    if root != Path(args.root).resolve():
        raise SystemExit(f"imported repro_torch from {root}, not {args.root}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    kbuild.load()
    out = {"card": card, "root": str(root)}
    params = prompts = None
    for name, emulate, iters in (("simdive", False, (10, 3, 3)),
                                 ("emulate", True, (5, 2, 2))):
        cfg = serve.serving_config(cs.ARCH, approx="simdive", emulate=emulate)
        lm = build(cfg)
        if params is None:
            params = lm.init(cs.SEED)
            prompts = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
                0, cfg.vocab_size, (cs.BATCH, cs.PROMPT), dtype=np.int64)
            ).to(dev)
        out[name] = time_path(lm, params, prompts, step_iters=iters[0],
                              graph_iters=iters[1], gen_iters=iters[2],
                              trace=not emulate)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
