#!/usr/bin/env python3
"""Time one checkout's decode-step attention on the card.

    python3 scripts/decode_attention_times.py [--root DIR] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there, and prints one JSON line: the card as ``nvidia-smi
--query-gpu=name,power.limit`` gives it; the ``decode_attention`` op's
graph-replayed time at the decode step's shape (batch 4, cache 544, 5 kv
heads x 3, d_head 64, bf16, pos 527, the serving divider), at pos 0 and at
cache 2048 / pos 2047, each beside one ``scaled_dot_product_attention``
call and the bound; and smollm-360m's divider-only decode step at full
width (random weights, seed 0): eager and graph-replayed time and the
kernels it puts on the card. The timing code is ``chip_smoke.py``'s from
this script's checkout, so two checkouts timed in turns in one call
(A, B, B, A) are measured alike. Needs one GPU; exits 1 without one.
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
        print("decode_attention_times: no GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import serve
    from repro_torch.metrics.timing import time_callable
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
    int_rate = cs.int32_ops_per_s(dev)
    cfg = serve.serving_config(cs.ARCH, approx="simdive")
    spec, _, frac_out = cfg.approx.resolve_attention()
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    out = {"card": card, "root": str(root)}
    smax = cs.PROMPT + cs.GEN
    for key, Smax, pos in (("serving", smax, cs.PROMPT + 15),
                           ("pos0", smax, 0), ("cache2048", 2048, 2047)):
        t = cs.time_decode_attention(dev, gen, cs.BATCH, Smax, KV, G, dh, pos,
                                     spec, frac_out, int_rate)
        out[key] = {k: t[k] for k in ("ms", "library_ms", "bound_ms",
                                      "bound_by", "cluster")}

    lm = build(cfg)
    params = lm.init(cs.SEED)
    prompts = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (cs.BATCH, cs.PROMPT), dtype=np.int64)).to(dev)
    logits, cache = lm.prefill(params, {"tokens": prompts})
    cache = serve.merge_cache(lm.empty_cache(cs.BATCH, smax), cache)
    tok = logits.argmax(-1)
    step = lambda: lm.decode_step(params, cache, tok, cs.PROMPT)
    out["decode_step_ms"] = time_callable(
        lm.decode_step, params, cache, tok, cs.PROMPT, iters=10,
        warmup=2).best_s * 1e3
    out["decode_step_device_ms"] = cs.gpu_graph_time_ms(step, iters=3)
    out["decode_step_device_kernels"] = cs.count_device_kernels(step)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
