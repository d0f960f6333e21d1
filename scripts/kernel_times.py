#!/usr/bin/env python3
"""Time one checkout's CUDA kernels at the main path's shapes, on one card.

Builds the kernels of the checkout at ``--root`` (default: this one), reads
each kernel's registers from the build log, and times each kernel as many
launches replayed from one CUDA graph (``chip_smoke.gpu_graph_time_ms``),
twice: ``elemwise`` (div, width 8, the exhaustive square), ``packed`` (mul
and div, (17280, 960) words), ``decode_attention`` (q (4, 5, 3, 64), caches
(4, 544, 5, 64), pos 527), ``flash_attention`` depth 0 and the (64, 64, 2)
ring (q (60, 512, 64), kv (20, 512, 64), bf16, causal) and ``logmatmul``
((4, 960) @ (960, 2560) at the 4-row tile, depth 0 and ring; (2048, 960) @
(960, 2560) at the 8-row tile). To compare two checkouts, run it once a
checkout in one call, in turns (parent, change, change, parent):

    python3 scripts/kernel_times.py [--root DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def registers(build_dir: Path) -> dict:
    """Registers a thread of each compiled kernel (``-Xptxas -v``)."""
    out = {}
    for log in build_dir.rglob("build.*.log"):
        entry = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                name = subprocess.run(["cu++filt", entry], capture_output=True,
                                      text=True).stdout.strip() or entry
                out[name] = int(m.group(1))
                entry = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.simdive import SimdiveSpec
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import elemwise as ew
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logmatmul as lm
    from repro_torch.kernels import packed_simd as ps
    from repro_torch.metrics import grid8
    from repro_torch.metrics.timing import wall_clock

    if not torch.cuda.is_available():
        print("kernel_times: no GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = wall_clock()
    build.load()
    build_s = wall_clock() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    w8, w16 = SimdiveSpec(width=8, coeff_bits=6), SimdiveSpec(width=16,
                                                               coeff_bits=6)
    a, b = (ew.cuda_operand(torch.from_numpy(x.astype(np.int64)).to(dev), n)
            for x, n in zip(grid8(), "ab"))
    words = torch.randint(0, 1 << 32, (17280, 960), generator=gen,
                          device=dev, dtype=torch.int64)
    wa = ew.cuda_operand(words, "a", kernel="packed")
    wb = ew.cuda_operand(words.flip(-1), "b", kernel="packed")

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(*shape):
        return torch.randint(-255, 256, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    q, k, v = bf16(60, 512, 64), bf16(20, 512, 64), bf16(20, 512, 64)
    dq, kc, vc = bf16(4, 5, 3, 64), bf16(4, 544, 5, 64), bf16(4, 544, 5, 64)
    kn, vn = bf16(4, 1, 5, 64), bf16(4, 1, 5, 64)
    x4, x2k, w = ints(4, 960), ints(2048, 960), ints(960, 2560)
    attn = dict(spec=w16, approx_div=True, causal=True, kv_group=3)
    cases = {
        "elemwise_div": (lambda: ew.elemwise_cuda(a, b, w8, op="div",
                                                  frac_out=12), 400),
        "packed_mul": (lambda: ps.packed_cuda(wa, wb, w8, op="mul"), 60),
        "packed_div": (lambda: ps.packed_cuda(wa, wb, w8, op="div",
                                              frac_out=8), 60),
        "decode_attention": (lambda: da.decode_attention_cuda(
            dq, kc, vc, kn, vn, pos=527, slot=527, spec=w16, approx_div=True,
            frac_out=15), 400),
        # simdive-lint: allow(hardcoded-block): each schedule is timed by name, apart from the autotune
        "flash_depth0": (lambda: fa.flash_attention_cuda(
            q, k, v, block=(64, 64), **attn), 200),
        # simdive-lint: allow(hardcoded-block): each schedule is timed by name, apart from the autotune
        "flash_ring": (lambda: fa.flash_attention_cuda(
            q, k, v, block=(64, 64, 2), **attn), 200),
        # simdive-lint: allow(hardcoded-block): each schedule is timed by name, apart from the autotune
        "logmatmul_M4_depth0": (lambda: lm.logmatmul_cuda(
            x4, w, w8, block=(4, 128, 256, 4, 0)), 400),
        # simdive-lint: allow(hardcoded-block): each schedule is timed by name, apart from the autotune
        "logmatmul_M4_ring": (lambda: lm.logmatmul_cuda(
            x4, w, w8, block=(4, 128, 256, 4, 2)), 400),
        # simdive-lint: allow(hardcoded-block): each schedule is timed by name, apart from the autotune
        "logmatmul_M2048_depth0": (lambda: lm.logmatmul_cuda(
            x2k, w, w8, block=(8, 128, 256, 4, 0)), 10),
    }
    times = {}
    for _ in range(2):
        for name, (fn, iters) in cases.items():
            fn()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(cs.gpu_graph_time_ms(fn, iters))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    print(json.dumps({"root": str(root), "build_s": build_s,
                      "ms": times}))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"root": str(root), "card": card, "build_s": build_s,
             "ms": times, "registers": registers(build.build_dir())},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
