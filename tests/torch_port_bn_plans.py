#!/usr/bin/env python3
"""Times the BN statistics K7 and K8 of this tree at variants of their
plan, in one process on one GPU.

    python3 tests/torch_port_bn_plans.py [--variants JSON]

The plan (``ops/batch_norm.py`` ``_stats_plan``) is worked out from the
module's constants ``_STATS_ONE_TILE``, ``_STATS_TILE``, ``_STATS_ROWS``
and ``_STATS_BLOCKS``; a variant overrides some of them, e.g.
``{"tile128": {"_STATS_TILE": 128}}`` (the default set is below). Each
variant's K7 and K8 (f32 arithmetic, no mask, bf16 x and dy) are timed
from a CUDA graph (``chip_smoke.graph_ms``) at Inception's launches and
the ResNet-50 stem, each beside the plan it gave. Then the host cost of
the ways to allocate the statistics' output (microseconds a call, 2,000
calls without synchronising, median of 7). Prints one ``PLANS {...}``
JSON line a shape, one ``ALLOC {...}`` line, and the card's name and
power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((8192, 448), (8192, 320), (36992, 192), (36992, 128),
          (156800, 96), (156800, 64), (682112, 80), (645248, 192),
          (2841728, 32), (256 * 112 * 112, 64))
VARIANTS = {"base": {}, "one_tile_128": {"_STATS_ONE_TILE": 128},
            "one_tile_64": {"_STATS_ONE_TILE": 64},
            "tile128": {"_STATS_TILE": 128},
            "rows_k7_16": {"_STATS_ROWS": {"K7": 16, "K8": 16}},
            "rows_k8_32": {"_STATS_ROWS": {"K7": 32, "K8": 32}},
            "blocks132": {"_STATS_BLOCKS": 132},
            "blocks528": {"_STATS_BLOCKS": 528}}


def host_us(fn, n=2000, reps=7):
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", type=json.loads, default=VARIANTS)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    import torch
    import chip_smoke as cs
    from horovod_tpu_torch.ops import batch_norm as bn
    names = ("_STATS_ONE_TILE", "_STATS_TILE", "_STATS_ROWS",
             "_STATS_BLOCKS")
    base = {k: getattr(bn, k) for k in names}
    for M, C in SHAPES:
        x, dy, mean, rstd = cs._bn_inputs(M, C, "bfloat16", 1)
        res = {}
        for label, over in args.variants.items():
            for k in names:
                setattr(bn, k, over.get(k, base[k]))
            bn._stats_plan.cache_clear()
            res[label] = {
                "plan": [bn._stats_plan(M, C, 8, 1, k) for k in ("K7", "K8")],
                "k7_device_ms": cs.graph_ms(lambda: bn.batch_norm_stats(x)),
                "k8_device_ms": cs.graph_ms(
                    lambda: bn.batch_norm_grad_stats(dy, x, mean, rstd))}
        for k in names:
            setattr(bn, k, base[k])
        bn._stats_plan.cache_clear()
        print("PLANS %d x %d %s" % (M, C, json.dumps(res)), flush=True)
        del x, dy
        torch.cuda.empty_cache()
    x = torch.zeros(8192, 448, device="cuda", dtype=torch.bfloat16)
    like = torch.empty(2, 448, device="cuda")
    print("ALLOC " + json.dumps({
        "new_empty": host_us(lambda: x.new_empty((2, 448),
                                                 dtype=torch.float32)),
        "empty_like": host_us(lambda: torch.empty_like(like)),
        "empty_like_unbind": host_us(lambda: torch.empty_like(like)
                                     .unbind(0)),
        "batch_norm_stats": host_us(lambda: bn.batch_norm_stats(x))}),
        flush=True)


if __name__ == "__main__":
    main()
