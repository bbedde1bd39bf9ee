#!/usr/bin/env python3
"""Time kernel K2's single-table gather (``gather_rows``) at several row
widths on one GPU, in turns with ``torch.index_select`` (the same function
for in-range ids), after checking it bitwise against it.

    python3 quiver_tpu_torch/ops/kernels/time_gather.py [--root DIR]
        [--widths 400,1024,2400] [--ids 100000] [--rows 1000000]

Rows are f32 (a width of W bytes is W / 4 features), ids uniform over
``--rows`` rows. ``--root`` imports ``quiver_tpu_torch`` from another
checkout (default: the one holding this file), so two commits compare on
one card: run this script once per checkout, in turns (A, B, B, A). Prints
the card's name and power limit, then one JSON line: per width, the
kernel's and ``index_select``'s ms (median of 7 repetitions of 200 calls
between CUDA events, each the mean of its two turns) and the kernel's
share of its byte bound (ids read once, every row read and written once,
at 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak device-memory rate


def cuda_ms(fn, iters: int = 200, reps: int = 7) -> float:
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(here))))
    p.add_argument("--widths", default="400,1024,2400")
    p.add_argument("--ids", type=int, default=100_000)
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from quiver_tpu_torch.ops.kernels import gather

    if not os.path.abspath(gather.__file__).startswith(root + os.sep):
        raise RuntimeError(f"gather came from {gather.__file__}, not {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    ids = torch.randint(0, args.rows, (args.ids,), generator=g, device="cuda",
                        dtype=torch.int32)
    ids64 = ids.to(torch.int64)
    result = {"root": root, "ids": args.ids, "rows": args.rows, "card": card, "widths": {}}
    for width in (int(w) for w in args.widths.split(",")):
        table = torch.randn(args.rows, width // 4, generator=g, device="cuda")
        if not torch.equal(gather.gather_rows(table, ids), torch.index_select(table, 0, ids64)):
            raise AssertionError(f"gather_rows != index_select at {width} B rows")
        y1 = cuda_ms(lambda: torch.index_select(table, 0, ids64))
        k1 = cuda_ms(lambda: gather.gather_rows(table, ids))
        k2 = cuda_ms(lambda: gather.gather_rows(table, ids))
        y2 = cuda_ms(lambda: torch.index_select(table, 0, ids64))
        ms = (k1 + k2) / 2
        bound_ms = (args.ids * 4 + 2 * args.ids * width) / HBM_BYTES_PER_S * 1e3
        result["widths"][width] = {"ms": ms, "ms_turns": [k1, k2],
                                   "index_select_ms": (y1 + y2) / 2,
                                   "index_select_turns": [y1, y2],
                                   "bound_ms": bound_ms, "bound_share": bound_ms / ms}
        del table
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
