"""The readings each limit is set from, at a cell's own size, on many seeds
in one process (the dataset and the program's state are built once).

    python -m perfbench.control --workload <name> --seeds <n> [<n> ...] [--out <file>]

For every seed it prints one JSON line from the cell's loop
(``readings(cfg, mix, seeds, device)`` in ``perfbench/loops/<loop>.py``):
``program``, the program's timed path against the reference, as a run
judges it (the lower readings); ``control``, the reference put in the
program's place in the nearest precision below the configuration's (the
upper readings); and the loop's planted faults.

The benchmark's own runs never run this. It needs the card, as they do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)
    loop = harness.load_module(ROOT, "loops", cell.mix["loop"])
    lines = []
    for line in loop.readings(cell.cfg, cell.mix, args.seeds, device):
        line = {"workload": args.workload, **line}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
