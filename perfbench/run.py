"""Run one cell of the benchmark on the card and print its result line.

    python -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, judges the window's outputs
against the plain reference, and prints one JSON object as the last line
of standard output; the compared numbers, each beside its limit, are the
last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits with 2 and prints no result; when a
module of JAX or of the JAX package was loaded, with 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _caches() -> None:
    """Every build and kernel cache a library may keep, at fixed paths
    inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("QUIVER_ELECTION_CACHE", "kernel_elections.json")):
        os.environ[var] = os.path.join(CACHE, sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _caches()
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import quiver_tpu_torch

    if not os.path.abspath(quiver_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"quiver_tpu_torch comes from {quiver_tpu_torch.__file__}, not from this "
              f"checkout", file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, compared = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                        device, T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    for k, v, lim in compared:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
