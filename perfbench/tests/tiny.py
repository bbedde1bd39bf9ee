"""A copy of the benchmark's tree with a tiny configuration beside the real
one, for runs on the CPU. Only data files and entries are added: the code
is the benchmark's own."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REAL_CELL = "sage-products.infer"

TINY = {
    "source": "https://arxiv.org/abs/2005.00687",
    "num_nodes": 600,
    "num_edges": 12000,
    "num_features": 12,
    "num_classes": 5,
    "model": "GraphSAGE",
    "hidden_channels": 16,
    "num_layers": 2,
    "dropout": 0.5,
    "topology_mode": "HBM",
    "data_seed": 3,
    "reduced": [],
    "assumed": {"degree_exponent": 1.0, "degree_cap": 120},
}

LIMITS_INFER = {"logprob_gap": 1e-4}


def make_root(tmp: str, extra_cells=()) -> str:
    """``tmp`` holding ``BENCHMARK.json`` and ``perfbench/`` as committed,
    plus the tiny configuration ``tiny`` and its cell ``tiny.infer`` (the
    committed ``infer`` mix); ``extra_cells`` are more workload entries."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    write(root, "perfbench/configs/tiny.json", TINY)
    bench["configs"].append({"name": "tiny", "source": TINY["source"],
                             "file": "perfbench/configs/tiny.json", "reduced": [],
                             "why": "a test size"})
    bench["workloads"].append({"name": "tiny.infer", "config": "tiny", "traffic": "infer",
                               "chips": 1, "why": "a test size"})
    write(root, "perfbench/limits/tiny.infer.json", LIMITS_INFER)
    list_beside(bench, "tiny.infer", REAL_CELL)
    bench["workloads"] += list(extra_cells)
    write(root, "BENCHMARK.json", bench)
    return root


def list_beside(bench: dict, cell: str, like: str) -> None:
    """List ``cell`` wherever the metrics list the cell ``like``."""
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append(cell)


def write(root: str, rel: str, obj) -> None:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        if isinstance(obj, str):
            fh.write(obj)
        else:
            json.dump(obj, fh, indent=1)
