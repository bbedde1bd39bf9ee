"""Find a cell by name in ``BENCHMARK.json``, run it, judge it, and build
the result line.

Everything that belongs to one configuration, mix, loop, cell or metric is
a file found by its name:

- ``perfbench/configs/<config>.json`` (the entry's ``file``): the sizes;
- ``perfbench/traffic/<mix>.json``: the mix's parameters, and under
  ``loop`` the name of the loop that runs it;
- ``perfbench/loops/<loop>.py``: the loop, ``run(cfg, mix, seed, seconds,
  trace, device) -> runs.Run`` (the end-to-end values by metric name, the
  per-layer records, what the judge reads) and ``judge(cfg, mix, check,
  device) -> {compared number: reading}``;
- ``perfbench/limits/<workload>.json``: each compared number's limit;
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(records) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import NamedTuple

import torch

__all__ = ["Cell", "FORBIDDEN", "forbidden_modules", "load_cell", "load_module", "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "quiver_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's (``quiver_tpu_torch`` is not
    ``quiver_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.partition(".")[0] in FORBIDDEN)


class Cell(NamedTuple):
    root: str
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    mix = _read_json(os.path.join(root, "perfbench", "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(root, "perfbench", "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(root, name, int(w["chips"]), cfg, mix, limits, e2e, layer)


def load_module(root: str, folder: str, name: str):
    """``root/perfbench/<folder>/<name>.py``, loaded by its path."""
    path = os.path.join(root, "perfbench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{folder}:{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_info(device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> tuple[dict, list]:
    """Run ``cell`` once; returns the result line's object and the compared
    numbers as ``[(name, value, limit)]``. ``t_process`` is the process's
    start on ``time.perf_counter``'s clock."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = load_module(cell.root, "loops", cell.mix["loop"])
    run = loop.run(cell.cfg, cell.mix, seed, seconds, trace, device)
    values = dict(run.values, setup_s=run.t_start - t_process)
    info = _device_info(device, run.memory_peak_bytes)
    metrics, extra = {}, {}
    if trace:
        peaks = _read_json(os.path.join(cell.root, "perfbench", "peaks.json"))
        records = dict(run.records, peaks=peaks.get(info["kind"]))
        for m in cell.per_layer:
            value = load_module(cell.root, "metrics", m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del records
        tr = run.records["trace"]
        if tr is not None:
            print(f"trace: {tr.device_events} device operations in the window, "
                  f"{tr.attributed_s:.4f} of {tr.summed_s:.4f} device seconds charged to "
                  f"a span, reduced in {run.records['trace_reduce_s']:.3f} s",
                  file=sys.stderr)
            info.update(busy_s=tr.busy_s, window_s=tr.window_s)
            extra["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    attempted, check = run.units, run.check
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = loop.judge(cell.cfg, cell.mix, check, device)
    del check
    compared = [(k, got[k], cell.limits[k]) for k in cell.limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": info, **extra}
    return result, compared
