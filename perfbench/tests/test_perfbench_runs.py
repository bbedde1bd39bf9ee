"""Each mix end to end on the CPU at a tiny size against the reference; the
command line's refusals; the check for JAX; and a configuration, a mix, a
per-layer metric, and a loop with an end-to-end metric of its own, each
added from new files and entries alone.

Run from the repository's root: ``python -m pytest perfbench/tests -q``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_cpu(root, trace):
    c = harness.load_cell(root, "tiny.infer")
    result, compared = harness.run_cell(c, SEED, 0.5, trace, CPU, time.perf_counter())
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {k for k, _, _ in compared} == set(c.limits)
    if trace:
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device time and no peaks of a CPU: every reader finds nothing to read
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_answer(root):
    c = harness.load_cell(root, "tiny.infer")
    loop = harness.load_module(root, "loops", c.mix["loop"])
    a, b = (loop.run(c.cfg, c.mix, SEED, 0.05, False, CPU).check["out"] for _ in range(2))
    assert torch.equal(a, b)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "quiver_tpu_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "quiver_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "quiver_tpu.ops"]


def test_a_run_loads_no_jax(root):
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {tiny.ROOT!r})\n"
        "from perfbench import harness\n"
        f"c = harness.load_cell({root!r}, 'tiny.infer')\n"
        "for trace in (True, False):\n"
        "    harness.run_cell(c, 5, 0.2, trace, torch.device('cpu'), time.perf_counter())\n"
        "print('FOUND', harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def _cli(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "perfbench.run", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_cli_refuses_without_a_card():
    out = _cli(["--workload", tiny.REAL_CELL, "--seed", str(SEED), "--seconds", "1",
                "--trace", "0"], tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_cli_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(["--workload", tiny.REAL_CELL, "--seed", "1", "--seconds", "1",
                "--trace", "0"], str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


NEW_METRIC = '''"""``passes.seen``: window passes the per-layer records hold (a test metric)."""


def read(rec):
    return float(rec["passes"]) if rec.get("passes") else None
'''


def test_new_config_mix_and_metric_from_files_alone(tmp_path):
    cfg = dict(tiny.TINY, num_nodes=900, num_edges=18000, num_layers=3, data_seed=9)
    mix = {"loop": "infer", "chunk_edges": 4096, "warmup_passes": 0}
    cell = {"name": "tiny2.infer-chunked", "config": "tiny2", "traffic": "infer-chunked",
            "chips": 1, "why": "a test cell"}
    root = tiny.make_root(str(tmp_path), extra_cells=[cell])
    tiny.write(root, "perfbench/configs/tiny2.json", cfg)
    tiny.write(root, "perfbench/traffic/infer-chunked.json", mix)
    tiny.write(root, "perfbench/limits/tiny2.infer-chunked.json", tiny.LIMITS_INFER)
    tiny.write(root, "perfbench/metrics/passes.seen.py", NEW_METRIC)
    bench = _bench(root)
    bench["configs"].append({"name": "tiny2", "source": cfg["source"],
                             "file": "perfbench/configs/tiny2.json", "reduced": [],
                             "why": "a test size"})
    tiny.list_beside(bench, "tiny2.infer-chunked", tiny.REAL_CELL)
    bench["per_layer"].append({"name": "passes.seen", "unit": "passes", "better": "higher",
                               "source": "host_clock", "layer": "layer-wise inference",
                               "moves": "infer_nodes_per_s",
                               "workloads": ["tiny2.infer-chunked"]})
    tiny.write(root, "BENCHMARK.json", bench)
    c = harness.load_cell(root, "tiny2.infer-chunked")
    result, compared = harness.run_cell(c, SEED, 0.3, True, CPU, time.perf_counter())
    assert result["correct"], compared
    assert result["metrics"]["passes.seen"]["value"] == result["attempted"]
    result, _ = harness.run_cell(c, SEED, 0.3, False, CPU, time.perf_counter())
    assert result["metrics"]["infer_nodes_per_s"]["value"] > 0


NEW_LOOP = '''"""The ``sum`` loop (a test loop): sums of a seeded vector, back to back."""

import time

import torch

from perfbench import runs
from perfbench.trace import TracedWindow


def run(cfg, mix, seed, seconds, trace, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    v = torch.rand(int(mix["length"]), generator=g, device=device, dtype=torch.float64)
    part = v[: v.numel() // 2] if mix.get("broken") else v  # a planted fault
    sums = 0
    with TracedWindow(trace, device.type == "cuda") as tw:
        t_start = last = time.perf_counter()
        while last - t_start < seconds or sums == 0:
            total = part.sum()
            sums += 1
            last = time.perf_counter()
    return runs.Run(t_start, {"sums_per_s": sums / (last - t_start)}, sums, 0,
                    {"trace": tw.trace, "trace_reduce_s": tw.reduce_s, "sums": sums},
                    {"total": total, "v": v})


def judge(cfg, mix, check, device):
    return {"sum_gap": abs(float(check["total"]) - sum(check["v"].tolist()))}
'''

SUMS_METRIC = '''def read(rec):
    return float(rec["sums"]) if rec.get("sums") else None
'''


@pytest.mark.parametrize("broken", [False, True])
def test_new_loop_with_its_own_metrics_from_files_alone(tmp_path, broken):
    cells = [{"name": "tiny.sum", "config": "tiny", "traffic": "sum", "chips": 1,
              "why": "a test cell of a loop added from files"}]
    root = tiny.make_root(str(tmp_path), extra_cells=cells)
    tiny.write(root, "perfbench/loops/sum.py", NEW_LOOP)
    tiny.write(root, "perfbench/traffic/sum.json",
               {"loop": "sum", "length": 1000, **({"broken": True} if broken else {})})
    tiny.write(root, "perfbench/limits/tiny.sum.json", {"sum_gap": 1e-9})
    tiny.write(root, "perfbench/metrics/sums.seen.py", SUMS_METRIC)
    bench = _bench(root)
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.sum"]})
    bench["per_layer"].append({"name": "sums.seen", "unit": "sums", "better": "higher",
                               "source": "host_clock", "layer": "sum",
                               "moves": "sums_per_s", "workloads": ["tiny.sum"]})
    tiny.write(root, "BENCHMARK.json", bench)
    c = harness.load_cell(root, "tiny.sum")
    assert {m["name"] for m in c.end_to_end} == {"sums_per_s", "setup_s"}
    result, compared = harness.run_cell(c, SEED, 0.2, False, CPU, time.perf_counter())
    assert result["correct"] is (not broken), compared
    assert set(result["metrics"]) == {"sums_per_s", "setup_s"}
    result, _ = harness.run_cell(c, SEED, 0.2, True, CPU, time.perf_counter())
    assert result["metrics"]["sums.seen"]["value"] == result["attempted"]
