"""The ``infer`` loop: layer-wise passes of the configuration's GraphSAGE
over the whole graph, back to back, through the program's
``sage_layerwise_inference`` (the refresher's path, which embeds every
node), and its judge.

Mix parameters: ``chunk_edges`` (edges per accumulate), ``warmup_passes``.
End-to-end value: ``infer_nodes_per_s``, the nodes embedded by every pass
completed in the window over the window's seconds. Compared number:
``logprob_gap``, the largest gap between the last pass's log-probs and the
plain reference's, over every node and class.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

from perfbench import data, runs
from perfbench.reference import sage
from perfbench.trace import TracedWindow

__all__ = ["build", "judge", "readings", "reference", "run", "window"]


def build(cfg: dict, device) -> dict:
    """What every run shares: the program's CSR and the features on the
    card."""
    ds = data.make_dataset(cfg, device)
    system = {"cfg": cfg, "device": device, "topo": runs.program_csr(ds.edges),
              "features": ds.features}
    del ds
    runs.peak_reset(device)
    return system


def window(system: dict, mix: dict, seed: int, seconds: float, trace: bool,
           warmup_passes: int | None = None) -> runs.Run:
    """The model's weights from ``seed``, the warm-up, and passes for
    ``seconds`` (at least one)."""
    from quiver_tpu_torch.models.inference import sage_layerwise_inference
    from quiver_tpu_torch.models.sage import GraphSAGE

    cfg, device = system["cfg"], system["device"]
    topo, features = system["topo"], system["features"]
    n, f = int(cfg["num_nodes"]), int(cfg["num_features"])
    layers, hidden = int(cfg["num_layers"]), int(cfg["hidden_channels"])
    model = GraphSAGE(f, hidden, int(cfg["num_classes"]), num_layers=layers,
                      dropout=float(cfg["dropout"])).to(device)
    shapes = [(k, tuple(p.shape)) for k, p in model.named_parameters()]
    weights = data.make_weights(shapes, seed, device)
    runs.load_weights(model, weights)
    model.eval()
    chunk = int(mix["chunk_edges"])

    def one_pass(call: int):
        with record_function(f"bench.pass#{call}"):
            out = sage_layerwise_inference(model, topo, features, chunk=chunk,
                                           mode=cfg["topology_mode"], device=device)
        runs.sync(device)
        return out

    warmup = int(mix["warmup_passes"]) if warmup_passes is None else warmup_passes
    for _ in range(warmup):
        one_pass(0)
    passes = 0
    out = None
    with TracedWindow(trace, device.type == "cuda") as tw:
        t_start = last = time.perf_counter()
        while True:
            out = None
            passes += 1
            out = one_pass(passes)
            last = time.perf_counter()
            if last - t_start >= seconds:
                break
    runs.sync(device)
    peak = runs.peak(device)
    records = {"trace": tw.trace, "trace_reduce_s": tw.reduce_s, "passes": passes,
               "num_nodes": n, "num_edges": int(cfg["num_edges"]),
               "widths": [f] + [hidden] * (layers - 1) + [int(cfg["num_classes"])]}
    del model
    return runs.Run(t_start, {"infer_nodes_per_s": passes * n / (last - t_start)}, passes,
                    peak, records, {"out": out, "weights": weights})


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device) -> runs.Run:
    return window(build(cfg, device), mix, seed, seconds, trace)


def reference(cfg: dict, device) -> dict:
    """The reference's own copy of the inputs, made again from the data
    seed."""
    ds = data.make_dataset(cfg, device)
    return {"features": ds.features, "edges": ds.edges}


def _reference_pass(cfg: dict, weights: dict, ref: dict):
    return sage.layerwise_pass(weights, ref["features"], ref["edges"], int(cfg["num_nodes"]),
                               int(cfg["num_layers"]))


def judge(cfg: dict, mix: dict, check: dict, device) -> dict:
    want = _reference_pass(cfg, check["weights"], reference(cfg, device))
    return {"logprob_gap": float((check["out"] - want).abs().max())}


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def readings(cfg: dict, mix: dict, seeds, device):
    """Per seed, the readings the limit is set from: the program's pass
    against the reference (the lower reading), the reference with TF32
    products in the program's place (the control: the upper reading), and
    the program's answer with one log-prob altered."""
    system = build(cfg, device)
    ref = reference(cfg, device)
    for seed in seeds:
        run_ = window(system, mix, seed, 0.0, False, warmup_passes=0)
        out, weights = run_.check["out"], run_.check["weights"]
        want = _reference_pass(cfg, weights, ref)
        with _tf32():
            ctl = _reference_pass(cfg, weights, ref)
        alt = out.clone()
        alt[0, 0] += 1.0
        yield {"seed": seed,
               "program": {"logprob_gap": float((out - want).abs().max())},
               "control": {"logprob_gap": float((ctl - want).abs().max())},
               "altered": {"logprob_gap": float((alt - want).abs().max())}}
