#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quiver_tpu_torch) on one GPU.

    python3 chip_smoke.py [--nodes N] [--requests R] [--report FILE]

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (K1 ``select.cu``, K2
   ``gather.cu``) from the sources in this checkout, one ``nvcc`` each, in
   parallel.
3. kernel checks: hold each kernel bitwise against its plain PyTorch
   version on the card, on the products-scale graph and feature tables
   (device and pinned host tables), and time both at the serving path's
   shapes. Prints one ``{"kernels": [...]}`` line.
4. serve: the full-width serving configuration (products-shaped graph,
   F=100, GraphSAGE hidden 256 / 47 classes / 2 layers, fanouts [5, 5],
   max_batch 8) answers closed-loop point queries with every kernel launch
   counted; the answers are checked (finite, normalised, no overflow,
   ladder == single-query oracle at every bucket), then the same stream is
   served again from a store with 3/4 of its rows cold in pinned host
   memory and from a UVA topology, both of which must answer bitwise the
   same.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX
or of the JAX package ``quiver_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak device-memory rate

PRODUCTS_NODES = 2_450_000
PRODUCTS_AVG_DEG = 50.5


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the mean per-call time of ``iters`` calls,
    between CUDA events, after a warm-up."""
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


def equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


# -- phase 3: kernel checks ---------------------------------------------------


def select_checks(topo_np, dev_topo, uva_topo, rng):
    """K1 against select_plain on the products CSR: with and without the
    eid lane, a ragged row count, counts on and off, and a UVA table."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import select, select_plain
    from quiver_tpu_torch.ops.sample import seed_degrees, uniform_offsets

    dev = dev_topo.device
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    results = []
    for rows, k in ((100_003, 5), (64, 5), (8, 5)):
        seeds = torch.from_numpy(rng.integers(
            0, topo_np.node_count, rows).astype("int32")).to(dev)
        valid, base, deg = seed_degrees(dev_topo, seeds, rows)
        offs = uniform_offsets(deg, k, g)
        count = torch.where(valid, deg.clamp(max=k), 0)
        start = base.to(torch.int64)
        cases = [
            ("indices", (dev_topo.indices,), count),
            ("indices+eid", (dev_topo.indices, dev_topo.eid), count),
            ("uva indices+eid", (uva_topo.indices, uva_topo.eid), count),
        ]
        # without counts every lane is read: keep rows with deg >= 1
        nz = deg > 0
        for name, tabs, cnt in cases + [("indices, no count",
                                         (dev_topo.indices,), None)]:
            st, of = (start[nz], offs[nz]) if cnt is None else (start, offs)
            got = select(tabs, st, of.contiguous(), cnt)
            want = select_plain(tabs, st, of, cnt)
            torch.cuda.synchronize()
            ok = all(equal(a, b) for a, b in zip(got, want))
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      if a.numel() else 0 for a, b in zip(got, want))
            results.append({"rows": int(st.shape[0]), "k": k, "case": name,
                            "match": ok, "max_abs_err": err})
            check(ok, f"select {name} rows={rows}")
    return results


def gather_checks(tables, rng):
    """K2 against gather_rows_plain: f32/bf16/int8 tables, device and
    pinned host, a ragged id count with -1 lanes, and the keep-out form."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    results = []
    for name, tab in tables:
        dev = torch.device("cuda")
        n = tab.shape[0]
        for count in (100_003, 384, 7):
            ids = rng.integers(0, n, count).astype("int32")
            ids[rng.random(count) < 0.1] = -1
            ids_d = torch.from_numpy(ids).to(dev)
            got = gather_rows(tab, ids_d)
            want = gather_rows_plain(tab, ids_d)
            base = torch.full_like(want, 3)
            got_keep = gather_rows(tab, ids_d, out=base.clone())
            want_keep = gather_rows_plain(tab, ids_d, out=base)
            torch.cuda.synchronize()
            ok = equal(got, want) and equal(got_keep, want_keep)
            err = float((got.float() - want.float()).abs().max()) if count else 0.0
            results.append({"table": name, "ids": count, "match": ok,
                            "max_abs_err": err})
            check(ok, f"gather {name} ids={count}")
    return results


def time_select(dev_topo, seeds, k, g):
    """K1 at one hop's shapes: kernel, plain version and the stock
    ``index_select`` of the drawn slots, with its byte bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import select, select_plain
    from quiver_tpu_torch.ops.sample import seed_degrees, uniform_offsets

    valid, base, deg = seed_degrees(dev_topo, seeds, seeds.shape[0])
    offs = uniform_offsets(deg, k, g).contiguous()
    count = torch.where(valid, deg.clamp(max=k), 0)
    start = base.to(torch.int64)
    tabs = (dev_topo.indices,)
    before = select.launches
    ms = cuda_ms(lambda: select(tabs, start, offs, count))
    plain_ms = cuda_ms(lambda: select_plain(tabs, start, offs, count))
    pos = (start[:, None] + offs.to(torch.int64)).reshape(-1)
    pos = torch.where(
        (torch.arange(k, device=pos.device)[None, :] < count[:, None]).reshape(-1),
        pos, 0)
    stock_ms = cuda_ms(lambda: torch.index_select(dev_topo.indices, 0, pos))
    select.launches = before  # timing launches are not main-path launches
    S = seeds.shape[0]
    lanes = int(count.sum())
    nbytes = S * 8 + S * k * 4 + S * 4 + lanes * 4 + S * k * 4
    return {"ms": ms, "plain_ms": plain_ms, "stock_ms": stock_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "rows": S, "k": k}


def time_gather(table, ids):
    """K2 at one lookup's shapes (in-range ids): kernel, plain version and
    ``torch.index_select``, which computes the same function here."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    before = gather_rows.launches
    ms = cuda_ms(lambda: gather_rows(table, ids))
    plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids))
    ids64 = ids.to(torch.int64)
    library_ms = cuda_ms(lambda: torch.index_select(table, 0, ids64))
    gather_rows.launches = before
    B = ids.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    nbytes = B * 4 + 2 * B * row_bytes
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ids": B,
            "row_bytes": row_bytes}


# -- phase 4: serve -----------------------------------------------------------


def closed_loop(server, nodes, top):
    done = []
    for i in range(0, len(nodes), top):
        for n in nodes[i:i + top]:
            server.submit(int(n))
        while server.batcher.depth:
            done += server.pump(force=True)
    return done


def ladder_parity(server, picks):
    """Ladder lanes against the single-query oracle at every bucket: ids
    and edges bitwise; log-probs bitwise, else within atol 1e-5 (the
    batched forward may take another cuBLAS algorithm than one lane)."""
    import numpy as np
    import torch

    lad = server.ladder
    capL = lad.lane_caps[-1]
    bitwise_logp = True
    worst = 0.0
    for bucket in server.batcher.buckets:
        groups = [picks[i:i + bucket] for i in range(0, len(picks), bucket)]
        if bucket > 1:
            groups.append(picks[:bucket - 1])  # a padded tail
        for group in groups:
            seeds = np.full(bucket, -1, np.int32)
            seqs = [None] * bucket
            for j, (node, seq) in enumerate(group):
                seeds[j], seqs[j] = node, seq
            n_ids, eis, _ovf = lad.sample_exec(bucket)(
                torch.from_numpy(seeds).to(server.device), seqs)
            x = server.feature[n_ids.reshape(-1)].reshape(
                bucket, capL, lad.feature_dim)
            logp = lad.forward_exec(bucket)(x, eis).cpu().numpy()
            for j, (node, seq) in enumerate(group):
                o_nid, o_eis, _ = lad.oracle_sample(node, seq)
                check(equal(n_ids[j], o_nid), f"n_id bucket={bucket} lane={j}")
                for e, oe in zip(eis, o_eis):
                    check(equal(e[j], oe), f"edges bucket={bucket} lane={j}")
                want = server.oracle(node, seq)
                if not np.array_equal(logp[j], want):
                    bitwise_logp = False
                    worst = max(worst, float(np.abs(logp[j] - want).max()))
                    check(np.allclose(logp[j], want, rtol=0, atol=1e-5),
                          f"log-probs bucket={bucket} lane={j}")
    return {"ids_edges": "bitwise", "logp": "bitwise" if bitwise_logp
            else f"atol 1e-5 (max abs diff {worst:.3g})"}


def serve_phase(args, topo, x_all, card):
    import numpy as np
    import torch

    from quiver_tpu_torch import Feature, GraphSAGE, GraphSageSampler, InferenceServer
    from quiver_tpu_torch.ops.kernels.fused import select
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    n, F = x_all.shape
    t0 = time.time()
    feat_hot = Feature(device_cache_size=n * F * 4).from_cpu_tensor(x_all)
    feat_cold = Feature(device_cache_size=(n // 4) * F * 4,
                        csr_topo=topo).from_cpu_tensor(x_all)
    log(f"feature stores built in {time.time() - t0:.1f}s: hot-only "
        f"{feat_hot.hot_rows} rows; tiered {feat_cold.hot_rows} hot / "
        f"{n - feat_cold.hot_rows} cold (pinned host)")
    sampler = GraphSageSampler(topo, [5, 5], seed=0)
    torch.manual_seed(0)
    model = GraphSAGE(F, 256, 47, num_layers=2)
    server = InferenceServer(sampler, model, feat_hot, max_batch=8, seed=0)
    server.warmup()

    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, n, args.requests)
    torch.cuda.synchronize()
    select.launches = 0
    gather_rows.launches = 0
    t0 = time.perf_counter()
    reqs = closed_loop(server, nodes, 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"select": select.launches, "gather": gather_rows.launches}
    log(f"served {len(reqs)} queries in {wall:.3f}s; launches {launches}")

    check(len(reqs) == args.requests, "every request answered")
    out = np.stack([r.result for r in reqs])
    check(out.shape == (args.requests, 47), f"log-prob shape {out.shape}")
    check(bool(np.isfinite(out).all()), "finite log-probs")
    sums = np.exp(out.astype(np.float64)).sum(axis=1)
    check(bool(np.all(np.abs(sums - 1.0) < 1e-4)), "exp(log-probs) sums to 1")
    check(all(r.overflow == 0 for r in reqs), "overflow == 0")
    check(launches["select"] > 0 and launches["gather"] > 0,
          "the serve path launched both kernels")

    picks = [(r.node, r.seq) for r in
             (reqs[i] for i in rng.choice(len(reqs), 16, replace=False))]
    parity = ladder_parity(server, picks)

    # the same stream from the tiered store (3/4 of rows read over UVA) and
    # from a UVA topology: every answer bitwise equal to the first run's
    m = min(64, args.requests)
    uva_sampler = GraphSageSampler(topo, [5, 5], mode="UVA", seed=0)
    variants = {}
    for label, smp, store in (("tiered store", sampler, feat_cold),
                              ("UVA topology", uva_sampler, feat_hot)):
        other = InferenceServer(smp, model, store, max_batch=8, seed=0)
        select.launches = gather_rows.launches = 0
        got = closed_loop(other, nodes[:m], 8)
        variants[label] = {"queries": m, "select": select.launches,
                           "gather": gather_rows.launches}
        check(all(np.array_equal(a.result, b.result)
                  for a, b in zip(got, reqs)),
              f"{label} answers == the first run's answers")

    st = server.stats()["stages"]
    stages = {k: {"p50_ms": v["p50"] * 1e3, "p99_ms": v["p99"] * 1e3}
              for k, v in st.items()}
    return server, launches, {
        "queries": len(reqs), "qps": len(reqs) / wall, "wall_s": wall,
        "stages": stages, "parity": parity,
        "bitwise_reruns_launches": variants,
        "card": card,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nodes", type=int, default=PRODUCTS_NODES)
    p.add_argument("--avg-degree", type=float, default=PRODUCTS_AVG_DEG)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", default=None,
                   help="also write every check and timing to this JSON file")
    args = p.parse_args()

    # phase 1: device
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False; this smoke needs a GPU")
        return 2
    sys.path.insert(0, HERE)
    import quiver_tpu_torch

    pkg = os.path.dirname(os.path.abspath(quiver_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"quiver_tpu_torch came from {pkg}, not this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    print(card, flush=True)
    log(f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 2: build
    import numpy as np

    from quiver_tpu_torch.ops.kernels import build

    t0 = time.time()
    libs = build.build_all()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f}s: {sorted(libs)}")

    # graph and features of the serving configuration
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    if args.nodes != PRODUCTS_NODES:
        print(json.dumps({"reduced": {"nodes": args.nodes,
                                      "from": PRODUCTS_NODES}}), flush=True)
    t0 = time.time()
    ei = generate_pareto_graph(args.nodes, args.avg_degree, seed=0)
    topo = CSRTopo(edge_index=ei)
    del ei
    graph_s = time.time() - t0
    log(f"graph built in {graph_s:.1f}s: {topo}")
    rng = np.random.default_rng(args.seed)
    x_all = rng.standard_normal((topo.node_count, 100), dtype=np.float32)

    # phase 3: kernel checks
    dev_topo = topo.to_device("GPU", with_eid=True)
    uva_topo = topo.to_device("UVA", with_eid=True)
    sel = select_checks(topo, dev_topo, uva_topo, rng)
    x_dev = torch.from_numpy(x_all).cuda()
    codes = torch.randint(-127, 128, x_dev.shape, dtype=torch.int8,
                          device="cuda")
    pin_rows = 500_000
    tables = [
        ("f32 device", x_dev), ("bf16 device", x_dev.to(torch.bfloat16)),
        ("int8 device", codes),
        ("f32 pinned", torch.from_numpy(x_all[:pin_rows]).pin_memory()),
        ("bf16 pinned", x_dev[:pin_rows].to(torch.bfloat16).cpu().pin_memory()),
        ("int8 pinned", codes[:pin_rows].cpu().pin_memory()),
    ]
    gat = gather_checks(tables, rng)
    del tables, codes
    # timing at the serving path's shapes: its largest hop (8 lanes x 8
    # frontier rows, fanout 5) and its lookup (8 lanes x 48 rows, F=100)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    hop_seeds = torch.from_numpy(
        rng.integers(0, topo.node_count, 64).astype(np.int32)).cuda()
    t_sel = time_select(dev_topo, hop_seeds, 5, g)
    look_ids = torch.from_numpy(
        rng.integers(0, topo.node_count, 384).astype(np.int32)).cuda()
    t_gat = time_gather(x_dev, look_ids)
    bulk = {
        "select": time_select(dev_topo, torch.from_numpy(rng.integers(
            0, topo.node_count, 1_000_000).astype(np.int32)).cuda(), 5, g),
        "gather": time_gather(x_dev, torch.from_numpy(rng.integers(
            0, topo.node_count, 100_000).astype(np.int32)).cuda()),
    }
    del x_dev, dev_topo, uva_topo

    # phase 4: serve (the main path; launch counts are read here)
    server, launches, serve = serve_phase(args, topo, x_all, card)

    kernels = [
        {"name": "select", "route": "cuda",
         "source": "quiver_tpu_torch/ops/kernels/select.cu",
         "replaces": "quiver_tpu/ops/pallas/fused.py:75",
         "launches": launches["select"],
         "max_abs_err": max(c["max_abs_err"] for c in sel),
         "ms": t_sel["ms"], "plain_ms": t_sel["plain_ms"],
         "bound_ms": t_sel["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "stock_ms": t_sel["stock_ms"],
         "shape": [t_sel["rows"], t_sel["k"]], "match": True,
         "checks": sel, "device": name, "card": card},
        {"name": "gather", "route": "cuda",
         "source": "quiver_tpu_torch/ops/kernels/gather.cu",
         "replaces": "quiver_tpu/ops/pallas/gather.py:28",
         "launches": launches["gather"],
         "max_abs_err": max(c["max_abs_err"] for c in gat),
         "ms": t_gat["ms"], "plain_ms": t_gat["plain_ms"],
         "bound_ms": t_gat["bound_ms"], "bound_by": "bytes",
         "library_ms": t_gat["library_ms"],
         "shape": [t_gat["ids"], t_gat["row_bytes"]], "match": True,
         "checks": gat, "device": name, "card": card},
    ]
    check(all(k["launches"] > 0 for k in kernels), "every kernel launched")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"kernels": kernels, "bulk": bulk, "serve": serve,
                       "build_s": build_s, "graph_s": graph_s,
                       "graph": {"nodes": topo.node_count,
                                 "edges": topo.edge_count}}, fh, indent=1)
    print(json.dumps({"bulk": bulk, "card": card}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    for k in kernels:
        k.pop("checks")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
