#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quiver_tpu_torch) on one GPU.

    python3 chip_smoke.py [--nodes N] [--requests R] [--report FILE]

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (K1 ``select.cu``, K2
   ``gather.cu``, K3 ``wselect.cu``) from the sources in this checkout, one
   ``nvcc`` each, in parallel.
3. kernel checks: hold each kernel bitwise against its plain PyTorch
   version on the card, on the products-scale graph (with exp(N(0,1)) edge
   weights) and feature tables, device and pinned host (UVA) tables, and
   time both at the serving path's shapes and in bulk.
4. serve, uniform: the full-width serving configuration (products-shaped
   graph, F=100, GraphSAGE hidden 256 / 47 classes / 2 layers, fanouts
   [5, 5], max_batch 8) answers closed-loop point queries with every kernel
   launch counted; the answers are checked (finite, normalised, no
   overflow, ladder == single-query oracle bitwise at every bucket, full
   and padded), then the same stream is served again from a store with 3/4
   of its rows cold in pinned host memory and from a UVA topology, both of
   which must answer bitwise the same.
5. serve, weighted: the same server over ``GraphSageSampler(weighted=True)``
   (every hop on K3, none on K1), with the same checks, and the same stream
   again from a UVA weighted topology.
6. sampler, weighted: ``bench_sampler``'s configuration (fanouts
   [15, 10, 5], batch 2048, worst-case caps) samples a few batches; every
   edge must join a frontier node to one of its CSR neighbours, with
   ``min(deg, k)`` edges per node. Prints sampled edges/s.
7. sampler, temporal: a copy of the graph with U[0, 1) edge timestamps
   samples at [15, 10, 5] in the window [0.25, 0.75]; every edge must be an
   in-window edge of its node, with ``min(in-window degree, k)`` per node.
   Prints sampled edges/s and the window search's share of a batch.

Prints one ``{"kernels": [...]}`` line with all three kernels; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of
the JAX package ``quiver_tpu``.
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
SECTOR = 32  # bytes a random device-memory load moves

PRODUCTS_NODES = 2_450_000
PRODUCTS_AVG_DEG = 50.5
KERNELS = ("select", "gather", "wselect")
WSELECT_BOUND_RULE = (
    "8 B start + 4 B deg per row; 4 B u and two 4 B outputs per lane; one "
    "32 B sector for each distinct sector of cum_weights and of indices "
    "that this call's searches and selects touch"
)
WSELECT_PROBE_RULE = (
    "as WSELECT_BOUND_RULE, but one 32 B sector for every probe (each "
    "searching row's total, each of the `iters` bisection probes of each "
    "searching lane) and every indices load, shared or not"
)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def pinned(t):
    """``t`` in pinned host memory (read by the kernels over UVA)."""
    return t.pin_memory()


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


def kernel_fns():
    """The three kernel wrappers, by name; each carries a launch count."""
    from quiver_tpu_torch.ops.kernels.fused import select, wselect
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    return {"select": select, "gather": gather_rows, "wselect": wselect}


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


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
            sync()
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
            sync()
            ok = equal(got, want) and equal(got_keep, want_keep)
            err = float((got.float() - want.float()).abs().max()) if count else 0.0
            results.append({"table": name, "ids": count, "match": ok,
                            "max_abs_err": err})
            check(ok, f"gather {name} ids={count}")
    return results


def wselect_cases(dev_topo, uva_topo, seeds, k, g, label):
    """K3 against wselect_plain (on the device tables) for one seed set:
    scale_u on (raw u01) and off (u pre-scaled by the row totals), without
    and with the eid lane, device and UVA tables."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import wselect, wselect_plain
    from quiver_tpu_torch.ops.sample import seed_degrees

    S = seeds.shape[0]
    _valid, base, deg = seed_degrees(dev_topo, seeds, S)
    start = base.to(torch.int64)
    iters = dev_topo.search_iters
    u01 = torch.rand((S, k), generator=g, device=seeds.device)
    end = (start + deg - 1).clamp(min=0)
    tot = torch.where(deg > 0, dev_topo.cum_weights[end], 1.0)
    d = deg.to(torch.int64)
    classes = {"deg0_rows": int((d == 0).sum()),
               "deg_le_k_rows": int(((d > 0) & (d <= k)).sum()),
               "max_deg": int(d.max())}
    results = []
    for scale_u, u in ((True, u01), (False, (u01 * tot[:, None]).contiguous())):
        want = wselect_plain(dev_topo.indices, dev_topo.cum_weights, start,
                             deg, u, iters, eid=dev_topo.eid, scale_u=scale_u)
        for name, t, with_eid in (("device", dev_topo, False),
                                  ("device+eid", dev_topo, True),
                                  ("uva+eid", uva_topo, True)):
            got = wselect(t.indices, t.cum_weights, start, deg, u, t.search_iters,
                          eid=t.eid if with_eid else None, scale_u=scale_u)
            sync()
            # zip stops at got's length: without eid, (nbr, row_off) only
            ok = all(equal(a, b) for a, b in zip(got, want))
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      if a.numel() else 0 for a, b in zip(got, want))
            results.append({"graph": label, "rows": S, "k": k, "case": name,
                            "scale_u": scale_u, "match": ok,
                            "max_abs_err": err, **classes})
            check(ok, f"wselect {label} {name} rows={S} k={k} scale_u={scale_u}")
    return results


def wselect_checks(topo_np, dev_topo, uva_topo, rng):
    """K3 on the weighted products CSR (rows 100,003 / 64 / 8 at k 5 and
    15, each seed set holding the max-degree row, a row of degree <= k and
    an invalid seed of degree 0), then on a small CSR with empty rows and
    zero-total-weight rows (which carry the uniform prefix)."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    dev = dev_topo.device
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    deg_np = topo_np.degree
    results = []
    for k in (5, 15):
        for rows in (100_003, 64, 8):
            seeds = rng.integers(0, topo_np.node_count, rows).astype(np.int32)
            seeds[:3] = [int(np.argmax(deg_np)),
                         int(np.flatnonzero(deg_np <= k)[0]), -1]
            results += wselect_cases(dev_topo, uva_topo,
                                     torch.from_numpy(seeds).to(dev), k, g,
                                     "products")
    coo = generate_pareto_graph(20_000, 20.0, seed=3)
    coo = coo[:, coo[0] % 50 != 7]  # empty rows
    w = np.exp(np.random.default_rng(4).normal(size=coo.shape[1])).astype(np.float32)
    w[coo[0] % 10 == 3] = 0.0  # zero-total rows
    small = CSRTopo(edge_index=coo, edge_weight=w)
    s_dev = small.to_device("GPU", "cuda", with_eid=True, with_weights=True)
    s_uva = small.to_device("UVA", "cuda", with_eid=True, with_weights=True)
    seeds = torch.arange(small.node_count, dtype=torch.int32, device=dev)
    for k in (5, 15):
        results += wselect_cases(s_dev, s_uva, seeds, k, g, "small, zero-weight rows")
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


def wselect_sectors(dev_topo, start, deg, u, k):
    """Replay K3's searches (scaled draws, no eid lane) and count the 32 B
    sectors of ``cum_weights`` and ``indices`` they touch: every probe and
    load, and the distinct ones. Positions // 8 are sectors, since a 4 B
    array's allocation is sector-aligned."""
    import torch

    cw, iters = dev_topo.cum_weights, dev_topo.search_iters
    d = deg.to(torch.int64)
    i = torch.arange(k, device=d.device)
    take = (d <= k)[:, None] & (i[None, :] < d[:, None])
    loads = [(start[:, None] + i[None, :])[take]]  # take-all selects
    rows = d > k
    s, dd = start[rows][:, None], d[rows][:, None]
    probes = [(s + dd - 1).reshape(-1)]  # the row totals
    lo, hi = s.expand(-1, k), (s + dd - 1).expand(-1, k)
    uu = u[rows] * cw[s + dd - 1]
    for _ in range(iters):
        mid = (lo + hi) // 2
        probes.append(mid.reshape(-1))
        go = cw[mid] < uu
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    loads.append(torch.minimum(lo, s + dd - 1).reshape(-1))
    probes, loads = torch.cat(probes), torch.cat(loads)
    return {"cw_probes": int(probes.numel()),
            "cw_sectors": int(torch.unique(probes // 8).numel()),
            "index_loads": int(loads.numel()),
            "index_sectors": int(torch.unique(loads // 8).numel())}


def time_wselect(dev_topo, seeds, k, g, iters_timed: int = 200):
    """K3 at one weighted hop's shapes (the hop of ``sample_layer``:
    scaled in-kernel, no eid lane): kernel and plain version, with the byte
    bound of WSELECT_BOUND_RULE counted from this call's searches (and the
    looser WSELECT_PROBE_RULE beside it). No single PyTorch call computes a
    row-local inverse-CDF select over ragged rows, so there is no library
    time."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import wselect, wselect_plain
    from quiver_tpu_torch.ops.sample import seed_degrees

    S = seeds.shape[0]
    _valid, base, deg = seed_degrees(dev_topo, seeds, S)
    start = base.to(torch.int64)
    u = torch.rand((S, k), generator=g, device=seeds.device)
    iters = dev_topo.search_iters
    args = (dev_topo.indices, dev_topo.cum_weights, start, deg, u, iters)
    before = wselect.launches
    ms = cuda_ms(lambda: wselect(*args), iters=iters_timed)
    plain_ms = cuda_ms(lambda: wselect_plain(*args), iters=iters_timed)
    wselect.launches = before
    sec = wselect_sectors(dev_topo, start, deg, u, k)
    dense = S * 12 + S * k * 12
    nbytes = dense + SECTOR * (sec["cw_sectors"] + sec["index_sectors"])
    probe_bytes = dense + SECTOR * (sec["cw_probes"] + sec["index_loads"])
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "probe_bound_ms": probe_bytes / HBM_BYTES_PER_S * 1e3,
            "rows": S, "k": k, "iters": iters, **sec,
            "dependent_loads_per_searching_lane": iters + 2}


# -- phases 4 and 5: serve ----------------------------------------------------


def closed_loop(server, nodes, top):
    done = []
    for i in range(0, len(nodes), top):
        for n in nodes[i:i + top]:
            server.submit(int(n))
        while server.batcher.depth:
            done += server.pump(force=True)
    return done


def ladder_parity(server, picks):
    """Ladder lanes against the single-query oracle at every bucket, full
    and with a padded tail: ids, edges and log-probs bitwise."""
    import numpy as np
    import torch

    lad = server.ladder
    capL = lad.lane_caps[-1]
    lanes = 0
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
                check(np.array_equal(logp[j], server.oracle(node, seq)),
                      f"log-probs bucket={bucket} lane={j} bitwise")
                lanes += 1
    return {"ids_edges": "bitwise", "logp": "bitwise", "lanes": lanes}


def serve_phase(args, topo, feat_hot, variants, card, weighted):
    """Serve ``args.requests`` closed-loop queries over the [5, 5] sampler
    (weighted or uniform), with every kernel launch counted, and check the
    answers; then serve the first 64 again through each of ``variants``
    (``(label, sampler kwargs or None to reuse the sampler, store)``),
    which must answer bitwise the same."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSAGE, GraphSageSampler, InferenceServer

    n, F = topo.node_count, feat_hot.size(1)
    sampler = GraphSageSampler(topo, [5, 5], device="cuda", seed=0,
                               weighted=weighted)
    torch.manual_seed(0)
    model = GraphSAGE(F, 256, 47, num_layers=2)
    server = InferenceServer(sampler, model, feat_hot, device="cuda",
                             max_batch=8, seed=0)
    server.warmup()

    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, n, args.requests)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    reqs = closed_loop(server, nodes, 8)
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    batches = len(server.timeline.samples["sample"])
    log(f"served {len(reqs)} {'weighted' if weighted else 'uniform'} queries "
        f"in {wall:.3f}s ({batches} batches); launches {launches}")

    check(len(reqs) == args.requests, "every request answered")
    out = np.stack([r.result for r in reqs])
    check(out.shape == (args.requests, 47), f"log-prob shape {out.shape}")
    check(bool(np.isfinite(out).all()), "finite log-probs")
    sums = np.exp(out.astype(np.float64)).sum(axis=1)
    check(bool(np.all(np.abs(sums - 1.0) < 1e-4)), "exp(log-probs) sums to 1")
    check(all(r.overflow == 0 for r in reqs), "overflow == 0")
    hop, off_path = ("wselect", "select") if weighted else ("select", "wselect")
    check(launches[hop] == 2 * batches and launches[off_path] == 0,
          f"{hop} launched twice per batch and {off_path} never: {launches}")
    check(launches["gather"] == batches, f"gather once per batch: {launches}")

    picks = [(r.node, r.seq) for r in
             (reqs[i] for i in rng.choice(len(reqs), 16, replace=False))]
    parity = ladder_parity(server, picks)

    m = min(64, args.requests)
    reruns = {}
    for label, kwargs, store in variants:
        smp = sampler if kwargs is None else GraphSageSampler(
            topo, [5, 5], device="cuda", seed=0, weighted=weighted, **kwargs)
        other = InferenceServer(smp, model, store, device="cuda", max_batch=8,
                                seed=0)
        reset_launches()
        got = closed_loop(other, nodes[:m], 8)
        reruns[label] = {"queries": m, **read_launches()}
        check(all(np.array_equal(a.result, b.result)
                  for a, b in zip(got, reqs)),
              f"{label} answers == the first run's answers")

    st = server.stats()["stages"]
    stages = {k: {"p50_ms": v["p50"] * 1e3, "p99_ms": v["p99"] * 1e3}
              for k, v in st.items()}
    return launches, {
        "sampler": "weighted" if weighted else "uniform",
        "queries": len(reqs), "batches": batches, "qps": len(reqs) / wall,
        "wall_s": wall, "launches": launches, "stages": stages,
        "parity": parity, "bitwise_reruns_launches": reruns, "card": card,
    }


# -- phases 6 and 7: sampler --------------------------------------------------


def verify_sample(out, sizes, indptr, row_limit, member):
    """Check a SampleOutput on the card: overflow 0; in every layer each
    target node has ``min(row_limit[node], k)`` edges, and every edge
    ``(target, source)`` passes ``member(dst, src, e_id)`` (global ids).
    Returns the number of edges checked."""
    import torch

    check(int(out.overflow) == 0, "sampler overflow == 0")
    n_id = out.n_id.to(torch.int64)
    # targets of layer l: the frontier after layer l-1 (the seeds for l=0)
    counts = [out.batch_size] + [int(c) for c in reversed(out.frontier_counts)][:-1]
    edges = 0
    for l, adj in enumerate(reversed(out.adjs)):
        S = adj.size[1]
        tgt = torch.where(torch.arange(S, device=n_id.device) < counts[l],
                          n_id[:S], -1)
        want = torch.where(tgt >= 0, row_limit[tgt.clamp(min=0)].clamp(max=sizes[l]), 0)
        src, dst = adj.edge_index[0], adj.edge_index[1]
        ok = src >= 0
        got = torch.bincount(dst[ok].to(torch.int64), minlength=S)
        check(equal(got, want.to(got.dtype)),
              f"layer {l}: min(deg, k) edges per target node")
        e_id = None if adj.e_id is None else adj.e_id[ok].to(torch.int64)
        hit = member(tgt[dst[ok].to(torch.int64)], n_id[src[ok].to(torch.int64)], e_id)
        check(bool(hit.all()), f"layer {l}: every edge lies in its node's row")
        edges += int(ok.sum())
    return edges


def sampler_weighted_phase(topo, card, batches: int = 5):
    """``bench_sampler``'s weighted configuration: [15, 10, 5], batch 2048,
    worst-case caps, seed 0. Times ``batches`` calls after one warm-up and
    checks the last one against the CSR."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler

    sizes, batch = (15, 10, 5), 2048
    smp = GraphSageSampler(topo, list(sizes), device="cuda", seed=0,
                           seed_capacity=batch, weighted=True)
    rng = np.random.default_rng(0)
    n = topo.node_count
    smp.sample(rng.integers(0, n, batch))
    sync()
    reset_launches()
    total = 0
    t0 = time.perf_counter()
    for _ in range(batches):
        out = smp.sample(rng.integers(0, n, batch))
        total += int(sum(out.edge_counts))
    sync()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches["wselect"] == len(sizes) * batches and launches["select"] == 0,
          f"weighted sampler: K3 on every hop, K1 never: {launches}")

    dev = smp.topo.device
    indptr = smp.topo.indptr.to(torch.int64)
    deg = indptr[1:] - indptr[:-1]
    # membership by (row, neighbour) keys of the whole CSR, sorted
    rows = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    keys = torch.sort(rows * n + smp.topo.indices.to(torch.int64)).values
    del rows

    def member(dst, src, _e_id):
        key = dst * n + src
        pos = torch.searchsorted(keys, key).clamp(max=keys.shape[0] - 1)
        return keys[pos] == key

    checked = verify_sample(out, sizes, indptr, deg, member)
    return {"sizes": list(sizes), "batch": batch, "batches": batches,
            "edges": total, "seconds": dt, "edges_per_s": total / dt,
            "launches": launches, "edges_checked": checked, "card": card}


def sampler_temporal_phase(topo, args, card, window=(0.25, 0.75), batches: int = 5):
    """A second CSRTopo of the same graph with U[0, 1) timestamps (COO
    order, from ``--seed``) samples at [15, 10, 5] with ``time_window``;
    times ``batches`` calls after one warm-up, then the window search
    (``temporal_window_counts``) alone at each hop's frontier size; every
    edge of the last batch must be an in-window edge of its node."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CSRTopo, GraphSageSampler
    from quiver_tpu_torch.ops.sample import temporal_window_counts

    t0 = time.time()
    t = np.random.default_rng(args.seed).random(topo.edge_count, dtype=np.float32)
    topo_t = CSRTopo(indptr=topo.indptr, indices=topo.indices, eid=topo.eid)
    topo_t.set_edge_time(t)
    setup_s = time.time() - t0
    sizes, batch = (15, 10, 5), 2048
    smp = GraphSageSampler(topo_t, list(sizes), device="cuda", seed=0,
                           seed_capacity=batch, time_window=window,
                           with_eid=True)
    rng = np.random.default_rng(1)
    n = topo.node_count
    smp.sample(rng.integers(0, n, batch))
    sync()
    reset_launches()
    total = 0
    t1 = time.perf_counter()
    for _ in range(batches):
        out = smp.sample(rng.integers(0, n, batch))
        total += int(sum(out.edge_counts))
    sync()
    dt = time.perf_counter() - t1
    launches = read_launches()
    check(launches["select"] == len(sizes) * batches and launches["wselect"] == 0,
          f"temporal sampler: K1 on every hop: {launches}")

    d = smp.topo
    lo, hi = np.float32(window[0]), np.float32(window[1])
    indptr = d.indptr.to(torch.int64)
    inside = (d.edge_time >= float(lo)) & (d.edge_time <= float(hi))
    csum = torch.zeros(inside.shape[0] + 1, dtype=torch.int64, device=inside.device)
    csum[1:] = torch.cumsum(inside, 0)
    in_deg = csum[indptr[1:]] - csum[indptr[:-1]]
    slot_of = torch.empty_like(d.eid, dtype=torch.int64)  # COO position -> CSR slot
    slot_of[d.eid.to(torch.int64)] = torch.arange(d.eid.shape[0], device=d.eid.device)

    def member(dst, src, e_id):
        slot = slot_of[e_id]
        return ((slot >= indptr[dst]) & (slot < indptr[dst + 1])
                & (d.indices[slot].to(torch.int64) == src) & inside[slot])

    checked = verify_sample(out, sizes, indptr, in_deg, member)

    # the window search alone, at each hop's padded frontier size, on
    # random valid rows: its share of a batch's time
    search_ms = []
    for adj in reversed(out.adjs):
        rows = torch.randint(0, n, (adj.size[1],), device=indptr.device)
        base, deg = indptr[rows], (indptr[rows + 1] - indptr[rows]).to(torch.int32)
        search_ms.append(cuda_ms(lambda: temporal_window_counts(
            d.edge_time, base, deg, window[0], window[1], d.search_iters),
            iters=20, reps=3))
    return {"sizes": list(sizes), "batch": batch, "batches": batches,
            "window": list(window), "timestamps": "U[0,1) from --seed",
            "setup_s": setup_s, "edges": total, "seconds": dt,
            "edges_per_s": total / dt, "batch_ms": 1e3 * dt / batches,
            "frontier_sizes": [adj.size[1] for adj in reversed(out.adjs)],
            "window_search_ms": search_ms,
            "window_search_ms_per_batch": sum(search_ms),
            "launches": launches, "edges_checked": checked, "card": card}


def kernel_row(name, source, replaces, launches, checks, t, extra, card, device):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t.get("library_ms"),
            "match": all(c["match"] for c in checks), **extra,
            "checks": checks, "device": device, "card": card}


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
    check(sorted(libs) == sorted(KERNELS), f"built {sorted(libs)}")
    log(f"kernels built in {build_s:.1f}s: {sorted(libs)}")

    # graph, weights and features of the serving configuration
    from quiver_tpu_torch import CSRTopo, Feature
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    if args.nodes != PRODUCTS_NODES:
        print(json.dumps({"reduced": {"nodes": args.nodes,
                                      "from": PRODUCTS_NODES}}), flush=True)
    t0 = time.time()
    ei = generate_pareto_graph(args.nodes, args.avg_degree, seed=0)
    topo = CSRTopo(edge_index=ei)
    del ei
    # benchmarks/bench_sampler.py's weights: exp(N(0, 1)) from seed 0 + 5
    topo.set_edge_weight(np.exp(np.random.default_rng(5).normal(
        size=topo.edge_count)).astype(np.float32))
    graph_s = time.time() - t0
    log(f"graph and weights built in {graph_s:.1f}s: {topo}, max degree "
        f"{topo.max_degree}")
    rng = np.random.default_rng(args.seed)
    x_all = rng.standard_normal((topo.node_count, 100), dtype=np.float32)

    # phase 3: kernel checks
    dev_topo = topo.to_device("GPU", "cuda", with_eid=True, with_weights=True)
    uva_topo = topo.to_device("UVA", "cuda", with_eid=True, with_weights=True)
    sel = select_checks(topo, dev_topo, uva_topo, rng)
    wsel = wselect_checks(topo, dev_topo, uva_topo, rng)
    x_dev = torch.from_numpy(x_all).to("cuda")
    codes = torch.randint(-127, 128, x_dev.shape, dtype=torch.int8,
                          device="cuda")
    pin_rows = 500_000
    tables = [
        ("f32 device", x_dev), ("bf16 device", x_dev.to(torch.bfloat16)),
        ("int8 device", codes),
        ("f32 pinned", pinned(torch.from_numpy(x_all[:pin_rows]))),
        ("bf16 pinned", pinned(x_dev[:pin_rows].to(torch.bfloat16).cpu())),
        ("int8 pinned", pinned(codes[:pin_rows].cpu())),
    ]
    gat = gather_checks(tables, rng)
    del tables, codes
    # timing at the serving path's shapes: its largest hop (8 lanes x 8
    # frontier rows, fanout 5) and its lookup (8 lanes x 48 rows, F=100)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    hop_seeds = torch.from_numpy(
        rng.integers(0, topo.node_count, 64).astype(np.int32)).to("cuda")
    t_sel = time_select(dev_topo, hop_seeds, 5, g)
    t_wsel = time_wselect(dev_topo, hop_seeds, 5, g)
    look_ids = torch.from_numpy(
        rng.integers(0, topo.node_count, 384).astype(np.int32)).to("cuda")
    t_gat = time_gather(x_dev, look_ids)
    bulk_seeds = torch.from_numpy(rng.integers(
        0, topo.node_count, 1_000_000).astype(np.int32)).to("cuda")
    bulk = {
        "select": time_select(dev_topo, bulk_seeds, 5, g),
        "gather": time_gather(x_dev, torch.from_numpy(rng.integers(
            0, topo.node_count, 100_000).astype(np.int32)).to("cuda")),
        "wselect": time_wselect(dev_topo, bulk_seeds, 5, g, iters_timed=50),
    }
    del x_dev, dev_topo, uva_topo, bulk_seeds

    # phases 4 and 5: serve (the main paths; launch counts are read there)
    n, F = x_all.shape
    t0 = time.time()
    feat_hot = Feature(device_cache_size=n * F * 4,
                       device="cuda").from_cpu_tensor(x_all)
    feat_cold = Feature(device_cache_size=(n // 4) * F * 4, csr_topo=topo,
                        device="cuda").from_cpu_tensor(x_all)
    log(f"feature stores built in {time.time() - t0:.1f}s: hot-only "
        f"{feat_hot.hot_rows} rows; tiered {feat_cold.hot_rows} hot / "
        f"{n - feat_cold.hot_rows} cold (pinned host)")
    launches_u, serve_u = serve_phase(
        args, topo, feat_hot,
        [("tiered store", None, feat_cold),
         ("UVA topology", {"mode": "UVA"}, feat_hot)], card, weighted=False)
    launches_w, serve_w = serve_phase(
        args, topo, feat_hot, [("UVA topology", {"mode": "UVA"}, feat_hot)],
        card, weighted=True)
    del feat_hot, feat_cold

    # phases 6 and 7: sampler entry points
    samp_w = sampler_weighted_phase(topo, card)
    log(f"weighted sampler: {samp_w['edges_per_s']:.4g} sampled edges/s")
    samp_t = sampler_temporal_phase(topo, args, card)
    log(f"temporal sampler: {samp_t['edges_per_s']:.4g} sampled edges/s, "
        f"{samp_t['batch_ms']:.3f} ms per batch, window search "
        f"{samp_t['window_search_ms_per_batch']:.3f} ms of it")

    kernels = [
        kernel_row("select", "quiver_tpu_torch/ops/kernels/select.cu",
                   "quiver_tpu/ops/pallas/fused.py:75", launches_u, sel, t_sel,
                   {"stock_ms": t_sel["stock_ms"],
                    "shape": [t_sel["rows"], t_sel["k"]]}, card, name),
        kernel_row("gather", "quiver_tpu_torch/ops/kernels/gather.cu",
                   "quiver_tpu/ops/pallas/gather.py:28", launches_u, gat, t_gat,
                   {"shape": [t_gat["ids"], t_gat["row_bytes"]]}, card, name),
        kernel_row("wselect", "quiver_tpu_torch/ops/kernels/wselect.cu",
                   "quiver_tpu/ops/pallas/fused.py:113", launches_w, wsel, t_wsel,
                   {"shape": [t_wsel["rows"], t_wsel["k"]],
                    "iters": t_wsel["iters"],
                    "bound_rule": WSELECT_BOUND_RULE,
                    "probe_bound_ms": t_wsel["probe_bound_ms"],
                    "probe_bound_rule": WSELECT_PROBE_RULE,
                    "library": "none: no single PyTorch call computes a "
                               "row-local inverse-CDF select over ragged rows"},
                   card, name),
    ]
    check(all(k["launches"] > 0 and k["match"] for k in kernels),
          "every kernel launched on its main path and matched")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"kernels": kernels, "bulk": bulk,
                       "serve": {"uniform": serve_u, "weighted": serve_w},
                       "sampler": {"weighted": samp_w, "temporal": samp_t},
                       "build_s": build_s, "graph_s": graph_s,
                       "graph": {"nodes": topo.node_count,
                                 "edges": topo.edge_count,
                                 "max_degree": topo.max_degree}}, fh, indent=1)
    print(json.dumps({"bulk": bulk, "card": card}), flush=True)
    print(json.dumps({"serve": {"uniform": serve_u, "weighted": serve_w}}), flush=True)
    print(json.dumps({"sampler": {"weighted": samp_w, "temporal": samp_t}}), flush=True)
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
