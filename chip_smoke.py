#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quiver_tpu_torch) on one GPU.

    python3 chip_smoke.py [--nodes N] [--requests R] [--report FILE]

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (K1 ``select.cu``, K2
   ``gather.cu``, K3 ``wselect.cu``) from the sources in this checkout, one
   ``nvcc`` each, in parallel.
3. kernel checks: hold every kernel entry bitwise against its plain
   PyTorch version on the card (K1's select and fused uniform hop, K2's
   single-table and tiered gathers, K3's search-and-select and fused
   weighted hop), on the products-scale graph (with exp(N(0,1)) edge
   weights) and feature tables (and wide f32 rows of 1 KB and 2.4 KB), a
   small graph with zero-weight rows and one whose rows take every degree
   of 0-40 and some up to 3232, device and pinned host (UVA) tables; then time each
   entry at the serving path's shapes and in bulk, in turns with its
   yardstick (yardstick, kernel, kernel, yardstick) where it has one,
   beside its bound.
4. serve, uniform: the full-width serving configuration (products-shaped
   graph, F=100, GraphSAGE hidden 256 / 47 classes / 2 layers, fanouts
   [5, 5], max_batch 8) answers closed-loop point queries with every kernel
   launch counted; the answers are checked (finite, normalised, no
   overflow, ladder == single-query oracle bitwise at every bucket, full
   and padded, with the oracle's launches counted), then the same stream
   is served again from a store with 3/4
   of its rows cold in pinned host memory and from a UVA topology, both of
   which must answer bitwise the same.
5. serve, weighted: the same server over ``GraphSageSampler(weighted=True)``
   (every hop one launch of K3's fused entry, none on K1; the oracle runs
   K3's search-and-select), with the same checks, and the same stream
   again from a UVA weighted topology.
6. sampler, uniform and weighted (K1's and K3's fused hops):
   ``bench_sampler``'s configuration
   (fanouts [15, 10, 5], batch 2048, worst-case caps) samples a few
   batches; every edge must join a frontier node to one of its CSR
   neighbours, with ``min(deg, k)`` edges per node. Prints sampled edges/s.
7. sampler, temporal: a copy of the graph with U[0, 1) edge timestamps
   samples at [15, 10, 5] in the window [0.25, 0.75]; every edge must be an
   in-window edge of its node, with ``min(in-window degree, k)`` per node.
   Prints sampled edges/s and the window search's share of a batch.
8. train, full width: ``examples/train_sage_torch.py``'s default
   configuration (Reddit-scale synthetic graph, 232,965 nodes, F=602, 41
   classes, GraphSAGE 256 x 2, fanouts [25, 10], batch 1024, 20% of the
   rows cached on the card and the rest pinned on the host, auto caps,
   Adam). The planning call, one warm-up step, then 20 timed steps with
   the sample, gather and train-step (forward, backward, Adam) times, each
   ending in a synchronise; steps/s, sampled edges/s, peak device memory,
   the planned caps beside the worst case; 5 more steps under
   ``torch.profiler`` (device time per kernel, each stage's span on the
   card, the device's idle share); finite losses; exactly 2
   ``uniform_hop`` and 1 ``tiered_gather`` launches per step (2 more per
   regrowth rerun, counted apart); then the card's train step against the
   CPU's on one full-width batch (dropout 0, TF32 off): loss within 1e-5
   relative, each gradient within 1e-4 x its max |g|.
9. train, acceptance: the twin's ``--dataset planted:20000 --epochs 4``
   on the card, with sampled and then layer-wise evaluation; each test
   accuracy must clear the feature-only Bayes accuracy + 0.15.

Prints one ``{"kernels": [...]}`` line with every kernel entry under its
TPU kernel; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the JAX package ``quiver_tpu``.
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
WIDE_ROWS = 1_000_000  # rows of the wide-row gather tables
PROFILED_STEPS = 5  # training steps traced by torch.profiler
KERNELS = ("select", "gather", "wselect")
# the wrappers, each with its launch count: K1's two entries, K2's two, K3's two
ENTRIES = ("select", "uniform_hop", "gather_rows", "tiered_gather", "wselect",
           "weighted_hop")
SELECT_BOUND_RULE = (
    "8 B start + 4 B count per row; 4 B offset and 4 B output per lane; one "
    "32 B sector for each distinct sector of indices that the selected "
    "lanes touch (replayed)"
)
HOP_BOUND_RULE = (
    "4 B seed + 4 B count per row, 4 B num per lead, 4 B output per lane; "
    "one 32 B sector for each distinct sector that the hop touches "
    "(replayed) of indptr (two loads per valid seed, indptr[0] for invalid "
    "ones), of the rotation bits (one 8 B load per row of degree > k) and "
    "the jitter bits (one 8 B load per lane of such a row), and of indices "
    "(the selected lanes)"
)
GATHER_BOUND_RULE = (
    "device memory: 4 B per id (+4 B per valid id for the order lookup), "
    "each hot row read once and each output row written once, at 3.35 "
    "TB/s; cold rows (pinned host, read over UVA) at the pinned-host -> "
    "device copy rate measured in the same call; the bound is the larger "
    "of the two times"
)
WSELECT_BOUND_RULE = (
    "8 B start + 4 B deg per row; 4 B u and two 4 B outputs per lane; one "
    "32 B sector for each distinct sector of cum_weights and of indices "
    "that this call's searches and selects touch"
)
WHOP_BOUND_RULE = (
    "4 B seed + 4 B count per row, 4 B num per lead, 4 B output per lane; "
    "one 32 B sector for each distinct sector that the hop touches "
    "(replayed) of indptr (two loads per valid seed, indptr[0] for invalid "
    "ones), of u (one 4 B load per lane of a row of degree > k), of "
    "cum_weights (the searches, as WSELECT_BOUND_RULE) and of indices (the "
    "selects)"
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
    """The kernel entries' wrappers, by name; each carries a launch count."""
    from quiver_tpu_torch.ops.kernels.fused import (select, uniform_hop,
                                                    weighted_hop, wselect)
    from quiver_tpu_torch.ops.kernels.gather import gather_rows, tiered_gather

    return {"select": select, "uniform_hop": uniform_hop,
            "gather_rows": gather_rows, "tiered_gather": tiered_gather,
            "wselect": wselect, "weighted_hop": weighted_hop}


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def expect_launches(launches: dict, want: dict, what: str) -> None:
    """Every entry launched exactly as ``want`` says (0 when unnamed)."""
    full = {name: want.get(name, 0) for name in ENTRIES}
    check(launches == full, f"{what}: launches {launches}, expected {full}")


def in_turns(kernel_fn, yard_fn, iters: int = 200, reps: int = 7) -> dict:
    """Kernel and yardstick timed in turns (yardstick, kernel, kernel,
    yardstick) in this call; each figure the mean of its two turns."""
    y1 = cuda_ms(yard_fn, iters, reps)
    k1 = cuda_ms(kernel_fn, iters, reps)
    k2 = cuda_ms(kernel_fn, iters, reps)
    y2 = cuda_ms(yard_fn, iters, reps)
    return {"ms": (k1 + k2) / 2, "ms_turns": [k1, k2],
            "yard_ms": (y1 + y2) / 2, "yard_turns": [y1, y2],
            "ratio": (k1 + k2) / (y1 + y2)}


# -- phase 3: kernel checks ---------------------------------------------------


def max_err(got, want) -> int:
    import torch

    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def select_checks(topo_np, dev_topo, uva_topo, rng):
    """K1's select entry against select_plain on the products CSR: with
    and without the eid lane, a ragged row count, counts on and off, and a
    UVA table."""
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
        valid, base, deg = seed_degrees(dev_topo.indptr, seeds, rows)
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
            ok = len(got) == len(want) and all(equal(a, b) for a, b in zip(got, want))
            results.append({"rows": int(st.shape[0]), "k": k, "case": name,
                            "match": ok, "max_abs_err": max_err(got, want)})
            check(ok, f"select {name} rows={rows}")
    return results


def hop_seeds(topo_np, shape, k, rng, dev):
    """Seeds of ``shape`` holding, in every lane, the max-degree row, a row
    of degree <= k and a -1."""
    import numpy as np
    import torch

    seeds = rng.integers(0, topo_np.node_count, shape).astype(np.int32)
    seeds[..., 0] = int(np.argmax(topo_np.degree))
    seeds[..., 1] = int(np.flatnonzero(topo_np.degree <= k)[0])
    seeds[..., 2] = -1
    return torch.from_numpy(seeds).to(dev)


def hop_checks(topo_np, dev_topo, uva_topo, rng):
    """K1's fused uniform hop against uniform_hop_plain on the products
    CSR: 100,003 flat rows with a scalar count (3 invalid), and 8 x 8 lanes
    with per-lane counts at k 5 and 15; without an eid lane, with the eid
    table's, with CSR slots in int32 and int64 indptr; device and UVA
    tables."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, uniform_hop_plain
    from quiver_tpu_torch.ops.sample import draw_bits

    dev = dev_topo.device
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    ip64 = dev_topo.indptr.to(torch.int64)
    results = []
    for shape, k in (((100_003,), 5), ((8, 8), 5), ((8, 8), 15)):
        seeds = hop_seeds(topo_np, shape, k, rng, dev)
        if len(shape) == 1:
            num = shape[0] - 3
        else:
            num = torch.from_numpy(rng.integers(
                0, shape[1] + 1, shape[0]).astype("int32")).to(dev)
            num[0] = shape[1]
        jitter, rot = draw_bits(shape, k, g)
        for name, t, indptr, eid, with_eid in (
                ("device", dev_topo, dev_topo.indptr, None, False),
                ("device+eid", dev_topo, dev_topo.indptr, dev_topo.eid, True),
                ("device, CSR slots", dev_topo, dev_topo.indptr, None, True),
                ("device, int64 indptr, CSR slots", dev_topo, ip64, None, True),
                ("uva+eid", uva_topo, uva_topo.indptr, uva_topo.eid, True)):
            got = uniform_hop(indptr, t.indices, seeds, num, jitter, rot,
                              eid=eid, with_eid=with_eid)
            want = uniform_hop_plain(indptr, dev_topo.indices, seeds, num, jitter,
                                     rot, eid=None if eid is None else dev_topo.eid,
                                     with_eid=with_eid)
            sync()
            ok = len(got) == len(want) and all(equal(a, b) for a, b in zip(got, want))
            results.append({"shape": list(shape), "k": k, "case": name,
                            "match": ok, "max_abs_err": max_err(got, want)})
            check(ok, f"uniform_hop {name} shape={shape} k={k}")
    return results


def gather_checks(tables, rng):
    """K2's single-table entry against gather_rows_plain: f32/bf16/int8
    tables, device and pinned host, wide f32 rows, a ragged id count with
    -1 lanes, and the keep-out form."""
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
            want = gather_rows_plain(tab, ids_d)
            base = torch.full_like(want, 3)
            want_keep = gather_rows_plain(tab, ids_d, out=base)
            got = gather_rows(tab, ids_d)
            got_keep = gather_rows(tab, ids_d, out=base.clone())
            sync()
            ok = equal(got, want) and equal(got_keep, want_keep)
            err = float((got.float() - want.float()).abs().max()) if count else 0.0
            results.append({"table": name, "ids": count, "match": ok, "max_abs_err": err})
            check(ok, f"gather_rows {name} ids={count}")
    return results


def tiered_checks(stores, rng):
    """K2's tiered entry against tiered_gather_plain on feature stores
    (hot-only, hot + pinned cold with the degree reorder, cold-only; f32
    and bf16), for ragged id counts with -1 lanes."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import tiered_gather, tiered_gather_plain

    results = []
    for name, feat in stores:
        n = feat.shape[0]
        for count in (100_003, 384, 7):
            ids = rng.integers(0, n, count).astype("int32")
            ids[rng.random(count) < 0.1] = -1
            args = (torch.from_numpy(ids).to("cuda"), feat.feature_order,
                    feat.hot_rows, feat.hot, feat.cold)
            want = tiered_gather_plain(*args)
            got = tiered_gather(*args)
            sync()
            ok = equal(got, want)
            err = float((got.float() - want.float()).abs().max()) if count else 0.0
            results.append({"store": name, "ids": count, "hot_rows": feat.hot_rows,
                            "match": ok, "max_abs_err": err})
            check(ok, f"tiered_gather {name} ids={count}")
    return results


def wselect_cases(dev_topo, uva_topo, seeds, k, g, label):
    """K3 against wselect_plain (on the device tables) for one seed set:
    scale_u on (raw u01) and off (u pre-scaled by the row totals), without
    and with the eid lane, device and UVA tables."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import wselect, wselect_plain
    from quiver_tpu_torch.ops.sample import seed_degrees

    S = seeds.shape[0]
    _valid, base, deg = seed_degrees(dev_topo.indptr, seeds, S)
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
            results.append({"graph": label, "rows": S, "k": k, "case": name,
                            "scale_u": scale_u, "match": ok,
                            "max_abs_err": max_err(got, want), **classes})
            check(ok, f"wselect {label} {name} rows={S} k={k} scale_u={scale_u}")
    return results


def small_graphs():
    """K3's edge cases as placed ``(label, CSRTopo, device, UVA)`` triples:
    a small CSR with empty rows and zero-total-weight rows (which carry the
    uniform prefix), and one whose rows take every degree of 0-40, 60-69,
    250-262, 500, 1000 and 3232 (the products graph's largest)."""
    import numpy as np

    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    coo = generate_pareto_graph(20_000, 20.0, seed=3)
    coo = coo[:, coo[0] % 50 != 7]  # empty rows
    w = np.exp(np.random.default_rng(4).normal(size=coo.shape[1])).astype(np.float32)
    w[coo[0] % 10 == 3] = 0.0  # zero-total rows
    rng = np.random.default_rng(7)
    degs = np.array(list(range(41)) + list(range(60, 70)) + list(range(250, 263))
                    + [500, 1000, 3232])
    deg_coo = np.stack([np.repeat(np.arange(len(degs)), degs),
                        rng.integers(0, len(degs), degs.sum())])
    deg_w = np.exp(rng.normal(size=deg_coo.shape[1])).astype(np.float32)
    deg_w[deg_coo[0] % 5 == 3] = 0.0
    out = []
    for label, c, wt in (("small, zero-weight rows", coo, w),
                         ("every degree to 3232", deg_coo, deg_w)):
        topo = CSRTopo(edge_index=c, edge_weight=wt)
        out.append((label, topo, *(topo.to_device(mode, "cuda", with_eid=True,
                                                  with_weights=True)
                                   for mode in ("GPU", "UVA"))))
    return out


def wselect_checks(topo_np, dev_topo, uva_topo, smalls, rng):
    """K3's search-and-select entry on the weighted products CSR (rows
    100,003 / 64 / 8 at k 5 and 15, each seed set holding the max-degree
    row, a row of degree <= k and an invalid seed of degree 0), then on
    every row of each of ``smalls`` at k 5 and 15."""
    import numpy as np
    import torch

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
    for label, topo, s_dev, s_uva in smalls:
        seeds = torch.arange(topo.node_count, dtype=torch.int32, device=dev)
        for k in (5, 15):
            results += wselect_cases(s_dev, s_uva, seeds, k, g, label)
    return results


def whop_checks(topo_np, dev_topo, uva_topo, smalls, rng):
    """K3's fused weighted hop against weighted_hop_plain: on the products
    CSR, 100,003 flat rows with a scalar count (3 invalid) and 8 x 8 lanes
    with per-lane counts at k 5 and 15 (the max-degree row, a row of
    degree <= k and a -1 in every lane); on every row of each of
    ``smalls`` at k 5 and 15 (every ninth seed -1, the last 3 invalid);
    without an eid lane, with the eid table's, with CSR slots in int32 and
    int64 indptr; device and UVA tables."""
    import numpy as np
    import torch

    from quiver_tpu_torch.ops.kernels.fused import weighted_hop, weighted_hop_plain

    dev = dev_topo.device
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    sets = []
    for shape, k in (((100_003,), 5), ((8, 8), 5), ((8, 8), 15)):
        seeds = hop_seeds(topo_np, shape, k, rng, dev)
        if len(shape) == 1:
            num = shape[0] - 3
        else:
            num = torch.from_numpy(rng.integers(
                0, shape[1] + 1, shape[0]).astype("int32")).to(dev)
            num[0] = shape[1]
        sets.append(("products", dev_topo, uva_topo, seeds, num, k))
    for label, topo, s_dev, s_uva in smalls:
        seeds = torch.arange(topo.node_count, dtype=torch.int32, device=dev)
        seeds[5::9] = -1
        sets += [(label, s_dev, s_uva, seeds, topo.node_count - 3, k) for k in (5, 15)]
    results = []
    for label, d_topo, u_topo, seeds, num, k in sets:
        u01 = torch.rand(tuple(seeds.shape) + (k,), generator=g, device=dev)
        ip64 = d_topo.indptr.to(torch.int64)
        iters = d_topo.search_iters
        for name, t, indptr, eid, with_eid in (
                ("device", d_topo, d_topo.indptr, None, False),
                ("device+eid", d_topo, d_topo.indptr, d_topo.eid, True),
                ("device, CSR slots", d_topo, d_topo.indptr, None, True),
                ("device, int64 indptr, CSR slots", d_topo, ip64, None, True),
                ("uva+eid", u_topo, u_topo.indptr, u_topo.eid, True)):
            got = weighted_hop(indptr, t.indices, t.cum_weights, seeds, num, u01,
                               iters, eid=eid, with_eid=with_eid)
            want = weighted_hop_plain(indptr, d_topo.indices, d_topo.cum_weights,
                                      seeds, num, u01, iters,
                                      eid=None if eid is None else d_topo.eid,
                                      with_eid=with_eid)
            sync()
            ok = len(got) == len(want) and all(equal(a, b) for a, b in zip(got, want))
            results.append({"graph": label, "shape": list(seeds.shape), "k": k,
                            "case": name, "match": ok, "max_abs_err": max_err(got, want)})
            check(ok, f"weighted_hop {label} {name} shape={tuple(seeds.shape)} k={k}")
    return results


# -- phase 3: timing ------------------------------------------------------------


def distinct_sectors(pos, elem_bytes: int) -> int:
    """32 B sectors touched by loads at element positions ``pos`` of an
    array of ``elem_bytes`` elements (allocations are sector-aligned)."""
    import torch

    return int(torch.unique(pos.reshape(-1) // (SECTOR // elem_bytes)).numel())


def indptr_sectors(indptr, seeds, valid) -> int:
    """Sectors of ``indptr`` a fused hop loads: two entries per valid seed,
    ``indptr[0]`` for invalid ones."""
    import torch

    s = seeds.to(torch.int64)[valid]
    pos = torch.cat([s, s + 1] + ([torch.zeros(1, dtype=torch.int64, device=s.device)]
                                  if bool((~valid).any()) else []))
    return distinct_sectors(pos, indptr.element_size())


def h2d_rate() -> float:
    """Bytes/s of one 256 MiB pinned-host -> device copy."""
    import torch

    src = torch.empty(64 << 20, dtype=torch.float32).pin_memory()
    dst = torch.empty_like(src, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), iters=10, reps=5)
    return src.numel() * 4 / (ms * 1e-3)


def time_select(dev_topo, seeds, k, g):
    """K1's select entry at one hop's shapes, in turns with the stock
    ``index_select`` of the drawn slots, beside its plain version and its
    SELECT_BOUND_RULE bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import select, select_plain
    from quiver_tpu_torch.ops.sample import seed_degrees, uniform_offsets

    S = seeds.shape[0]
    valid, base, deg = seed_degrees(dev_topo.indptr, seeds, S)
    offs = uniform_offsets(deg, k, g).contiguous()
    count = torch.where(valid, deg.clamp(max=k), 0)
    start = base.to(torch.int64)
    tabs = (dev_topo.indices,)
    lane = torch.arange(k, device=seeds.device)[None, :] < count[:, None]
    pos = torch.where(lane, start[:, None] + offs.to(torch.int64), 0).reshape(-1)
    t = in_turns(lambda: select(tabs, start, offs, count),
                 lambda: torch.index_select(dev_topo.indices, 0, pos))
    plain_ms = cuda_ms(lambda: select_plain(tabs, start, offs, count))
    sectors = distinct_sectors(pos[lane.reshape(-1)], 4)
    nbytes = S * 12 + S * k * 8 + SECTOR * sectors
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "stock_ms": t["yard_ms"], "stock_turns": t["yard_turns"],
            "ratio_to_stock": t["ratio"], "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / t["ms"],
            "index_sectors": sectors, "rows": S, "k": k}


def time_hop(topo_np, dev_topo, shape, k, g, rng, iters: int = 200, reps: int = 7):
    """K1's fused hop at ``shape`` rows (per-lane counts when it has lanes),
    in turns with the composed path on the same bits (``sample_layer`` with
    the offsets computed from them: seed_degrees, stratified_offsets,
    rotate_offsets, then the select entry), beside its plain version and
    its HOP_BOUND_RULE bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, uniform_hop_plain
    from quiver_tpu_torch.ops.sample import (draw_bits, rotate_offsets, sample_layer,
                                             seed_degrees, stratified_offsets)

    dev = dev_topo.device
    seeds = hop_seeds(topo_np, shape, k, rng, dev)
    num = (shape[0] - 3 if len(shape) == 1 else
           torch.full(shape[:-1], shape[-1], dtype=torch.int32, device=dev))
    jitter, rot = draw_bits(shape, k, g)
    indptr, indices = dev_topo.indptr, dev_topo.indices

    def offs(deg):
        off, _ = stratified_offsets(deg, k, jitter)
        return rotate_offsets(off, deg, k, rot)

    fused = uniform_hop(indptr, indices, seeds, num, jitter, rot)
    composed = sample_layer(dev_topo, seeds, num, k, offs=offs)
    sync()
    check(all(equal(a, b) for a, b in zip(fused, composed)),
          f"uniform_hop == composed path at {shape} x {k}")
    t = in_turns(lambda: uniform_hop(indptr, indices, seeds, num, jitter, rot),
                 lambda: sample_layer(dev_topo, seeds, num, k, offs=offs),
                 iters, reps)
    plain_ms = cuda_ms(lambda: uniform_hop_plain(indptr, indices, seeds, num,
                                                 jitter, rot), iters, reps)
    valid, base, deg = seed_degrees(indptr, seeds, num)
    lane = torch.arange(k, device=dev) < deg.clamp(max=k)[..., None]
    pos = (base.to(torch.int64)[..., None] + offs(deg).to(torch.int64))[lane]
    ip_sectors = indptr_sectors(indptr, seeds, valid)
    ix_sectors = distinct_sectors(pos, 4)
    # the draw bits are read only for rows of degree > k, all k lanes each
    drawn = torch.nonzero((deg > k).reshape(-1)).reshape(-1)
    rot_sectors = distinct_sectors(drawn, 8)
    jit_sectors = distinct_sectors(drawn[:, None] * k + torch.arange(k, device=dev), 8)
    rows = seeds.numel()
    lead = rows // shape[-1] if len(shape) > 1 else 0
    nbytes = (rows * 8 + lead * 4 + rows * k * 4
              + SECTOR * (ip_sectors + ix_sectors + rot_sectors + jit_sectors))
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "composed_ms": t["yard_ms"], "composed_turns": t["yard_turns"],
            "speedup_over_composed": 1 / t["ratio"], "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / t["ms"],
            "indptr_sectors": ip_sectors, "index_sectors": ix_sectors,
            "rot_sectors": rot_sectors, "jitter_sectors": jit_sectors,
            "drawn_rows": int(drawn.numel()), "shape": list(shape), "k": k}


def time_gather(table, ids):
    """K2's single-table entry at one lookup's shapes (in-range ids), in
    turns with ``torch.index_select``, which computes the same function
    here, beside its plain version and its byte bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    ids64 = ids.to(torch.int64)
    t = in_turns(lambda: gather_rows(table, ids),
                 lambda: torch.index_select(table, 0, ids64))
    plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids))
    B = ids.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    nbytes = B * 4 + 2 * B * row_bytes
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "library_ms": t["yard_ms"], "library_turns": t["yard_turns"],
            "ratio_to_library": t["ratio"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / t["ms"], "ids": B,
            "row_bytes": row_bytes}


def two_launch_lookup(n_id, order, hot_rows, hot, cold):
    """The tiered lookup as two K2 single-table launches around id ops (the
    port's lookup before the tiered entry): the yardstick of a split store."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    valid = n_id >= 0
    ids = torch.where(valid, n_id, 0).to(torch.int64)
    if order is not None:
        ids = order[ids].to(torch.int64)
    ids = torch.where(valid, ids, -1)
    out = gather_rows(hot, torch.where(ids < hot_rows, ids, -1).to(torch.int32))
    cold_ids = torch.where(ids >= hot_rows, ids - hot_rows, -1)
    return gather_rows(cold, cold_ids.to(torch.int32), out=out)


def time_tiered(feat, ids, pcie_bytes_per_s, iters: int = 200):
    """K2's tiered entry on a store at one lookup's shapes: in turns with
    ``index_select`` on a hot-only store without reorder (the same function
    for in-range ids), else with the two-launch lookup; beside its plain
    version and its GATHER_BOUND_RULE bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import tiered_gather, tiered_gather_plain

    args = (ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold)
    if feat.cold is None and feat.feature_order is None:
        ids64 = ids.to(torch.int64)
        yard, yard_name = (lambda: torch.index_select(feat.hot, 0, ids64)), "index_select"
    else:
        yard, yard_name = (lambda: two_launch_lookup(*args)), "two K2 launches"
        check(equal(tiered_gather(*args), two_launch_lookup(*args)),
              "tiered_gather == two-launch lookup")
    t = in_turns(lambda: tiered_gather(*args), yard, iters)
    plain_ms = cuda_ms(lambda: tiered_gather_plain(*args), max(iters // 20, 5), 3)
    valid = ids >= 0
    rows = ids[valid].to(torch.int64)
    if feat.feature_order is not None:
        rows = feat.feature_order[rows].to(torch.int64)
    n_cold = int((rows >= feat.hot_rows).sum())
    n_valid = int(valid.sum())
    B = ids.shape[0]
    row_bytes = feat.shape[1] * (feat.hot if feat.hot is not None else feat.cold).element_size()
    dev_bytes = (B * 4 + (n_valid * 4 if feat.feature_order is not None else 0)
                 + (n_valid - n_cold) * row_bytes + B * row_bytes)
    cold_bytes = n_cold * row_bytes
    bound_s = max(dev_bytes / HBM_BYTES_PER_S, cold_bytes / pcie_bytes_per_s)
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "yardstick": yard_name, "yard_ms": t["yard_ms"],
            "yard_turns": t["yard_turns"], "ratio_to_yard": t["ratio"],
            "library_ms": t["yard_ms"] if yard_name == "index_select" else None,
            "bound_ms": bound_s * 1e3, "bound_share": bound_s * 1e3 / t["ms"],
            "device_bytes": dev_bytes,
            "cold_bytes": cold_bytes, "cold_rows": n_cold, "ids": B,
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
            "cw_sectors": distinct_sectors(probes, 4),
            "index_loads": int(loads.numel()),
            "index_sectors": distinct_sectors(loads, 4)}


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
    _valid, base, deg = seed_degrees(dev_topo.indptr, seeds, S)
    start = base.to(torch.int64)
    u = torch.rand((S, k), generator=g, device=seeds.device)
    iters = dev_topo.search_iters
    args = (dev_topo.indices, dev_topo.cum_weights, start, deg, u, iters)
    ms = cuda_ms(lambda: wselect(*args), iters=iters_timed)
    plain_ms = cuda_ms(lambda: wselect_plain(*args), iters=iters_timed)
    sec = wselect_sectors(dev_topo, start, deg, u, k)
    dense = S * 12 + S * k * 12
    nbytes = dense + SECTOR * (sec["cw_sectors"] + sec["index_sectors"])
    probe_bytes = dense + SECTOR * (sec["cw_probes"] + sec["index_loads"])
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms,
            "probe_bound_ms": probe_bytes / HBM_BYTES_PER_S * 1e3,
            "rows": S, "k": k, "iters": iters, **sec}


def time_whop(topo_np, dev_topo, shape, k, g, rng, iters: int = 200, reps: int = 7):
    """K3's fused weighted hop at ``shape`` rows (per-lane counts when it
    has lanes), in turns with the composed path on the same ``u01``
    (``sample_layer`` with a ``u`` callable of the degrees: seed_degrees,
    then the search-and-select entry), beside its plain version and its
    WHOP_BOUND_RULE bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import weighted_hop, weighted_hop_plain
    from quiver_tpu_torch.ops.sample import sample_layer, seed_degrees

    dev = dev_topo.device
    seeds = hop_seeds(topo_np, shape, k, rng, dev)
    num = (shape[0] - 3 if len(shape) == 1 else
           torch.full(shape[:-1], shape[-1], dtype=torch.int32, device=dev))
    u01 = torch.rand(tuple(shape) + (k,), generator=g, device=dev)
    args = (dev_topo.indptr, dev_topo.indices, dev_topo.cum_weights, seeds, num,
            u01, dev_topo.search_iters)

    def composed():
        return sample_layer(dev_topo, seeds, num, k, weighted=True, u=lambda deg: u01)

    sync()
    check(all(equal(a, b) for a, b in zip(weighted_hop(*args), composed())),
          f"weighted_hop == composed path at {shape} x {k}")
    t = in_turns(lambda: weighted_hop(*args), composed, iters, reps)
    plain_ms = cuda_ms(lambda: weighted_hop_plain(*args), iters, reps)
    valid, base, deg = seed_degrees(dev_topo.indptr, seeds, num)
    start, d = base.to(torch.int64).reshape(-1), deg.reshape(-1)
    sec = wselect_sectors(dev_topo, start, d, u01.reshape(-1, k), k)
    ip_sectors = indptr_sectors(dev_topo.indptr, seeds, valid)
    drawn = torch.nonzero(d > k).reshape(-1)  # rows whose lanes read u
    u_sectors = distinct_sectors(drawn[:, None] * k + torch.arange(k, device=dev), 4)
    rows = seeds.numel()
    lead = rows // shape[-1] if len(shape) > 1 else 0
    nbytes = (rows * 8 + lead * 4 + rows * k * 4 + SECTOR * (
        ip_sectors + u_sectors + sec["cw_sectors"] + sec["index_sectors"]))
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "composed_ms": t["yard_ms"], "composed_turns": t["yard_turns"],
            "speedup_over_composed": 1 / t["ratio"], "library_ms": None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
            "bound_share": nbytes / HBM_BYTES_PER_S * 1e3 / t["ms"],
            "indptr_sectors": ip_sectors, "u_sectors": u_sectors,
            "cw_sectors": sec["cw_sectors"], "index_sectors": sec["index_sectors"],
            "drawn_rows": int(drawn.numel()), "shape": list(shape), "k": k}


# -- phases 4 and 5: serve ----------------------------------------------------


def closed_loop(server, nodes, top):
    done = []
    for i in range(0, len(nodes), top):
        for n in nodes[i:i + top]:
            server.submit(int(n))
        while server.batcher.depth:
            done += server.pump(force=True)
    return done


def ladder_parity(server, picks, hop: str, composed: str):
    """Ladder lanes against the single-query oracle at every bucket, full
    and with a padded tail: ids, edges and log-probs bitwise. Counts the
    launches: per group one ``hop`` launch per layer and one lookup, per
    lane the oracle's two samples (``composed`` on each layer) and one
    lookup."""
    import numpy as np
    import torch

    lad = server.ladder
    capL = lad.lane_caps[-1]
    lanes = groups_run = 0
    sync()
    reset_launches()
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
            groups_run += 1
    sync()
    layers = len(lad.sizes)
    launches = read_launches()
    expect_launches(launches, {hop: layers * groups_run,
                               composed: 2 * layers * lanes,
                               "tiered_gather": groups_run + lanes},
                    "ladder parity")
    return {"ids_edges": "bitwise", "logp": "bitwise", "lanes": lanes,
            "groups": groups_run, "launches": launches}


def serve_phase(args, topo, feat_hot, variants, card, weighted):
    """Serve ``args.requests`` closed-loop queries over the [5, 5] sampler
    (weighted or uniform), with every kernel launch counted, and check the
    answers and the launches (per batch: one hop launch per layer, K1's or
    K3's fused hop, and one K2 tiered lookup; nothing else); then serve
    the same stream again through each of ``variants`` (``(label, sampler
    kwargs or None to reuse the sampler, store)``), which must answer
    bitwise the same with the same launches."""
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
    hop = "weighted_hop" if weighted else "uniform_hop"
    expect_launches(launches, {hop: 2 * batches, "tiered_gather": batches},
                    "serve")

    picks = [(r.node, r.seq) for r in
             (reqs[i] for i in rng.choice(len(reqs), 16, replace=False))]
    parity = ladder_parity(server, picks, hop, "wselect" if weighted else "select")

    reruns = {}
    for label, kwargs, store in variants:
        smp = sampler if kwargs is None else GraphSageSampler(
            topo, [5, 5], device="cuda", seed=0, weighted=weighted, **kwargs)
        other = InferenceServer(smp, model, store, device="cuda", max_batch=8,
                                seed=0)
        reset_launches()
        got = closed_loop(other, nodes, 8)
        runs = len(other.timeline.samples["sample"])
        reruns[label] = {"queries": len(got), "batches": runs, **read_launches()}
        expect_launches(read_launches(), {hop: 2 * runs, "tiered_gather": runs},
                        f"{label} rerun")
        check(len(got) == len(reqs) and all(
            np.array_equal(a.result, b.result) for a, b in zip(got, reqs)),
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


def sampler_phase(topo, card, weighted: bool, batches: int = 5):
    """``bench_sampler``'s configuration, uniform (K1's fused hop) or
    weighted (K3's): [15, 10, 5], batch 2048, worst-case caps, seed 0. Times
    ``batches`` calls after one warm-up and checks the last one against
    the CSR."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler

    sizes, batch = (15, 10, 5), 2048
    smp = GraphSageSampler(topo, list(sizes), device="cuda", seed=0,
                           seed_capacity=batch, weighted=weighted)
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
    hop = "weighted_hop" if weighted else "uniform_hop"
    expect_launches(launches, {hop: len(sizes) * batches},
                    f"{'weighted' if weighted else 'uniform'} sampler")

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
    return {"sampler": "weighted" if weighted else "uniform",
            "sizes": list(sizes), "batch": batch, "batches": batches,
            "edges": total, "seconds": dt, "edges_per_s": total / dt,
            "batch_ms": 1e3 * dt / batches, "launches": launches,
            "edges_checked": checked, "card": card}


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
    expect_launches(launches, {"select": len(sizes) * batches},
                    "temporal sampler (K1's select entry on every hop)")

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


# -- phases 8 and 9: train ---------------------------------------------------


def step_grads(model, x, adjs, labels, mask):
    """One ``make_train_step`` call at SGD lr 0 (the parameters stay, the
    gradients stay in ``.grad``): (loss, gradients on the host)."""
    import torch

    from quiver_tpu_torch.parallel.train import make_train_step

    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
    loss = float(step(x, adjs, labels, mask))
    return loss, [p.grad.detach().cpu() for p in model.parameters()]


def train_parity(run, seeds):
    """The card's train step against the CPU's plain run on one full-width
    batch: the same ``init_model`` parameters (dropout 0), the same x,
    Adjs, labels and mask; TF32 is off for the whole smoke. The loss within
    1e-5 relative, each gradient within 1e-4 x its max |g|."""
    import copy

    from examples.train_sage_torch import batch_inputs
    from quiver_tpu_torch import GraphSAGE
    from quiver_tpu_torch.parallel.train import init_model

    import torch

    out, x, labels, mask = batch_inputs(run, seeds)
    model = GraphSAGE(x.shape[1], 256, run.ds.num_classes, num_layers=2,
                      dropout=0.0)
    init_model(model, torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model)
    t0 = time.time()
    loss_g, grads_g = step_grads(model.to("cuda"), x, out.adjs, labels, mask)
    loss_c, grads_c = step_grads(cpu_model, x.cpu(), [a.to("cpu") for a in out.adjs],
                                 labels.cpu(), mask.cpu())
    rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = [float((g - c).abs().max()) / float(c.abs().max())
                for g, c in zip(grads_g, grads_c)]
    check(rel <= 1e-5, f"train parity: loss {loss_g} (card) vs {loss_c} (CPU)")
    check(max(grad_err) <= 1e-4,
          f"train parity: gradient errors / max |g| {grad_err}")
    return {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": rel,
            "grad_err_over_max": grad_err, "rows": int(x.shape[0]),
            "seconds": time.time() - t0,
            "tolerance": "loss 1e-5 relative; each gradient 1e-4 x max |g|"}


def profile_steps(step, batches, first, median_step_ms):
    """``PROFILED_STEPS`` more steps under ``torch.profiler``: the device
    time of every kernel and copy per step, the span on the card of each
    stage's annotation, and the device's idle share against the median
    step time of the unprofiled run (the profiler's own host cost would
    inflate the profiled steps' wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + PROFILED_STEPS):
            step(i, batches[i])
    spans, kernels = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        ms = e.self_device_time_total / 1e3 / PROFILED_STEPS
        (spans if e.key.startswith("train:") else kernels)[e.key] = ms
    busy = sum(kernels.values())
    check(busy > 0 and len(spans) == 3, f"the profiler saw the card: spans {spans}")
    ours = {name: sum(ms for key, ms in kernels.items() if name in key)
            for name in ("uniform_hop_kernel", "gather_kernel")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    log(f"train profile: device busy {busy:.3f} ms per step of {median_step_ms:.3f}; "
        f"stage spans {spans}")
    return {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy,
            "median_step_ms": median_step_ms,
            "idle_share": 1 - busy / median_step_ms,
            "stage_span_ms_per_step": spans, "port_kernels_ms_per_step": ours,
            "top_kernels_ms_per_step": {k[:100]: v for k, v in top}}


def train_phase(card, pcie_bytes_per_s, steps: int = 20):
    """The twin's default configuration (``examples/train_sage_torch.py``):
    the Reddit-scale synthetic graph, F=602 f32, 41 classes, GraphSAGE 256
    x 2, fanouts [25, 10], batch 1024, a 20% degree-ordered cache on the
    card and the rest pinned on the host, auto caps, Adam at 0.01. One
    warm-up step, then ``steps`` timed steps, each stage ending in a
    synchronise; exact launches; then card-vs-CPU step parity. K2's
    lookup is held to GATHER_BOUND_RULE with the pinned-host rate
    ``pcie_bytes_per_s`` measured in phase 3."""
    import math

    import numpy as np
    import torch

    from torch.profiler import record_function

    from examples.train_sage_torch import parse_args, setup
    from quiver_tpu_torch.ops.sample import seeded_generator

    args = parse_args(["--device", "cuda"])
    t0 = time.time()
    reset_launches()
    run = setup(args)  # its first sample plans the auto caps
    sync()
    setup_s = time.time() - t0
    plan_launches, plan_reruns = read_launches(), run.sampler.reruns
    expect_launches(plan_launches, {"uniform_hop": 2 * (1 + plan_reruns)},
                    "train: the planning call")
    worst = run.sampler._worst_caps(args.batch)
    caps = run.sampler._frontier_caps
    log(f"train set-up {setup_s:.1f}s; auto caps {caps} (worst case {worst}), "
        f"{plan_reruns} reruns")

    # the batches of two epochs of the twin's shuffles: warm-up, timed,
    # profiled and parity steps
    train_idx = np.asarray(run.ds.train_idx)
    order = np.concatenate([np.random.default_rng(e).permutation(train_idx)
                            for e in (1, 2)])
    batches = [order[i * args.batch:(i + 1) * args.batch]
               for i in range(len(order) // args.batch)]
    check(len(batches) >= steps + PROFILED_STEPS + 2, "enough training batches")

    def step(i, seeds):
        a = time.perf_counter()
        with record_function("train:sample"):
            out = run.sampler.sample(seeds)
            sync()
        b = time.perf_counter()
        with record_function("train:gather"):
            x = run.feature[out.n_id]
            seed_ids = out.n_id[:args.batch]
            labels = run.labels_all[seed_ids.clamp(min=0)]
            mask = seed_ids >= 0
            sync()
        c = time.perf_counter()
        with record_function("train:step"):
            loss = run.train_step(x, out.adjs, labels, mask,
                                  seeded_generator(run.device, args.seed, i))
            sync()
        d = time.perf_counter()
        return out, loss, (b - a, c - b, d - c)

    step(0, batches[0])  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    reruns0 = run.sampler.reruns
    reset_launches()
    rows, kept = [], []
    t_all = time.perf_counter()
    for i in range(1, steps + 1):
        out, loss, (ts, tg, tt) = step(i, batches[i])
        rows.append({"sample_ms": ts * 1e3, "gather_ms": tg * 1e3,
                     "train_step_ms": tt * 1e3})
        kept.append((out.n_id, out.edge_counts, loss))
    wall = time.perf_counter() - t_all
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    reruns = run.sampler.reruns - reruns0
    # per step: its loss, sampled edges, valid and cold rows, and the
    # GATHER_BOUND_RULE bound of its lookup
    losses, edges, cold, k2_bound = [], 0, [], []
    row_bytes = run.feature.shape[1] * run.feature.hot.element_size()
    for n_id, edge_counts, loss in kept:
        losses.append(float(loss))
        edges += int(torch.stack(list(edge_counts)).sum())
        valid = n_id[n_id >= 0].to(torch.int64)
        nv = int(valid.shape[0])
        nc = int((run.feature.feature_order[valid] >= run.feature.hot_rows).sum())
        cold.append((nv, nc))
        dev_bytes = (n_id.shape[0] * 4 + nv * 4 + (nv - nc) * row_bytes
                     + n_id.shape[0] * row_bytes)
        k2_bound.append(1e3 * max(dev_bytes / HBM_BYTES_PER_S,
                                  nc * row_bytes / pcie_bytes_per_s))
    del kept
    for i, r in enumerate(rows, 1):
        log(f"train step {i:02d}: sample {r['sample_ms']:.3f} ms, gather "
            f"{r['gather_ms']:.3f} ms, train step {r['train_step_ms']:.3f} ms, "
            f"loss {losses[i - 1]:.4f}")
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    expect_launches(launches, {"uniform_hop": 2 * (steps + reruns),
                               "tiered_gather": steps},
                    f"train: {steps} steps ({reruns} reruns)")
    step_s = sum(sum(r.values()) for r in rows) / 1e3
    stage = {k: statistics.median(r[k] for r in rows)
             for k in ("sample_ms", "gather_ms", "train_step_ms")}
    prof = profile_steps(step, batches, steps + 1,
                         statistics.median(sum(r.values()) for r in rows))
    parity = train_parity(run, batches[steps + 1 + PROFILED_STEPS])
    log(f"train: {steps / wall:.4g} steps/s, {edges / wall:.4g} sampled "
        f"edges/s, peak {peak / 2**30:.3f} GiB; medians {stage}; parity "
        f"loss rel {parity['loss_rel_err']:.3g}")
    return launches, {
        "config": "examples/train_sage_torch.py defaults: synthetic "
                  "generate_pareto_graph(232965, 100, seed=0), F=602 f32, 41 "
                  "classes, hidden 256, 2 layers, fanouts [25, 10], batch 1024, "
                  "cache 20%, auto caps, Adam 0.01",
        "nodes": run.topo.node_count, "edges": run.topo.edge_count,
        "hot_rows": run.feature.hot_rows, "setup_s": setup_s,
        "caps": list(caps), "worst_caps": list(worst),
        "planning_reruns": plan_reruns, "planning_launches": plan_launches,
        "steps": steps, "reruns": reruns, "launches": launches,
        "wall_s": wall, "steps_per_s": steps / wall,
        "step_stage_sum_s": step_s, "sampled_edges": edges,
        "edges_per_s": edges / wall, "peak_bytes": peak,
        "median_ms": stage, "per_step": rows, "losses": losses,
        "valid_rows_and_cold_rows": cold, "profile": prof,
        "tiered_gather_bound_ms": statistics.median(k2_bound),
        "tiered_gather_bound_share": statistics.median(k2_bound)
        / prof["port_kernels_ms_per_step"]["gather_kernel"],
        "pcie_h2d_bytes_per_s": pcie_bytes_per_s,
        "cold_row_share": sum(c for _, c in cold) / sum(v for v, _ in cold),
        "parity": parity, "card": card}


def acceptance_phase(card):
    """The twin's acceptance run on the card: ``--dataset planted:20000
    --epochs 4`` with its other defaults, sampled evaluation and then
    layer-wise; each test accuracy must clear feature-only Bayes + 0.15."""
    from examples.train_sage_torch import main

    runs = {}
    for mode in ("sampled", "layerwise"):
        t0 = time.time()
        acc, ds = main(["--dataset", "planted:20000", "--epochs", "4",
                        "--device", "cuda", "--eval", mode])
        sync()
        bayes = ds.meta["feature_bayes_acc"]
        check(acc >= bayes + 0.15,
              f"planted:20000 {mode}: test acc {acc} < feature-only Bayes "
              f"{bayes} + 0.15")
        runs[mode] = {"test_acc": acc, "feature_bayes_acc": bayes,
                      "seconds": time.time() - t0}
    return {"dataset": "planted:20000", "epochs": 4, **runs, "card": card}


def kernel_row(name, source, replaces, launches, path, checks, t, extra, card,
               device):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "path": path,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_share": t["bound_share"], "bound_by": "bytes",
            "library_ms": t.get("library_ms"),
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

    # the serving configuration's feature stores: every row on the card,
    # and a quarter of them on the card with the rest pinned on the host
    n, F = x_all.shape
    t0 = time.time()
    feat_hot = Feature(device_cache_size=n * F * 4,
                       device="cuda").from_cpu_tensor(x_all)
    feat_cold = Feature(device_cache_size=(n // 4) * F * 4, csr_topo=topo,
                        device="cuda").from_cpu_tensor(x_all)
    log(f"feature stores built in {time.time() - t0:.1f}s: hot-only "
        f"{feat_hot.hot_rows} rows; tiered {feat_cold.hot_rows} hot / "
        f"{n - feat_cold.hot_rows} cold (pinned host)")

    # phase 3: kernel checks
    dev_topo = topo.to_device("GPU", "cuda", with_eid=True, with_weights=True)
    uva_topo = topo.to_device("UVA", "cuda", with_eid=True, with_weights=True)
    sel = select_checks(topo, dev_topo, uva_topo, rng)
    hop = hop_checks(topo, dev_topo, uva_topo, rng)
    smalls = small_graphs()
    wsel = wselect_checks(topo, dev_topo, uva_topo, smalls, rng)
    whop = whop_checks(topo, dev_topo, uva_topo, smalls, rng)
    del smalls
    x_dev = feat_hot.hot  # every row, in node order, on the card
    codes = torch.randint(-127, 128, x_dev.shape, dtype=torch.int8,
                          device="cuda")
    pin_rows = 500_000
    # wide f32 rows (1 KB: two rows per warp; 2.4 KB: one row per warp in
    # two chunks), checked here and timed in bulk
    wide = [(f"f32 {F * 4} B device", torch.randn(WIDE_ROWS, F, device="cuda"))
            for F in (256, 600)]
    tables = wide + [
        ("f32 device", x_dev), ("bf16 device", x_dev.to(torch.bfloat16)),
        ("int8 device", codes),
        ("f32 pinned", pinned(torch.from_numpy(x_all[:pin_rows]))),
        ("bf16 pinned", pinned(x_dev[:pin_rows].to(torch.bfloat16).cpu())),
        ("int8 pinned", pinned(codes[:pin_rows].cpu())),
    ]
    gat = gather_checks(tables, rng)
    del tables, codes
    small_topo = CSRTopo(edge_index=generate_pareto_graph(20_000, 10.0, seed=6))
    x_small = rng.standard_normal((20_000, F), dtype=np.float32)
    stores = [("f32 hot-only", feat_hot), ("f32 tiered, reorder", feat_cold)] + [
        (f"bf16 {label}", Feature(device_cache_size=budget, csr_topo=t,
                                  dtype="bfloat16", device="cuda").from_cpu_tensor(x_small))
        for label, budget, t in (("hot-only", 20_000 * F * 2, None),
                                 ("tiered, reorder", 5_000 * F * 2, small_topo),
                                 ("cold-only", 0, None))]
    tier = tiered_checks(stores, rng)
    del stores
    # timing at the serving path's shapes: its largest hop (8 lanes x 8
    # frontier rows, fanout 5; the select entries' 64 x 5) and its lookup
    # (8 lanes x 48 rows, F=100); then in bulk
    pcie = h2d_rate()
    log(f"pinned host -> device copy: {pcie / 1e9:.4g} GB/s")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    sel_seeds = torch.from_numpy(
        rng.integers(0, n, 64).astype(np.int32)).to("cuda")
    t_sel = time_select(dev_topo, sel_seeds, 5, g)
    t_hop = time_hop(topo, dev_topo, (8, 8), 5, g, rng)
    t_wsel = time_wselect(dev_topo, sel_seeds, 5, g)
    t_whop = time_whop(topo, dev_topo, (8, 8), 5, g, rng)
    look_ids = torch.from_numpy(
        rng.integers(0, n, 384).astype(np.int32)).to("cuda")
    t_gat = time_gather(x_dev, look_ids)
    t_tier = time_tiered(feat_hot, look_ids, pcie)
    t_tier_split = time_tiered(feat_cold, look_ids, pcie)
    bulk_seeds = torch.from_numpy(rng.integers(0, n, 1_000_000).astype(np.int32)).to("cuda")
    bulk_ids = torch.from_numpy(rng.integers(0, n, 100_000).astype(np.int32)).to("cuda")
    wide_ids = torch.from_numpy(rng.integers(0, WIDE_ROWS, 100_000).astype(np.int32)).to("cuda")
    bulk = {
        "select": time_select(dev_topo, bulk_seeds, 5, g),
        "uniform_hop": time_hop(topo, dev_topo, (1_000_000,), 5, g, rng, 20, 5),
        "gather_rows": time_gather(x_dev, bulk_ids),
        "tiered_gather": time_tiered(feat_hot, bulk_ids, pcie),
        "tiered_gather, tiered store": time_tiered(feat_cold, bulk_ids, pcie, 20),
        **{f"gather_rows, {tab.shape[1] * 4} B rows": time_gather(tab, wide_ids)
           for _name, tab in wide},
        "wselect": time_wselect(dev_topo, bulk_seeds, 5, g, iters_timed=50),
        "weighted_hop": time_whop(topo, dev_topo, (1_000_000,), 5, g, rng, 20, 5),
        "pcie_h2d_bytes_per_s": pcie,
    }
    del x_dev, dev_topo, uva_topo, bulk_seeds, bulk_ids, wide, wide_ids

    # phases 4 and 5: serve (the main paths; launch counts are read there)
    launches_u, serve_u = serve_phase(
        args, topo, feat_hot,
        [("tiered store", None, feat_cold),
         ("UVA topology", {"mode": "UVA"}, feat_hot)], card, weighted=False)
    launches_w, serve_w = serve_phase(
        args, topo, feat_hot, [("UVA topology", {"mode": "UVA"}, feat_hot)],
        card, weighted=True)
    del feat_hot, feat_cold

    # phases 6 and 7: sampler entry points
    samp_u = sampler_phase(topo, card, weighted=False)
    log(f"uniform sampler: {samp_u['edges_per_s']:.4g} sampled edges/s")
    samp_w = sampler_phase(topo, card, weighted=True)
    log(f"weighted sampler: {samp_w['edges_per_s']:.4g} sampled edges/s")
    samp_t = sampler_temporal_phase(topo, args, card)
    log(f"temporal sampler: {samp_t['edges_per_s']:.4g} sampled edges/s, "
        f"{samp_t['batch_ms']:.3f} ms per batch, window search "
        f"{samp_t['window_search_ms_per_batch']:.3f} ms of it")
    samplers = {"uniform": samp_u, "weighted": samp_w, "temporal": samp_t}

    # phases 8 and 9: train (the twin's main path; its launches are read there)
    launches_t, train = train_phase(card, pcie)
    accept = acceptance_phase(card)
    for mode in ("sampled", "layerwise"):
        log(f"planted:20000 {mode}: test acc {accept[mode]['test_acc']:.4f} "
            f"(feature-only Bayes {accept[mode]['feature_bayes_acc']:.4f})")

    k1, k2 = "quiver_tpu/ops/pallas/fused.py:75", "quiver_tpu/ops/pallas/gather.py:28"
    k3 = "quiver_tpu/ops/pallas/fused.py:113"
    kernels = [
        kernel_row("select", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   samp_t["launches"]["select"],
                   "temporal sampler (and the offs/draw_fn seams)", sel, t_sel,
                   {"stock_ms": t_sel["stock_ms"], "ratio_to_stock": t_sel["ratio_to_stock"],
                    "shape": [t_sel["rows"], t_sel["k"]], "bound_rule": SELECT_BOUND_RULE,
                    "library": "none: its yardstick is the stock index_select "
                               "of the already-computed slots"},
                   card, name),
        kernel_row("uniform_hop", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   launches_u["uniform_hop"], "uniform serving", hop, t_hop,
                   {"composed_ms": t_hop["composed_ms"],
                    "speedup_over_composed": t_hop["speedup_over_composed"],
                    "shape": t_hop["shape"] + [t_hop["k"]], "bound_rule": HOP_BOUND_RULE,
                    "train_launches": launches_t["uniform_hop"],
                    "library": "none: its yardstick is the composed path"},
                   card, name),
        kernel_row("tiered_gather", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_u["tiered_gather"], "uniform serving (hot-only store)",
                   tier, t_tier,
                   {"ratio_to_library": t_tier["ratio_to_yard"],
                    "shape": [t_tier["ids"], t_tier["row_bytes"]],
                    "bound_rule": GATHER_BOUND_RULE, "tiered_store": t_tier_split,
                    "train_launches": launches_t["tiered_gather"],
                    "single_table_entry": {
                        "name": "gather_rows", "path": "none (staged_gather)",
                        "launches": launches_u["gather_rows"],
                        "max_abs_err": max(c["max_abs_err"] for c in gat),
                        "match": all(c["match"] for c in gat),
                        **{key: t_gat[key] for key in ("ms", "plain_ms", "library_ms",
                                                       "ratio_to_library", "bound_ms",
                                                       "bound_share")}}},
                   card, name),
        kernel_row("wselect", "quiver_tpu_torch/ops/kernels/wselect.cu", k3,
                   serve_w["parity"]["launches"]["wselect"],
                   "weighted serving's single-query oracle (ladder parity)",
                   wsel, t_wsel,
                   {"shape": [t_wsel["rows"], t_wsel["k"]],
                    "iters": t_wsel["iters"],
                    "bound_rule": WSELECT_BOUND_RULE,
                    "probe_bound_ms": t_wsel["probe_bound_ms"],
                    "probe_bound_rule": WSELECT_PROBE_RULE,
                    "library": "none: no single PyTorch call computes a "
                               "row-local inverse-CDF select over ragged rows"},
                   card, name),
        kernel_row("weighted_hop", "quiver_tpu_torch/ops/kernels/wselect.cu", k3,
                   launches_w["weighted_hop"], "weighted serving", whop, t_whop,
                   {"composed_ms": t_whop["composed_ms"],
                    "speedup_over_composed": t_whop["speedup_over_composed"],
                    "shape": t_whop["shape"] + [t_whop["k"]],
                    "bound_rule": WHOP_BOUND_RULE,
                    "library": "none: its yardstick is the composed path"},
                   card, name),
    ]
    check(all(k["launches"] > 0 and k["match"] for k in kernels)
          and kernels[2]["single_table_entry"]["match"],
          "every kernel launched on its main path and every entry matched")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"kernels": kernels, "bulk": bulk,
                       "serve": {"uniform": serve_u, "weighted": serve_w},
                       "sampler": samplers, "train": train,
                       "acceptance": accept,
                       "build_s": build_s, "graph_s": graph_s,
                       "graph": {"nodes": topo.node_count,
                                 "edges": topo.edge_count,
                                 "max_degree": topo.max_degree}}, fh, indent=1)
    print(json.dumps({"bulk": bulk, "card": card}), flush=True)
    print(json.dumps({"serve": {"uniform": serve_u, "weighted": serve_w}}), flush=True)
    print(json.dumps({"sampler": samplers}), flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "per_step"},
                      "acceptance": accept}), flush=True)
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
