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
   single-table and tiered gathers and the int8 dequantising tiered
   gather, K3's search-and-select and fused weighted hop), on the
   products-scale graph (with exp(N(0,1)) edge weights) and feature tables
   (and wide f32 rows of 1 KB and 2.4 KB; int8 stores at F = 100, 602 and
   7, hot-only, cold-only and split, with and without the degree reorder),
   a small graph with zero-weight rows and one whose rows take every degree
   of 0-40 and some up to 3232, device and pinned host (UVA) tables, and
   K2's lookups also at ids past the table (which read its last row); then
   time each entry at the serving path's shapes and in bulk, in turns with
   its yardstick (yardstick, kernel, kernel, yardstick) where it has one,
   beside its bound, and the int8 lookup at ``bench_feature.py``'s
   configuration (65,536 uniform ids, a 20%-of-f32 budget stored as int8)
   in turns with the same lookup in stock torch ops.
   Then both kernel resolutions from an empty election cache
   (``QUIVER_ELECTION_CACHE`` in a fresh temporary directory): the
   lookup's ``auto`` is K2 after its bitwise smoke, with nothing measured
   or cached, and every store of the later phases resolves to it; the
   sample election (the fused hop against the composed path, edges/s on
   a 4,096-node, 2^18-edge graph, batch 1,024, k = 8) passes its bitwise
   smoke, elects the higher score, which must be the fused hop whose
   launches the later phases count, and comes from the disk cache on a
   fresh resolution; an explicit ``kernel="xla"`` store over the tiered
   table returns K2's rows bitwise with no K2 launch.
4. serve, uniform: the full-width serving configuration (products-shaped
   graph, F=100, GraphSAGE hidden 256 / 47 classes / 2 layers, fanouts
   [5, 5], max_batch 8) captures its per-bucket programs as CUDA graphs
   (each bucket's sample program runs its two hops once eagerly and once
   under capture) and answers closed-loop point queries by replaying them,
   with every kernel launch counted from before the capture: the wrappers'
   calls, plus each replay's captured launches (a replay calls no wrapper;
   ``torch.profiler`` sees the hop's kernel run in one); the answers are
   checked (finite, normalised, no
   overflow, ladder == single-query oracle bitwise at every bucket, full
   and padded, with the oracle's launches counted), then the same stream
   is served again from a store with 3/4
   of its rows cold in pinned host memory and from a UVA topology, both of
   which must answer bitwise the same.
5. serve, weighted: the same server over ``GraphSageSampler(weighted=True)``
   (every hop one launch of K3's fused entry, none on K1; the oracle runs
   K3's search-and-select), with the same checks, and the same stream
   again from a UVA weighted topology. Then the uniform server over the
   tiered store stored as int8 (612,500 rows on the card, the rest pinned;
   every lookup one launch of K2's dequantising entry), with the same
   checks.
6. sampler, uniform and weighted (K1's and K3's fused hops):
   ``bench_sampler``'s configuration
   (fanouts [15, 10, 5], batch 2048, worst-case caps) samples a few
   batches; every edge must join a frontier node to one of its CSR
   neighbours, with ``min(deg, k)`` edges per node. Prints sampled edges/s.
   A ``kernel="xla"`` sampler (the composed path: one K1 ``select`` or K3
   ``wselect`` launch per hop, no fused one) passes the same checks and
   equals a ``kernel="pallas"`` sampler's samples bitwise.
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
   relative, each gradient within 1e-4 x its max |g|; and K2's lookup of
   one step's ids timed in turns with the same lookup in stock torch ops.
   Then the same configuration stored as int8 (``--int8``), twice: (a) under
   the same byte budget (about four times the rows on the card) and (b)
   with the f32 run's hot rows; each with exactly 2 ``uniform_hop`` and 1
   ``tiered_gather_dequant`` launches per step.
9. train, acceptance: the twin's ``--dataset planted:20000 --epochs 4``
   on the card, with sampled and then layer-wise evaluation, then sampled
   once more over an int8 store; each test accuracy must clear the
   feature-only Bayes accuracy + 0.15.
9b. the training epoch's host loop, ``benchmarks/bench_epoch.py``'s
   configuration (the products-shaped graph on the card, F=100 f32, 47
   classes, a 20% degree-ordered cache, the rest pinned, fanouts [15, 10,
   5], batch 1024, auto caps, hidden 256, GAT heads 4, Adam 1e-3) for
   ``--model`` sage, gcn, gin and gat: 3 warm-up iterations, then 40
   serial ones (``--prefetch 0``: stage medians, 10%-trimmed mean) and 40
   through a ``Prefetcher`` at depth 2 (its dispatch on the worker's own
   CUDA stream); steps/s, sampled edges/s, peak memory, and the idle
   share of 5 prefetched steps under ``torch.profiler``; exactly 3
   ``uniform_hop`` and 1 ``tiered_gather`` launches per iteration (from
   the worker thread under the Prefetcher; regrowth reruns counted
   apart); the prefetched batches bitwise the serial loop's (fresh
   samplers, one seed stream); finite losses. Then GCN, GIN and GAT each
   train one step on the card against the CPU (fanouts [15, 10, 5] x 64,
   phase 8's tolerances); their layer-wise inference at
   ``benchmarks/bench_infer.py``'s defaults over the products graph
   (nodes/s, finite) and on the small graphs against the CPU (within 1e-5
   x max |out|); and the twin's ``--save-dir`` drill: planted:20000 for 2
   epochs, then resumed to 4 (epochs 3-4 only, the restored state bitwise
   the saved one, test accuracy above feature-only Bayes + 0.15).
9c. heterogeneous R-GCN and GraphSAINT. (a) ``benchmarks/bench_rgcn.py``
   at its defaults: a MAG-shaped ``HeteroCSRTopo`` (200,000 papers citing
   by ``generate_pareto_graph(200000, 10.0, seed=0)``, 100,000 authors
   writing 3 per paper, 5,000 institutions employing 2 per author), F=128
   f32 per type in a ``HeteroFeature`` (4G budget: every row on the card),
   16 classes, ``RGCN`` hidden 64 x 2, ``HeteroGraphSampler`` [8, 4] x
   512 with auto caps, Adam 5e-3: the planning call, 3 warm-up and 30
   timed iterations (10%-trimmed mean, stage medians, iterations per
   epoch, the planned caps beside the worst case, peak memory), the idle
   share of 5 profiled iterations; exactly 5 ``uniform_hop`` and 3
   ``tiered_gather`` launches per iteration (5 more per regrowth rerun),
   finite losses, no overflow, seeds first, every sampled lane a real
   edge of its relation. The same sampler over exp(N(0, 1)) weights on
   every relation: 5 ``weighted_hop`` and no ``uniform_hop`` launch per
   call, the same checks. One call of each sampler at its planned caps on
   the card against the same relations on the CPU, on the same raw draws
   (frontiers, counts, every Adj, overflow, bitwise), and the lookup of
   the uniform call's frontiers against each type's plain
   ``tiered_gather``. One R-GCN step on the card against the CPU
   (phase 8's tolerances), and ``rgcn_layerwise_inference`` over the
   whole graph in HBM and HOST mode (nodes/s, finite, HOST within 1e-5 x
   max |out| of HBM). (b) ``benchmarks/bench_saint.py`` at its defaults
   (``generate_pareto_graph(500000, 50.5, seed=0)`` on the card): the
   node and edge samplers at budget 4096 and the random-walk sampler at
   1024 roots x 3 steps, 5 warm-up and 50 timed draws each (subgraphs/s,
   induced edges/s, ``deg_cap``, the idle share of 5 profiled draws);
   exactly 1 ``gather_rows`` launch per node or walk draw, 2 per edge
   draw, 3 ``uniform_hop`` per walk draw; every induced edge a CSR edge
   between subgraph nodes, no duplicate node; ``saint_subgraph`` on the
   card bitwise its plain version on the same nodes, HBM and HOST; the
   walk's steps (K1 ``uniform_hop``, 1024 walkers x k=1) on the same raw
   draws, and ``random_walk`` under a ``draw_fn`` (K1 ``select``), on the
   card bitwise the CPU; K2's single-table entry at the window's shape
   bitwise its plain version and timed in turns with ``index_select``. (c) The twins:
   ``examples/train_saint_torch.py`` at ``tests/test_saint.py``'s
   acceptance arguments (test accuracy >= 0.85 and >= feature-only Bayes
   + 0.15) and ``examples/train_rgcn_hetero_torch.py`` at its defaults
   (finite losses). Cut in nothing but iterations: none of the three runs
   more than its benchmark's default count.
9d. beyond-HBM training: ``examples/train_host_offload_torch.py`` at the
   JAX example's defaults (``generate_pareto_graph(1000000, 15.0,
   seed=0)``, its edge count printed; a ``mode="HOST"`` sampler, K1
   reading ``indices`` over UVA, auto caps; F=128 f32 under a 10%
   degree-ordered hot tier, the cold 90% pinned; 172 classes, GraphSAGE
   256 x 2, [12, 8] x 1024, Adam 1e-3). The twin's loop and
   ``DataParallelTrainer.train_epoch`` on ``make_mesh()``, each for 100
   steps after 5 unrecorded ones, through the Prefetcher at depth 2 and
   then serially (depth 0, each stage ending in a synchronise): steps/s,
   stage medians at depth 0, peak memory, the idle share and K1's and
   K2's device ms of 5 profiled steps (the union of device intervals over
   both streams, as phase 9b), cold rows and bytes per step, the planned
   caps beside the worst case; exactly 2 ``uniform_hop`` and 1
   ``tiered_gather`` launches per step (2 more hops per regrowth rerun of
   the loop's auto caps; the trainer's are pinned), no composed path and
   no stock lookup. One HOST-mode sampler call at the planned caps
   bitwise an HBM copy's, its hops again one by one (K1 over UVA) and its
   lookup bitwise their plain versions on the card; one
   ``DataParallelTrainer.step`` on the card against the same step on a
   CPU mesh (phase 8's tolerances). K1 over UVA at both hops' shapes in
   turns with the composed hop, K2 on the call's ids in turns with the
   staged lookup, each beside its bound (UVA sectors and cold rows at the
   run's copy rate).
10. serve, observed and degraded, last so that the earlier phases run as
   before them; over phase 4's tiered store (612,500 hot rows): serving
   under telemetry, uniform and then weighted: the tracer, the registry
   and the flight recorder on against all off, in 4 alternating pairs of
   the 256 closed-loop queries: responses bitwise equal, ladder ==
   oracle, one trace per request with exactly the six stage spans, the
   registry's counters equal to ``stats()``, the Prometheus and JSONL
   exports parsing back, exact launches; queries/s on and off are printed
   and the Chrome trace is written to ``OUT_DIR``. Serving's device
   idle share: ``profile_epoch`` around the 256 served queries (32
   batches), busy time summed as phase 8 sums it, against the median
   batch time of 3 unprofiled passes of the same stream on the same
   server.
   Degraded serving: lookups 5-9 of a host-side wrapper of the store
   raise; with ``degraded="zeros"`` and again ``"last-good"`` the breaker
   fails two batches, opens on the third failure, serves 12 batches
   degraded (counted in ``serve.degraded_lookups``; every opening dumps a
   bundle that passes ``verify_bundle``), closes on the probe after the
   window, and answers bitwise as a healthy server after it; K2 launches
   once per batch whose lookup reaches the store.
11. serving fleet, last (its version drill mutates the topology); over
   phase 4's tiered store: a 2-replica ``ServingFleet`` with a fresh
   program cache and a ``CacheController``; replica 0 captures 8 programs
   (4 buckets x 2), replica 1 joins with none (join seconds and capture ms
   printed); 256 closed-loop queries, every replica serving every bucket
   full and padded, answer bitwise as ``fleet.oracle``, and the sketch
   counts every valid served id. A weighted fleet whose sampler shares the
   uniform sampler's placement (``device_topo``) answers bitwise as a
   server over its own placement. An ``EmbeddingRefresher`` over the full
   graph publishes from its background lane (its own CUDA stream) while
   the fleet serves, equal to a foreground refresh (bitwise expected,
   within 1e-5 at worst). The version drill: one
   edge inserted through ``CSRTopo._publish_mutation``; every serve path
   and the refresher raise; ``fleet.refresh()`` recaptures on replica 0
   and loads on replica 1; the answers equal the oracle. Then the
   replayed fleet's device idle share, as phase 10 measures it, with the
   controller's feed and without it.

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
OUT_DIR = os.path.join(HERE, "chiprun_out")  # run artifacts (git-ignored)
KERNELS = ("select", "gather", "wselect")
# the wrappers, each with its launch count: K1's two entries, K2's three,
# K3's two
ENTRIES = ("select", "uniform_hop", "gather_rows", "tiered_gather",
           "tiered_gather_dequant", "wselect", "weighted_hop")
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
    "of the two times. int8 stores: a stored row is F code bytes, each "
    "valid id also reads its 4 B scale, and each output row is 4F bytes"
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
WINDOW_BOUND_RULE = (
    "device memory: 4 B per id, each distinct table row read once and each "
    "output row written once, at 3.35 TB/s"
)
K3_LIBRARY = (
    "none: no single PyTorch call does a per-row inverse-CDF search over "
    "ragged rows (torch.searchsorted needs one sequence length per batch row)"
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
    from quiver_tpu_torch.ops.kernels.gather import (gather_rows, tiered_gather,
                                                     tiered_gather_dequant)

    return {"select": select, "uniform_hop": uniform_hop,
            "gather_rows": gather_rows, "tiered_gather": tiered_gather,
            "tiered_gather_dequant": tiered_gather_dequant,
            "wselect": wselect, "weighted_hop": weighted_hop}


def reset_launches() -> None:
    """Set every wrapper's count and the programs' replay tally to 0."""
    from quiver_tpu_torch.serving.ladder import REPLAYED_LAUNCHES

    for fn in kernel_fns().values():
        fn.launches = 0
    REPLAYED_LAUNCHES.clear()


def read_launches() -> dict:
    """The wrappers' counts: launches made by calling a wrapper (eagerly,
    or into a CUDA graph under capture)."""
    from quiver_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def read_replayed() -> dict:
    """Launches made by replaying captured serving programs: each replay
    launches again every kernel its capture recorded, calling no wrapper."""
    from quiver_tpu_torch.serving.ladder import REPLAYED_LAUNCHES

    return {name: REPLAYED_LAUNCHES.get(name, 0) for name in ENTRIES}


def expect_launches(launches: dict, want: dict, what: str,
                    replayed: dict | None = None) -> None:
    """Every entry launched exactly as ``want`` says through its wrapper
    and as ``replayed`` says through program replays (0 when unnamed)."""
    full = {name: want.get(name, 0) for name in ENTRIES}
    check(launches == full, f"{what}: launches {launches}, expected {full}")
    got = read_replayed()
    full = {name: (replayed or {}).get(name, 0) for name in ENTRIES}
    check(got == full, f"{what}: replayed launches {got}, expected {full}")


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


def past_the_table(ids, n: int) -> None:
    """Put ids of ``n`` and more (which read row ``n - 1``) in the first
    lanes of ``ids``."""
    ids[:3] = [n, n + 5, 2**31 - 1][:len(ids)]


def gather_checks(tables, rng):
    """K2's single-table entry against gather_rows_plain: f32/bf16/int8
    tables, device and pinned host, wide f32 rows, a ragged id count with
    -1 lanes and ids past the table, and the keep-out form."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    results = []
    for name, tab in tables:
        dev = torch.device("cuda")
        n = tab.shape[0]
        for count in (100_003, 384, 7):
            ids = rng.integers(0, n, count).astype("int32")
            ids[rng.random(count) < 0.1] = -1
            past_the_table(ids, n)
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
    """K2's tiered entries against tiered_gather_plain on feature stores
    (hot-only, hot + pinned cold with the degree reorder, cold-only; f32,
    bf16, and int8 through the dequantising entry), for ragged id counts
    with -1 lanes and ids past the table."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import (tiered_gather, tiered_gather_dequant,
                                                     tiered_gather_plain)

    results = []
    for name, feat in stores:
        n = feat.shape[0]
        entry = tiered_gather if feat.scale is None else tiered_gather_dequant
        extra = () if feat.scale is None else (feat.scale,)
        for count in (100_003, 384, 7):
            ids = rng.integers(0, n, count).astype("int32")
            ids[rng.random(count) < 0.1] = -1
            past_the_table(ids, n)
            args = (torch.from_numpy(ids).to("cuda"), feat.feature_order,
                    feat.hot_rows, feat.hot, feat.cold) + extra
            want = tiered_gather_plain(*args)
            got = entry(*args)
            sync()
            ok = equal(got, want)
            err = float((got.float() - want.float()).abs().max()) if count else 0.0
            results.append({"store": name, "ids": count, "hot_rows": feat.hot_rows,
                            "match": ok, "max_abs_err": err})
            check(ok, f"{entry.__name__} {name} ids={count}")
    return results


def int8_stores(x_small, small_topo):
    """int8 stores of the small graph at F = 100, 602 and 7: hot-only,
    cold-only and split, with and without the degree reorder (row 5 all
    zeros: scale 0)."""
    import numpy as np

    from quiver_tpu_torch import Feature

    n = x_small.shape[0]
    rng = np.random.default_rng(7)
    stores = []
    for F in (100, 602, 7):
        x = np.array(x_small[:, :F]) if F <= x_small.shape[1] else rng.standard_normal(
            (n, F), dtype=np.float32)
        x[5] = 0.0
        for label, hot, topo in (("hot-only", n, None), ("cold-only", 0, None),
                                 ("cold-only, reorder", 0, small_topo),
                                 ("split", n // 4, None),
                                 ("split, reorder", n // 4, small_topo)):
            stores.append((f"int8 F={F} {label}", Feature(
                device_cache_size=4 * n + hot * F, csr_topo=topo, dtype="int8",
                device="cuda").from_cpu_tensor(x)))
    return stores


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


def time_hop(topo_np, dev_topo, shape, k, g, rng, iters: int = 200, reps: int = 7,
             plain_topo=None, pcie_bytes_per_s=None):
    """K1's fused hop at ``shape`` rows (per-lane counts when it has lanes),
    in turns with the composed path on the same bits (``sample_layer`` with
    the offsets computed from them: seed_degrees, stratified_offsets,
    rotate_offsets, then the select entry), beside its plain version and
    its HOP_BOUND_RULE bound. For a UVA topology (``indices`` pinned on the
    host) the plain version reads ``plain_topo``'s device copy, and the
    bound counts the indices sectors at ``pcie_bytes_per_s`` (the larger
    of the two times)."""
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
    plain = plain_topo or dev_topo
    plain_ms = cuda_ms(lambda: uniform_hop_plain(plain.indptr, plain.indices, seeds,
                                                 num, jitter, rot), iters, reps)
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
    bound_s = nbytes / HBM_BYTES_PER_S
    if pcie_bytes_per_s is not None:  # the indices sectors come over UVA
        uva = SECTOR * ix_sectors
        bound_s = max((nbytes - uva) / HBM_BYTES_PER_S, uva / pcie_bytes_per_s)
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "composed_ms": t["yard_ms"], "composed_turns": t["yard_turns"],
            "speedup_over_composed": 1 / t["ratio"], "library_ms": None,
            "bound_ms": bound_s * 1e3, "bound_bytes": nbytes,
            "bound_share": bound_s * 1e3 / t["ms"],
            "uva_index_bytes": None if pcie_bytes_per_s is None else SECTOR * ix_sectors,
            "indptr_sectors": ip_sectors, "index_sectors": ix_sectors,
            "rot_sectors": rot_sectors, "jitter_sectors": jit_sectors,
            "drawn_rows": int(drawn.numel()), "shape": list(shape), "k": k}


def time_gather(table, ids, distinct_rows=None):
    """K2's single-table entry at one lookup's shapes (in-range ids), in
    turns with ``torch.index_select``, which computes the same function
    here, beside its plain version and its byte bound (a table row read
    per id, or once per distinct row when ``distinct_rows`` counts them)."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    ids64 = ids.to(torch.int64)
    t = in_turns(lambda: gather_rows(table, ids),
                 lambda: torch.index_select(table, 0, ids64))
    plain_ms = cuda_ms(lambda: gather_rows_plain(table, ids))
    B = ids.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    nbytes = B * 4 + (B if distinct_rows is None else distinct_rows) * row_bytes \
        + B * row_bytes
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
    _, n_cold, dev_bytes, cold_bytes = lookup_bytes(feat, ids)
    B = ids.shape[0]
    row_bytes = feat.shape[1] * (feat.hot if feat.hot is not None else feat.cold).element_size()
    bound_s = max(dev_bytes / HBM_BYTES_PER_S, cold_bytes / pcie_bytes_per_s)
    return {"ms": t["ms"], "ms_turns": t["ms_turns"], "plain_ms": plain_ms,
            "yardstick": yard_name, "yard_ms": t["yard_ms"],
            "yard_turns": t["yard_turns"], "ratio_to_yard": t["ratio"],
            "library_ms": t["yard_ms"] if yard_name == "index_select" else None,
            "bound_ms": bound_s * 1e3, "bound_share": bound_s * 1e3 / t["ms"],
            "device_bytes": dev_bytes,
            "cold_bytes": cold_bytes, "cold_rows": n_cold, "ids": B,
            "row_bytes": row_bytes}


def staged_lookup(n_id, feat, buf):
    """The tiered lookup in stock torch ops: the port's ``kernel="xla"``
    path (``feature.stock_lookup``): translate on the card, a host
    ``index_select`` of the cold rows into the pinned buffer ``buf``, one
    ``non_blocking`` copy to the card, the hot rows' ``index_select``, the
    merge and, for int8 codes, the multiply by their scales. The same
    function as K2's tiered entries."""
    from quiver_tpu_torch.feature.feature import stock_lookup

    return stock_lookup(n_id, feat.feature_order, feat.hot_rows, feat.hot,
                        feat.cold, feat.scale, buf)


def lookup_bytes(feat, n_id):
    """(valid ids, cold ids, device bytes, cold bytes) of one tiered lookup
    of ``n_id`` under GATHER_BOUND_RULE."""
    import torch

    B = n_id.shape[0]
    valid = n_id[n_id >= 0].clamp(max=feat.shape[0] - 1).to(torch.int64)
    if feat.feature_order is not None:
        valid = feat.feature_order[valid].to(torch.int64)
    nv = int(valid.shape[0])
    nc = int((valid >= feat.hot_rows).sum())
    row_bytes = feat.shape[1] * (feat.hot if feat.hot is not None else feat.cold).element_size()
    out_bytes = feat.shape[1] * 4 if feat.scale is not None else row_bytes
    dev_bytes = (B * 4 + (nv * 4 if feat.feature_order is not None else 0)
                 + (nv * 4 if feat.scale is not None else 0)
                 + (nv - nc) * row_bytes + B * out_bytes)
    return nv, nc, dev_bytes, nc * row_bytes


def time_lookup(feat, ids, pcie_bytes_per_s, iters: int, reps: int):
    """K2's tiered entry (the dequantising one for an int8 store) on a
    split store, in turns with :func:`staged_lookup`, beside its plain
    version and its GATHER_BOUND_RULE bound."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import (tiered_gather, tiered_gather_dequant,
                                                     tiered_gather_plain)

    args = (ids, feat.feature_order, feat.hot_rows, feat.hot, feat.cold)
    if feat.scale is not None:
        args, entry = args + (feat.scale,), tiered_gather_dequant
    else:
        entry = tiered_gather
    buf = torch.empty((ids.shape[0], feat.shape[1]), dtype=feat.cold.dtype).pin_memory()
    got = entry(*args)
    check(equal(got, staged_lookup(ids, feat, buf)), f"{entry.__name__} == staged lookup")
    check(equal(got, tiered_gather_plain(*args)), f"{entry.__name__} == plain")
    del got
    t = in_turns(lambda: entry(*args), lambda: staged_lookup(ids, feat, buf), iters, reps)
    plain_ms = cuda_ms(lambda: tiered_gather_plain(*args), max(iters // 5, 2), 3)
    nv, nc, dev_bytes, cold_bytes = lookup_bytes(feat, ids)
    bound_s = max(dev_bytes / HBM_BYTES_PER_S, cold_bytes / pcie_bytes_per_s)
    return {"entry": entry.__name__, "ms": t["ms"], "ms_turns": t["ms_turns"],
            "plain_ms": plain_ms, "yardstick": "staged lookup in stock torch ops "
            "(host index_select of the cold rows into a pinned buffer, one "
            "non_blocking copy, hot index_select, merge"
            + (", multiply)" if feat.scale is not None else ")"),
            "yard_ms": t["yard_ms"], "yard_turns": t["yard_turns"],
            "ratio_to_yard": t["ratio"], "library_ms": None,
            "bound_ms": bound_s * 1e3, "bound_share": bound_s * 1e3 / t["ms"],
            "bound_by": "bytes", "device_bytes": dev_bytes, "cold_bytes": cold_bytes,
            "ids": int(ids.shape[0]), "valid_ids": nv, "cold_rows": nc,
            "hot_rows": feat.hot_rows, "rows": feat.shape[0],
            "stored_row_bytes": feat.shape[1] * feat.cold.element_size(),
            "iters": iters, "reps": reps}


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


def ladder_parity(server, picks, hop: str, composed: str, lookup: str):
    """Ladder lanes against the single-query oracle at every bucket, full
    and with a padded tail: ids, edges and log-probs bitwise. Counts the
    launches: per group one ``hop`` launch per layer, replayed by the
    bucket's captured sample program, and one ``lookup``; per lane the
    oracle's two samples (``composed`` on each layer) and one
    ``lookup``."""
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
    replayed = read_replayed()
    expect_launches(launches, {composed: 2 * layers * lanes,
                               lookup: groups_run + lanes},
                    "ladder parity", replayed={hop: layers * groups_run})
    return {"ids_edges": "bitwise", "logp": "bitwise", "lanes": lanes,
            "groups": groups_run, "launches": launches, "replayed": replayed}


def replay_profile(server, hop: str) -> dict:
    """``torch.profiler`` over one replay of the bucket-8 sample program
    (8 live lanes): the hop's kernel runs on the card inside the replay,
    which calls no wrapper."""
    import torch

    name = {"uniform_hop": "uniform_hop_kernel",
            "weighted_hop": "weighted_hop_kernel"}[hop]
    run = server.ladder.sample_exec(8)
    seeds = torch.arange(8, dtype=torch.int32)
    seqs = list(range(1 << 20, (1 << 20) + 8))
    sync()
    before = read_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(seeds, seqs)
        sync()
    check(read_launches() == before, "a replay calls no wrapper")
    rows = [e for e in prof.key_averages()
            if name in e.key and e.self_device_time_total > 0]
    check(bool(rows), f"the profiler sees {name} run in a replay")
    return {"kernel": name, "calls": sum(e.count for e in rows),
            "device_us": sum(e.self_device_time_total for e in rows)}


def serve_phase(args, topo, feat_hot, variants, card, weighted):
    """Build the server's programs (warm-up: each bucket's sample program
    runs its two hops once eagerly and once under capture) and serve
    ``args.requests`` closed-loop queries over the [5, 5] sampler (weighted
    or uniform) from the store ``feat_hot``, with every kernel launch
    counted from before the warm-up, and check the answers and the
    launches (per batch: one hop launch per layer, K1's or K3's fused hop,
    replayed by the captured sample program, and one K2 tiered lookup,
    eager, the dequantising entry for an int8 store; nothing else); the
    profiler sees the hop's kernel in a replay; then serve the same stream
    again through each of ``variants`` (``(label, sampler kwargs or None
    to reuse the sampler, store)``), which must answer bitwise the same
    with the same launches (its programs built at first use)."""
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
    hop = "weighted_hop" if weighted else "uniform_hop"
    lookup = "tiered_gather" if feat_hot.scale is None else "tiered_gather_dequant"
    sync()
    reset_launches()
    t0 = time.perf_counter()
    captures = server.warmup()
    sync()
    warm_s = time.perf_counter() - t0
    buckets = len(server.batcher.buckets)
    programs = server.ladder.programs()
    check(captures == 2 * buckets == len(programs)
          and all(p.graph is not None for p in programs),
          f"warm-up captured {captures} programs")
    check([p.launches for p in programs] == [{hop: 2}, {}] * buckets,
          f"captured launches {[p.launches for p in programs]}")
    expect_launches(read_launches(), {hop: 2 * 2 * buckets},
                    "warm-up (eager passes and captures)")

    rng = np.random.default_rng(args.seed)
    nodes = rng.integers(0, n, args.requests)
    sync()
    t0 = time.perf_counter()
    reqs = closed_loop(server, nodes, 8)
    sync()
    wall = time.perf_counter() - t0
    wrapped, replayed = read_launches(), read_replayed()
    launches = {k: wrapped[k] + replayed[k] for k in ENTRIES}
    batches = server.timeline.stats("sample").count
    log(f"served {len(reqs)} {'weighted' if weighted else 'uniform'} queries "
        f"in {wall:.3f}s ({batches} batches); launches {launches} "
        f"({replayed[hop]} {hop} replayed)")

    check(len(reqs) == args.requests, "every request answered")
    out = np.stack([r.result for r in reqs])
    check(out.shape == (args.requests, 47), f"log-prob shape {out.shape}")
    check(bool(np.isfinite(out).all()), "finite log-probs")
    sums = np.exp(out.astype(np.float64)).sum(axis=1)
    check(bool(np.all(np.abs(sums - 1.0) < 1e-4)), "exp(log-probs) sums to 1")
    check(all(r.overflow == 0 for r in reqs), "overflow == 0")
    expect_launches(wrapped, {hop: 2 * 2 * buckets, lookup: batches}, "serve",
                    replayed={hop: 2 * batches})
    profiled = replay_profile(server, hop)

    picks = [(r.node, r.seq) for r in
             (reqs[i] for i in rng.choice(len(reqs), 16, replace=False))]
    parity = ladder_parity(server, picks, hop, "wselect" if weighted else "select",
                           lookup)

    reruns = {}
    for label, kwargs, store in variants:
        smp = sampler if kwargs is None else GraphSageSampler(
            topo, [5, 5], device="cuda", seed=0, weighted=weighted, **kwargs)
        other = InferenceServer(smp, model, store, device="cuda", max_batch=8,
                                seed=0)
        reset_launches()
        got = closed_loop(other, nodes, 8)
        runs = other.timeline.stats("sample").count
        built = len(other.ladder._sample_exec)
        reruns[label] = {"queries": len(got), "batches": runs,
                         "built_buckets": built, **read_launches(),
                         "replayed": read_replayed()}
        expect_launches(read_launches(), {hop: 2 * 2 * built, lookup: runs},
                        f"{label} rerun", replayed={hop: 2 * runs})
        check(len(got) == len(reqs) and all(
            np.array_equal(a.result, b.result) for a, b in zip(got, reqs)),
              f"{label} answers == the first run's answers")

    st = server.stats()["stages"]
    stages = {k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
              for k, v in st.items()}
    return launches, {
        "sampler": "weighted" if weighted else "uniform",
        "store": {"dtype": str(feat_hot.dtype), "hot_rows": feat_hot.hot_rows,
                  "rows": feat_hot.shape[0]},
        "queries": len(reqs), "batches": batches, "qps": len(reqs) / wall,
        "wall_s": wall, "launches": launches,
        "launches_by": {"wrapper_calls": wrapped, "replayed": replayed},
        "warmup": {"captures": captures, "seconds": warm_s,
                   "capture_ms": [p.build_s * 1e3 for p in programs]},
        "replay_profile": profiled, "stages": stages,
        "parity": parity, "bitwise_reruns_launches": reruns, "card": card,
    }


# -- the elections, serving under telemetry, idle share, degraded serving ------


def election_phase(topo, x_all, feat_cold, rng):
    """Both kernel resolutions from an empty cache (``QUIVER_ELECTION_CACHE``
    in a fresh temporary directory): the lookup's ``auto`` is K2 once its
    smoke passes bitwise, with nothing measured or cached; the sample
    election passes its bitwise smoke, measures both paths, elects the
    higher score, which must be the fused hop (the later phases count its
    launches), and a fresh resolution (``reset()``) comes from the disk
    cache. Then an explicit ``kernel="xla"`` store over the tiered table
    returns K2's rows bitwise (ids past the table and ``-1`` lanes
    included) with no K2 launch."""
    import tempfile

    import torch

    import quiver_tpu_torch.ops.election as EL
    from quiver_tpu_torch import Feature
    from quiver_tpu_torch.feature import feature as FM
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather
    from quiver_tpu_torch.sampling import sampler as SM

    cache = os.path.join(tempfile.mkdtemp(prefix="quiver-election-"),
                         "kernel_elections.json")
    os.environ["QUIVER_ELECTION_CACHE"] = cache
    for var in ("QUIVER_GATHER_KERNEL", "QUIVER_SAMPLE_KERNEL"):
        os.environ.pop(var, None)
    EL._ELECTION_CACHE_PATH = None
    FM._PALLAS_GATHER_OK = SM._PALLAS_SAMPLE_OK = None
    out = {}
    FM.GATHER_ELECTION.reset()
    t0 = time.time()
    kernel = FM.resolve_gather_kernel("auto", "cuda")
    seconds = time.time() - t0
    check(kernel == "pallas" and FM.GATHER_ELECTION.result["how"] == "smoke",
          f"gather auto on the card is K2 after its smoke: {FM.GATHER_ELECTION.result}")
    check(not os.path.exists(cache), "the gather resolution caches nothing")
    out["gather"] = {"resolved": kernel, "how": "smoke", "seconds": seconds}
    log(f"gather: auto -> {kernel} (smoke {seconds:.2f} s; nothing measured)")
    SM.SAMPLE_ELECTION.reset()
    t0 = time.time()
    kernel = SM.resolve_sample_kernel("auto", "cuda")
    seconds = time.time() - t0
    res = dict(SM.SAMPLE_ELECTION.result)
    check(res["how"] == "measured", f"sample election measured: {res}")
    check(kernel == max(res["score"], key=res["score"].get),
          f"sample election elects the higher score: {res}")
    check(kernel == "pallas", f"sample election elects the fused hop: {res}")
    SM.SAMPLE_ELECTION.reset()
    check(SM.resolve_sample_kernel("auto", "cuda") == kernel
          and SM.SAMPLE_ELECTION.result["how"] == "disk cache",
          f"sample election from the disk cache after reset(): "
          f"{SM.SAMPLE_ELECTION.result}")
    out["sample"] = {"elected": kernel, "score": res["score"],
                     "unit": SM.SAMPLE_ELECTION.unit, "key": res["key"],
                     "seconds": seconds}
    log(f"sample election: {res['score']} {SM.SAMPLE_ELECTION.unit} -> {kernel} "
        f"({seconds:.2f} s with the smoke)")
    check(FM._PALLAS_GATHER_OK is True and SM._PALLAS_SAMPLE_OK is True,
          "both smokes bitwise")
    with open(cache) as fh:
        check(set(json.load(fh)) == {"torch.sample"},
              "the port's entry in the election cache")

    # the explicit stock-op store over the tiered table
    n, F = x_all.shape
    feat_x = Feature(device_cache_size=(n // 4) * F * 4, csr_topo=topo,
                     kernel="xla", device="cuda").from_cpu_tensor(x_all)
    check(feat_x.kernel == "xla" and feat_x.hot_rows == feat_cold.hot_rows,
          "kernel='xla' store")
    checks = []
    for count in (100_003, 384, 7):
        ids = rng.integers(0, n, count).astype("int32")
        ids[rng.random(count) < 0.1] = -1
        past_the_table(ids, n)
        ids_d = torch.from_numpy(ids).to("cuda")
        want = tiered_gather(ids_d, feat_cold.feature_order, feat_cold.hot_rows,
                             feat_cold.hot, feat_cold.cold)
        sync()
        reset_launches()
        got = feat_x[ids_d]
        sync()
        expect_launches(read_launches(), {}, "kernel='xla' lookup (no K2 launch)")
        ok = equal(got, want)
        checks.append({"ids": count, "match": ok,
                       "max_abs_err": float((got - want).abs().max())})
        check(ok, f"kernel='xla' rows == K2's rows, ids={count}")
    out["xla_store"] = {"hot_rows": feat_x.hot_rows, "checks": checks}
    return out


def serve_pair(args, topo, store, weighted, model, **telemetry):
    """A server with the telemetry of ``telemetry`` (none: all off) over the
    [5, 5] sampler (seed 0) and ``store``, warmed up."""
    from quiver_tpu_torch import GraphSageSampler, InferenceServer

    sampler = GraphSageSampler(topo, [5, 5], device="cuda", seed=0, weighted=weighted)
    server = InferenceServer(sampler, model, store, device="cuda", max_batch=8,
                             seed=0, **telemetry)
    server.warmup()
    return server


def telemetry_phase(args, topo, store, card, weighted, pairs: int = 4):
    """Phase 5's serving configuration over ``store`` with the tracer, the
    registry and the recorder on, against a server with all off, in
    ``pairs`` alternating pairs of ``args.requests`` closed-loop queries:
    responses bitwise equal (log-probs included), ladder == oracle under
    telemetry, one trace per request with exactly the six stage spans, the
    registry's counters equal to ``stats()``, the Prometheus text and the
    JSONL parsing back, exact launches; the Chrome trace is written under
    ``OUT_DIR``. Queries/s on and off are tracing's cost (no claim)."""
    import io
    import tempfile

    import numpy as np
    import torch

    from quiver_tpu_torch import FlightRecorder, GraphSAGE, MetricsRegistry, Tracer
    from quiver_tpu_torch.obs import export

    torch.manual_seed(0)
    model = GraphSAGE(store.size(1), 256, 47, num_layers=2)
    reg = MetricsRegistry()
    tracer = Tracer(max_spans=8 * args.requests * pairs + 64, metrics=reg)
    rec = FlightRecorder(tempfile.mkdtemp(prefix="quiver-pm-"), tracer=tracer,
                         metrics=reg)
    on = serve_pair(args, topo, store, weighted, model, tracer=tracer, metrics=reg,
                    recorder=rec)
    off = serve_pair(args, topo, store, weighted, model)
    nodes = np.random.default_rng(args.seed + 7).integers(0, topo.node_count,
                                                           args.requests)
    hop = "weighted_hop" if weighted else "uniform_hop"
    lookup = "tiered_gather" if store.scale is None else "tiered_gather_dequant"
    qps = {"on": [], "off": []}
    traced = []
    for _ in range(pairs):
        runs = {}
        for label, server in (("off", off), ("on", on)):
            before = server.timeline.stats("sample").count if \
                server.timeline.stats("sample") else 0
            sync()
            reset_launches()
            t0 = time.perf_counter()
            runs[label] = closed_loop(server, nodes, 8)
            sync()
            qps[label].append(len(nodes) / (time.perf_counter() - t0))
            batches = server.timeline.stats("sample").count - before
            expect_launches(read_launches(), {lookup: batches},
                            f"telemetry {label}", replayed={hop: 2 * batches})
        check(all(a.seq == b.seq and np.array_equal(a.result.view(np.uint8),
                                                    b.result.view(np.uint8))
                  for a, b in zip(runs["on"], runs["off"])),
              "tracing on == off, bitwise")
        traced += runs["on"]
    by_trace = {}
    for sp in tracer.spans():
        by_trace.setdefault(sp.trace_id, []).append(sp)
    stage_names = sorted(f"serve.{s}" for s in on.STAGES)
    for r in traced:
        spans = by_trace.get(r.trace_id, [])
        roots = [sp for sp in spans if sp.name == "serve.request"]
        check(len(roots) == 1, f"one trace root per request ({r.trace_id})")
        check(sorted(sp.name for sp in spans if sp.parent_id == roots[0].span_id)
              == stage_names, f"six stage spans under {r.trace_id}")
    stats = on.stats()
    counters = {
        "serve.requests": stats["requests"],
        "serve.deadline_misses": stats["deadline_misses"],
        "serve.shed_requests": [stats["shed"][p] for p in ("gold", "bronze")],
        "serve.class_deadline_misses": [stats["class_deadline_misses"][p]
                                        for p in ("gold", "bronze")],
    }
    for name, want in counters.items():
        check(reg.snapshot(name).numpy.tolist() == want, f"registry {name} == stats()")
    check(int(reg.value("trace.spans")) == tracer.spans_total, "trace.spans counter")
    snaps = reg.snapshots()
    buf = io.StringIO()
    export.write_jsonl(snaps, buf)
    for back in (export.from_prometheus(export.to_prometheus(snaps)),
                 export.read_jsonl(buf.getvalue())):
        check([(b.name, b.numpy.tolist()) for b in back]
              == [(a.name, a.numpy.tolist()) for a in snaps],
              "Prometheus and JSONL exports parse back")
    parity = ladder_parity(on, [(r.node, r.seq) for r in traced[:16]], hop,
                           "wselect" if weighted else "select", lookup)
    label = "weighted" if weighted else "uniform"
    os.makedirs(OUT_DIR, exist_ok=True)
    trace_path = os.path.join(OUT_DIR, f"serve_trace_{label}.json")
    events = tracer.write_chrome(trace_path)
    log(f"telemetry {label}: queries/s on {[round(q, 1) for q in qps['on']]}, "
        f"off {[round(q, 1) for q in qps['off']]}; {events} trace events")
    return {"sampler": label, "store_hot_rows": store.hot_rows, "pairs": pairs,
            "queries_per_run": len(nodes), "qps_on": qps["on"], "qps_off": qps["off"],
            "qps_on_median": statistics.median(qps["on"]),
            "qps_off_median": statistics.median(qps["off"]),
            "traced_requests": len(traced), "spans_total": tracer.spans_total,
            "chrome_trace": os.path.relpath(trace_path, HERE), "trace_events": events,
            "stages_on": {k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
                          for k, v in stats["stages"].items()},
            "stages_off": {k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
                           for k, v in off.stats()["stages"].items()},
            "parity": parity, "card": card}


SERVE_ANNOTATIONS = ("serve", "queue_wait", "pad", "sample", "gather", "forward",
                     "readback", "feature_gather")


def idle_phase(args, topo, store, card, passes: int = 3):
    """Serving's device idle share over ``args.requests`` closed-loop
    queries (uniform, over ``store``, telemetry off), all on one server:
    the median batch time of ``passes`` unprofiled passes of the stream,
    then one pass under ``profile_epoch``, whose card busy time is summed
    as phase 8's ``profile_steps`` sums it (device time of every kernel
    and copy, the annotations left out). The share is taken against the
    unprofiled batch time (the profiler's own host cost inflates the
    profiled batches) and, for the same window, against the profiled
    pass's wall time."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSAGE

    torch.manual_seed(0)
    model = GraphSAGE(store.size(1), 256, 47, num_layers=2)
    nodes = np.random.default_rng(args.seed + 9).integers(0, topo.node_count,
                                                           args.requests)
    server = serve_pair(args, topo, store, False, model)

    def batches() -> int:
        stats = server.timeline.stats("sample")
        return stats.count if stats else 0

    return idle_share(lambda: closed_loop(server, nodes, 8), batches,
                      len(nodes), card, passes)


def idle_share(serve_pass, batches, queries: int, card, passes: int = 3):
    """The device idle share of ``serve_pass()`` (which serves ``queries``
    queries and returns their requests; ``batches()`` counts the batches
    served so far): the median batch time of ``passes`` unprofiled passes,
    then one pass under ``profile_epoch``, busy time summed over every
    kernel and copy (the annotations left out)."""
    import tempfile

    import torch

    from quiver_tpu_torch import profile_epoch

    pass_ms = []
    for _ in range(passes):
        before = batches()
        sync()
        t0 = time.perf_counter()
        serve_pass()
        sync()
        pass_ms.append((time.perf_counter() - t0) * 1e3 / (batches() - before))
    batch_ms = statistics.median(pass_ms)
    log_dir = tempfile.mkdtemp(prefix="quiver-profile-")
    before = batches()
    t0 = time.perf_counter()
    with profile_epoch(log_dir, "serve") as prof:
        reqs = serve_pass()
    wall_ms = (time.perf_counter() - t0) * 1e3
    profiled = batches() - before
    spans, kernels = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        (spans if e.key in SERVE_ANNOTATIONS else kernels)[e.key] = \
            e.self_device_time_total / 1e3 / profiled
    busy = sum(kernels.values())
    check(len(reqs) == queries and busy > 0, f"the profiler saw the card: {spans}")
    ours = {k: v for k, v in kernels.items()
            if any(m in k for m in ("uniform_hop_kernel", "gather_kernel"))}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    trace_bytes = os.path.getsize(os.path.join(log_dir, "serve.trace.json"))
    log(f"serving idle share: device busy {busy:.4f} ms per batch of "
        f"{batch_ms:.4f} (median of {passes} unprofiled passes: {pass_ms})")
    return {"queries": queries, "batches": profiled,
            "device_busy_ms_per_batch": busy,
            "batch_ms_unprofiled": batch_ms, "batch_ms_unprofiled_passes": pass_ms,
            "idle_share": 1 - busy / batch_ms,
            "profiled_wall_ms_per_batch": wall_ms / profiled,
            "idle_share_of_profiled_wall": 1 - busy * profiled / wall_ms,
            "stage_span_ms_per_batch": spans, "port_kernels_ms_per_batch": ours,
            "top_kernels_ms_per_batch": {k[:100]: v for k, v in top},
            "profile_trace_bytes": trace_bytes, "card": card}


class ScriptedOutage:
    """A store whose lookups raise ``ConnectionError`` while its call index
    lies in ``window`` (a host-side wrapper: the failing calls never reach
    the store, so they launch no kernel)."""

    def __init__(self, store, window):
        self.store = store
        self.window = range(*window)
        self.calls = 0

    def __getitem__(self, ids):
        call = self.calls
        self.calls += 1
        if call in self.window:
            raise ConnectionError(f"scripted outage (lookup {call})")
        return self.store[ids]

    def __getattr__(self, name):
        return getattr(self.store, name)


def degraded_phase(args, topo, store, card, window=(5, 10), failures: int = 3,
                   probe_every: int = 4):
    """Degraded serving on the card: lookups ``window`` of the store fail
    (lookup 0 is the server's probe). With ``degraded="zeros"`` and again
    ``"last-good"``: the breaker opens at the ``failures``-th failure (the
    earlier ones fail their batches), every short-circuited batch and
    failed probe is served degraded and counted in
    ``serve.degraded_lookups``, each opening dumps a bundle that passes
    ``verify_bundle``, a probe after the window closes the breaker, and the
    answers after it are bitwise a healthy server's. Every batch samples
    (2 hop launches, replayed by the captured program); K2 launches once per batch whose lookup reaches the
    store."""
    import tempfile

    import numpy as np
    import torch

    from quiver_tpu_torch import FlightRecorder, GraphSAGE, MetricsRegistry, Tracer
    from quiver_tpu_torch.obs.recorder import verify_bundle

    torch.manual_seed(0)
    model = GraphSAGE(store.size(1), 256, 47, num_layers=2)
    nodes = np.random.default_rng(args.seed + 11).integers(0, topo.node_count,
                                                            args.requests)
    healthy = serve_pair(args, topo, store, False, model)
    want = {(r.node, r.seq): r.result for r in closed_loop(healthy, nodes, 8)}
    out = {}
    for fallback in ("zeros", "last-good"):
        reg = MetricsRegistry()
        rec = FlightRecorder(tempfile.mkdtemp(prefix="quiver-pm-"), tracer=Tracer(),
                             metrics=reg)
        server = serve_pair(args, topo, ScriptedOutage(store, window), False, model,
                            degraded=fallback, breaker_failures=failures,
                            probe_every=probe_every, metrics=reg, recorder=rec,
                            tracer=rec.tracer)
        breaker = server.feature.breaker
        sync()
        reset_launches()
        states, failed, done = [], 0, []
        t0 = time.perf_counter()
        for i in range(0, len(nodes), 8):
            for n in nodes[i:i + 8]:
                server.submit(int(n))
            try:
                done.append(server.pump(force=True))
            except ConnectionError:
                failed += 1
                done.append([])
            states.append(breaker.state)
        sync()
        wall = time.perf_counter() - t0
        wrapped, replayed = read_launches(), read_replayed()
        launches = {k: wrapped[k] + replayed[k] for k in ENTRIES}
        batches = len(states)
        # lookups window[0]..: `failures` failures open the breaker; each
        # later outage lookup is a failed probe after probe_every - 1
        # short-circuited batches; the probe after the window closes it
        first_bad = window[0] - 1  # the batch of lookup window[0]
        probes = window[1] - window[0] - failures
        degraded = 1 + probes * probe_every + (probe_every - 1)
        reached = batches - failed - degraded
        stats = server.stats()
        check(failed == failures - 1, f"{fallback}: {failed} failed batches")
        check(stats["degraded_lookups"] == degraded
              and int(reg.value("serve.degraded_lookups")) == degraded
              and int(reg.value("resilience.degraded_lookups")) == degraded,
              f"{fallback}: {stats['degraded_lookups']} degraded lookups, "
              f"expected {degraded}")
        check(states[-1] == "closed" and "open" in states, f"{fallback}: states {states}")
        expect_launches(wrapped, {"tiered_gather": reached},
                        f"degraded serving ({fallback})",
                        replayed={"uniform_hop": 2 * batches})
        bundles = rec.bundles()
        check(len(bundles) == 1 + probes
              and all(m["reason"] == "breaker_open" and m["stage"] == "gather"
                      for _p, m in bundles),
              f"{fallback}: breaker-open bundles {[m['reason'] for _p, m in bundles]}")
        for path, _m in bundles:
            verify_bundle(path)
        recovered = first_bad + failed + degraded
        after = [r for batch in done[recovered:] for r in batch]
        check(after and all(np.array_equal(r.result.view(np.uint8),
                                           want[(r.node, r.seq)].view(np.uint8))
                            for r in after),
              f"{fallback}: answers after recovery == a healthy server's")
        served = [r for batch in done for r in batch]
        check(all(np.isfinite(r.result).all() for r in served), f"{fallback}: finite")
        gather = stats["stages"]["gather"]
        out[fallback] = {"batches": batches, "failed_batches": failed,
                         "degraded_lookups": degraded, "store_lookups": reached,
                         "bundles": len(bundles), "recovered_batches": len(done) - recovered,
                         "launches": launches, "wall_s": wall,
                         "qps": len(served) / wall,
                         "gather_p50_ms": gather["p50_ms"], "gather_max_ms": gather["max_ms"],
                         "states": states}
        log(f"degraded serving ({fallback}): {failed} failed, {degraded} degraded, "
            f"{reached} store lookups of {batches} batches; {len(bundles)} bundles; "
            f"{len(served) / wall:.1f} queries/s")
    return {**out, "window": list(window), "failures": failures,
            "probe_every": probe_every, "card": card}


# -- phase 11: the serving fleet ------------------------------------------------

# queries submitted before each drain of the fleet's queues: least-depth
# routing splits a group between the two replicas, so every replica serves
# every bucket full (16, 8, 4, 2) and the padded ones (14, 6, 13, 5, 3)
FLEET_GROUPS = (16, 14, 8, 6, 4, 2, 1, 13, 5, 3)


def fleet_loop(fleet, nodes, groups=FLEET_GROUPS):
    """Closed loop over a fleet: submit the next group of ``nodes``, drain
    every replica's queue; returns the requests in admission order."""
    reqs, i, g = [], 0, 0
    while i < len(nodes):
        size = groups[g % len(groups)]
        g += 1
        reqs += [fleet.submit(int(node)) for node in nodes[i:i + size]]
        i += size
        while any(srv.batcher.depth for srv in fleet.servers):
            fleet.pump(force=True)
    return reqs


def fleet_batches(fleet) -> int:
    return sum(srv.timeline.stats("sample").count if srv.timeline.stats("sample")
               else 0 for srv in fleet.servers)


def fleet_phase(args, topo, store, x_all, card):
    """Phase 11, the serving fleet, over phase 4's tiered store.

    A 2-replica uniform ``ServingFleet`` with a fresh program cache and a
    ``CacheController``, its sampler over a placement it shares
    (``device_topo``) with the weighted fleet: replica 0 captures the 8
    programs, replica 1 joins with none; ``args.requests`` closed-loop
    queries, every replica serving every bucket full and padded, answer
    bitwise as ``fleet.oracle``, and the sketch counts every valid served
    id. The weighted fleet over the shared placement answers bitwise as a
    server over its own placement. An ``EmbeddingRefresher`` over the full
    graph publishes from its background lane while the fleet serves, equal
    to a foreground refresh of the same version (bitwise expected; within
    1e-5 at worst). Then the version drill: one
    edge inserted through ``CSRTopo._publish_mutation``, every serve path
    and the refresher raise, ``fleet.refresh()`` recaptures on replica 0
    and loads on replica 1, and the answers equal the oracle. Last, the
    replayed fleet's device idle share, as phase 10 measures it, with the
    controller's feed and without it."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from quiver_tpu_torch import (CacheController, EmbeddingRefresher, FreqSketch,
                                  GraphSAGE, GraphSageSampler, InferenceServer,
                                  ServingFleet, VersionMismatchError)

    n = topo.node_count
    torch.manual_seed(0)
    model = GraphSAGE(store.size(1), 256, 47, num_layers=2)
    rng = np.random.default_rng(args.seed + 13)
    placed = topo.to_device("GPU", "cuda", with_weights=True)
    ctl = CacheController(FreqSketch(n, 256, top_k=1024))
    sampler = GraphSageSampler(topo, [5, 5], device="cuda", seed=0,
                               device_topo=placed)
    cache_dir = tempfile.mkdtemp(prefix="quiver-aot-")
    out = {"config": "2 replicas, max_batch 8, [5, 5], tiered store "
                     f"({store.hot_rows} hot rows), one shared placement"}

    # joins: replica 0 captures, replica 1 takes its programs
    sync()
    reset_launches()
    fleet = ServingFleet(sampler, model, store, replicas=2, aot_cache=cache_dir,
                         controller=ctl, seed=0, max_batch=8, device="cuda")
    sync()
    joins = [dict(c) for c in fleet.cold_starts]
    check([(c["loaded"], c["compiled"]) for c in joins] == [(0, 8), (8, 0)],
          f"joins {joins}")
    check(fleet.recompiles == 8 and fleet.aot_loads == 8 and len(fleet.aot_cache) == 8,
          f"fleet counters {fleet.stats()['aot_cache']}")
    progs = [srv.ladder.programs() for srv in fleet.servers]
    check(all(a is b and a.graph is not None for a, b in zip(*progs)),
          "replica 1 replays replica 0's captured programs")
    # a store probe per replica; replica 0's 4 sample programs run their 2
    # hops eagerly and under capture
    expect_launches(read_launches(), {"uniform_hop": 16, "tiered_gather": 2},
                    "fleet joins")
    out["joins"] = joins
    out["capture_ms"] = [p.build_s * 1e3 for p in progs[0]]
    log(f"fleet joins: replica 0 {joins[0]['seconds']:.3f} s ({joins[0]['compiled']} "
        f"captures), replica 1 {joins[1]['seconds']:.3f} s ({joins[1]['loaded']} "
        f"loaded, 0 captures); capture ms per program "
        f"{[round(m, 1) for m in out['capture_ms']]}")

    # closed loop: every bucket full and padded on both replicas
    seen = collections.Counter()
    for srv in fleet.servers:
        def counted(reqs, bucket, inner=srv._run_batch, idx=srv.replica_index):
            seen[(idx, bucket, "full" if len(reqs) == bucket else "padded")] += 1
            return inner(reqs, bucket)
        srv._run_batch = counted
    nodes = rng.integers(0, n, args.requests)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    reqs = fleet_loop(fleet, nodes)
    sync()
    wall = time.perf_counter() - t0
    batches = fleet_batches(fleet)
    wrapped, replayed = read_launches(), read_replayed()
    expect_launches(wrapped, {"tiered_gather": batches}, "fleet serving",
                    replayed={"uniform_hop": 2 * batches})
    for srv in fleet.servers:
        del srv._run_batch
    want_seen = {(i, b, f) for i in (0, 1) for b, f in
                 ((1, "full"), (2, "full"), (4, "full"), (8, "full"),
                  (4, "padded"), (8, "padded"))}
    check(want_seen <= set(seen), f"buckets served {sorted(seen)}")
    check(len(reqs) == len(nodes) and all(r.done and not r.shed for r in reqs),
          "every fleet request answered")
    sync()
    reset_launches()
    valid = 0
    for r in reqs:
        check(np.array_equal(r.result, fleet.oracle(r.node, r.seq)),
              f"fleet answer == oracle bitwise ({r.node}, {r.seq})")
        n_id, _eis, _ovf = fleet.servers[0].ladder.oracle_sample(r.node, r.seq)
        valid += int((n_id >= 0).sum())
    expect_launches(read_launches(), {"select": 2 * 2 * len(reqs),
                                      "tiered_gather": len(reqs)}, "fleet oracle")
    check(ctl.sketch.observed == valid, f"sketch observed {ctl.sketch.observed} "
          f"of {valid} valid served ids")
    stats = fleet.stats()
    out["serve"] = {
        "queries": len(reqs), "batches": batches, "qps": len(reqs) / wall,
        "wall_s": wall, "buckets_served": {f"{i}/{b}/{f}": c
                                           for (i, b, f), c in sorted(seen.items())},
        "launches": {"wrapper_calls": wrapped, "replayed": replayed},
        "sketch_observed": ctl.sketch.observed,
        "stages": [{k: {"p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
                    for k, v in p["stages"].items()} for p in stats["per_replica"]],
        "recompiles": stats["recompiles"], "aot_loads": stats["aot_loads"]}
    log(f"fleet served {len(reqs)} queries in {wall:.3f} s "
        f"({len(reqs) / wall:.1f} queries/s, {batches} batches); == oracle bitwise; "
        f"sketch observed {valid} ids")

    # the weighted fleet over the shared placement against its own placement
    wsampler = GraphSageSampler(topo, [5, 5], device="cuda", seed=0, weighted=True,
                                device_topo=placed)
    check(wsampler.topo is sampler.topo, "the samplers share one placement")
    wfleet = ServingFleet(wsampler, model, store, replicas=2, aot_cache=cache_dir,
                          seed=0, max_batch=8, device="cuda")
    check([(c["loaded"], c["compiled"]) for c in wfleet.cold_starts] == [(0, 8), (8, 0)],
          f"weighted joins {wfleet.cold_starts}")
    own = InferenceServer(GraphSageSampler(topo, [5, 5], device="cuda", seed=0,
                                           weighted=True), model, store,
                          device="cuda", max_batch=8, seed=0)
    wnodes = rng.integers(0, n, 64)
    sync()
    reset_launches()
    got = fleet_loop(wfleet, wnodes)
    wb = fleet_batches(wfleet)
    expect_launches(read_launches(), {"tiered_gather": wb}, "weighted fleet serving",
                    replayed={"weighted_hop": 2 * wb})
    for r in got:
        check(np.array_equal(r.result, own.oracle(r.node, r.seq)),
              "shared-placement answer == own-placement oracle bitwise")
    for r in own.serve(wnodes):
        check(np.array_equal(r.result, wfleet.oracle(r.node, r.seq)),
              "own-placement answer == shared-placement oracle bitwise")
    out["weighted"] = {"queries": len(got), "batches": wb,
                       "joins": [dict(c) for c in wfleet.cold_starts]}
    del own

    # the refresher over the full graph: background lane while the fleet serves
    x_dev = torch.from_numpy(x_all).to("cuda")
    bg = EmbeddingRefresher(model, topo, x_dev, device="cuda")
    sync()
    t0 = time.perf_counter()
    bg.start(interval_s=0.05)
    during = fleet_loop(fleet, rng.integers(0, n, 64))
    while bg.version is None and time.perf_counter() - t0 < 300:
        time.sleep(0.01)
    bg.stop()
    bg_s = time.perf_counter() - t0
    check(bg.version == topo.version and bg.refreshes == 1 and bg._thread is None,
          f"background lane published version {bg.version} and joined")
    for r in during[:16]:
        check(np.array_equal(r.result, fleet.oracle(r.node, r.seq)),
              "answers while the lane runs == oracle bitwise")
    fg = EmbeddingRefresher(model, topo, x_dev, device="cuda")
    sync()
    t0 = time.perf_counter()
    fg.refresh()
    sync()
    fg_s = time.perf_counter() - t0
    check(fg.table.shape == (n, 47) and bool(torch.isfinite(fg.table).all()),
          "refresher table shape and finite")
    # the layer-wise path is deterministic on the card (a sorted accumulate,
    # the same GEMMs), so the tables should agree bitwise; the stated
    # tolerance (tests/test_torch_inference.py's) is the floor
    bitwise = bool(torch.equal(bg.table, fg.table))
    err = float((bg.table - fg.table).abs().max())
    check(bitwise or bool(torch.allclose(bg.table, fg.table, atol=1e-5, rtol=1e-5)),
          f"background table == foreground table (max abs err {err})")
    ids = torch.from_numpy(rng.integers(0, n, 1000))
    check(torch.equal(bg.lookup(ids), bg.table[ids.to("cuda")]), "refresher lookup")
    out["refresher"] = {"foreground_s": fg_s, "background_with_serving_s": bg_s,
                        "served_while_refreshing": len(during), "bitwise": bitwise,
                        "max_abs_err": err}
    log(f"refresher: full graph in {fg_s:.3f} s (foreground); background lane "
        f"published in {bg_s:.3f} s while the fleet served {len(during)} queries")
    del x_dev

    # the version drill: one edge inserted through the mutation seam
    indptr = topo.indptr.astype(np.int64)
    u = int(np.argmax(np.diff(indptr) > 0))
    row = set(topo.indices[indptr[u]:indptr[u + 1]].tolist())
    v = next(c for c in range(n) if c not in row)
    at = int(indptr[u + 1])
    new_indptr = indptr.copy()
    new_indptr[u + 1:] += 1
    t0 = time.perf_counter()
    topo._publish_mutation(new_indptr, np.insert(topo.indices, at, v),
                           edge_weight=np.insert(topo.edge_weight, at, 1.0))
    publish_s = time.perf_counter() - t0
    check(topo.version == 1 and topo.edge_count == len(topo.indices), "published")
    stale = {"fleet.pump": lambda: fleet.pump(force=True),
             "replica 1 pump": lambda: fleet.servers[1].pump(force=True),
             "fleet.oracle": lambda: fleet.oracle(1, 0),
             "weighted fleet": wfleet.check_version,
             "sampler.sample": lambda: sampler.sample(np.arange(4)),
             "refresher lookup": lambda: bg.lookup([0])}
    for what, fn in stale.items():
        try:
            fn()
            raised = False
        except VersionMismatchError:
            raised = True
        check(raised, f"{what} raises after the mutation")
    sync()
    reset_launches()
    t0 = time.perf_counter()
    fleet.refresh()
    sync()
    refresh_s = time.perf_counter() - t0
    r0, r1 = fleet.servers
    check(r0.recompiles == 16 and r0.aot_loads == 0 and r1.recompiles == 0
          and r1.aot_loads == 16, f"refresh: replica 0 recaptures, replica 1 loads "
          f"({r0.recompiles}, {r0.aot_loads}, {r1.recompiles}, {r1.aot_loads})")
    expect_launches(read_launches(), {"uniform_hop": 16}, "fleet refresh")
    after = fleet_loop(fleet, rng.integers(0, n, 64))
    for r in after:
        check(np.array_equal(r.result, fleet.oracle(r.node, r.seq)),
              "answers after the refresh == oracle bitwise")
    out["drill"] = {"inserted": [u, v], "publish_s": publish_s, "refresh_s": refresh_s,
                    "stale_paths_raised": sorted(stale), "answers_after": len(after)}
    log(f"version drill: publish {publish_s:.2f} s, fleet refresh {refresh_s:.3f} s "
        f"(replica 0 recaptured 8, replica 1 loaded 8)")

    # the replayed fleet's idle share, batches of 8 on each replica, with
    # the controller's feed and without it (its host cost)
    idle_nodes = rng.integers(0, n, args.requests)
    for label in ("idle", "idle_no_controller"):
        if label == "idle_no_controller":
            for srv in fleet.servers:
                srv.controller = None
        out[label] = idle_share(lambda: fleet_loop(fleet, idle_nodes, (16,)),
                                lambda: fleet_batches(fleet), len(idle_nodes), card)
        what = "with" if label == "idle" else "without"
        log(f"fleet idle share {what} the controller {out[label]['idle_share']:.4f}: "
            f"busy {out[label]['device_busy_ms_per_batch']:.4f} ms of a "
            f"{out[label]['batch_ms_unprofiled']:.4f} ms batch")
    out["card"] = card
    return out


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
    # kernel="xla", the composed path: one K1 select (or K3 wselect) launch
    # per hop and no fused one, the invariants above, and bitwise a fused
    # sampler's samples from the same seed
    seeds = rng.integers(0, n, batch)
    paths = {}
    for kernel in ("pallas", "xla"):
        fresh = GraphSageSampler(topo, list(sizes), device="cuda", seed=3,
                                 seed_capacity=batch, weighted=weighted, kernel=kernel)
        sync()
        reset_launches()
        paths[kernel] = fresh.sample(seeds)
        sync()
        composed = "wselect" if weighted else "select"
        expect_launches(read_launches(), {hop if kernel == "pallas" else composed: len(sizes)},
                        f"kernel={kernel!r} sampler")
    xla_checked = verify_sample(paths["xla"], sizes, indptr, deg, member)
    check(equal(paths["xla"].n_id, paths["pallas"].n_id) and all(
        equal(a.edge_index, b.edge_index)
        for a, b in zip(paths["xla"].adjs, paths["pallas"].adjs)),
          "kernel='xla' sampler == kernel='pallas' sampler, bitwise")
    return {"sampler": "weighted" if weighted else "uniform",
            "sizes": list(sizes), "batch": batch, "batches": batches,
            "edges": total, "seconds": dt, "edges_per_s": total / dt,
            "batch_ms": 1e3 * dt / batches, "launches": launches,
            "edges_checked": checked, "xla_sampler_edges_checked": xla_checked,
            "card": card}


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


def step_parity(model, x, adjs, labels, mask, what: str) -> dict:
    """One train step of ``model`` (host parameters, dropout 0) on the card
    against the same step on the CPU: the same parameters, x (a tensor or a
    dict of them), Adjs or hetero layers, labels and mask; TF32 is off for
    the whole smoke. The loss within 1e-5 relative, each gradient within
    1e-4 x its max |g|."""
    import copy

    cpu_model = copy.deepcopy(model)
    loss_g, grads_g = step_grads(model.to("cuda"), x, adjs, labels, mask)
    x_cpu = {t: v.cpu() for t, v in x.items()} if isinstance(x, dict) else x.cpu()
    loss_c, grads_c = step_grads(cpu_model, x_cpu, [a.to("cpu") for a in adjs],
                                 labels.cpu(), mask.cpu())
    rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = [float((g - c).abs().max()) / float(c.abs().max())
                for g, c in zip(grads_g, grads_c)]
    check(rel <= 1e-5, f"{what} parity: loss {loss_g} (card) vs {loss_c} (CPU)")
    check(max(grad_err) <= 1e-4, f"{what} parity: gradient errors / max |g| {grad_err}")
    return {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": rel,
            "grad_err_over_max": grad_err, "max_grad_err_over_max": max(grad_err),
            "tolerance": "loss 1e-5 relative; each gradient 1e-4 x max |g|"}


def train_parity(run, seeds):
    """Phase 8's card-vs-CPU step (:func:`step_parity`) on one full-width
    batch, from ``init_model`` parameters with dropout 0."""
    from examples.train_sage_torch import batch_inputs
    from quiver_tpu_torch import GraphSAGE
    from quiver_tpu_torch.parallel.train import init_model

    import torch

    out, x, labels, mask = batch_inputs(run, seeds)
    model = GraphSAGE(x.shape[1], 256, run.ds.num_classes, num_layers=2,
                      dropout=0.0)
    init_model(model, torch.Generator().manual_seed(1))
    t0 = time.time()
    result = step_parity(model, x, out.adjs, labels, mask, "train")
    return {**result, "rows": int(x.shape[0]), "seconds": time.time() - t0}


def annotation(e) -> bool:
    """Whether a profiled device row is the span of a ``record_function``
    annotation (the step's stages, the optimizer's ``Optimizer.step#...``)
    rather than a kernel or copy."""
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("train:")


def device_ms(prof, steps: int) -> tuple[dict, dict]:
    """Device time per step in ms of every profiled CUDA row: ``(kernels
    and copies, annotations' spans)``."""
    import torch

    kernels, spans = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            (spans if annotation(e) else kernels)[e.key] = \
                e.self_device_time_total / 1e3 / steps
    return kernels, spans


def device_union_ms(prof, steps: int) -> float:
    """Device time per step in ms during which at least one kernel or copy
    ran, on any stream (kernels that overlap on two streams count once)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not annotation(e))
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 / steps


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
    kernels, spans = device_ms(prof, PROFILED_STEPS)
    spans = {k: ms for k, ms in spans.items() if k.startswith("train:")}
    busy = sum(kernels.values())
    check(busy > 0 and len(spans) == 3, f"the profiler saw the card: spans {spans}")
    ours = {name: sum(ms for key, ms in kernels.items() if name in key)
            for name in ("uniform_hop_kernel", "gather_kernel", "gather_dequant_kernel")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    log(f"train profile: device busy {busy:.3f} ms per step of {median_step_ms:.3f}; "
        f"stage spans {spans}")
    return {"steps": PROFILED_STEPS, "device_busy_ms_per_step": busy,
            "median_step_ms": median_step_ms,
            "idle_share": 1 - busy / median_step_ms,
            "stage_span_ms_per_step": spans, "port_kernels_ms_per_step": ours,
            "top_kernels_ms_per_step": {k[:100]: v for k, v in top}}


def profiled_idle(run_steps, steps: int, step_ms: float, names=()) -> dict:
    """``steps`` more steps under ``torch.profiler``: busy is the union of
    the device intervals, the idle share is against ``step_ms`` (the
    unprofiled run's), and the kernels whose names hold one of ``names``
    are summed apart, as phase 9b reads them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps()
        sync()
    kernels, _spans = device_ms(prof, steps)
    busy = device_union_ms(prof, steps)
    check(busy > 0, "the profiler saw the card")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "device_busy_ms_per_step": busy,
            "device_summed_ms_per_step": sum(kernels.values()),
            "idle_share": 1 - busy / step_ms, "step_ms": step_ms,
            "port_kernels_ms_per_step": {n: sum(ms for k, ms in kernels.items() if n in k)
                                         for n in names},
            "top_kernels_ms_per_step": {k[:100]: v for k, v in top}}


def train_phase(card, pcie_bytes_per_s, steps: int = 20, int8: bool = False,
                budget=None, parity: bool = True):
    """The twin's default configuration (``examples/train_sage_torch.py``):
    the Reddit-scale synthetic graph, F=602 f32, 41 classes, GraphSAGE 256
    x 2, fanouts [25, 10], batch 1024, a 20% degree-ordered cache on the
    card and the rest pinned on the host, auto caps, Adam at 0.01; with
    ``int8`` the store holds int8 codes (``--int8``), under ``budget``
    bytes when given. One warm-up step, then ``steps`` timed steps, each
    stage ending in a synchronise; exact launches; K2's lookup of one
    step's ids in turns with the staged lookup in stock torch ops; then
    (with ``parity``) card-vs-CPU step parity. K2's lookup is held to
    GATHER_BOUND_RULE with the pinned-host rate ``pcie_bytes_per_s``
    measured in phase 3."""
    import math

    import numpy as np
    import torch

    from torch.profiler import record_function

    from examples.train_sage_torch import parse_args, setup
    from quiver_tpu_torch.ops.sample import seeded_generator

    args = parse_args(["--device", "cuda"] + (["--int8"] if int8 else []))
    lookup = "tiered_gather_dequant" if int8 else "tiered_gather"
    t0 = time.time()
    reset_launches()
    run = setup(args, budget=budget)  # its first sample plans the auto caps
    sync()
    setup_s = time.time() - t0
    plan_launches, plan_reruns = read_launches(), run.sampler.reruns
    expect_launches(plan_launches, {"uniform_hop": 2 * (1 + plan_reruns)},
                    "train: the planning call")
    worst = run.sampler._worst_caps(args.batch)
    caps = run.sampler._frontier_caps
    log(f"train{' int8' if int8 else ''} set-up {setup_s:.1f}s; "
        f"{run.feature.hot_rows} hot rows; auto caps {caps} (worst case "
        f"{worst}), {plan_reruns} reruns")

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
    losses, edges, cold, k2_bound, cold_bytes = [], 0, [], [], []
    for n_id, edge_counts, loss in kept:
        losses.append(float(loss))
        edges += int(torch.stack(list(edge_counts)).sum())
        nv, nc, dev_bytes, cb = lookup_bytes(run.feature, n_id)
        cold.append((nv, nc))
        cold_bytes.append(cb)
        k2_bound.append(1e3 * max(dev_bytes / HBM_BYTES_PER_S, cb / pcie_bytes_per_s))
    last_n_id = kept[-1][0]
    del kept
    for i, r in enumerate(rows, 1):
        log(f"train step {i:02d}: sample {r['sample_ms']:.3f} ms, gather "
            f"{r['gather_ms']:.3f} ms, train step {r['train_step_ms']:.3f} ms, "
            f"loss {losses[i - 1]:.4f}")
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    expect_launches(launches, {"uniform_hop": 2 * (steps + reruns), lookup: steps},
                    f"train: {steps} steps ({reruns} reruns)")
    step_s = sum(sum(r.values()) for r in rows) / 1e3
    stage = {k: statistics.median(r[k] for r in rows)
             for k in ("sample_ms", "gather_ms", "train_step_ms")}
    prof = profile_steps(step, batches, steps + 1,
                         statistics.median(sum(r.values()) for r in rows))
    k2_ms = prof["port_kernels_ms_per_step"][
        "gather_dequant_kernel" if int8 else "gather_kernel"]
    # K2 and the staged lookup in stock torch ops on the last timed step's ids
    yard = time_lookup(run.feature, last_n_id.to(torch.int32), pcie_bytes_per_s, 10, 5)
    log(f"train lookup ({lookup}): {yard['ms']:.3f} ms, staged lookup in torch "
        f"ops {yard['yard_ms']:.3f} ms, bound {yard['bound_ms']:.3f} ms")
    result = {
        "config": "examples/train_sage_torch.py defaults: synthetic "
                  "generate_pareto_graph(232965, 100, seed=0), F=602 f32, 41 "
                  "classes, hidden 256, 2 layers, fanouts [25, 10], batch 1024, "
                  "cache 20%, auto caps, Adam 0.01"
                  + (", stored as int8 (--int8)" if int8 else "")
                  + (f", budget {budget} B" if budget is not None else ""),
        "storage": str(run.feature.dtype), "budget_bytes": run.feature.cache_budget,
        "nodes": run.topo.node_count, "edges": run.topo.edge_count,
        "feature_dim": run.feature.shape[1],
        "hot_rows": run.feature.hot_rows, "setup_s": setup_s,
        "caps": list(caps), "worst_caps": list(worst),
        "planning_reruns": plan_reruns, "planning_launches": plan_launches,
        "steps": steps, "reruns": reruns, "launches": launches,
        "wall_s": wall, "steps_per_s": steps / wall,
        "step_stage_sum_s": step_s, "sampled_edges": edges,
        "edges_per_s": edges / wall, "peak_bytes": peak,
        "median_ms": stage, "per_step": rows, "losses": losses,
        "valid_rows_and_cold_rows": cold, "profile": prof,
        "k2_device_ms_per_step": k2_ms,
        "cold_rows_per_step": statistics.median(c for _, c in cold),
        "cold_bytes_per_step": statistics.median(cold_bytes),
        "tiered_gather_bound_ms": statistics.median(k2_bound),
        "tiered_gather_bound_share": statistics.median(k2_bound) / k2_ms,
        "pcie_h2d_bytes_per_s": pcie_bytes_per_s,
        "cold_row_share": sum(c for _, c in cold) / sum(v for v, _ in cold),
        "lookup_in_turns": yard, "card": card}
    if parity:
        result["parity"] = train_parity(run, batches[steps + 1 + PROFILED_STEPS])
    log(f"train{' int8' if int8 else ''}: {steps / wall:.4g} steps/s, {edges / wall:.4g} "
        f"sampled edges/s, peak {peak / 2**30:.3f} GiB; medians {stage}; K2 "
        f"{k2_ms:.3f} ms per step")
    return launches, result


def acceptance_phase(card):
    """The twin's acceptance run on the card: ``--dataset planted:20000
    --epochs 4`` with its other defaults, sampled evaluation and then
    layer-wise, then sampled over an int8 store (``--int8``, every lookup
    K2's dequantising entry); each test accuracy must clear feature-only
    Bayes + 0.15."""
    from examples.train_sage_torch import main

    runs = {}
    for label, extra in (("sampled", ["--eval", "sampled"]),
                         ("layerwise", ["--eval", "layerwise"]),
                         ("int8_sampled", ["--eval", "sampled", "--int8"])):
        t0 = time.time()
        reset_launches()
        acc, ds = main(["--dataset", "planted:20000", "--epochs", "4",
                        "--device", "cuda"] + extra)
        sync()
        launches = read_launches()
        lookup = "tiered_gather_dequant" if "--int8" in extra else "tiered_gather"
        check(launches[lookup] > 0, f"planted:20000 {label}: {lookup} launched")
        bayes = ds.meta["feature_bayes_acc"]
        check(acc >= bayes + 0.15,
              f"planted:20000 {label}: test acc {acc} < feature-only Bayes "
              f"{bayes} + 0.15")
        runs[label] = {"test_acc": acc, "feature_bayes_acc": bayes,
                       "seconds": time.time() - t0, "launches": launches}
    return {"dataset": "planted:20000", "epochs": 4, **runs, "card": card}


# -- phase 9b: the training epoch's host loop, the other families ------------

EPOCH_FAMILIES = ("sage", "gcn", "gin", "gat")
EPOCH_FANOUT = [15, 10, 5]  # benchmarks/bench_epoch.py:44-57, 104-109
EPOCH_BATCH, EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, EPOCH_HEADS = 1024, 100, 256, 47, 4
EPOCH_ITERS, EPOCH_WARMUP = 40, 3
BITWISE_BATCHES = 3  # prefetched against serial batches, per family
# layer-wise inference at benchmarks/bench_infer.py's defaults (2 layers)
# with the family's default chunk; GAT walks the edges twice per layer
INFER_SWEEPS = {"gcn": 1, "gin": 1, "gat": 2}


def make_family(family, in_channels, hidden, classes, layers, dropout=0.5):
    """A port model of ``family`` (``benchmarks/common.py:677-710``'s
    dispatch), initialised from generator seed 0 on the host."""
    import torch

    from quiver_tpu_torch.models import GAT, GCN, GIN, GraphSAGE
    from quiver_tpu_torch.parallel.train import init_model

    if family == "gat":
        model = GAT(in_channels, hidden, classes, num_layers=layers,
                    heads=EPOCH_HEADS, dropout=dropout)
    else:
        model = {"sage": GraphSAGE, "gcn": GCN, "gin": GIN}[family](
            in_channels, hidden, classes, num_layers=layers, dropout=dropout)
    return init_model(model, torch.Generator().manual_seed(0))


def trimmed_mean(times) -> float:
    """10%-trimmed mean (``benchmarks/common.py`` ``trimmed_mean``)."""
    times = sorted(times)
    k = max(1, len(times) // 10)
    if len(times) > 2 * k:
        times = times[k:-k]
    return sum(times) / len(times)


def host_copy(tree):
    """A state tree with every tensor copied to the host."""
    import torch

    if isinstance(tree, dict):
        return type(tree)((k, host_copy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def same_tree(a, b) -> bool:
    """Bitwise equality of two host state trees."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str)
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and equal(a, b)
    return type(a) is type(b) and a == b


def epoch_family(family, topo, feat, labels_all, card):
    """``benchmarks/bench_epoch.py``'s host loop for one ``--model``: the
    planning call and 3 warm-up iterations, then (a) ``--prefetch 0``, 40
    serial iterations, each stage ending in a synchronise (10%-trimmed
    mean per iteration, stage medians); (b) ``--prefetch 2``, 40
    iterations through a ``Prefetcher`` at depth 2 (wall / iterations),
    its sample and lookup on the worker's own CUDA stream; 5 prefetched
    steps under ``torch.profiler`` (device time, idle share); then the
    prefetched batches against the serial loop's from two freshly seeded
    samplers, bitwise. Exactly 3 ``uniform_hop`` and 1 ``tiered_gather``
    launches per iteration (3 more per regrowth rerun, counted apart), in
    (b) all from the worker thread."""
    import math
    import threading

    import numpy as np
    import torch

    from quiver_tpu_torch import Batch, GraphSageSampler, Prefetcher
    from quiver_tpu_torch.ops.sample import seeded_generator
    from quiver_tpu_torch.parallel.train import make_train_step

    n = topo.node_count

    def fresh_sampler():
        return GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", mode="HBM",
                                seed_capacity=EPOCH_BATCH, seed=0,
                                frontier_caps="auto")

    t0 = time.time()
    sampler = fresh_sampler()
    model = make_family(family, EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES,
                        len(EPOCH_FANOUT)).to("cuda")
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    rng = np.random.default_rng(1)  # bench_epoch: seed + 1

    def labels_of(out):
        seed_ids = out.n_id[:EPOCH_BATCH]
        return labels_all[seed_ids.clamp(min=0)], seed_ids >= 0

    def train(batch_x, out, i):
        labels, mask = labels_of(out)
        return step(batch_x, out.adjs, labels, mask,
                    seeded_generator("cuda", 0, 100 + i))

    def iteration(i):
        seeds = rng.integers(0, n, EPOCH_BATCH)
        a = time.perf_counter()
        out = sampler.sample(seeds)
        sync()
        b = time.perf_counter()
        x = feat[out.n_id]
        sync()
        c = time.perf_counter()
        loss = train(x, out, i)
        sync()
        return out, loss, (b - a, c - b, time.perf_counter() - c)

    out0 = sampler.sample(rng.integers(0, n, EPOCH_BATCH))  # plans the caps
    feat[out0.n_id]
    del out0
    for i in range(EPOCH_WARMUP):
        iteration(i)
    sync()
    setup_s = time.time() - t0

    def edges_of(counts) -> int:
        return int(torch.stack([torch.stack(list(c)) for c in counts]).sum())

    def profiled(run_steps, step_ms: float) -> dict:
        """Device time of ``PROFILED_STEPS`` more steps
        (:func:`profiled_idle`); K1 and K2 summed by kernel name."""
        r = profiled_idle(run_steps, PROFILED_STEPS, step_ms,
                          ("gather_kernel", "uniform_hop_kernel"))
        ours = r.pop("port_kernels_ms_per_step")
        return {**r, "k2_device_ms_per_step": ours["gather_kernel"],
                "k1_device_ms_per_step": ours["uniform_hop_kernel"]}

    # (a) --prefetch 0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reruns0 = sampler.reruns
    rows, losses, counts = [], [], []
    for i in range(EPOCH_ITERS):
        out, loss, stages = iteration(i)
        rows.append(stages)
        losses.append(loss)
        counts.append(out.edge_counts)
    reruns_a = sampler.reruns - reruns0
    expect_launches(read_launches(), {"uniform_hop": 3 * (EPOCH_ITERS + reruns_a),
                                      "tiered_gather": EPOCH_ITERS},
                    f"epoch {family} --prefetch 0 ({reruns_a} reruns)")
    iter_a = trimmed_mean([sum(r) for r in rows])
    serial = {"iter_ms_trimmed_mean": iter_a * 1e3, "steps_per_s": 1 / iter_a,
              "edges_per_s": edges_of(counts) / len(counts) / iter_a,
              "reruns": reruns_a,
              "median_ms": {k: statistics.median(r[j] for r in rows) * 1e3
                            for j, k in enumerate(("sample", "gather", "train_step"))},
              "peak_bytes": torch.cuda.max_memory_allocated()}
    serial.update(profiled(lambda: [iteration(EPOCH_ITERS + k)
                                    for k in range(PROFILED_STEPS)],
                           serial["iter_ms_trimmed_mean"]))

    # (b) --prefetch 2
    threads = set()

    def on_worker(seeds, out, x):
        threads.add(threading.current_thread().name)
        return Batch(seeds, out, x)

    stream = [rng.integers(0, n, EPOCH_BATCH) for _ in range(EPOCH_ITERS)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reruns0 = sampler.reruns
    counts = []
    sync()
    ends = [time.perf_counter()]
    for i, batch in enumerate(Prefetcher(sampler, feat, depth=2,
                                         transform=on_worker).run(stream)):
        losses.append(train(batch.x, batch.out, EPOCH_ITERS + i))
        counts.append(batch.out.edge_counts)
        ends.append(time.perf_counter())
    sync()
    iter_b = (time.perf_counter() - ends[0]) / EPOCH_ITERS
    reruns_b = sampler.reruns - reruns0
    launches_b = read_launches()
    expect_launches(launches_b, {"uniform_hop": 3 * (EPOCH_ITERS + reruns_b),
                                 "tiered_gather": EPOCH_ITERS},
                    f"epoch {family} --prefetch 2 ({reruns_b} reruns)")
    check(len(counts) == EPOCH_ITERS and threads
          and all(t.startswith("quiver-prefetch") for t in threads),
          f"epoch {family}: every dispatch on the prefetch worker ({threads})")
    prefetched = {"iter_ms": iter_b * 1e3, "steps_per_s": 1 / iter_b,
                  "host_iter_ms_median": statistics.median(
                      b - a for a, b in zip(ends, ends[1:])) * 1e3,
                  "edges_per_s": edges_of(counts) / len(counts) / iter_b,
                  "reruns": reruns_b, "peak_bytes": torch.cuda.max_memory_allocated()}
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"epoch {family}: finite losses")
    stream = [rng.integers(0, n, EPOCH_BATCH) for _ in range(PROFILED_STEPS)]
    prefetched.update(profiled(
        lambda: [train(batch.x, batch.out, 2 * EPOCH_ITERS + i) for i, batch in
                 enumerate(Prefetcher(sampler, feat, depth=2).run(stream))],
        prefetched["iter_ms"]))

    # bitwise: the prefetched stream against the serial loop, each from a
    # freshly seeded sampler, the train step running on every batch
    seeds = [np.random.default_rng(50 + i).integers(0, n, EPOCH_BATCH)
             for i in range(BITWISE_BATCHES)]
    plain = fresh_sampler()
    want = []
    for s in seeds:
        out = plain.sample(s)
        want.append((out.n_id, [a.edge_index for a in out.adjs], feat[out.n_id]))
    del plain
    same = []
    for i, (batch, (n_id, eis, x)) in enumerate(zip(
            Prefetcher(fresh_sampler(), feat, depth=2).run(seeds), want)):
        train(batch.x, batch.out, 3 * EPOCH_ITERS + i)
        same.append(equal(batch.out.n_id, n_id) and equal(batch.x, x)
                    and all(equal(a.edge_index, e)
                            for a, e in zip(batch.out.adjs, eis)))
    check(len(same) == BITWISE_BATCHES and all(same),
          f"epoch {family}: prefetched batches bitwise the serial loop's {same}")
    del want
    result = {"family": family, "setup_s": setup_s, "caps": list(sampler._frontier_caps),
              "prefetch_0": serial, "prefetch_2": prefetched,
              "launches_per_iteration": {"uniform_hop": 3, "tiered_gather": 1},
              "launches_prefetch_2": launches_b,
              "losses_first_last": [losses[0], losses[-1]],
              "bitwise_batches": BITWISE_BATCHES, "card": card}
    log(f"epoch {family} --prefetch 0: stage medians "
        f"{ {k: round(v, 3) for k, v in serial['median_ms'].items()} } ms [{card}]")
    for mode, r in (("--prefetch 0", serial), ("--prefetch 2", prefetched)):
        log(f"epoch {family} {mode}: {r['steps_per_s']:.4g} steps/s [{card}]")
        log(f"epoch {family} {mode}: {r['edges_per_s']:.4g} sampled edges/s [{card}]")
        log(f"epoch {family} {mode}: peak device memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB [{card}]")
        log(f"epoch {family} {mode}: idle share {r['idle_share']:.4f} (device busy "
            f"{r['device_busy_ms_per_step']:.3f} ms, kernels summed over the streams "
            f"{r['device_summed_ms_per_step']:.3f} ms, K2 "
            f"{r['k2_device_ms_per_step']:.3f} ms) [{card}]")
    return result


def family_parity(family, topo, feat, labels_all):
    """One train step of ``family`` on the card against the CPU's
    (:func:`step_parity`) on one batch at fanouts [15, 10, 5] x 64."""
    import numpy as np

    from quiver_tpu_torch import GraphSageSampler

    sampler = GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", seed_capacity=64,
                               seed=5)
    out = sampler.sample(np.random.default_rng(7).integers(0, topo.node_count, 64))
    x = feat[out.n_id]
    seed_ids = out.n_id[:64]
    labels, mask = labels_all[seed_ids.clamp(min=0)], seed_ids >= 0
    model = make_family(family, EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES,
                        len(EPOCH_FANOUT), dropout=0.0)
    return {**step_parity(model, x, out.adjs, labels, mask, family),
            "rows": int(x.shape[0])}


def layerwise_families(topo, x_feat, card):
    """``benchmarks/bench_infer.py``'s defaults for GCN, GIN and GAT (2
    layers, hidden 256, 47 classes, GAT heads 4, the family's default
    chunk, HBM): one warm-up pass, then one timed pass over the products
    graph (nodes/s, finite log-probs); then on ``small_graphs()`` (chunks
    of 65,536 edges) the card's log-probs against the CPU's, within 1e-5
    x max |out|."""
    import copy

    import numpy as np
    import torch

    from quiver_tpu_torch.models import inference

    n, E = topo.node_count, topo.edge_count
    x_dev = torch.from_numpy(x_feat).to("cuda")
    smalls = [(label, t) for label, t, *_ in small_graphs()]
    out = {}
    for family in ("gcn", "gin", "gat"):
        infer = getattr(inference, f"{family}_layerwise_inference")
        model = make_family(family, EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, 2,
                            dropout=0.0)
        cpu_model = copy.deepcopy(model)
        model.to("cuda")
        infer(model, topo, x_dev, device="cuda")  # warm-up
        sync()
        t0 = time.perf_counter()
        logp = infer(model, topo, x_dev, device="cuda")
        sync()
        dt = time.perf_counter() - t0
        check(logp.shape == (n, EPOCH_CLASSES) and bool(torch.isfinite(logp).all()),
              f"layer-wise {family}: finite ({n}, {EPOCH_CLASSES}) log-probs")
        del logp
        errs = {}
        for label, st in smalls:
            xs = np.random.default_rng(3).normal(size=(st.node_count, EPOCH_F)).astype(
                np.float32)
            got = infer(model, st, torch.from_numpy(xs).to("cuda"), chunk=65_536,
                        device="cuda").cpu()
            want = infer(cpu_model, st, torch.from_numpy(xs), chunk=65_536, device="cpu")
            errs[label] = float((got - want).abs().max()) / float(want.abs().max())
        check(max(errs.values()) <= 1e-5,
              f"layer-wise {family}: card against CPU, error / max |out| {errs}")
        out[family] = {"pass_s": dt, "nodes_per_s": n / dt,
                       "edges_per_s": INFER_SWEEPS[family] * 2 * E / dt,
                       "small_graph_err_over_max": errs, "card": card}
        log(f"layer-wise {family}: {n / dt:.4g} nodes/s ({dt:.3f} s a pass) [{card}]")
        del model
        torch.cuda.empty_cache()
    return out


def resume_drill(card):
    """The twin's ``--save-dir``: ``--dataset planted:20000 --epochs 2``,
    then ``--epochs 4`` over the same directory (under ``OUT_DIR``). The
    second run resumes at epoch 2 and trains epochs 3-4 only; the state it
    restores is bitwise what the first run saved after epoch 2; its test
    accuracy clears feature-only Bayes + 0.15."""
    import contextlib
    import io
    import re
    import shutil

    from examples.train_sage_torch import main
    from quiver_tpu_torch.utils import checkpoint

    d = os.path.join(OUT_DIR, "resume_drill")
    shutil.rmtree(d, ignore_errors=True)
    saved, restored = {}, []
    save, restore = checkpoint.Checkpointer.save, checkpoint.Checkpointer.restore

    def record_save(self, step, state, *a, **kw):
        saved[step] = host_copy(state)
        return save(self, step, state, *a, **kw)

    def record_restore(self, *a, **kw):
        state = restore(self, *a, **kw)
        restored.append(host_copy(state))
        return state

    runs = []
    checkpoint.Checkpointer.save = record_save
    checkpoint.Checkpointer.restore = record_restore
    try:
        for epochs in (2, 4):
            t0 = time.time()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                acc, ds = main(["--dataset", "planted:20000", "--epochs", str(epochs),
                                "--save-dir", d, "--device", "cuda"])
            for line in text.getvalue().splitlines():
                log(f"resume drill, --epochs {epochs}: {line}")
            runs.append({"epochs": epochs, "test_acc": acc, "seconds": time.time() - t0,
                         "trained": re.findall(r"Epoch (\d+)", text.getvalue()),
                         "resumed": f"resumed from {d} at epoch 2" in text.getvalue()})
    finally:
        checkpoint.Checkpointer.save = save
        checkpoint.Checkpointer.restore = restore
    bayes = ds.meta["feature_bayes_acc"]
    check(runs[0]["trained"] == ["01", "02"] and not runs[0]["resumed"],
          f"resume drill: the first run trains epochs 1-2 {runs[0]}")
    check(runs[1]["trained"] == ["03", "04"] and runs[1]["resumed"],
          f"resume drill: the second run resumes at epoch 2 {runs[1]}")
    check(len(restored) == 1 and same_tree(saved[2], restored[0]),
          "resume drill: the restored state is bitwise the saved one")
    check(runs[1]["test_acc"] >= bayes + 0.15,
          f"resume drill: test acc {runs[1]['test_acc']} < Bayes {bayes} + 0.15")
    return {"runs": runs, "feature_bayes_acc": bayes, "restored_bitwise": True,
            "saved_steps": sorted(saved), "card": card}


def epoch_phase(topo, card):
    """Phase 9b: bench_epoch's configuration on the products graph (F = 100
    f32 from ``default_rng(0).normal``, 47 labels from ``default_rng(1)``,
    a 20% degree-ordered cache, the rest pinned) for every family; the
    card-vs-CPU steps of GCN, GIN and GAT; layer-wise inference at
    bench_infer's configuration; the resume drill."""
    import numpy as np
    import torch

    from quiver_tpu_torch import Feature

    t0 = time.time()
    n = topo.node_count
    x_feat = np.random.default_rng(0).normal(size=(n, EPOCH_F)).astype(np.float32)
    feat = Feature(device_cache_size=int(0.2 * n) * EPOCH_F * 4, csr_topo=topo,
                   device="cuda").from_cpu_tensor(x_feat)
    labels_all = torch.from_numpy(np.random.default_rng(1).integers(
        0, EPOCH_CLASSES, n).astype(np.int32)).to("cuda")
    log(f"epoch phase set-up {time.time() - t0:.1f}s: {feat.hot_rows} hot rows")
    result = {"config": "benchmarks/bench_epoch.py defaults: products-shaped "
                        "generate_pareto_graph(2450000, 50.5, seed=0), HBM topology, "
                        "F=100 f32, 47 classes, 20% cache, fanouts [15, 10, 5], "
                        "batch 1024, auto caps, hidden 256, GAT heads 4, Adam 1e-3, "
                        f"{EPOCH_WARMUP} warm-up + {EPOCH_ITERS} iterations",
              "hot_rows": feat.hot_rows, "families": {}, "parity": {}}
    for family in EPOCH_FAMILIES:
        result["families"][family] = epoch_family(family, topo, feat, labels_all, card)
        torch.cuda.empty_cache()
    for family in ("gcn", "gin", "gat"):
        result["parity"][family] = family_parity(family, topo, feat, labels_all)
    del feat, labels_all
    torch.cuda.empty_cache()
    result["layerwise"] = layerwise_families(topo, x_feat, card)
    result["resume"] = resume_drill(card)
    result["seconds"] = time.time() - t0
    return result


# -- phase 9c: heterogeneous R-GCN and GraphSAINT ------------------------------

# benchmarks/bench_rgcn.py's defaults (:27-33 flags, :73 nodes, batch, iters,
# warm-up; :97-99 the node counts)
MAG_PAPERS, MAG_AUTHORS, MAG_INSTS = 200_000, 100_000, 5_000
RGCN_F, RGCN_CLASSES, RGCN_HIDDEN, RGCN_FANOUT, RGCN_BATCH = 128, 16, 64, [8, 4], 512
RGCN_WARMUP, RGCN_ITERS = 3, 30
RGCN_HOPS = 5  # relation hops per sample at [8, 4]: 2 into paper, then 2 + 1
RGCN_TYPES = 3  # one K2 lookup per node type
# benchmarks/bench_saint.py's defaults (:20-25) on common.py's graph
SAINT_NODES, SAINT_DEG, SAINT_BUDGET, SAINT_ROOTS, SAINT_WALK = 500_000, 50.5, 4096, 1024, 3
SAINT_WARMUP, SAINT_ITERS = 5, 50
# launches per draw: the window read (and the edge sampler's endpoints) by
# K2, each walk step by K1
SAINT_LAUNCHES = {"node": {"gather_rows": 1}, "edge": {"gather_rows": 2},
                  "rw": {"gather_rows": 1, "uniform_hop": SAINT_WALK}}


def mag_graph():
    """``bench_rgcn.py``'s graph, features and labels, drawn in its order
    from ``default_rng(0)``: paper-cites-paper from
    ``generate_pareto_graph(200000, 10.0, seed=0)``, 3 writes per paper, 2
    employs per author, F = 128 f32 per type, 16 labels."""
    import numpy as np

    from quiver_tpu_torch import HeteroCSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(0)
    num_nodes = {"paper": MAG_PAPERS, "author": MAG_AUTHORS, "inst": MAG_INSTS}
    topo = HeteroCSRTopo(num_nodes, {
        ("paper", "cites", "paper"): generate_pareto_graph(MAG_PAPERS, 10.0, seed=0),
        ("author", "writes", "paper"): np.stack([
            rng.integers(0, MAG_AUTHORS, MAG_PAPERS * 3),
            rng.integers(0, MAG_PAPERS, MAG_PAPERS * 3)]),
        ("inst", "employs", "author"): np.stack([
            rng.integers(0, MAG_INSTS, MAG_AUTHORS * 2),
            rng.integers(0, MAG_AUTHORS, MAG_AUTHORS * 2)]),
    })
    feats = {t: rng.normal(size=(c, RGCN_F)).astype(np.float32)
             for t, c in num_nodes.items()}
    labels = rng.integers(0, RGCN_CLASSES, MAG_PAPERS).astype(np.int32)
    return topo, feats, labels, rng


def edge_keys(indptr, indices, n_src: int):
    """Sorted ``row * n_src + col`` keys of a CSR's edges, on the card."""
    import torch

    indptr = torch.as_tensor(indptr).to("cuda", torch.int64)
    rows = torch.repeat_interleave(torch.arange(indptr.shape[0] - 1, device="cuda"),
                                   indptr[1:] - indptr[:-1])
    cols = torch.as_tensor(indices).to("cuda", torch.int64)
    return torch.sort(rows * n_src + cols).values


def real_edges(keys, n_src: int, rows, cols) -> bool:
    """Whether every ``(rows[i], cols[i])`` is an edge of ``keys``'s CSR."""
    import torch

    if rows.numel() == 0:
        return True
    q = rows.to(torch.int64) * n_src + cols.to(torch.int64)
    pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    return bool((keys[pos] == q).all())


def hetero_checks(out, seeds, rel_keys, topo) -> int:
    """A hetero sample's checks: no overflow, ``n_id[paper][:batch] ==
    seeds``, and every valid lane of every relation a real edge (its
    source and destination read back through the final frontiers, of which
    each earlier frontier is a prefix). Returns the lanes checked."""
    import torch

    check(int(out.overflow) == 0, f"hetero sample overflow {int(out.overflow)}")
    check(equal(out.n_id["paper"][:len(seeds)].cpu(),
                torch.from_numpy(seeds.astype("int32"))), "n_id[paper][:batch] == seeds")
    lanes = 0
    for layer in out.adjs:
        for et, adj in layer.adjs.items():
            col, row = adj.edge_index[0], adj.edge_index[1]
            valid = col >= 0
            src = out.n_id[et[0]][col[valid].to(torch.int64)]
            dst = out.n_id[et[2]][row[valid].to(torch.int64)]
            check(real_edges(rel_keys[et], topo.num_nodes[et[0]], dst, src),
                  f"every sampled {et} lane is an edge of its relation")
            lanes += int(valid.sum())
    return lanes


def rgcn_parity(model_args, out, x, labels, mask):
    """One R-GCN step on the card against the CPU's (:func:`step_parity`)
    on one full-width batch, from ``init_model`` parameters with dropout
    0."""
    import torch

    from quiver_tpu_torch import RGCN
    from quiver_tpu_torch.parallel.train import init_model

    model = RGCN(*model_args, dropout=0.0)
    init_model(model, torch.Generator().manual_seed(1))
    return {**step_parity(model, x, out.adjs, labels, mask, "R-GCN"),
            "rows": {t: int(v.shape[0]) for t, v in x.items()}}


def hetero_parity(topo, sampler, seeds, what: str):
    """One call of the hetero loop at the main path's planned caps: on the
    card over ``sampler.dev_topos`` (one fused K1 or K3 launch per relation
    per hop) against its plain run over the same relations placed on the
    CPU, on the same raw draws (made on the card, then copied). Frontiers,
    counts, every ``Adj`` (and ``e_id``), overflow and the per-hop unique
    counts must agree bitwise. Returns ``(check row, the card's
    frontiers)``."""
    import torch

    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, weighted_hop
    from quiver_tpu_torch.ops.sample import hop_draws, seeded_generator
    from quiver_tpu_torch.sampling.hetero import hetero_multilayer_sample

    plans = sampler._plan(RGCN_BATCH, sampler._cap_overrides)
    draws = {}

    def bits_on(dev):
        def bits(hop, et, shape):
            if (hop, et) not in draws:
                g = seeded_generator("cuda", 7, hop, sampler._rel_index[et])
                draws[hop, et] = hop_draws(shape, plans[hop][0][et], g,
                                           weighted=et in sampler.weighted_rels)
            d = draws[hop, et]
            return d.to(dev) if torch.is_tensor(d) else tuple(x.to(dev) for x in d)
        return bits

    ids = torch.from_numpy(seeds.astype("int32"))
    kw = {"weighted_rels": sampler.weighted_rels, "with_eid": sampler.with_eid}
    before = (uniform_hop.launches, weighted_hop.launches)
    got = hetero_multilayer_sample(sampler.dev_topos, ids.to("cuda"), len(seeds), "paper",
                                   plans, bits=bits_on("cuda"), **kw)
    sync()
    fired = {"uniform_hop": uniform_hop.launches - before[0],
             "weighted_hop": weighted_hop.launches - before[1]}
    cpu_topos = topo.to_device(sampler.mode, with_eid=sampler.with_eid,
                               weighted_rels=sampler.weighted_rels, device="cpu")
    want = hetero_multilayer_sample(cpu_topos, ids, len(seeds), "paper", plans,
                                    bits=bits_on("cpu"), **kw)
    pairs = [(got[0][t], want[0][t]) for t in want[0]]
    pairs += [(torch.as_tensor(got[1][t]), torch.as_tensor(want[1][t])) for t in want[1]]
    same_keys = got[0].keys() == want[0].keys() and len(got[2]) == len(want[2])
    for lg, lw in zip(got[2], want[2]):
        same_keys &= lg.adjs.keys() == lw.adjs.keys()
        for et, a in lw.adjs.items():
            pairs.append((lg.adjs[et].edge_index, a.edge_index))
            if a.e_id is not None:
                pairs.append((lg.adjs[et].e_id, a.e_id))
    pairs.append((got[3], want[3]))
    for fg, fw in zip(got[4], want[4]):
        pairs += [(fg[t], fw[t]) for t in fw]
    pairs = [(a.cpu(), b) for a, b in pairs]
    ok = same_keys and all(equal(a, b) for a, b in pairs)
    entry = "weighted_hop" if sampler.weighted_rels else "uniform_hop"
    check(ok, f"hetero sample {what} on the card == plain on the CPU")
    check(fired == {"uniform_hop": 0, "weighted_hop": 0, entry: RGCN_HOPS},
          f"hetero sample {what}: launches {fired}")
    check(int(got[3]) == 0, f"hetero sample {what}: overflow {int(got[3])}")
    row = {"case": f"R-GCN {what} sample on the MAG graph: {len(seeds)} seeds x "
                   f"{RGCN_FANOUT} at the planned caps, card against CPU",
           "caps": [p[2] for p in plans], "launches": fired[entry],
           "match": ok, "max_abs_err": max_err(*zip(*pairs))}
    return row, got[0]


def hetero_gather_parity(feature, n_id):
    """``HeteroFeature[n_id]`` on the card (one ``tiered_gather`` launch
    per node type) against each type's ``tiered_gather_plain`` on the same
    ids and tiers, bitwise. Returns one check row per type."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import tiered_gather, tiered_gather_plain

    before = tiered_gather.launches
    x = feature[n_id]
    sync()
    check(tiered_gather.launches - before == RGCN_TYPES,
          f"HeteroFeature lookup: {tiered_gather.launches - before} tiered_gather launches")
    rows = []
    for t, ids in n_id.items():
        f = feature.features[t]
        want = tiered_gather_plain(ids.to(torch.int32).contiguous(), f.feature_order,
                                   f.hot_rows, f.hot, f.cold)
        ok = equal(x[t], want)
        rows.append({"store": f"R-GCN {t} rows (F={RGCN_F} f32) at a batch's n_id",
                     "ids": int(ids.numel()), "hot_rows": f.hot_rows, "match": ok,
                     "max_abs_err": float((x[t] - want).abs().max())})
        check(ok, f"HeteroFeature[{t}] on the card == tiered_gather_plain")
    return rows


def rgcn_phase(card):
    """``bench_rgcn.py`` at its defaults on the card (see the module
    docstring, phase 9c (a)). Returns ``(launches of the timed
    iterations, launches of the weighted calls, check rows by entry,
    result)``."""
    import math

    import numpy as np
    import torch
    from torch.profiler import record_function

    from quiver_tpu_torch import HeteroFeature, HeteroGraphSampler, RGCN
    from quiver_tpu_torch.models.inference import rgcn_layerwise_inference
    from quiver_tpu_torch.models.rgcn import rgcn_schema
    from quiver_tpu_torch.ops.sample import seeded_generator
    from quiver_tpu_torch.parallel.train import init_model, make_train_step

    t0 = time.time()
    topo, feats, labels_np, rng = mag_graph()
    feature = HeteroFeature.from_cpu_tensors(feats, device_cache_size="4G", device="cuda")
    labels_all = torch.from_numpy(labels_np).to("cuda")
    rel_keys = {et: edge_keys(rel.indptr, rel.indices, topo.num_nodes[et[0]])
                for et, rel in topo.relations.items()}
    sampler = HeteroGraphSampler(topo, RGCN_FANOUT, "paper", seed_capacity=RGCN_BATCH,
                                 frontier_caps="auto", seed=0, device="cuda")
    reset_launches()
    out = sampler.sample(rng.integers(0, MAG_PAPERS, RGCN_BATCH))  # plans the caps
    sync()
    plan_reruns = sampler.reruns
    expect_launches(read_launches(), {"uniform_hop": RGCN_HOPS * (1 + plan_reruns)},
                    "R-GCN: the planning call")
    model_args = (rgcn_schema(out.adjs, {t: RGCN_F for t in topo.num_nodes}),
                  RGCN_HIDDEN, RGCN_CLASSES, "paper", len(RGCN_FANOUT))
    model = RGCN(*model_args)
    init_model(model, torch.Generator().manual_seed(0))
    model.to("cuda")
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-3))
    worst = sampler._plan(RGCN_BATCH)
    planned = sampler._plan(RGCN_BATCH, sampler._cap_overrides)
    setup_s = time.time() - t0

    def iteration(i):
        seeds = rng.integers(0, MAG_PAPERS, RGCN_BATCH)
        a = time.perf_counter()
        with record_function("rgcn:sample"):
            out = sampler.sample(seeds)
            sync()
        b = time.perf_counter()
        with record_function("rgcn:gather"):
            x = feature[out.n_id]
            seed_ids = out.n_id["paper"][:RGCN_BATCH]
            labels, mask = labels_all[seed_ids.clamp(min=0)], seed_ids >= 0
            sync()
        c = time.perf_counter()
        with record_function("rgcn:step"):
            loss = step(x, out.adjs, labels, mask, seeded_generator("cuda", 0, i))
            sync()
        return out, seeds, loss, (b - a, c - b, time.perf_counter() - c)

    for i in range(RGCN_WARMUP):
        iteration(i)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reruns0 = sampler.reruns
    rows, losses, kept = [], [], []
    for i in range(RGCN_ITERS):
        out, seeds, loss, stages = iteration(100 + i)
        rows.append(stages)
        losses.append(loss)
        kept.append((out, seeds))
    launches = read_launches()
    reruns = sampler.reruns - reruns0
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, {"uniform_hop": RGCN_HOPS * (RGCN_ITERS + reruns),
                               "tiered_gather": RGCN_TYPES * RGCN_ITERS},
                    f"R-GCN: {RGCN_ITERS} iterations ({reruns} reruns)")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"R-GCN: finite losses {losses}")
    lanes = sum(hetero_checks(out, seeds, rel_keys, topo) for out, seeds in kept)
    del kept
    iter_s = trimmed_mean([sum(r) for r in rows])
    per_epoch = -(-(MAG_PAPERS // 10) // RGCN_BATCH)
    stage = {k: statistics.median(r[j] for r in rows) * 1e3
             for j, k in enumerate(("sample", "gather", "train_step"))}
    prof = profiled_idle(lambda: [iteration(200 + k) for k in range(PROFILED_STEPS)],
                         PROFILED_STEPS, iter_s * 1e3,
                         ("uniform_hop_kernel", "gather_kernel"))

    # the same sampler over exp(N(0, 1)) weights on every relation
    # (bench_rgcn.py:120-125): every hop one K3 fused launch, none on K1
    wrng = np.random.default_rng(5)
    for et in topo.relations:
        topo.set_edge_weight(et, np.exp(wrng.normal(size=topo.relations[et].edge_count)))
    wsampler = HeteroGraphSampler(topo, RGCN_FANOUT, "paper", seed_capacity=RGCN_BATCH,
                                  frontier_caps="auto", weighted=True, seed=0,
                                  device="cuda")
    wsampler.sample(rng.integers(0, MAG_PAPERS, RGCN_BATCH))  # plans the caps
    reset_launches()
    wreruns0, wtimes, wouts = wsampler.reruns, [], []
    for _ in range(5):
        seeds = rng.integers(0, MAG_PAPERS, RGCN_BATCH)
        a = time.perf_counter()
        wout = wsampler.sample(seeds)
        sync()
        wtimes.append(time.perf_counter() - a)
        wouts.append((wout, seeds))
    wlaunches = read_launches()
    wreruns = wsampler.reruns - wreruns0
    expect_launches(wlaunches, {"weighted_hop": RGCN_HOPS * (5 + wreruns)},
                    f"weighted R-GCN sampler: 5 calls ({wreruns} reruns)")
    wlanes = sum(hetero_checks(o, s, rel_keys, topo) for o, s in wouts)
    del wouts

    # the kernels at the main path's shapes against their plain versions:
    # one call of each sampler on the card against the CPU, and the lookup
    # of the uniform call's frontiers against each type's plain gather
    prng = np.random.default_rng(12)
    u_row, n_id = hetero_parity(topo, sampler, prng.integers(0, MAG_PAPERS, RGCN_BATCH),
                                "uniform")
    w_row, _ = hetero_parity(topo, wsampler, prng.integers(0, MAG_PAPERS, RGCN_BATCH),
                             "weighted")
    parity_rows = {"uniform_hop": [u_row], "weighted_hop": [w_row],
                   "tiered_gather": hetero_gather_parity(feature, n_id)}
    del n_id

    # one step on the card against the CPU, on one full-width batch
    seeds = rng.integers(0, MAG_PAPERS, RGCN_BATCH)
    out = sampler.sample(seeds)
    x = feature[out.n_id]
    seed_ids = out.n_id["paper"][:RGCN_BATCH]
    parity = rgcn_parity(model_args, out, x, labels_all[seed_ids.clamp(min=0)],
                         seed_ids >= 0)

    # layer-wise inference over the whole graph, HBM and HOST
    x_all = {t: torch.from_numpy(v).to("cuda") for t, v in feats.items()}
    model.eval()
    layerwise = {}
    for mode in ("HBM", "HOST"):
        rgcn_layerwise_inference(model, topo, x_all, mode=mode, device="cuda")  # warm-up
        sync()
        a = time.perf_counter()
        logp = rgcn_layerwise_inference(model, topo, x_all, mode=mode, device="cuda")
        sync()
        dt = time.perf_counter() - a
        check(logp.shape == (MAG_PAPERS, RGCN_CLASSES) and bool(torch.isfinite(logp).all()),
              f"R-GCN layer-wise {mode}: finite log-probs")
        layerwise[mode] = {"pass_s": dt, "paper_nodes_per_s": MAG_PAPERS / dt,
                           "all_nodes_per_s": sum(topo.num_nodes.values()) / dt,
                           "logp": logp}
    hbm, host = layerwise["HBM"].pop("logp"), layerwise["HOST"].pop("logp")
    err = float((hbm - host).abs().max()) / float(hbm.abs().max())
    check(err <= 1e-5, f"R-GCN layer-wise HOST against HBM: {err} x max |out|")
    layerwise["host_err_over_max"] = err
    del hbm, host, x_all
    result = {
        "config": "benchmarks/bench_rgcn.py defaults: 200000 papers (cites: "
                  "generate_pareto_graph(200000, 10.0, seed=0)), 100000 authors (3 "
                  "writes per paper), 5000 institutions (2 employs per author), F=128 "
                  "f32 per type, HeteroFeature device_cache_size 4G, 16 classes, RGCN "
                  "hidden 64 x 2, fanouts [8, 4], batch 512, auto caps, Adam 5e-3, "
                  f"{RGCN_WARMUP} warm-up + {RGCN_ITERS} iterations",
        "setup_s": setup_s, "planning_reruns": plan_reruns, "reruns": reruns,
        "caps": [p[2] for p in planned], "worst_caps": [p[2] for p in worst],
        "iter_ms_trimmed_mean": iter_s * 1e3, "iterations_per_epoch": per_epoch,
        "epoch_s": iter_s * per_epoch, "median_ms": stage,
        "peak_bytes": peak, "launches": launches,
        "launches_per_iteration": {"uniform_hop": RGCN_HOPS, "tiered_gather": RGCN_TYPES},
        "losses_first_last": [losses[0], losses[-1]], "checked_lanes": lanes,
        "profile": prof,
        "weighted": {"calls": 5, "reruns": wreruns, "launches": wlaunches,
                     "sample_ms_median": statistics.median(wtimes) * 1e3,
                     "checked_lanes": wlanes},
        "parity": parity, "kernel_parity": parity_rows, "layerwise": layerwise,
        "card": card}
    log(f"R-GCN: {iter_s * 1e3:.3f} ms an iteration (10%-trimmed mean), {per_epoch} "
        f"iterations an epoch ({iter_s * per_epoch:.3f} s); medians "
        f"{ {k: round(v, 3) for k, v in stage.items()} } ms; idle share "
        f"{prof['idle_share']:.4f}; peak {peak / 2**30:.3f} GiB [{card}]")
    log(f"R-GCN caps {result['caps']} (worst case {result['worst_caps']})")
    log(f"R-GCN weighted sample: {result['weighted']['sample_ms_median']:.3f} ms median; "
        f"layer-wise HBM {layerwise['HBM']['paper_nodes_per_s']:.4g} / HOST "
        f"{layerwise['HOST']['paper_nodes_per_s']:.4g} paper nodes/s [{card}]")
    return launches, wlaunches, parity_rows, result


def walk_parity(topo):
    """The random walk's kernels at its shape (``SAINT_ROOTS`` rows, k =
    1) on the card against the CPU: each step's K1 ``uniform_hop`` (the
    main path's entry) against its plain run on the same raw draws and the
    same walkers, then :func:`random_walk` under a ``draw_fn`` (each step
    one K1 ``select``), bitwise. Returns check rows by entry."""
    import numpy as np
    import torch

    from quiver_tpu_torch.ops.kernels.fused import select, uniform_hop
    from quiver_tpu_torch.ops.sample import draw_bits, sample_layer
    from quiver_tpu_torch.sampling.saint import random_walk

    dev_t, cpu_t = topo.to_device("HBM", "cuda"), topo.to_device("HBM", "cpu")
    g = torch.Generator().manual_seed(11)
    starts = torch.randint(0, topo.node_count, (SAINT_ROOTS,), generator=g,
                           dtype=torch.int32)
    cur, pairs = starts, []
    before = uniform_hop.launches
    for _ in range(SAINT_WALK):
        bits = draw_bits((SAINT_ROOTS,), 1, g)
        got = sample_layer(dev_t, cur.to("cuda"), SAINT_ROOTS, 1,
                           bits=tuple(b.to("cuda") for b in bits))
        want = sample_layer(cpu_t, cur, SAINT_ROOTS, 1, bits=bits)
        pairs += [(a.cpu(), b) for a, b in zip(got, want)]
        nxt = want[0][:, 0]
        cur = torch.where(nxt >= 0, nxt, cur)
    sync()
    hops = uniform_hop.launches - before
    ok = hops == SAINT_WALK and all(equal(a, b) for a, b in pairs)
    check(ok, f"random-walk steps: uniform_hop on the card == plain ({hops} launches)")
    r = np.random.default_rng(13).integers(0, 2**30, (SAINT_WALK, SAINT_ROOTS, 1))

    def draw_fn(step, deg):
        bound = deg.to(torch.int64).clamp(min=1)[:, None]
        return (torch.from_numpy(r[step]).to(deg.device) % bound).to(torch.int32)

    before = select.launches
    walk = random_walk(dev_t, starts.to("cuda"), SAINT_WALK, draw_fn=draw_fn)
    sync()
    picks = select.launches - before
    want_walk = random_walk(cpu_t, starts, SAINT_WALK, draw_fn=draw_fn)
    walk_ok = picks == SAINT_WALK and equal(walk.cpu(), want_walk)
    check(walk_ok, f"random_walk under a draw_fn on the card == CPU ({picks} select "
                   "launches)")
    return {"uniform_hop": [{"case": f"random-walk steps: {SAINT_ROOTS} walkers x k=1, "
                                      f"{SAINT_WALK} steps, card against CPU",
                             "launches": hops, "match": ok,
                             "max_abs_err": max_err(*zip(*pairs))}],
            "select": [{"case": f"random_walk under a draw_fn: {SAINT_ROOTS} walkers x "
                                f"{SAINT_WALK} steps, card against CPU",
                        "launches": picks, "match": walk_ok,
                        "max_abs_err": max_err([walk.cpu()], [want_walk])}]}


def saint_phase(card):
    """``bench_saint.py`` at its defaults on the card (see the module
    docstring, phase 9c (b)). Returns ``(launches summed over the three
    samplers' timed draws, K2's row for the kernel line, the random
    walk's check rows by entry, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import (CSRTopo, SAINTEdgeSampler, SAINTNodeSampler,
                                  SAINTRandomWalkSampler)
    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain
    from quiver_tpu_torch.sampling.saint import saint_subgraph
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    t0 = time.time()
    topo = CSRTopo(edge_index=generate_pareto_graph(SAINT_NODES, SAINT_DEG, seed=0))
    keys = edge_keys(topo.indptr, topo.indices, topo.node_count)
    setup_s = time.time() - t0
    makers = {
        "node": lambda: SAINTNodeSampler(topo, budget=SAINT_BUDGET, seed=0, device="cuda"),
        "edge": lambda: SAINTEdgeSampler(topo, budget=SAINT_BUDGET, seed=0, device="cuda"),
        "rw": lambda: SAINTRandomWalkSampler(topo, roots=SAINT_ROOTS,
                                             walk_length=SAINT_WALK, seed=0, device="cuda"),
    }
    total = {name: 0 for name in ENTRIES}
    out, node_sub = {}, None
    for kind, make in makers.items():
        s = make()
        for _ in range(SAINT_WARMUP):
            sub = s.sample()
        sync()
        reset_launches()
        edges, kept = 0, []
        a = time.perf_counter()
        for i in range(SAINT_ITERS):
            sub = s.sample()
            edges += int(sub.num_edges)  # one scalar sync per draw, as bench_saint
            if i >= SAINT_ITERS - 3:
                kept.append(sub)
        sync()
        dt = time.perf_counter() - a
        launches = read_launches()
        expect_launches(launches, {k: v * SAINT_ITERS for k, v in SAINT_LAUNCHES[kind].items()},
                        f"SAINT {kind}: {SAINT_ITERS} draws")
        for name, v in launches.items():
            total[name] += v
        for sub in kept:
            valid = sub.node_id[sub.node_id >= 0]
            check(valid.unique().numel() == valid.numel() == int(sub.num_nodes),
                  f"SAINT {kind}: node_id holds no duplicate")
            src, dst = sub.edge_index[0], sub.edge_index[1]
            keep = src >= 0
            check(int(keep.sum()) == int(sub.num_edges), f"SAINT {kind}: edge count")
            u = sub.node_id[src[keep].to(torch.int64)]
            v = sub.node_id[dst[keep].to(torch.int64)]
            check(bool((u >= 0).all() and (v >= 0).all())
                  and real_edges(keys, topo.node_count, u, v),
                  f"SAINT {kind}: every induced edge is a CSR edge between subgraph nodes")
        prof = profiled_idle(lambda: [s.sample() for _ in range(PROFILED_STEPS)],
                             PROFILED_STEPS, dt / SAINT_ITERS * 1e3,
                             ("gather_kernel", "uniform_hop_kernel"))
        out[kind] = {"subgraphs_per_s": SAINT_ITERS / dt,
                     "induced_edges_per_s": edges / dt, "draw_ms": dt / SAINT_ITERS * 1e3,
                     "budget": s.budget, "deg_cap": s.deg_cap, "launches": launches,
                     "launches_per_draw": SAINT_LAUNCHES[kind], "profile": prof,
                     "card": card}
        log(f"SAINT {kind}: {SAINT_ITERS / dt:.4g} subgraphs/s, {edges / dt:.4g} induced "
            f"edges/s, deg_cap {s.deg_cap}; idle share {prof['idle_share']:.4f} [{card}]")
        if kind == "node":
            node_sub = kept[-1]
        del s, kept
    # the induction on the card against its plain version on the same nodes
    deg_cap = out["node"]["deg_cap"]
    nodes, num = node_sub.node_id, node_sub.num_nodes
    want = saint_subgraph(topo.to_device("HBM", "cpu"), nodes.cpu(), int(num), deg_cap)
    bitwise = {}
    for mode in ("HBM", "HOST"):
        got = saint_subgraph(topo.to_device(mode, "cuda"), nodes, num, deg_cap)
        bitwise[mode] = all(equal(a.cpu(), b) for a, b in zip(got, want))
        check(bitwise[mode], f"saint_subgraph {mode} on the card == plain")
    walk_rows = walk_parity(topo)
    # K2's single-table entry at the main path's shape: the node sampler's
    # (budget, deg_cap) window over the (E, 1) int32 indices
    table = topo.to_device("HBM", "cuda").indices.reshape(-1, 1)
    valid = torch.arange(nodes.shape[0], device="cuda") < num
    s_ids = torch.where(valid, nodes, 0).to(torch.int64)
    indptr = torch.from_numpy(topo.indptr).to("cuda", torch.int64)
    base, deg = indptr[s_ids], torch.where(valid, indptr[s_ids + 1] - indptr[s_ids], 0)
    j = torch.arange(deg_cap, device="cuda")[None, :]
    ids = (base[:, None] + torch.where(j < deg.clamp(max=deg_cap)[:, None], j, 0)).reshape(
        -1).to(torch.int32)
    got, want_rows = gather_rows(table, ids), gather_rows_plain(table, ids)
    sync()
    window = [{"table": "int32 (E, 1) indices, the node sampler's window", "ids": int(
        ids.shape[0]), "match": equal(got, want_rows),
               "max_abs_err": float((got - want_rows).abs().max())}]
    check(window[0]["match"], "gather_rows at the SAINT window's shape == plain")
    rng = np.random.default_rng(9)
    window += gather_checks([("int32 (E, 1) indices", table)], rng)
    t_win = time_gather(table, ids, distinct_rows=int(torch.unique(ids).numel()))
    log(f"gather_rows, SAINT window ({ids.shape[0]} ids): {t_win['ms']:.4f} ms, "
        f"index_select {t_win['library_ms']:.4f}, plain {t_win['plain_ms']:.4f}, bound "
        f"{t_win['bound_ms']:.4f} [{card}]")
    result = {"config": "benchmarks/bench_saint.py defaults: generate_pareto_graph("
                        "500000, 50.5, seed=0) on the card, node and edge budget 4096, "
                        f"rw roots 1024 x walk 3; {SAINT_WARMUP} warm-up + {SAINT_ITERS} "
                        "draws each",
              "nodes": topo.node_count, "edges": topo.edge_count, "setup_s": setup_s,
              "samplers": out, "subgraph_bitwise": bitwise, "window_gather": t_win,
              "walk_parity": walk_rows, "card": card}
    return total, (window, t_win), walk_rows, result


def twins_phase(card):
    """The two example twins on the card: ``train_saint_torch.py`` at
    ``tests/test_saint.py``'s acceptance arguments (test accuracy >= 0.85
    and >= feature-only Bayes + 0.15), then ``train_rgcn_hetero_torch.py``
    at its defaults (finite losses; its labels are random)."""
    import contextlib
    import io
    import math

    from examples.train_rgcn_hetero_torch import main as rgcn_main
    from examples.train_saint_torch import main as saint_main

    t0 = time.time()
    reset_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        acc, ds = saint_main(["--dataset", "planted:4000:6", "--steps", "150",
                              "--budget", "512", "--norm-iters", "15", "--device", "cuda"])
    saint_launches = read_launches()
    bayes = ds.meta["feature_bayes_acc"]
    for line in text.getvalue().splitlines():
        log(f"train_saint_torch: {line}")
    check(acc >= 0.85 and acc >= bayes + 0.15,
          f"SAINT twin: test acc {acc} against 0.85 and Bayes {bayes} + 0.15")
    check(saint_launches["gather_rows"] > 0, "SAINT twin: gather_rows launched")
    saint_s = time.time() - t0
    t0 = time.time()
    reset_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        losses = rgcn_main(["--device", "cuda"])
    rgcn_launches = read_launches()
    for line in text.getvalue().splitlines():
        log(f"train_rgcn_hetero_torch: {line}")
    check(len(losses) == 60 and all(math.isfinite(v) for v in losses),
          "R-GCN twin: 60 finite losses")
    check(rgcn_launches["uniform_hop"] > 0 and rgcn_launches["tiered_gather"] > 0,
          "R-GCN twin: K1 and K2 launched")
    return {"saint": {"args": "--dataset planted:4000:6 --steps 150 --budget 512 "
                              "--norm-iters 15", "test_acc": acc,
                      "feature_bayes_acc": bayes, "seconds": saint_s,
                      "launches": saint_launches},
            "rgcn": {"args": "defaults (20000 papers, 60 steps)",
                     "losses_first_last": [losses[0], losses[-1]],
                     "seconds": time.time() - t0, "launches": rgcn_launches},
            "card": card}


def hetero_saint_phase(card):
    """Phase 9c: R-GCN (a), GraphSAINT (b), the twins (c). Returns
    ``(launches by part, K2's window row, the check rows of the kernels at
    the phase's shapes by entry, result)``."""
    import torch

    t0 = time.time()
    rgcn_launches, rgcn_wlaunches, rgcn_rows, rgcn = rgcn_phase(card)
    torch.cuda.empty_cache()
    saint_launches, k2_row, walk_rows, saint = saint_phase(card)
    torch.cuda.empty_cache()
    twins = twins_phase(card)
    rows = {name: rgcn_rows.get(name, []) + walk_rows.get(name, []) for name in ENTRIES}
    return ({"rgcn": rgcn_launches, "rgcn_weighted": rgcn_wlaunches,
             "saint": saint_launches}, k2_row, rows,
            {"rgcn": rgcn, "saint": saint, "twins": twins, "seconds": time.time() - t0})


# -- phase 9d: beyond-HBM training (the host-offload twin) ----------------------

OFFLOAD_WARMUP = 5  # unrecorded steps before each timed run
OFFLOAD_KERNELS = ("uniform_hop_kernel", "gather_kernel")  # K1, K2 by kernel name


class StageClock:
    """A run's sampler and store behind a stopwatch, for phase 9d's serial
    runs: each sample and each lookup synchronises before it ends, and
    each sample also before it starts; the train step is what lies between
    a lookup's end and the next sample's start. Keeps each step's marks
    and looked-up ids."""

    def __init__(self, sampler, feature):
        self.sampler, self.feature = sampler, feature
        self.marks, self.n_ids = [], []

    def sample(self, seeds):
        sync()
        a = time.perf_counter()
        out = self.sampler.sample(seeds)
        sync()
        self.marks.append([a, time.perf_counter()])
        return out

    def __getitem__(self, n_id):
        x = self.feature[n_id]
        sync()
        self.marks[-1].append(time.perf_counter())
        self.n_ids.append(n_id)
        return x

    def stages_ms(self, end: float) -> list:
        """Per step ``(sample, gather, train_step)`` ms; the last step's
        train step runs to ``end``."""
        starts = [m[0] for m in self.marks[1:]] + [end]
        return [((b - a) * 1e3, (c - b) * 1e3, (nxt - c) * 1e3)
                for (a, b, c), nxt in zip(self.marks, starts)]


def offload_loop(run, step, n_steps, depth, first, clock=None):
    """``n_steps`` steps of the twin's loop (``loop_batches``, then its
    train step) over fresh seed arrays, through a ``Prefetcher`` at
    ``depth`` or serially (with ``clock`` as sampler and store). Returns
    the losses, on the card."""
    from types import SimpleNamespace

    from examples.train_host_offload_torch import loop_batches
    from quiver_tpu_torch.ops.sample import seeded_generator

    n, B = run.topo.node_count, run.args.batch
    stream = [run.rng.integers(0, n, B) for _ in range(n_steps)]
    src = run if clock is None else SimpleNamespace(
        args=run.args, labels_all=run.labels_all, sampler=clock, feature=clock)
    losses = []
    for i, b in enumerate(loop_batches(src, stream, depth)):
        x, labels, mask = b.x
        losses.append(step(x, b.out.adjs, labels, mask,
                           seeded_generator(run.device, run.args.seed, first + i)))
    return losses


def offload_dp(trainer, run, n_steps, depth, first, clock=None):
    """One ``DataParallelTrainer.train_epoch`` of ``n_steps`` x batch fresh
    seeds at ``depth`` (with ``clock`` as sampler and store). Returns
    ``[mean loss]``."""
    import torch

    seeds = run.rng.integers(0, run.topo.node_count, n_steps * run.args.batch)
    sampler, feature = trainer.sampler, trainer.feature
    if clock is not None:
        trainer.sampler = trainer.feature = clock
    try:
        loss, done = trainer.train_epoch(seeds, run.labels_all,
                                         torch.Generator().manual_seed(first),
                                         rng=run.rng, depth=depth)
    finally:
        trainer.sampler, trainer.feature = sampler, feature
    check(done == n_steps, f"beyond-HBM dp: {done} steps of {n_steps}")
    return [loss]


def offload_timed(label, run_n, sampler, feature, depth, steps, card):
    """``OFFLOAD_WARMUP`` unrecorded steps, then ``steps`` recorded ones at
    ``depth`` (serially under a :class:`StageClock` when 0): steps/s,
    exact launches (2 ``uniform_hop`` and 1 ``tiered_gather`` per step, 2
    more hops per regrowth rerun), finite losses, peak memory; at depth 0
    the stage medians and the cold rows and bytes per step; then the idle
    share and K1's and K2's device ms of ``PROFILED_STEPS`` more steps
    under ``torch.profiler``."""
    import math

    import torch

    run_n(OFFLOAD_WARMUP, depth, 0)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reruns0 = sampler.reruns
    clock = StageClock(sampler, feature) if depth == 0 else None
    t0 = time.perf_counter()
    losses = run_n(steps, depth, OFFLOAD_WARMUP, clock)
    sync()
    end = time.perf_counter()
    launches, reruns = read_launches(), sampler.reruns - reruns0
    losses = [float(v) for v in losses]
    expect_launches(launches, {"uniform_hop": 2 * (steps + reruns), "tiered_gather": steps},
                    f"beyond-HBM {label}, depth {depth} ({reruns} reruns)")
    check(all(math.isfinite(v) for v in losses), f"beyond-HBM {label}: finite losses")
    step_ms = (end - t0) / steps * 1e3
    r = {"depth": depth, "steps": steps, "steps_per_s": 1e3 / step_ms, "step_ms": step_ms,
         "reruns": reruns, "launches": launches, "peak_bytes": torch.cuda.max_memory_allocated(),
         "loss_first_last": [losses[0], losses[-1]]}
    if clock is not None:
        rows = clock.stages_ms(end)
        r["median_ms"] = {k: statistics.median(x[j] for x in rows)
                          for j, k in enumerate(("sample", "gather", "train_step"))}
        r["per_step_ms"] = rows
        r["cold"] = clock.n_ids
    prof = profiled_idle(lambda: run_n(PROFILED_STEPS, depth, 1000), PROFILED_STEPS,
                         step_ms, OFFLOAD_KERNELS)
    ours = prof.pop("port_kernels_ms_per_step")
    prof["profiled_steps"] = prof.pop("steps")
    del prof["step_ms"]  # the unprofiled run's, already in r
    r.update(prof, k1_device_ms_per_step=ours["uniform_hop_kernel"],
             k2_device_ms_per_step=ours["gather_kernel"])
    log(f"beyond-HBM {label} depth {depth}: {r['steps_per_s']:.4g} steps/s, idle share "
        f"{r['idle_share']:.4f}, K1 {r['k1_device_ms_per_step']:.4f} ms, K2 "
        f"{r['k2_device_ms_per_step']:.4f} ms per step, peak "
        f"{r['peak_bytes'] / 2**30:.3f} GiB" + (f"; stage medians {r['median_ms']}"
                                                if clock is not None else "") + f" [{card}]")
    return r


def offload_cold(feat, n_ids, pcie_bytes_per_s) -> dict:
    """Median cold rows and bytes per step of the looked-up ids, and the
    median GATHER_BOUND_RULE bound of one step's lookup."""
    rows = [lookup_bytes(feat, n_id) for n_id in n_ids]
    return {"valid_rows_per_step": statistics.median(r[0] for r in rows),
            "cold_rows_per_step": statistics.median(r[1] for r in rows),
            "cold_bytes_per_step": statistics.median(r[3] for r in rows),
            "lookup_bound_ms": statistics.median(
                1e3 * max(r[2] / HBM_BYTES_PER_S, r[3] / pcie_bytes_per_s) for r in rows)}


def offload_parity(run, caps, seeds):
    """One sampler call at the planned caps, HOST against an HBM copy of
    the topology (same seed, bitwise), then that call's hops again one by
    one, K1 over the UVA ``indices`` against ``uniform_hop_plain`` over the
    device copy, and its lookup against ``tiered_gather_plain``, bitwise.
    Returns ``(K1 rows, K2 rows, the HOST call's output and rows, the
    HBM sampler)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, uniform_hop_plain
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather_plain
    from quiver_tpu_torch.ops.reindex import reindex_layer
    from quiver_tpu_torch.ops.sample import hop_draws, seeded_generator

    args, B = run.args, run.args.batch

    def sampler(mode):
        return GraphSageSampler(run.topo, args.fanout, mode=mode, seed_capacity=B,
                                seed=args.seed, frontier_caps=caps, device="cuda")

    host, hbm = sampler("HOST"), sampler("HBM")
    check(host.topo.indices.device.type == "cpu" and host.topo.indices.is_pinned(),
          "HOST mode keeps indices pinned on the host")
    reset_launches()
    got = host.sample(seeds)
    sync()
    fired = read_launches()
    expect_launches(fired, {"uniform_hop": 2}, "beyond-HBM HOST sampler call")
    want = hbm.sample(seeds)
    pairs = [(got.n_id, want.n_id), (got.n_count, want.n_count),
             (got.overflow, want.overflow)]
    pairs += [(a.edge_index, b.edge_index) for a, b in zip(got.adjs, want.adjs)]
    same = all(equal(a, b) for a, b in pairs)
    check(same, "beyond-HBM: the HOST sampler call == the HBM copy's, bitwise")
    host_row = {"case": f"HOST-mode sampler call ({B} seeds x {args.fanout}, caps "
                        f"{list(caps)}) against an HBM copy of the topology",
                "match": same, "max_abs_err": max_err(*zip(*pairs)), "launches": 2}
    # the call's hops again, one by one, on the call's own draws
    padded = np.full(B, -1, dtype=np.int32)
    padded[:len(seeds)] = seeds
    cur, num = torch.from_numpy(padded).to("cuda"), len(seeds)
    rows = (B,) + tuple(map(max, host._worst_caps(B), caps))
    k1_rows = [host_row]
    for l, k in enumerate(host.sizes):
        jitter, rot = (d[:cur.shape[0]].contiguous() for d in hop_draws(
            (rows[l],), k, seeded_generator(host.device, args.seed, 1, l)))
        kern = uniform_hop(host.topo.indptr, host.topo.indices, cur, num, jitter, rot)
        plain = uniform_hop_plain(hbm.topo.indptr, hbm.topo.indices, cur, num, jitter, rot)
        sync()
        ok = all(equal(a, b) for a, b in zip(kern, plain))
        k1_rows.append({"case": f"beyond-HBM hop {l}: {cur.shape[0]} rows x {k}, "
                                f"indices over UVA, against the plain version",
                        "match": ok, "max_abs_err": max_err(kern, plain)})
        check(ok, f"beyond-HBM hop {l}: uniform_hop over UVA == plain")
        cur, num, _col, _ovf = reindex_layer(cur, num, kern[0], caps[l])
    check(equal(cur, got.n_id), "beyond-HBM: the replayed hops give the call's n_id")
    f = run.feature
    reset_launches()
    x = f[got.n_id]
    sync()
    expect_launches(read_launches(), {"tiered_gather": 1}, "beyond-HBM lookup")
    want_x = tiered_gather_plain(got.n_id.to(torch.int32).contiguous(), f.feature_order,
                                 f.hot_rows, f.hot, f.cold)
    ok = equal(x, want_x)
    check(ok, "beyond-HBM lookup == tiered_gather_plain")
    nv, nc, _dev_bytes, _cold = lookup_bytes(f, got.n_id)
    k2_rows = [{"store": f"beyond-HBM store: {f.hot_rows} hot / {f.shape[0] - f.hot_rows} "
                         f"pinned rows x F={f.shape[1]} f32, a call's n_id ({nv} ids, "
                         f"{nc} cold)", "ids": int(got.n_id.numel()), "hot_rows": f.hot_rows,
                "match": ok, "max_abs_err": float((x - want_x).abs().max())}]
    return k1_rows, k2_rows, (got, x), hbm


def offload_step_parity(run, caps, got, x):
    """One ``DataParallelTrainer.step`` on the card (``make_mesh()``)
    against the same step on a CPU mesh: the same batch, and the card
    model's weights moved by their state dict; dropout 0, SGD lr 0.
    Phase 8's tolerances (:func:`step_parity`)."""
    import copy

    import torch

    from quiver_tpu_torch import (Batch, DataParallelTrainer, GraphSAGE,
                                  GraphSageSampler, make_mesh)
    from quiver_tpu_torch.parallel.train import init_model

    args = run.args
    sampler = GraphSageSampler(run.topo, args.fanout, mode="HOST", seed_capacity=args.batch,
                               seed=args.seed, frontier_caps=caps, device="cuda")
    model = GraphSAGE(args.feature_dim, args.hidden, args.classes,
                      num_layers=len(args.fanout), dropout=0.0)
    init_model(model, torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model)
    model.to("cuda")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    seeds = got.n_id[:got.batch_size].cpu().numpy()
    sides = {}
    for dev, m, mesh in (("cuda", model, make_mesh()),
                         ("cpu", cpu_model, make_mesh(devices=["cpu"]))):
        trainer = DataParallelTrainer(mesh, sampler, run.feature, m,
                                      torch.optim.SGD(m.parameters(), lr=0.0),
                                      local_batch=args.batch)
        out = got if dev == "cuda" else got._replace(
            n_id=got.n_id.cpu(), adjs=[a.to("cpu") for a in got.adjs])
        loss = float(trainer.step([Batch(seeds, out, x.to(dev))], run.labels_all.to(dev)))
        sides[dev] = (loss, [p.grad.detach().cpu() for p in m.parameters()])
    (loss_g, grads_g), (loss_c, grads_c) = sides["cuda"], sides["cpu"]
    rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = [float((g - c).abs().max()) / float(c.abs().max())
                for g, c in zip(grads_g, grads_c)]
    check(rel <= 1e-5, f"beyond-HBM dp step: loss {loss_g} (card) vs {loss_c} (CPU)")
    check(max(grad_err) <= 1e-4, f"beyond-HBM dp step: gradient errors / max |g| {grad_err}")
    return {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": rel,
            "max_grad_err_over_max": max(grad_err), "rows": int(x.shape[0]),
            "tolerance": "loss 1e-5 relative; each gradient 1e-4 x max |g|"}


def offload_phase(card, pcie_bytes_per_s):
    """Phase 9d (see the module docstring). Returns ``(launches of each
    timed run, K1's check rows, K2's check rows, K1's and K2's timings at
    the path's shapes, result)``."""
    import numpy as np
    import torch

    from examples.train_host_offload_torch import parse_args, setup
    from quiver_tpu_torch import DataParallelTrainer, GraphSAGE, GraphSageSampler, make_mesh
    from quiver_tpu_torch.parallel.train import make_train_step

    t0 = time.time()
    args = parse_args(["--device", "cuda"])
    run = setup(args)
    B, n = args.batch, run.topo.node_count
    # the twin's first sample plans the auto caps (as its loop does)
    out0 = run.sampler.sample(run.rng.integers(0, n, B))
    run.feature[out0.n_id]
    del out0
    sync()
    caps, worst = run.sampler._frontier_caps, run.sampler._worst_caps(B)
    check(run.sampler.kernel == "pallas" and run.feature.kernel == "pallas",
          "beyond-HBM: the fused hop and K2's lookup (no composed path, no stock lookup)")
    setup_s = time.time() - t0
    log(f"beyond-HBM set-up {setup_s:.1f}s: {n} nodes, {run.topo.edge_count} edges; "
        f"{run.feature.hot_rows} hot rows; caps {caps} (worst case {worst})")
    step = make_train_step(run.model, run.optimizer)
    loop = {d: offload_timed("loop", lambda k, depth, first, clock=None: offload_loop(
                run, step, k, depth, first, clock), run.sampler, run.feature, d,
                args.steps, card) for d in (args.prefetch_depth, 0)}

    # the same configuration through DataParallelTrainer on make_mesh(): a
    # fresh HOST sampler (its probe pins the caps), model and optimizer
    dp_sampler = GraphSageSampler(run.topo, args.fanout, mode="HOST", seed_capacity=B,
                                  seed=args.seed, frontier_caps="auto", device="cuda")
    model = GraphSAGE(args.feature_dim, args.hidden, args.classes,
                      num_layers=len(args.fanout)).to("cuda")
    trainer = DataParallelTrainer(make_mesh(), dp_sampler, run.feature, model,
                                  torch.optim.Adam(model.parameters(), lr=1e-3),
                                  local_batch=B)
    trainer.init(torch.Generator().manual_seed(0))
    dp = {d: offload_timed("dp", lambda k, depth, first, clock=None: offload_dp(
              trainer, run, k, depth, first, clock), dp_sampler, run.feature, d,
              args.steps, card) for d in (args.prefetch_depth, 0)}
    check(all(r["reruns"] == 0 for r in dp.values()), "beyond-HBM dp: the caps stay pinned")
    cold = offload_cold(run.feature, loop[0].pop("cold"), pcie_bytes_per_s)
    dp_cold = offload_cold(run.feature, dp[0].pop("cold"), pcie_bytes_per_s)

    # (c) the kernels at this path's shapes, and the card's step
    seeds = run.rng.integers(0, n, B)
    k1_rows, k2_rows, (got, x), hbm = offload_parity(run, caps, seeds)
    parity = offload_step_parity(run, caps, got, x)
    # (d) K1 over the UVA indices, both hops, and K2 on a step's ids, in
    # turns with their yardsticks
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    rng = np.random.default_rng(9)
    host_topo = run.sampler.topo
    t_hops = [time_hop(run.topo, host_topo, (rows,), k, g, rng, 50, 5, plain_topo=hbm.topo,
                       pcie_bytes_per_s=pcie_bytes_per_s)
              for rows, k in ((B, args.fanout[0]), (caps[0], args.fanout[1]))]
    t_lookup = time_lookup(run.feature, got.n_id.to(torch.int32), pcie_bytes_per_s, 10, 5)
    del hbm, got, x
    log(f"beyond-HBM K1 over UVA: {[round(t['ms'], 4) for t in t_hops]} ms (composed "
        f"{[round(t['composed_ms'], 4) for t in t_hops]}, bound "
        f"{[round(t['bound_ms'], 5) for t in t_hops]}); K2 {t_lookup['ms']:.4f} ms "
        f"(staged {t_lookup['yard_ms']:.4f}, bound {t_lookup['bound_ms']:.4f}) [{card}]")
    launches = {f"{name} depth {d}": r["launches"]
                for name, runs in (("loop", loop), ("dp", dp)) for d, r in runs.items()}
    result = {
        "config": "examples/train_host_offload.py defaults: "
                  "generate_pareto_graph(1000000, 15.0, seed=0), F=128 f32, 172 classes, "
                  "GraphSAGE 256 x 2, fanouts [12, 8], batch 1024, mode HOST, auto caps, "
                  "cache 10% (degree-ordered hot rows on the card, the rest pinned), "
                  "Adam 1e-3, dropout 0.5",
        "nodes": n, "edges": run.topo.edge_count, "hot_rows": run.feature.hot_rows,
        "setup_s": setup_s, "caps": list(caps), "worst_caps": list(worst),
        "dp_caps": list(dp_sampler._frontier_caps),
        "loop": {str(d): r for d, r in loop.items()},
        "dp": {str(d): r for d, r in dp.items()},
        "cold_loop_depth_0": cold, "cold_dp_depth_0": dp_cold,
        "pcie_h2d_bytes_per_s": pcie_bytes_per_s, "dp_step_parity": parity,
        "k1_uva_hops": t_hops, "k2_lookup": t_lookup, "card": card,
        "seconds": time.time() - t0}
    log(f"beyond-HBM: {n} nodes, {run.topo.edge_count} edges; cold rows "
        f"{cold['cold_rows_per_step']} ({cold['cold_bytes_per_step'] / 2**20:.2f} MiB) "
        f"per step; phase {result['seconds']:.1f}s [{card}]")
    return launches, k1_rows, k2_rows, (t_hops, t_lookup), result


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
    phase_s, last = {}, [time.time()]

    def lap(label: str) -> None:
        """Record the seconds since the last lap under ``label``."""
        now = time.time()
        phase_s[label] = now - last[0]
        last[0] = now

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
    lap("set-up and phase 3 checks")
    # int8 stores: the small graph's, and bench_feature.py's configuration
    # (its budget int(0.2 n) * F * 4 B, stored as int8 under the degree
    # reorder: 1,862,000 of 2,450,000 rows on the card)
    t0 = time.time()
    feat_q = Feature(device_cache_size=int(0.2 * n) * F * 4, csr_topo=topo,
                     dtype="int8", device="cuda").from_cpu_tensor(x_all)
    if n == PRODUCTS_NODES:
        check(feat_q.hot_rows == 1_862_000, f"int8 hot rows {feat_q.hot_rows}")
    log(f"int8 store built in {time.time() - t0:.1f}s: {feat_q.hot_rows} hot / "
        f"{n - feat_q.hot_rows} cold rows")
    deq = tiered_checks(int8_stores(x_small, small_topo)
                        + [("int8 bench_feature store, reorder", feat_q)], rng)
    lap("phase 3 int8 stores and checks")
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
    lap("phase 3 timing at serving shapes")
    # the int8 lookup at bench_feature.py's configuration: 65,536 uniform ids
    q_ids = torch.from_numpy(rng.integers(0, n, 65_536).astype(np.int32)).to("cuda")
    t_q = time_lookup(feat_q, q_ids, pcie, 50, 5)
    log(f"int8 lookup, 65,536 ids: {t_q['ms']:.4f} ms (staged lookup in torch ops "
        f"{t_q['yard_ms']:.4f}, plain {t_q['plain_ms']:.4f}, bound {t_q['bound_ms']:.4f})")
    del feat_q, q_ids
    lap("phase 3 int8 lookup timing")
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
    lap("phase 3 bulk timing")
    # the elections, before any store or sampler resolves kernel="auto"
    elect = election_phase(topo, x_all, feat_cold, rng)
    check(feat_hot.kernel == feat_cold.kernel == "pallas",
          "the serving stores' auto lookups resolve to K2")
    lap("elections")

    # phases 4 and 5: serve (the main paths; launch counts are read there)
    launches_u, serve_u = serve_phase(
        args, topo, feat_hot,
        [("tiered store", None, feat_cold),
         ("UVA topology", {"mode": "UVA"}, feat_hot)], card, weighted=False)
    launches_w, serve_w = serve_phase(
        args, topo, feat_hot, [("UVA topology", {"mode": "UVA"}, feat_hot)],
        card, weighted=True)
    del feat_hot
    lap("phases 4 and 5")
    # uniform serving over the tiered store stored as int8: 612,500 rows on
    # the card (the scales charged first), the rest pinned
    feat_q = Feature(device_cache_size=4 * n + (n // 4) * F, csr_topo=topo,
                     dtype="int8", device="cuda").from_cpu_tensor(x_all)
    check(feat_q.hot_rows == n // 4, f"int8 serving store hot rows {feat_q.hot_rows}")
    launches_q, serve_q = serve_phase(args, topo, feat_q, [], card, weighted=False)
    del feat_q
    lap("int8 serving")

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
    lap("phases 6 and 7")

    # phases 8 and 9: train (the twin's main path; its launches are read there)
    launches_t, train = train_phase(card, pcie)
    lap("phase 8")
    # int8 storage: (a) the same byte budget, (b) the f32 run's hot rows
    launches_qa, train_qa = train_phase(card, pcie, int8=True, parity=False)
    lap("int8 training (a)")
    budget_b = train["hot_rows"] * train["feature_dim"] + 4 * train["nodes"]
    launches_qb, train_qb = train_phase(card, pcie, int8=True, budget=budget_b,
                                        parity=False)
    check(train_qb["hot_rows"] == train["hot_rows"], "int8 (b) keeps the f32 hot rows")
    lap("int8 training (b)")
    accept = acceptance_phase(card)
    lap("phase 9 (with its int8 run)")
    # phase 9b: bench_epoch's host loop for every family (serial and
    # through the Prefetcher), GCN/GIN/GAT against the CPU, their
    # layer-wise inference, and the --save-dir resume drill
    epoch = epoch_phase(topo, card)
    lap("phase 9b (epoch loop, families, resume)")
    # phase 9c: bench_rgcn.py's R-GCN and bench_saint.py's samplers at
    # their defaults, and the two example twins
    launches_h, (win_checks, t_win), rows_h, hetero = hetero_saint_phase(card)
    lap("phase 9c (R-GCN, GraphSAINT, twins)")
    # phase 9d: beyond-HBM training at examples/train_host_offload.py's
    # defaults, the twin's loop and DataParallelTrainer
    launches_o, k1_rows_o, k2_rows_o, (t_uva_hops, t_off_lookup), offload = \
        offload_phase(card, pcie)
    torch.cuda.empty_cache()
    lap("phase 9d (beyond-HBM training)")
    # last, so that the earlier phases run as they did before them: serving
    # under telemetry (tracer, registry, recorder on against off), its
    # device idle share, and degraded serving through an outage, all over
    # phase 4's tiered store
    telemetry = {"uniform": telemetry_phase(args, topo, feat_cold, card, False),
                 "weighted": telemetry_phase(args, topo, feat_cold, card, True)}
    lap("serving under telemetry")
    idle = idle_phase(args, topo, feat_cold, card)
    lap("serving idle share")
    degraded = degraded_phase(args, topo, feat_cold, card)
    lap("degraded serving")
    # phase 11, last: it mutates the topology (the version drill)
    fleet = fleet_phase(args, topo, feat_cold, x_all, card)
    del feat_cold
    lap("phase 11 (serving fleet)")
    for mode in ("sampled", "layerwise", "int8_sampled"):
        log(f"planted:20000 {mode}: test acc {accept[mode]['test_acc']:.4f} "
            f"(feature-only Bayes {accept[mode]['feature_bayes_acc']:.4f})")

    k1, k2 = "quiver_tpu/ops/pallas/fused.py:75", "quiver_tpu/ops/pallas/gather.py:28"
    k3 = "quiver_tpu/ops/pallas/fused.py:113"
    kernels = [
        kernel_row("select", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   samp_t["launches"]["select"],
                   "temporal sampler (and the offs/draw_fn seams)",
                   sel + rows_h["select"], t_sel,
                   {"stock_ms": t_sel["stock_ms"], "ratio_to_stock": t_sel["ratio_to_stock"],
                    "shape": [t_sel["rows"], t_sel["k"]], "bound_rule": SELECT_BOUND_RULE,
                    "library": "none: its yardstick is the stock index_select "
                               "of the already-computed slots"},
                   card, name),
        kernel_row("uniform_hop", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   launches_u["uniform_hop"], "uniform serving",
                   hop + rows_h["uniform_hop"] + k1_rows_o, t_hop,
                   {"composed_ms": t_hop["composed_ms"],
                    "speedup_over_composed": t_hop["speedup_over_composed"],
                    "shape": t_hop["shape"] + [t_hop["k"]], "bound_rule": HOP_BOUND_RULE,
                    "train_launches": launches_t["uniform_hop"],
                    "epoch_launches_prefetch_2": {
                        f: r["launches_prefetch_2"]["uniform_hop"]
                        for f, r in epoch["families"].items()},
                    "degraded_serve_launches": {
                        k: degraded[k]["launches"]["uniform_hop"]
                        for k in ("zeros", "last-good")},
                    "launches_by": serve_u["launches_by"],
                    "replay_profile": serve_u["replay_profile"],
                    "fleet_serve_replayed": fleet["serve"]["launches"]["replayed"][
                        "uniform_hop"],
                    "rgcn_launches": launches_h["rgcn"]["uniform_hop"],
                    "saint_rw_launches": launches_h["saint"]["uniform_hop"],
                    "beyond_hbm": {
                        "launches": {k: v["uniform_hop"] for k, v in launches_o.items()},
                        "uva_hops": [{key: t[key] for key in (
                            "shape", "k", "ms", "plain_ms", "composed_ms", "bound_ms",
                            "bound_share", "uva_index_bytes")} for t in t_uva_hops]},
                    "library": "none: its yardstick is the composed path"},
                   card, name),
        kernel_row("gather_rows", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_h["saint"]["gather_rows"],
                   "GraphSAINT samplers (each draw's (budget, deg_cap) window; the "
                   "edge sampler's endpoints)", gat + win_checks, t_win,
                   {"shape": [t_win["ids"], t_win["row_bytes"]],
                    "ratio_to_library": t_win["ratio_to_library"],
                    "bound_rule": WINDOW_BOUND_RULE,
                    "serving_shape": {key: t_gat[key] for key in (
                        "ms", "plain_ms", "library_ms", "ratio_to_library", "bound_ms",
                        "bound_share", "ids", "row_bytes")},
                    "library": "torch.index_select"},
                   card, name),
        kernel_row("tiered_gather", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_u["tiered_gather"], "uniform serving (hot-only store)",
                   tier + rows_h["tiered_gather"] + k2_rows_o, t_tier,
                   {"ratio_to_library": t_tier["ratio_to_yard"],
                    "shape": [t_tier["ids"], t_tier["row_bytes"]],
                    "bound_rule": GATHER_BOUND_RULE, "tiered_store": t_tier_split,
                    "train_launches": launches_t["tiered_gather"],
                    "epoch_launches_prefetch_2": {
                        f: r["launches_prefetch_2"]["tiered_gather"]
                        for f, r in epoch["families"].items()},
                    "degraded_serve_launches": {
                        k: degraded[k]["launches"]["tiered_gather"]
                        for k in ("zeros", "last-good")},
                    "train_lookup_in_turns": train["lookup_in_turns"],
                    "rgcn_launches": launches_h["rgcn"]["tiered_gather"],
                    "beyond_hbm": {
                        "launches": {k: v["tiered_gather"] for k, v in launches_o.items()},
                        "lookup": {key: t_off_lookup[key] for key in (
                            "ids", "cold_rows", "cold_bytes", "ms", "plain_ms", "yard_ms",
                            "bound_ms", "bound_share")}}},
                   card, name),
        kernel_row("tiered_gather_dequant", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_qa["tiered_gather_dequant"],
                   "int8 training (a) (also int8 training (b) and int8 serving)",
                   deq, t_q,
                   {"yardstick": t_q["yardstick"], "yard_ms": t_q["yard_ms"],
                    "ratio_to_yard": t_q["ratio_to_yard"],
                    "shape": [t_q["ids"], t_q["stored_row_bytes"]],
                    "config": "bench_feature.py: 2,450,000 rows x F=100 stored "
                              "int8 under int(0.2 n) * F * 4 B, 65,536 uniform ids",
                    "bound_rule": GATHER_BOUND_RULE,
                    "serve_launches": launches_q["tiered_gather_dequant"],
                    "train_b_launches": launches_qb["tiered_gather_dequant"],
                    "train_lookup_in_turns": train_qa["lookup_in_turns"],
                    "library": "none: no single PyTorch call dequantises a "
                               "tiered lookup; its yardstick is the staged "
                               "lookup in stock torch ops"},
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
                    "library": K3_LIBRARY},
                   card, name),
        kernel_row("weighted_hop", "quiver_tpu_torch/ops/kernels/wselect.cu", k3,
                   launches_w["weighted_hop"], "weighted serving",
                   whop + rows_h["weighted_hop"], t_whop,
                   {"composed_ms": t_whop["composed_ms"],
                    "speedup_over_composed": t_whop["speedup_over_composed"],
                    "shape": t_whop["shape"] + [t_whop["k"]],
                    "bound_rule": WHOP_BOUND_RULE,
                    "launches_by": serve_w["launches_by"],
                    "replay_profile": serve_w["replay_profile"],
                    "rgcn_weighted_launches": launches_h["rgcn_weighted"]["weighted_hop"],
                    "library": K3_LIBRARY + "; its yardstick is the composed path"},
                   card, name),
    ]
    check(len(kernels) == len(ENTRIES)
          and all(k["launches"] > 0 and k["match"] for k in kernels)
          and launches_q["tiered_gather_dequant"] > 0
          and launches_qb["tiered_gather_dequant"] > 0,
          "every kernel launched on its main path and every entry matched")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"kernels": kernels, "bulk": bulk, "int8_lookup": t_q,
                       "serve": {"uniform": serve_u, "weighted": serve_w,
                                 "int8": serve_q},
                       "elections": elect, "telemetry": telemetry,
                       "serve_idle": idle, "degraded": degraded, "fleet": fleet,
                       "sampler": samplers, "train": train,
                       "train_int8_a": train_qa, "train_int8_b": train_qb,
                       "acceptance": accept, "epoch": epoch, "hetero_saint": hetero,
                       "beyond_hbm": offload,
                       "build_s": build_s, "graph_s": graph_s, "phase_s": phase_s,
                       "graph": {"nodes": topo.node_count,
                                 "edges": topo.edge_count,
                                 "max_degree": topo.max_degree}}, fh, indent=1)
    print(json.dumps({"bulk": bulk, "int8_lookup": t_q, "card": card}), flush=True)
    print(json.dumps({"serve": {"uniform": serve_u, "weighted": serve_w,
                                "int8": serve_q}}), flush=True)
    print(json.dumps({"elections": elect}), flush=True)
    print(json.dumps({"telemetry": {k: {key: v for key, v in t.items() if key != "parity"}
                                    for k, t in telemetry.items()}}), flush=True)
    print(json.dumps({"serve_idle": idle}), flush=True)
    print(json.dumps({"degraded": degraded}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"sampler": samplers}), flush=True)
    for label, tr in (("train", train), ("train_int8_a", train_qa),
                      ("train_int8_b", train_qb)):
        print(json.dumps({label: {k: v for k, v in tr.items()
                                  if k not in ("per_step", "valid_rows_and_cold_rows")}}),
              flush=True)
    print(json.dumps({"acceptance": accept}), flush=True)
    print(json.dumps({"epoch": epoch}), flush=True)
    print(json.dumps({"hetero_saint": hetero}), flush=True)
    print(json.dumps({"beyond_hbm": {
        k: ({d: {key: v for key, v in r.items() if key != "per_step_ms"}
             for d, r in val.items()} if k in ("loop", "dp") else val)
        for k, val in offload.items()}}), flush=True)
    log(f"seconds by phase: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
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
