#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quiver_tpu_torch) on one GPU.

    python3 chip_smoke.py [--nodes N] [--requests R] [--report FILE]

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (K1 ``select.cu``, K2
   ``gather.cu``, K3 ``wselect.cu``) from the sources in this checkout, one
   ``nvcc`` each, in parallel. 2b. lint: ``quiver_tpu_torch.tools.lint``
   over ``quiver_tpu_torch/``, this script and ``examples/*_torch.py`` on
   this Python; any finding fails the run. 2c. audit: the program audit
   (``quiver_tpu_torch.tools.audit``) over its registry's 14 programs,
   each recorded once on the card and once on the CPU: 0 findings under
   every rule, no kernel-attribute finding suppressed (each launched
   kernel's registers, shared memory and block size read on the card),
   each target's card kernel nodes the CPU recording's, and each target's
   estimated growth (512 B blocks) against the growth of
   ``max_memory_allocated`` over one more run within the registry's
   ``PEAK_BAND``; prints an ``{"audit": ...}`` line.
3. kernel checks: hold every kernel entry bitwise against its plain
   PyTorch version on the card (K1's select and fused uniform hop, K2's
   single-table and tiered gathers and the int8 dequantising tiered
   gather, K3's search-and-select and fused weighted hop), on the
   products-scale graph (with exp(N(0,1)) edge weights) and feature tables
   (and wide f32 rows of 1 KB and 2.4 KB; int8 stores at F = 100, 602, 7,
   1000 and 2000, hot-only, cold-only and split, with and without the
   degree reorder, and code tables whose base is not 16 B aligned),
   a small graph with zero-weight rows and one whose rows take every degree
   of 0-40 and some up to 3232, device and pinned host (UVA) tables, and
   K2's lookups also at ids past the table (which read its last row); then
   time each entry at the serving path's shapes and in bulk, in turns with
   its yardstick (yardstick, kernel, kernel, yardstick) where it has one,
   beside its bound, and the int8 lookup at ``bench_feature.py``'s
   configuration (65,536 uniform ids, a 20%-of-f32 budget stored as int8)
   in turns with the same lookup in stock torch ops, and the rate at which
   the int8 entry reads cold rows over UVA against the f32 entry's at the
   same 65,536 cold ids, in turns, beside the pinned copy rate.
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
   checks; then that entry at the serving lookup's shape (384 ids) in
   turns with the lookup in stock torch ops.
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
9l. (run right after 9c (a), over its graph, store, planned samplers
   and model) ``bench_rgcn.py --stream 16``'s twin: 16 R-GCN steps as one
   stream of launches through ``hetero_stream_steps``
   (``HeteroGraphSampler.sample_padded`` with a device ``num_seeds``, the
   lookup, the labels, ``make_train_step``'s step), step ``t`` keyed
   ``fold_key(key0, 0, t)``, a ``(16, 512)`` seed matrix uploaded before
   each rep, one host read after the last step; a warm rep, 3 timed reps
   and one more under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronising call may happen: (a)), then one rep over the weighted
   relations. Exactly 80 ``uniform_hop`` (80 ``weighted_hop`` in the
   weighted rep) and 48 ``tiered_gather`` launches per rep (b); under
   deterministic kernels the 16 losses and the final parameters of the
   stream bitwise a loop of the same calls with a synchronise after every
   step (c); finite losses (d); the summed overflow printed, the caps
   planned, never regrown (e). The hops at the stream's shapes with a
   device ``num_seeds`` against the CPU, bitwise. Prints the stream's and
   9c's per-call step ms, the epoch seconds (``dispatch="stream"``),
   device busy ms, the idle share and device launches a step.
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
9e. the fused trainer: ``DistributedTrainer`` on ``make_mesh()`` (one
   worker) over phase 9b's graph and store, at ``benchmarks/bench_epoch.py
   --fused``'s configuration (fanouts [15, 10, 5], batch 1024, auto caps
   planned from one draw of 1024 seeds, GraphSAGE 256 x 3, Adam 1e-3).
   Every check names itself on stderr before it runs. (a) ``trainer.step``
   5 times untimed, then 20 timed: steps/s, peak memory, exactly 3
   ``uniform_hop`` and 1 ``tiered_gather`` launches per step and nothing
   else, the idle share and K1's and K2's device ms of 5 profiled steps.
   (b) A 64-step epoch (the first 64 x 1024 of ``default_rng(3)``'s
   permutation, a cut of bench_epoch's 196,615 train nodes) through
   ``epoch_scan`` at depth 0 twice and at depth 1, as the main path runs
   (steps/s at each depth; whether the depth-0 runs were bitwise and
   depth 1's distance are printed, not checked: the backward's
   scatter-adds use float atomics, and two runs differ in the last bits
   or by about 1e-5 by chance), then again under
   ``torch.use_deterministic_algorithms``, where depth 1's losses must
   lie within the spread rule (every step within 4 x the two depth-0
   runs' largest difference + 1e-6 x |loss|); in all six runs the seed
   matrix and every step's sampled ids are bitwise the first run's.
   (c) The guard drill: NaN rows at step 1, the guard on: that step
   leaves the parameters and Adam's state bitwise in the same run, one
   skipped step, one flight-recorder bundle, finite losses after. (d) The
   preemption drill, deterministic as (b)'s checked runs: checkpoints
   every 16 steps under ``OUT_DIR``, ``Preemption`` at step 40; a fresh
   trainer resumes at step 32, its restored state bitwise the saved one,
   the resumed steps within the spread rule against (b)'s deterministic
   depth-0 run. (e) One ``issue_block``: its hops replayed on its draws
   against ``uniform_hop_plain`` and its lookup against
   ``tiered_gather_plain``, bitwise; ``sample_padded`` == ``sample``,
   bitwise; one card step against the CPU's (dropout 0, phase 8's
   tolerances). (f) One full-width ``trainer.step`` recorded by the
   program audit: its kernel nodes equal its launches (3 ``uniform_hop``,
   1 ``tiered_gather``), its estimated growth beside the growth of
   ``max_memory_allocated`` over the same step.
9f. the mesh-sharded feature store (``ShardedFeature``) on logical meshes
   of this card (every mesh slot ``cuda:0``). Every check names itself on
   stderr before it runs. (a) Phase 9b's rows (the products-shaped graph,
   F = 100 f32) on the meshes ``(1, 4)`` and ``(2, 2)``, 2% of them on L0,
   18% on L1, the rest pinned: for a 3-hop frontier of 1024 seeds, the psum
   gather and the routed gather (uncapped, the planned cap, a cap of 1 that
   overflows) bitwise phase 9b's replicated K2 lookup and the numpy rows,
   the tier hits a numpy count, ``gather_rows`` launches exact (one for L0,
   one per shard per feature group, one for the cold rows); the psum and
   routed lookups timed in turns with the replicated one, K2's device ms of
   each and their bound. (b) ``examples/train_multichip.py``'s
   configuration (``generate_pareto_graph(100000, 25.0)``, F = 128, 47
   classes, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3) through
   ``DistributedTrainer`` on a ``(2, 2)`` mesh over a store of 8,192 L0,
   32,768 L1 and 59,040 cold rows, ``seed_sharding="data"`` and then
   ``"all"``: 3 + 10 steps (steps/s, peak memory), exactly 3 ``uniform_hop``
   per worker and 4 ``gather_rows`` per feature group each step, the idle
   share and K1's and K2's device ms of 5 profiled steps; one step's ids
   and rows bitwise the same step's over a replicated ``Feature``; 3 steps
   of the sharded and twice of the replicated trainer as the main path
   runs (distances printed) and under deterministic kernels (bitwise, and
   within the spread rule); then the twin's ``main`` with ``--data-axis 2
   --feature-axis 2 --steps 30 --seed-sharding all --replicate-budget
   4M`` (in this process, as phase 9c runs its twins), its tier hits
   printed. (c) One worker's hops replayed on its draws against
   ``uniform_hop_plain`` and ``gather_rows`` on the L0 block, each L1 shard
   and the pinned cold rows against ``gather_rows_plain``, bitwise.
9g. the topology partitioned over logical meshes of this card and the
   distributed samplers; every check names itself on stderr first. (a)
   ``bench_sampler.py --topo-sharding mesh``: the serving graph on ``(1,
   4)``, [15, 10, 5], a batch of 2048 split over the 4 workers,
   ``routed_alpha`` 2.0, uniform, weighted (its exp(N(0,1)) weights) and
   temporal (phase 7's timestamped copy): exactly one owner-side K1
   ``select`` (K3 ``wselect`` when weighted) per owner per hop and no fused
   hop, each call bitwise its plain version, every worker's ids and edges
   bitwise the replicated sampler's (``uniform_hop`` / ``weighted_hop`` /
   the temporal ``select``) on its block and draws, a cap of 1 and no cap
   bitwise the planned budget (the first overflows, the second does not);
   edges/s in turns with the replicated sampler (a, b, b, a), the
   partition's bytes, the owner-side kernel's device ms beside its bound at
   the calls' shapes, and the idle share of 5 profiled calls. (b)
   ``DistributedTrainer`` over a topology-sharded sampler at phase 9f
   (b)'s configuration under ``seed_sharding="all"``: 3 + 10 steps
   (steps/s, peak memory), exactly 12 ``select`` and 8 ``gather_rows`` a
   step, 5 profiled steps; one step's owner-side calls against
   ``select_plain``; one step's ids and rows bitwise the replicated
   topology's; 3 steps' losses as the main path runs and under
   deterministic kernels (bitwise, within the spread rule). (c)
   ``DistHeteroSampler`` on phase 9c's MAG-shaped graph at
   ``bench_rgcn.py``'s defaults on ``(1, 4)``, uniform and weighted: exact
   launches, the owner-side calls against their plain versions, every
   worker bitwise ``HeteroGraphSampler`` on its block with the same draws,
   one R-GCN step on a worker's block against the CPU's.
9h. the sharded store's int8 tiers, ``repin``, row updates and the cache
   controller, then ``DistributedTrainer(auto_alpha=, controller=)``;
   every check names itself on stderr first. (a) Phase 9f (a)'s rows
   stored as int8 (245 MB of codes, 9.8 MB of scales) on ``(1, 4)`` and
   ``(2, 2)``, 2% of the rows on L0 and 18% on L1 after the scales are
   charged, the rest pinned: for the same 3-hop frontier the psum and
   routed (uncapped, the planned cap, a cap of 1 that overflows) lookups
   bitwise the replicated int8 ``Feature``'s ``tiered_gather_dequant``
   lookup and the numpy int8 rows, the tier hits a numpy count, exactly
   one ``tiered_gather_dequant`` for L0 and one for the cold rows, each
   shard's codes by ``gather_rows`` and one ``tiered_gather_dequant``
   after their sum (psum) or per feature group after the exchange
   (routed), each K2 call bitwise its plain version; the lookups timed in turns with the
   replicated one, K2's device ms and their bound. (b)
   ``bench_feature.py``'s feature-controller configuration (a ``(1, 4)``
   mesh, a 20%-of-f32 budget, 16M of L0, ``routed_alpha`` 2), float32 and
   int8: its recorded trace (4 x 65,536 ids, 80% on the 1,024
   lowest-degree rows) feeds a ``CacheController`` whose ``maybe_repin``
   re-tiers the store; the trace's L0 hit rate before and after; every
   post-repin gather flavour bitwise the dense rows. (c) On that store one
   ``apply_row_updates`` in every tier (``version`` once; every flavour
   bitwise the patched rows), a duplicate id and a NaN row rejected with
   the store bitwise unchanged; ``note_degree_update`` on an ``auto_split``
   store moves the boundary once. (d) Phase 9f (b)'s trainer over an int8
   ``auto_split`` store with ``CacheController(heat_bins=256)`` and
   ``auto_alpha=True`` from ``routed_alpha=0.25``, ``"data"`` over the
   replicated sampler and ``"all"`` over a topology-sharded one: 3 + 10
   steps (steps/s, peak memory), exact K1 and K2 launches every step, alpha
   doubling after each overflowing step, the heat histogram counting every
   valid lane, 5 profiled steps; 3 steps under deterministic kernels
   bitwise for ``auto_alpha`` against ``auto_alpha=False`` uncapped and for a
   frozen controller against none; under ``"all"`` one ``epoch_scan``
   whose ``end_epoch`` repins (the next step runs) and a manual repin that
   raises ``VersionMismatchError`` until ``refresh()``.
9i. elastic resume across logical mesh shapes (``benchmarks/chaos.py``'s
   resize drill and the JAX package's
   ``test_elastic_resume_cross_mesh_bit_parity`` at full width); every
   check names itself on stderr first. Phase 9f (b)'s configuration
   (``train_multichip``'s graph, rows and model, a three-tier store of 8M
   L1 and 4M L0 per device) through ``DistributedTrainer(seed_sharding=
   "all", logical_workers=4)`` over a topology-sharded sampler, under
   deterministic kernels: (a) a 9-step epoch on ``(1, 4)`` (checkpoints
   every 3 steps), exact K1 ``select`` and K2 ``gather_rows`` launches;
   (b) the same epoch preempted by ``FaultPlan(preempt_at_step=3)``; (c)
   resumed onto ``(1, 2)`` (2 blocks a slot) and again from the first
   checkpoint onto ``(1, 1)`` (4 blocks): the remaining losses and the
   final parameters bitwise (a)'s, exact launches, the seconds to resume
   and steps/s per mesh; (d) a trainer built afresh on ``(1, 2)`` resuming
   the ``(1, 4)`` checkpoint, bitwise (a); (e) an int8 store replanned
   ``(1, 4)`` -> ``(1, 2)`` -> ``(1, 1)``, its psum and routed lookups
   bitwise before and after, one ``tiered_gather_dequant`` for L0 and one
   for the cold rows, the shards' codes by ``gather_rows`` and one
   dequantising launch after their sum or the exchange.
9j. the out-of-core epoch at ``benchmarks/ooc_drill.py``'s defaults
   (550,503 nodes x 128 f32, 4.2x the 64 MiB budget, degree 10, 10% hot,
   [5, 5] x 128, 8 steps, 2 measured epochs); every check names itself on
   stderr first. The topology saved raw and loaded memory-mapped, the rows
   written by ``MmapFeatureStore.write`` and read with ``pread`` (windows
   of 1,024 rows, 8 cached); ``DataParallelTrainer`` on a logical ``(2,
   1)`` mesh through the Prefetcher, under deterministic kernels: the
   measured epochs' losses bitwise the same run over the in-RAM
   ``Feature``, exactly 2 ``uniform_hop`` and 2 ``tiered_gather`` launches
   a step, ``readahead_hits > 0``, the growth of ``VmRSS`` over the
   measured epochs under the budget (an address-space limit cannot bound a
   CUDA process); one lookup's K2 launch over the pinned staged block
   bitwise its plain version; the lookup timed in turns with the in-RAM
   one; ``CacheController.maybe_promote`` restages measured-hot disk rows
   and the lookups stay bitwise.
9k. transactional streaming mutation and the native CSR build; every
   check names itself on stderr first. (a) ``benchmarks/chaos.py``'s
   ``mutate`` drill at ``train_multichip``'s width: a ``ShardedFeature``
   on the logical ``(1, 4)`` mesh, a ``GraphSageSampler(topo_sharding=
   "mesh")`` at [15, 10, 5] x 256 and a ``StreamingGraph`` over both;
   three malformed batches quarantined (the counter reads 3, nothing
   staged); an injected failure at ``merge``, ``verify`` and ``features``
   each leaves both versions at 0 and the sample bitwise the pre-commit
   oracle; a commit of 4,096 inserts, 1,024 deletes of live edges and 512
   row updates publishes version 1 on both, the stale sampler raises until
   ``refresh_topology()``, every sampled edge is an edge of the merged CSR
   (exactly 12 owner-side ``select`` launches), and the updated rows
   gather bitwise from every tier; ingest, commit and refresh ms. (b) the
   epoch differential under deterministic kernels: ``DistributedTrainer(
   seed_sharding="all")`` over a topology-sharded sampler and an f32 store
   in identity row order, Adam; an 8-step epoch, the same delta committed
   at the boundary, ``step`` raising until ``refresh()``, an 8-step epoch
   on the mutated state; a trainer over the rebuilt graph and rows, given
   the same post-epoch-0 state and keys: the merged CSR, the samples, the
   losses and the parameters bitwise; the crash twin (a ``verify`` failure
   between the epochs) bitwise the uncrashed run; exactly 12 ``select``
   and 6 ``gather_rows`` launches a step. (c) the native host library
   built and loaded (required); ``CSRTopo`` over the products-shaped graph
   (62.6M edges) natively and with numpy, in turns, bitwise (dtypes
   included); one commit of 1,024 inserts and 256 deletes on it, bitwise
   the native rebuild of the final COO; bench_rgcn's ``HeteroCSRTopo``,
   native bitwise numpy.
9m. the trainers over a world of processes (A.11e (a1)); every check
   names itself on stderr first. ``init_distributed`` over ``nccl`` with a
   world of one rank (a file store under the git-ignored
   ``.smoke_scratch/``), the world mesh ``(1, 1)`` and, beside it, the
   logical ``(1, 1)`` mesh of the card, at phase 9f (b)'s configuration
   (the twin's defaults and width, a fresh three-tier store of 8M L1 and 4M
   L0 per device, the guard on): ``DistributedTrainer`` over a routed f32
   store (``"all"``) and a psum int8 one (``"data"``), 4 steps of each form
   under deterministic kernels: losses, tier hits, overflow, guard counters
   and parameters bitwise the logical mesh's, exactly 3 ``uniform_hop``
   and the store's K2 launches per step in both forms, every collective
   (``parallel/world.py`` ``CALLS``) on CUDA tensors; steps/s of the two
   forms in turns and the collectives per step. ``DataParallelTrainer``
   over a replicated ``Feature``: a 4-step epoch of each form, bitwise,
   3 ``uniform_hop`` and 1 ``tiered_gather`` a step. The process group is
   torn down; then a 2-rank ``nccl`` world on the one card is tried once
   (two processes, one ``all_reduce`` on ``cuda:0``, killed after 60 s)
   and what NCCL said is printed: a refusal is reported, not routed
   around.
9n. the topology-sharded samplers, checkpoints and the elastic resume over
   a world of processes (A.11e (a2)); every check names itself on stderr
   first. A world of one rank over ``nccl`` (a file store under
   ``.smoke_scratch/``) beside the logical ``(1, 1)`` mesh. (a) phase 9g
   (b)'s trainer (9f (b)'s width under ``"all"`` over a topology-sharded
   sampler), uniform and then weighted (exp(N(0, 1)) weights): 4 steps of
   each form under deterministic kernels: losses, tier hits, routed and
   per-hop overflow, guard counters and parameters bitwise, exactly 3
   owner-side ``select`` (``wselect``) and 3 ``gather_rows`` launches a
   step in both forms, every collective on CUDA tensors; one world step's
   owner-side calls against their plain versions; the rank's topology
   shard on the card; steps/s of both forms in turns and the collectives
   per step. (b) ``DistHeteroSampler`` at ``bench_rgcn.py``'s
   configuration, uniform and weighted: the world sample bitwise the
   logical one, one owner-side launch per relation hop. (c) phase 9i's
   elastic epoch (``logical_workers=4``) on the world of one, preempted at
   step 3; the group torn down; a fresh world of one (a new file store)
   and a new trainer resume it with ``resume(mesh=trainer.mesh)``: the
   tail bitwise the uninterrupted logical ``(1, 4)`` run, exact launches;
   the same checkpoint resumed on the logical ``(1, 2)`` mesh, bitwise
   too.
9o. the adaptive tuners over a world of processes (A.11e (a3)); every
   check names itself on stderr first. A world of one rank over ``nccl``
   (a file store under ``.smoke_scratch/``) beside the logical ``(1, 1)``
   mesh, at phase 9h (d)'s configuration (the twin's width over an int8
   ``auto_split`` store of 8M L1 and 4M L0 per device, the trainer's
   ``replicate_budget`` starting L0 at half that ceiling,
   ``CacheController(heat_bins=256, repin_min_gain=0)``, ``auto_alpha``
   from ``routed_alpha=0.25``), ``"data"`` over the replicated sampler and
   ``"all"`` over a topology-sharded one. Each form under deterministic
   kernels: 3 + 10 steps (the split tuner moves the boundary), an 8-step
   ``epoch_scan`` whose ``end_epoch``
   repins, a ``StreamingGraph`` commit of row updates into every tier
   (the trainer stale until ``refresh``, the fresh rows served) and the
   next step: losses, alpha, the split, the store's version and order,
   the overflow counts, tier hits, heat, the decision list and the
   parameters bitwise the logical mesh's; exact K1 and K2 launches every
   step and the epoch, in both forms; every collective on CUDA tensors;
   one world step's K1 and K2 calls recorded where the sampler and the
   store make them, each bitwise its plain version; steps/s of both forms
   in turns.
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

9p. the reindex's two dedup strategies (``"sort"`` and ``"map"``; the
   port's ``"scan"`` runs the sort), last, on the serving graph; every
   check names itself on stderr first. ``dedup="auto"`` resolves to ``"sort"`` on the card. (a)
   ``GraphSageSampler`` per strategy over one placement at bench_epoch's
   [15, 10, 5] x 1024 (auto caps: the planning call and a planned one)
   and at the serving fanouts [5, 5] x 8, uniform and weighted: ids, edge
   lists and planned caps bitwise across the strategies, the same K1 and
   K3 launches; each hop's ``reindex_layer`` under every strategy on the
   same inputs (the planned call's, and the ladder's 8 lanes of one seed),
   CUDA events around each eager call and around each replay of a CUDA
   graph of one call, the median of 50 of each in two turns, with each
   strategy's peak memory growth (the map's ``(rows, 2,450,000)`` int32
   scratch); the planned sample in turns; each strategy once under
   ``torch.use_deterministic_algorithms(True)``, recording whether it
   raises (only PyTorch's "no deterministic implementation" error is
   recorded; any other fails the run). (b) an ``InferenceServer`` per
   strategy (phase 4's, over a hot-only store, one placement), both on
   one program cache: 8 captures each and no cache hit (the strategy
   forks the sample programs' fingerprint), the map's scratch inside the
   capture; 256 closed-loop
   queries twice, the servers in turns: the answers bitwise across the
   strategies, 2 replayed ``uniform_hop`` and 1 ``tiered_gather`` a batch
   under each; queries/s. (c) ``DistributedTrainer`` over the serving
   graph partitioned on the logical ``(1, 4)`` mesh (``"all"``, GraphSAGE
   100 x 256 x 47 x 3, [15, 10, 5] x 256 a worker, the hot-only store), 3
   steps per strategy under deterministic kernels: losses, overflow and
   parameters bitwise, the same launches. (d) ``HeteroGraphSampler`` and
   ``DistHeteroSampler`` (``(1, 4)``) at bench_rgcn's defaults per
   strategy: bitwise, the same launches.

9q. the layer-wise inference's ``QUIVER_INFER_AGG`` switch, last; every
   check names itself on stderr first. The port reads and checks the
   variable and runs its segment mean under ``"scatter"`` and ``"scan"``
   alike. (a) ``bench_infer.py``'s defaults on the serving graph (F = 100
   f32, GraphSAGE 256 x 2, 47 classes), HBM and HOST: a warm-up pass,
   then one pass under each value; nodes/s of each pass, its peak memory
   growth, exact launches (one ``segment_mean`` a layer, HOST reading the
   pinned edge array over UVA, and no K2); finite log-probs, ``"scan"``
   bitwise ``"scatter"``, HOST bitwise HBM; one more HBM pass under
   ``torch.profiler`` (device busy, idle share, the costliest kernels).
   (b) ``QUIVER_INFER_AGG=scna`` raises ``ValueError`` from the SAGE pass
   and not from GAT's. (c) ``segment_mean`` on the serving graph at F =
   100 (the features; ids on the card and pinned) and F = 256 (the hidden
   width) bitwise its plain version, the chunked, sorted accumulate that
   the passes ran before it (chunk 2^21), and each timed by CUDA events
   against it, beside its byte bound.

9r. one process over distinct devices, last; every check names itself on
   stderr first. Phase 9f (b)'s width (``generate_pareto_graph(100000,
   25.0)``, F = 128, 47 classes, GraphSAGE 256 x 3, [15, 10, 5] x 256,
   Adam 1e-3, dropout 0), a ``Feature`` with 20% of the rows on the lead
   device or a three-tier ``ShardedFeature`` (8M L1, 4M L0 per device), the guard on,
   deterministic kernels, every step's draws from one numpy seed through
   ``draw_fn`` (a host slot's generator cannot replay the card's Philox).
   (a) ``DistributedTrainer`` on logical meshes over the card and the host,
   ``(2, 1)`` and ``(1, 2)`` over ``["cuda:0", "cpu"]`` and ``(2, 2)`` over
   ``["cuda:0", "cpu", "cuda:0", "cpu"]``: a replicated ``Feature`` on all
   three, a psum int8 store (``"data"``), a routed f32 store (``"all"``)
   and a topology-sharded weighted sampler (``"all"``, routed f32 store)
   on the last two; 4 steps each against the one-card mesh of the same
   shape: every worker's ids, frontier size, rows and edge lists, the tier
   hits, overflows and guard counters bitwise, every worker's tensors on
   its slot's device, the card's K1/K2/K3 launches exact (the card slots'
   share: each launch counted on the device its work runs on; the one-card
   run held to the same rule), the losses within 1e-4 relative and the
   parameters within 1e-2 of their update; steps/s of each mixed mesh and
   its one-card twin in turns. (b) ``DataParallelTrainer`` on ``(2, 1)``
   over the card and the host: a 4-step epoch under its ``Prefetcher``,
   held as (a). (c) an elastic run (4 logical workers, ``auto_alpha`` and a
   ``CacheController``) checkpointed on the one-card ``(1, 4)``, preempted,
   resumed with ``resume(mesh=)`` onto the mixed ``(2, 2)``: the resumed
   steps' blocks bitwise the uninterrupted one-card ``(2, 2)`` epoch's,
   their hits and overflow and the tuners' decisions (the epoch's end, two
   tuned steps) the one-card twin's (resumed the same way), the floats
   within tolerance of the uninterrupted epoch. (d) with two cards,
   (a)'s routed store on ``(2, 2)`` over both, bitwise the one-card mesh;
   with one, a line says it did not run.

Prints one ``{"kernels": [...]}`` line with every kernel entry under its
TPU kernel; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the JAX package ``quiver_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import shutil
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
KERNELS = ("select", "gather", "wselect", "segment")
# the wrappers, each with its launch count: K1's two entries, K2's three,
# K3's two, the layer-wise segment mean
ENTRIES = ("select", "uniform_hop", "gather_rows", "tiered_gather",
           "tiered_gather_dequant", "wselect", "weighted_hop", "segment_mean")
SELECT_BOUND_RULE = (
    "4 B count per row and 4 B output per lane; 8 B start per row of count "
    "> 0 and 4 B offset per lane below its row's count (the kernel reads "
    "neither for the other lanes); one 32 B sector for each distinct "
    "sector of indices that the selected lanes touch (replayed)"
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
    "8 B start + 4 B deg per row; two 4 B outputs per lane; 4 B u per "
    "searching lane (a lane below k of a row of degree > k: the only "
    "lanes that read u); one 32 B sector for each distinct sector of "
    "cum_weights and of indices that this call's searches and selects "
    "touch (the row total's sector only where the kernel scales u)"
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
    "searching row's total where the kernel scales u, each of the `iters` "
    "bisection probes of each searching lane) and every indices load, "
    "shared or not"
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
    from quiver_tpu_torch.ops.kernels.segment import segment_mean

    return {"select": select, "uniform_hop": uniform_hop,
            "gather_rows": gather_rows, "tiered_gather": tiered_gather,
            "tiered_gather_dequant": tiered_gather_dequant,
            "wselect": wselect, "weighted_hop": weighted_hop,
            "segment_mean": segment_mean}


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


def offset_codes(codes, pinned_host: bool, skip: int = 1):
    """A contiguous copy of the code table ``codes`` that starts ``skip``
    bytes into a buffer on the card or in pinned host memory: a base that
    is not 16 B aligned."""
    import torch

    n, F = codes.shape
    flat = torch.empty(n * F + skip, dtype=torch.int8)
    flat = flat.pin_memory() if pinned_host else flat.to("cuda")
    view = flat[skip:].view(n, F)
    view.copy_(codes)
    return view


def unaligned_store(feat):
    """``feat`` (a split int8 store) with both code tiers copied to bases
    one byte past a 16 B boundary: the hot tier on the card, the cold one
    pinned."""
    import types

    return types.SimpleNamespace(
        shape=feat.shape, feature_order=feat.feature_order, hot_rows=feat.hot_rows,
        hot=offset_codes(feat.hot, False), cold=offset_codes(feat.cold.cpu(), True),
        scale=feat.scale)


def int8_stores(x_small, small_topo):
    """int8 stores of the small graph at F = 100, 602, 7, 1000 and 2000 (one
    row filling a stage of the kernel's ring, and two segments a row):
    hot-only, cold-only and split, with and without the degree reorder (row
    5 all zeros: scale 0); and at every F the split store with both code
    tables at a base that is not 16 B aligned."""
    import numpy as np

    from quiver_tpu_torch import Feature

    n = x_small.shape[0]
    rng = np.random.default_rng(7)
    stores = []
    for F in (100, 602, 7, 1000, 2000):
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
            if label == "split, reorder":
                stores.append((f"int8 F={F} {label}, unaligned bases",
                               unaligned_store(stores[-1][1])))
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


def select_bytes(start, offs, count) -> tuple[int, int]:
    """SELECT_BOUND_RULE's bytes of one ``select`` call on these
    arguments, and the distinct sectors of ``indices`` it touches."""
    import torch

    S, k = offs.shape
    lane = torch.arange(k, device=offs.device)[None, :] < count[:, None]
    sectors = distinct_sectors((start[:, None] + offs.to(torch.int64))[lane], 4)
    nbytes = (S * 4 + S * k * 4 + 8 * int((count > 0).sum()) + 4 * int(lane.sum())
              + SECTOR * sectors)
    return nbytes, sectors


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
    nbytes, sectors = select_bytes(start, offs, count)
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


def cold_rates(feat_q, feat_f32, count: int, pcie_bytes_per_s, rng) -> dict:
    """The rate at which K2 reads cold rows over UVA: ``count`` ids drawn
    from the nodes whose rows are cold in both the int8 store ``feat_q``
    and the f32 store ``feat_f32`` (each under its degree reorder), looked up by
    ``tiered_gather_dequant`` and by ``tiered_gather`` in turns (f32, int8,
    int8, f32); each rate the stored row bytes of the lookup over its
    time, beside the pinned copy rate measured in phase 3."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import (tiered_gather, tiered_gather_dequant,
                                                     tiered_gather_plain)

    cold = torch.nonzero((feat_q.feature_order >= feat_q.hot_rows)
                         & (feat_f32.feature_order >= feat_f32.hot_rows))
    check(cold.shape[0] > 0, "nodes cold in both stores")
    pick = torch.from_numpy(rng.integers(0, cold.shape[0], count)).to(cold.device)
    ids = cold[pick, 0].to(torch.int32)
    q_args = (ids, feat_q.feature_order, feat_q.hot_rows, feat_q.hot, feat_q.cold,
              feat_q.scale)
    f_args = (ids, feat_f32.feature_order, feat_f32.hot_rows, feat_f32.hot, feat_f32.cold)
    check(equal(tiered_gather_dequant(*q_args), tiered_gather_plain(*q_args)),
          "tiered_gather_dequant == plain on cold ids")
    check(equal(tiered_gather(*f_args), tiered_gather_plain(*f_args)),
          "tiered_gather == plain on cold ids")
    t = in_turns(lambda: tiered_gather_dequant(*q_args), lambda: tiered_gather(*f_args),
                 50, 5)
    F = feat_q.shape[1]
    q_bytes, f_bytes = count * F, count * F * 4
    return {"ids": count, "row_bytes": {"int8": F, "f32": F * 4},
            "int8_ms": t["ms"], "int8_turns": t["ms_turns"],
            "f32_ms": t["yard_ms"], "f32_turns": t["yard_turns"],
            "int8_cold_bytes_per_s": q_bytes / (t["ms"] * 1e-3),
            "f32_cold_bytes_per_s": f_bytes / (t["yard_ms"] * 1e-3),
            "pcie_h2d_bytes_per_s": pcie_bytes_per_s}


def wselect_sectors(dev_topo, start, deg, u, k, scale_u: bool = True):
    """Replay K3's searches (draws scaled by the row totals, or already
    scaled when not ``scale_u``; no eid lane) and count the 32 B sectors of
    ``cum_weights`` and ``indices`` they touch: every probe and load, and
    the distinct ones; and the searching lanes, the only ones that read
    ``u``. The row total is probed only where the kernel scales ``u``.
    Positions // 8 are sectors, since a 4 B array's allocation is
    sector-aligned."""
    import torch

    cw, iters = dev_topo.cum_weights, dev_topo.search_iters
    d = deg.to(torch.int64)
    i = torch.arange(k, device=d.device)
    take = (d <= k)[:, None] & (i[None, :] < d[:, None])
    loads = [(start[:, None] + i[None, :])[take]]  # take-all selects
    rows = d > k
    s, dd = start[rows][:, None], d[rows][:, None]
    probes = [(s + dd - 1).reshape(-1)] if scale_u else []  # the row totals
    lo, hi = s.expand(-1, k), (s + dd - 1).expand(-1, k)
    uu = u[rows] * cw[s + dd - 1] if scale_u else u[rows]
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
            "index_sectors": distinct_sectors(loads, 4),
            "searching_lanes": int(rows.sum()) * k}


def wselect_bytes(sec, rows: int, k: int) -> tuple[int, int]:
    """WSELECT_BOUND_RULE's bytes of one ``wselect`` call of ``rows`` x
    ``k`` lanes from its :func:`wselect_sectors`, and WSELECT_PROBE_RULE's."""
    dense = rows * 12 + rows * k * 8 + sec["searching_lanes"] * 4
    return (dense + SECTOR * (sec["cw_sectors"] + sec["index_sectors"]),
            dense + SECTOR * (sec["cw_probes"] + sec["index_loads"]))


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
    nbytes, probe_bytes = wselect_bytes(sec, S, k)
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
            if kernel_name(e.key) == name and e.self_device_time_total > 0]
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
            if kernel_name(k) in ("uniform_hop_kernel", "gather_kernel")}
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
    # the layer-wise path is deterministic on the card (the segment-mean
    # kernel adds each row's edges in CSR order; the same GEMMs), so the tables should agree bitwise; the stated
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
    edge of the last batch must be an in-window edge of its node. Returns
    ``(result, the timestamped CSRTopo)`` (phase 9g samples it again)."""
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
            "launches": launches, "edges_checked": checked, "card": card}, topo_t


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


_KERNEL_NAME = re.compile(r"^(?:void\s+)?(\w+)[<(]")


def kernel_name(key: str) -> str:
    """The identifier of the kernel a profiled device row names:
    ``gather_kernel`` for ``void gather_kernel<uint4>(...)``, and ``""``
    for a kernel in a namespace (ATen's ``void
    at::native::vectorized_gather_kernel<16, long>(...)``) or a row that is
    no kernel. A port kernel is matched by its whole name, never as a
    substring of another's (``gather_kernel`` of ATen's, ``select_kernel``
    of ``wselect_kernel``)."""
    m = _KERNEL_NAME.match(key)
    return m.group(1) if m else ""


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
    ours = {name: sum(ms for key, ms in kernels.items() if kernel_name(key) == name)
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
    are summed apart, as phase 9b reads them. Device launches are the
    kernels and copies the profiler saw on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps()
        sync()
    kernels, _spans = device_ms(prof, steps)
    busy = device_union_ms(prof, steps)
    check(busy > 0, "the profiler saw the card")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not annotation(e))
    return {"steps": steps, "device_busy_ms_per_step": busy,
            "device_launches_per_step": launches / steps,
            "device_summed_ms_per_step": sum(kernels.values()),
            "idle_share": 1 - busy / step_ms, "step_ms": step_ms,
            "port_kernels_ms_per_step": {n: sum(ms for k, ms in kernels.items()
                                                if kernel_name(k) == n)
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
    bench_infer's configuration; the resume drill. Returns ``(result, the
    store, the labels)``: phase 9e trains over the same store."""
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
    torch.cuda.empty_cache()
    result["layerwise"] = layerwise_families(topo, x_feat, card)
    result["resume"] = resume_drill(card)
    result["seconds"] = time.time() - t0
    return result, feat, labels_all


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


def mag_edges(rng):
    """``bench_rgcn.py``'s node counts and relations: paper-cites-paper
    from ``generate_pareto_graph(200000, 10.0, seed=0)``, then 3 writes per
    paper and 2 employs per author drawn from ``rng``."""
    import numpy as np

    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    num_nodes = {"paper": MAG_PAPERS, "author": MAG_AUTHORS, "inst": MAG_INSTS}
    return num_nodes, {
        ("paper", "cites", "paper"): generate_pareto_graph(MAG_PAPERS, 10.0, seed=0),
        ("author", "writes", "paper"): np.stack([
            rng.integers(0, MAG_AUTHORS, MAG_PAPERS * 3),
            rng.integers(0, MAG_PAPERS, MAG_PAPERS * 3)]),
        ("inst", "employs", "author"): np.stack([
            rng.integers(0, MAG_INSTS, MAG_AUTHORS * 2),
            rng.integers(0, MAG_AUTHORS, MAG_AUTHORS * 2)]),
    }


def mag_graph():
    """``bench_rgcn.py``'s graph, features and labels, drawn in its order
    from ``default_rng(0)``: paper-cites-paper from
    ``generate_pareto_graph(200000, 10.0, seed=0)``, 3 writes per paper, 2
    employs per author, F = 128 f32 per type, 16 labels."""
    import numpy as np

    from quiver_tpu_torch import HeteroCSRTopo

    rng = np.random.default_rng(0)
    num_nodes, edges = mag_edges(rng)
    topo = HeteroCSRTopo(num_nodes, edges)
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


def hetero_parity(topo, sampler, seeds, what: str, num=None):
    """One call of the hetero loop at the main path's planned caps: on the
    card over ``sampler.dev_topos`` (one fused K1 or K3 launch per relation
    per hop; ``num`` valid seeds, a device scalar, or ``len(seeds)``
    unnamed) against its plain run over the same relations placed on the
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
    got = hetero_multilayer_sample(sampler.dev_topos, ids.to("cuda"),
                                   len(seeds) if num is None else num, "paper",
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
    result, the phase's objects for phase 9l)``."""
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
    ctx = {"topo": topo, "feature": feature, "labels_all": labels_all, "sampler": sampler,
           "wsampler": wsampler, "model_args": model_args, "step": step,
           "iter_ms": iter_s * 1e3, "stage_ms": stage, "iteration": iteration}
    return launches, wlaunches, parity_rows, result, ctx


# -- phase 9l: R-GCN steps streamed with no host read ---------------------------

# benchmarks/bench_rgcn.py --stream 16 (benchmarks/scoreboard.py:109):
# one warm rep, 3 timed reps (:281-283), then one rep over weighted relations
RGCN_STREAM_STEPS, RGCN_STREAM_REPS = 16, 3


def step9l(what: str) -> None:
    """Name a phase 9l check on stderr before it runs."""
    log(f"phase 9l check: {what}")


def stream_steps(ctx, sampler, step, seed_mat, num, key0: int, synced: bool):
    """The stream's steps: ``hetero_stream_steps``, or with ``synced`` a
    loop of the same calls with a synchronise after every step. Returns
    ``(losses, overflow)`` on the device."""
    import torch

    from quiver_tpu_torch.ops.sample import fold_key, seeded_generator
    from quiver_tpu_torch.parallel.train import hetero_stream_steps

    feature, labels_all = ctx["feature"], ctx["labels_all"]
    if not synced:
        return hetero_stream_steps(sampler, feature, labels_all, step, seed_mat, num, key0)
    losses, overflow = [], torch.zeros((), dtype=torch.int32, device="cuda")
    for t in range(seed_mat.shape[0]):
        k = fold_key(key0, 0, t)
        frontier, _c, layers, ovf, _u = sampler.sample_padded(
            seed_mat[t], num, generator=seeded_generator("cuda", k, 0))
        seed_ids = frontier["paper"][:RGCN_BATCH]
        losses.append(step(feature[frontier], layers, labels_all[seed_ids.clamp(min=0)],
                           seed_ids >= 0, seeded_generator("cuda", k, 1)))
        overflow = overflow + ovf
        sync()
    return torch.stack(losses), overflow


def stream_rep(ctx, sampler, step, seed_mat, num, key0: int, debug: bool,
               synced: bool = False):
    """One rep of :func:`stream_steps` over ``seed_mat`` (under
    ``torch.cuda.set_sync_debug_mode("error")`` when ``debug``), then the
    one host read of the losses and the summed overflow. Returns ``(ms a
    step, losses, overflow, launches)``, the time from the first launch to
    the read."""
    import torch

    reset_launches()
    a = time.perf_counter()
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        losses, overflow = stream_steps(ctx, sampler, step, seed_mat, num, key0, synced)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    *vals, ovf = torch.cat([losses, overflow.to(losses.dtype)[None]]).tolist()
    ms = (time.perf_counter() - a) / seed_mat.shape[0] * 1e3
    return ms, vals, int(ovf), read_launches()


def stream_composition(ctx, seed_mat, num, key0: int) -> dict:
    """Check (c): under deterministic kernels, the stream from fresh
    ``init_model(seed 3)`` parameters against a loop of the same calls
    with a synchronise after every step, from the same parameters: the
    losses, the overflow and the final parameters bitwise."""
    import torch

    from quiver_tpu_torch import RGCN
    from quiver_tpu_torch.parallel.train import init_model, make_train_step

    runs = []
    with deterministic_algorithms():
        for synced in (False, True):
            model = RGCN(*ctx["model_args"])
            init_model(model, torch.Generator().manual_seed(3))
            model.to("cuda")
            step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=5e-3))
            losses, overflow = stream_steps(ctx, ctx["sampler"], step, seed_mat, num, key0,
                                            synced)
            sync()
            runs.append((losses, overflow, [p.detach().clone() for p in model.parameters()]))
    (la, oa, pa), (lb, ob, pb) = runs
    ok = (equal(la, lb) and equal(oa, ob) and len(pa) == len(pb)
          and all(equal(a, b) for a, b in zip(pa, pb)))
    return {"bitwise": ok, "losses_first_last": [float(la[0]), float(la[-1])],
            "parameters": len(pa)}


def rgcn_stream_phase(ctx, card):
    """Phase 9l: ``bench_rgcn.py --stream 16``'s twin over phase 9c's
    graph, store, planned samplers and model (see the module docstring).
    Returns ``(launches by rep, check rows by entry, result)``."""
    import math

    import numpy as np
    import torch

    t0 = time.time()
    rng = np.random.default_rng(19)
    num = torch.full((), RGCN_BATCH, dtype=torch.int32, device="cuda")

    def seed_mat():
        # one pageable upload (a synchronising copy) before each rep's loop
        return torch.from_numpy(rng.integers(
            0, MAG_PAPERS, (RGCN_STREAM_STEPS, RGCN_BATCH)).astype(np.int32)).to("cuda")

    uniform = {"uniform_hop": RGCN_HOPS * RGCN_STREAM_STEPS,
               "tiered_gather": RGCN_TYPES * RGCN_STREAM_STEPS}
    sampler, step = ctx["sampler"], ctx["step"]
    step9l("(a, b) the warm rep under sync debug mode, exact launches")
    _ms, losses, ovf, launches = stream_rep(ctx, sampler, step, seed_mat(), num, 1000, True)
    expect_launches(launches, uniform, "stream warm rep")
    # the timed reps as the benchmark times them, then one more under the
    # sync debug mode (its time printed beside theirs)
    reps = []
    for r in range(RGCN_STREAM_REPS + 1):
        debug = r == RGCN_STREAM_REPS
        step9l(f"(b, d) timed rep {r}: exact launches, finite losses"
               + (" (a) under sync debug mode: no sync" if debug else ""))
        mat = seed_mat()
        sync()
        ms, losses, ovf, launches = stream_rep(ctx, sampler, step, mat, num, 1001 + r, debug)
        expect_launches(launches, uniform, f"stream rep {r}")
        check(all(math.isfinite(v) for v in losses), f"stream rep {r}: finite losses {losses}")
        reps.append({"ms_per_step": ms, "final_loss": losses[-1], "overflow": ovf,
                     "sync_debug_mode": "error" if debug else "off", "launches": launches})
    step_ms = statistics.median(r["ms_per_step"] for r in reps[:RGCN_STREAM_REPS])
    # in turns, in this process state: 9c (a)'s per-call iteration (its
    # host reads and a synchronise after every stage; its own seeds), the
    # stream's calls with a synchronise after every step, and the stream
    turns = {"per_call": [], "synced_loop": [], "stream": []}
    reruns0 = sampler.reruns
    for r in range(2):
        for kind in ("per_call", "synced_loop", "stream", "stream", "synced_loop",
                     "per_call"):
            if kind == "per_call":  # 9c (a)'s iterations: sample, lookup, step
                turns[kind].append(statistics.fmean(
                    sum(ctx["iteration"](300 + t)[3]) for t in range(RGCN_STREAM_STEPS)) * 1e3)
                continue
            mat = seed_mat()
            sync()
            turns[kind].append(stream_rep(ctx, sampler, step, mat, num, 1010 + r, False,
                                          synced=kind == "synced_loop")[0])
    turns["per_call_reruns"] = sampler.reruns - reruns0
    # PROFILED_STEPS steps under the profiler, as 9c (a) profiles: a
    # session over a whole 16-step rep (about 10,000 device records) left
    # the profiler dropping device rows in every later session
    mat = seed_mat()[:PROFILED_STEPS]
    sync()
    prof = profiled_idle(
        lambda: stream_rep(ctx, sampler, step, mat, num, 1100, False), PROFILED_STEPS,
        step_ms, ("uniform_hop_kernel", "gather_kernel"))

    # --weighted's relations (phase 9c's exp(N(0, 1)) weights): K3 on every hop
    step9l("(a, b, d) the weighted rep: no sync, exact weighted_hop launches")
    mat = seed_mat()
    sync()
    wms, wlosses, wovf, wlaunches = stream_rep(ctx, ctx["wsampler"], step, mat, num, 1200,
                                               True)
    expect_launches(wlaunches, {"weighted_hop": RGCN_HOPS * RGCN_STREAM_STEPS,
                                "tiered_gather": RGCN_TYPES * RGCN_STREAM_STEPS},
                    "weighted stream rep")
    check(all(math.isfinite(v) for v in wlosses), f"weighted stream: finite losses {wlosses}")

    step9l("(c) the stream bitwise the synchronised composition (deterministic kernels)")
    composition = stream_composition(ctx, seed_mat(), num, 1300)
    check(composition["bitwise"], "stream == the loop with a synchronise after every step")

    # the kernels at the stream's shapes, a device num_seeds included,
    # against their plain versions on the CPU
    step9l("the hops at the stream's shapes on the card == plain on the CPU")
    prng = np.random.default_rng(21)
    u_row, _ = hetero_parity(ctx["topo"], sampler, prng.integers(0, MAG_PAPERS, RGCN_BATCH),
                             "stream uniform", num=num)
    w_row, _ = hetero_parity(ctx["topo"], ctx["wsampler"],
                             prng.integers(0, MAG_PAPERS, RGCN_BATCH), "stream weighted",
                             num=num)
    per_epoch = -(-(MAG_PAPERS // 10) // RGCN_BATCH)
    result = {
        "config": f"benchmarks/bench_rgcn.py --stream {RGCN_STREAM_STEPS} on phase 9c's "
                  "graph, store, planned caps and model: (16, 512) int32 seeds uploaded "
                  "before each rep, step t keyed fold_key(key0, 0, t), 1 warm-up + "
                  f"{RGCN_STREAM_REPS} timed reps, 1 under sync debug mode, then 1 weighted rep",
        "dispatch": "stream", "stream_batches": RGCN_STREAM_STEPS,
        "step_ms_median": step_ms, "per_call_iter_ms": ctx["iter_ms"],
        "per_call_stage_ms": ctx["stage_ms"], "iterations_per_epoch": per_epoch,
        "epoch_s": step_ms / 1e3 * per_epoch, "reps": reps,
        "overflow": [r["overflow"] for r in reps], "profile": prof,
        "weighted": {"ms_per_step": wms, "final_loss": wlosses[-1], "overflow": wovf,
                     "launches": wlaunches},
        "step_ms_sync_debug": reps[-1]["ms_per_step"],
        "in_turns_ms": turns,
        "composition": composition, "card": card,
        "seconds": time.time() - t0}
    log(f"R-GCN stream: {step_ms:.3f} ms a step ({reps[-1]['ms_per_step']:.3f} under sync "
        f"debug mode; 9c per call {ctx['iter_ms']:.3f}; in turns, medians: per call "
        f"{statistics.median(turns['per_call']):.3f}, synced loop "
        f"{statistics.median(turns['synced_loop']):.3f}, stream "
        f"{statistics.median(turns['stream']):.3f}), epoch "
        f"{result['epoch_s']:.3f} s; device busy {prof['device_busy_ms_per_step']:.3f} ms a "
        f"step, idle share {prof['idle_share']:.4f}, "
        f"{prof['device_launches_per_step']:.1f} device launches a step; overflow "
        f"{result['overflow']} (weighted {wovf}); weighted {wms:.3f} ms a step [{card}]")
    return ({"uniform": reps[-1]["launches"], "weighted": wlaunches},
            {"uniform_hop": [u_row], "weighted_hop": [w_row]}, result)


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
    """Phase 9c: R-GCN (a), then phase 9l over (a)'s objects, GraphSAINT
    (b), the twins (c). Returns
    ``(launches by part, K2's window row, the check rows of the kernels at
    the phase's shapes by entry, result)``."""
    import torch

    t0 = time.time()
    rgcn_launches, rgcn_wlaunches, rgcn_rows, rgcn, ctx = rgcn_phase(card)
    # phase 9l, over 9c (a)'s objects: the per-call and streamed steps in one run
    stream_launches, stream_rows, stream = rgcn_stream_phase(ctx, card)
    del ctx
    torch.cuda.empty_cache()
    saint_launches, k2_row, walk_rows, saint = saint_phase(card)
    torch.cuda.empty_cache()
    twins = twins_phase(card)
    rows = {name: rgcn_rows.get(name, []) + stream_rows.get(name, []) + walk_rows.get(name, [])
            for name in ENTRIES}
    return ({"rgcn": rgcn_launches, "rgcn_weighted": rgcn_wlaunches,
             "rgcn_stream": stream_launches, "saint": saint_launches}, k2_row, rows,
            {"rgcn": rgcn, "rgcn_stream": stream, "saint": saint, "twins": twins,
             "seconds": time.time() - t0})


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


# -- phase 2c: the program audit on the card ----------------------------------------


def step2c(what: str) -> None:
    """Name a phase 2c check on stderr before it runs."""
    log(f"phase 2c check: {what}")


def audit_phase(card) -> dict:
    """Phase 2c: the program audit (``quiver_tpu_torch/tools/audit``) on the
    card: ``run_audit(device="cuda")`` over every registry target and every
    rule (0 findings, no kernel-attribute finding suppressed); each
    target's kernel nodes against its CPU recording's (entries, shapes and
    dtypes, in order); each target's estimated growth, rounded to the
    allocator's 512 B blocks, against ``cuda_memory_stats``'s measured
    growth of ``max_memory_allocated`` over one more run, within
    ``audit_targets.PEAK_BAND``; and every kernel instantiation's
    registers, shared bytes and spills. Returns the ``audit`` line."""
    from quiver_tpu_torch.tools.audit import audit_targets, ir, mem
    from quiver_tpu_torch.tools.audit.runner import run_audit

    t0 = time.time()
    result = run_audit(device="cuda")
    audit_s = time.time() - t0
    step2c(f"0 findings over {len(result.targets)} targets and every rule")
    check(not result.findings, "graftaudit on the card: " + "; ".join(
        f"{f.rule}: {f.message}" for f in result.findings))
    attr_waived = [f.message for f in result.suppressed if f.rule == "vmem-budget"]
    step2c("no kernel-attribute finding suppressed")
    check(not attr_waived, f"kernel attributes suppressed on the card: {attr_waived}")
    nodes = {}
    for name in audit_targets.REGISTRY:
        card_nodes = ir.kernel_nodes(audit_targets.build(name, "cuda").program)
        cpu_nodes = ir.kernel_nodes(audit_targets.build(name, "cpu").program)
        step2c(f"{name}: the card's kernel nodes are the CPU recording's")
        check(card_nodes == cpu_nodes, f"{name}: kernel nodes on the card {card_nodes} "
              f"against the CPU's {cpu_nodes}")
        nodes[name] = [n[0] for n in card_nodes]
    lo, hi = audit_targets.PEAK_BAND
    rows = mem.peak_table(device="cuda", with_cuda=True)
    for r in rows:
        step2c(f"{r['target']}: estimated growth {r['growth_512_bytes']} B against the "
               f"card's {r['cuda_growth_bytes']} B within [{lo}, {hi}]")
        check(r["cuda_ratio"] is not None and lo <= r["cuda_ratio"] <= hi,
              f"{r['target']}: estimate / measured growth {r['cuda_ratio']} outside "
              f"[{lo}, {hi}]")
    kernels = [{"kernel": a["kernel"], "entry": a["entry"], "block": a["block"],
                "regs": a["regs"], "shared_bytes": a["shared_static"] + a["shared_dynamic"],
                "local_bytes": a["local"], "max_threads": a["max_threads"]}
               for attrs in mem.kernel_attrs().values() for a in attrs]
    step2c("every kernel instantiation spills 0 B; the int8 entry's ring and the "
           "segment mean's static row table (at most 256 B) are the only shared memory")
    check(all(k["local_bytes"] == 0 for k in kernels),
          f"spills: {[(k['kernel'], k['local_bytes']) for k in kernels if k['local_bytes']]}")
    segment = {k["kernel"] for k in kernels if k["entry"] == "segment_mean"}
    check({k["kernel"] for k in kernels if k["shared_bytes"]}
          == {f"gather_dequant_kernel<{s}>" for s in (4, 2, 1)} | segment
          and all(k["shared_bytes"] <= 256 for k in kernels if k["kernel"] in segment),
          f"shared memory: {[(k['kernel'], k['shared_bytes']) for k in kernels]}")
    out = {"targets": len(result.targets), "findings": len(result.findings),
           "suppressed": len(result.suppressed), "kernel_nodes": nodes, "kernels": kernels,
           "peak_table": rows, "peak_band": [lo, hi], "audit_s": audit_s,
           "seconds": time.time() - t0, "card": card}
    audit_targets.clear_cache()
    log(f"graftaudit on the card: {out['targets']} targets, 0 findings, "
        f"{out['suppressed']} suppressed, {out['seconds']:.1f}s [{card}]")
    return out


# -- phase 9e: the fused trainer (DistributedTrainer) ------------------------------

FUSED_WARMUP, FUSED_STEPS = 5, 20  # benchmarks/bench_epoch.py --fused: untimed, timed
FUSED_EPOCH_STEPS = 64  # a 64-step epoch: 64 x 1024 of bench_epoch's 196,615 train nodes
FUSED_CHUNK, FUSED_PREEMPT = 16, 40  # the preemption drill's checkpoints and kill step
FUSED_KERNELS = ("uniform_hop_kernel", "gather_kernel")  # K1, K2 by kernel name


def step9e(what: str) -> None:
    """Name a phase 9e check on stderr before it runs."""
    log(f"phase 9e check: {what}")


def fused_trainer(sampler, feat, dropout=0.5, optimizer="adam", **kw):
    """A ``DistributedTrainer`` on ``make_mesh()`` (one worker) over phase
    9b's store: GraphSAGE hidden 256 x 3 (``len(EPOCH_FANOUT)`` layers), 47
    classes, Adam 1e-3 (``optimizer="sgd0"``: SGD at lr 0, which leaves
    the parameters and keeps the gradients), parameters from ``init(0)``."""
    import torch

    from quiver_tpu_torch import DistributedTrainer, make_mesh

    model = make_family("sage", EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, len(EPOCH_FANOUT),
                        dropout=dropout).to("cuda")
    opt = (torch.optim.Adam(model.parameters(), lr=1e-3) if optimizer == "adam"
           else torch.optim.SGD(model.parameters(), lr=0.0))
    trainer = DistributedTrainer(make_mesh(), sampler, feat, model, opt,
                                 local_batch=EPOCH_BATCH, **kw)
    trainer.init(0)
    return trainer


def record_issues(trainer, into: list, keep=lambda block: block):
    """Make ``trainer`` append ``keep(block)`` of each block it issues to
    ``into`` (on the card)."""
    issue = trainer.issue_block

    def recording(*a, **kw):
        block = issue(*a, **kw)
        into.append(keep(block))
        return block

    trainer.issue_block = recording


def fused_step_run(sampler, feat, labels_all, n, card):
    """(a) ``bench_epoch.py --fused``'s loop: ``trainer.step`` 5 times
    untimed, then 20 timed (each ending in a synchronise; 10%-trimmed
    mean), exact launches, peak memory, then the idle share and K1's and
    K2's device ms of ``PROFILED_STEPS`` more steps under the profiler."""
    import math

    import numpy as np
    import torch

    trainer = fused_trainer(sampler, feat)
    rng = np.random.default_rng(1)  # bench_epoch: seed + 1
    for i in range(FUSED_WARMUP):
        trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all, i)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for i in range(FUSED_STEPS):
        seeds = rng.integers(0, n, EPOCH_BATCH)
        t0 = time.perf_counter()
        losses.append(trainer.step(seeds, labels_all, 100 + i))
        sync()
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    step9e("(a) exactly 3 uniform_hop and 1 tiered_gather launches per step")
    expect_launches(launches, {"uniform_hop": 3 * FUSED_STEPS,
                               "tiered_gather": FUSED_STEPS}, "fused trainer steps")
    losses = [float(v) for v in losses]
    step9e("(a) finite step losses")
    check(all(math.isfinite(v) for v in losses), "fused trainer: finite step losses")
    step_ms = trimmed_mean(times) * 1e3
    r = {"warmup": FUSED_WARMUP, "steps": FUSED_STEPS, "step_ms_trimmed_mean": step_ms,
         "steps_per_s": 1e3 / step_ms, "launches": launches,
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "loss_first_last": [losses[0], losses[-1]],
         "hits_last_step": trainer.last_tier_hits.tolist()}
    step9e("(a) the profiler sees the card")
    prof = profiled_idle(lambda: [trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all,
                                               1000 + k) for k in range(PROFILED_STEPS)],
                         PROFILED_STEPS, step_ms, FUSED_KERNELS)
    ours = prof.pop("port_kernels_ms_per_step")
    prof["profiled_steps"] = prof.pop("steps")
    del prof["step_ms"]
    r.update(prof, k1_device_ms_per_step=ours["uniform_hop_kernel"],
             k2_device_ms_per_step=ours["gather_kernel"])
    log(f"fused trainer step: {r['steps_per_s']:.4g} steps/s ({step_ms:.3f} ms), idle "
        f"share {r['idle_share']:.4f}, K1 {r['k1_device_ms_per_step']:.4f} ms, K2 "
        f"{r['k2_device_ms_per_step']:.4f} ms per step, peak "
        f"{r['peak_bytes'] / 2**30:.3f} GiB [{card}]")
    return r


def within_spread(got, ref, spread: float) -> tuple[bool, float]:
    """The spread rule: every step's ``|got - ref|`` at most ``4 x spread +
    1e-6 x |ref|``; also returns the largest difference."""
    diffs = [abs(a - b) for a, b in zip(got, ref)]
    ok = len(got) == len(ref) and all(
        d <= 4 * spread + 1e-6 * abs(b) for d, b in zip(diffs, ref))
    return ok, max(diffs, default=0.0)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block: the
    backward's ``index_add_`` and ``scatter_add_`` (the gathers' and the
    aggregations' gradients) run their deterministic kernels instead of
    float atomics, so one float trajectory repeats bitwise."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def epoch_runs(sampler, feat, labels_all, train_idx, ids, mode):
    """The 64-step epoch through ``epoch_scan`` at depth 0, depth 0 again
    and depth 1, each from ``init(0)``: steps/s and losses of each; the
    seed matrix and every step's sampled ids bitwise ``ids`` (a list
    filled by the first run when empty)."""
    import math

    import numpy as np

    runs = {}
    for label, depth in (("depth0", 0), ("depth0_again", 0), ("depth1", 1)):
        trainer = fused_trainer(sampler, feat, pipeline_depth=depth)
        seed_mat = trainer.pack_epoch(train_idx, seed=0)
        blocks = []  # each step's sampled ids
        record_issues(trainer, blocks, lambda block: block.n_id)
        sync()
        t0 = time.perf_counter()
        losses = trainer.epoch_scan(seed_mat, labels_all, 5).tolist()
        dt = time.perf_counter() - t0
        step9e(f"(b) {mode} {label}: {FUSED_EPOCH_STEPS} finite losses")
        check(len(losses) == FUSED_EPOCH_STEPS and all(math.isfinite(v) for v in losses),
              f"fused epoch {mode} {label}: {FUSED_EPOCH_STEPS} finite losses")
        if not ids:
            ids.extend([seed_mat, blocks])
        else:
            step9e(f"(b) {mode} {label}: the seed matrix and every step's ids bitwise "
                   "the first run's")
            check(np.array_equal(seed_mat, ids[0]),
                  f"fused epoch {mode} {label}: seed matrix bitwise the first run's")
            check(len(blocks) == len(ids[1])
                  and all(equal(a, b) for a, b in zip(ids[1], blocks)),
                  f"fused epoch {mode} {label}: every step's sampled ids bitwise the "
                  "first run's")
        runs[label] = {"depth": depth, "steps_per_s": FUSED_EPOCH_STEPS / dt,
                       "epoch_s": dt, "losses": losses}
        del trainer, blocks
    return runs


def spread_of(runs) -> dict:
    """The spread rule's terms over :func:`epoch_runs`' runs: the depth-0
    runs' largest difference, whether they were bitwise, and depth 1's
    largest difference from the first depth-0 run and its verdict."""
    import numpy as np

    a, b, d1 = (runs[k]["losses"] for k in ("depth0", "depth0_again", "depth1"))
    spread = max(abs(x - y) for x, y in zip(a, b))
    ok, worst = within_spread(d1, a, spread)
    bitwise = all(np.float32(x).view(np.int32) == np.float32(y).view(np.int32)
                  for x, y in zip(a, b))
    return {"depth0_bitwise_twice": bitwise, "depth0_spread": spread,
            "depth1_max_diff": worst, "within_spread_rule": ok}


def fused_epochs(sampler, feat, labels_all, n, card):
    """(b) The 64-step epoch at depth 0 twice and at depth 1, twice over:
    as the main path runs (steps/s; whether the depth-0 runs were bitwise
    and depth 1's distance, readings), then under
    :func:`deterministic_algorithms`, where depth 1 must lie within the
    spread rule of the two depth-0 runs. In every run the seed matrix and
    every step's sampled ids are bitwise the first run's.

    The rule is checked on the deterministic runs because the main path's
    float atomics do not give a spread to measure depth 1 against: two of
    its runs differ in the loss's last bits or by about 1e-5 by chance,
    depth 0 against depth 0 as often as depth 1 against depth 0."""
    import numpy as np

    train_idx = np.random.default_rng(3).permutation(n)[:FUSED_EPOCH_STEPS * EPOCH_BATCH]
    ids = []
    main = epoch_runs(sampler, feat, labels_all, train_idx, ids, "main path")
    main_spread = spread_of(main)
    with deterministic_algorithms():
        det = epoch_runs(sampler, feat, labels_all, train_idx, ids, "deterministic")
    del ids
    det_spread = spread_of(det)
    step9e("(b) deterministic: depth 1 within the spread rule of the two depth-0 runs")
    check(det_spread["within_spread_rule"],
          f"fused epoch (deterministic): depth 1 differs from depth 0 by up to "
          f"{det_spread['depth1_max_diff']} (depth-0 spread {det_spread['depth0_spread']})")
    for mode, sp, runs in (("main path", main_spread, main),
                           ("deterministic", det_spread, det)):
        log(f"fused epoch, {mode}: the two depth-0 runs bitwise: "
            f"{sp['depth0_bitwise_twice']} (spread {sp['depth0_spread']:.3g}); depth 1 "
            f"off by {sp['depth1_max_diff']:.3g}; steps/s depth 0 "
            f"{runs['depth0']['steps_per_s']:.4g} / {runs['depth0_again']['steps_per_s']:.4g}"
            f", depth 1 {runs['depth1']['steps_per_s']:.4g} [{card}]")
    ref = det["depth0"]["losses"]

    def strip(runs):
        return {k: {key: v for key, v in r.items() if key != "losses"}
                for k, r in runs.items()}

    return {"train_idx": f"first {FUSED_EPOCH_STEPS} x {EPOCH_BATCH} of "
                         "default_rng(3).permutation(n) (bench_epoch trains 196,615)",
            "main_path": {"runs": strip(main), **main_spread},
            "deterministic": {"runs": strip(det), **det_spread},
            "loss_first_last": [ref[0], ref[-1]],
            "rule": "every step |depth 1 - depth 0| <= 4 x max |depth 0 - depth 0 again| "
                    "+ 1e-6 x |loss|, checked under torch.use_deterministic_algorithms"
            }, ref, det_spread["depth0_spread"], train_idx


def fused_guard(sampler, feat, labels_all, n, card):
    """(c) The guard drill: NaN rows planned at step 1, the guard on; that
    step leaves the parameters and Adam's state bitwise as they were in
    the same run, ``resilience.skipped_steps`` reads 1, the recorder dumps
    one bundle, and the next steps' losses are finite."""
    import math
    import shutil

    import numpy as np

    from quiver_tpu_torch import FaultPlan, FlightRecorder
    from quiver_tpu_torch.obs import GUARD_NONFINITE, GUARD_SKIPPED

    d = os.path.join(OUT_DIR, "fused_guard_recorder")
    shutil.rmtree(d, ignore_errors=True)
    recorder = FlightRecorder(d)
    trainer = fused_trainer(sampler, feat, nonfinite_guard=True, recorder=recorder,
                            fault_plan=FaultPlan(nan_feature_steps=(1,), nan_rows=4))
    rng = np.random.default_rng(4)

    def state():
        return host_copy({"params": trainer.model.state_dict(),
                          "opt_state": trainer.optimizer.state_dict()})

    losses = [float(trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all, 0))]
    before = state()
    losses.append(float(trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all, 1)))
    after = state()
    skipped = int(trainer.metrics.value(GUARD_SKIPPED))
    nonfinite = int(trainer.metrics.value(GUARD_NONFINITE))
    for i in range(2, 5):
        losses.append(float(trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all, i)))
    step9e("(c) the poisoned step leaves the parameters and Adam's state bitwise")
    check(same_tree(before, after),
          "fused guard: the skipped step left the parameters and Adam's state bitwise")
    step9e("(c) resilience.skipped_steps reads 1, one flight-recorder bundle")
    check(skipped == 1 and nonfinite > 0 and not math.isfinite(losses[1]),
          f"fused guard: skipped {skipped}, non-finite {nonfinite}, loss {losses[1]}")
    check(len(recorder.bundles()) == 1, "fused guard: one flight-recorder bundle")
    step9e("(c) the following steps' losses are finite")
    check(math.isfinite(losses[0]) and all(math.isfinite(v) for v in losses[2:]),
          f"fused guard: finite losses around the skipped step {losses}")
    log(f"fused guard: step 1 skipped ({nonfinite} non-finite values), 1 bundle [{card}]")
    return {"losses": losses, "skipped": skipped, "nonfinite": nonfinite, "bundles": 1,
            "adam_step_counts": sorted({int(s["step"]) for s in
                                        after["opt_state"]["state"].values()})}


def fused_preempt(sampler, feat, labels_all, train_idx, ref, spread, card):
    """(d) The preemption drill, under :func:`deterministic_algorithms`
    as (b)'s checked runs: checkpoints every 16 steps under ``OUT_DIR``,
    ``Preemption`` at step 40; a fresh trainer resumes at step 32, the
    state it restores bitwise what was saved there, and the resumed steps
    within (b)'s spread rule against (b)'s uninterrupted depth-0 run."""
    import math
    import shutil

    from quiver_tpu_torch import FaultPlan, Preemption
    from quiver_tpu_torch.utils import checkpoint

    d = os.path.join(OUT_DIR, "fused_preempt")
    shutil.rmtree(d, ignore_errors=True)
    saved, restored = {}, []
    save, restore = checkpoint.Checkpointer.save, checkpoint.Checkpointer.restore

    def record_save(self, step, state, *a, **kw):
        saved[int(state["step"])] = host_copy(state)
        return save(self, step, state, *a, **kw)

    def record_restore(self, *a, **kw):
        state = restore(self, *a, **kw)
        restored.append(host_copy(state))
        return state

    checkpoint.Checkpointer.save = record_save
    checkpoint.Checkpointer.restore = record_restore
    try:
        with deterministic_algorithms():
            victim = fused_trainer(sampler, feat, checkpoint_dir=d, checkpoint_every=FUSED_CHUNK,
                                   fault_plan=FaultPlan(preempt_at_step=FUSED_PREEMPT))
            seed_mat = victim.pack_epoch(train_idx, seed=0)
            fired = False
            try:
                victim.epoch_scan(seed_mat, labels_all, 5)
            except Preemption:
                fired = True
            victim.checkpointer.close()
            victim_saves = sorted(saved)
            step9e("(d) Preemption at step 40 after the checkpoints at 16 and 32")
            check(fired and victim_saves == [16, 32],
                  f"fused preemption: raised {fired}, checkpoints at {victim_saves}")
            fresh = fused_trainer(sampler, feat, checkpoint_dir=d, checkpoint_every=FUSED_CHUNK)
            _, _, key, step, epoch = fresh.resume()
            step9e("(d) resumed at step 32, the restored state bitwise the saved one")
            check((key, step, epoch) == (5, 32, 0),
                  f"fused preemption: resumed at {(key, step, epoch)}")
            check(len(restored) == 1 and same_tree(saved[32], restored[0]),
                  "fused preemption: the restored state is bitwise the saved one")
            losses = fresh.epoch_scan(seed_mat, labels_all, key, epoch=epoch,
                                      start_step=step).tolist()
            fresh.checkpointer.close()
    finally:
        checkpoint.Checkpointer.save = save
        checkpoint.Checkpointer.restore = restore
    ok, worst = within_spread(losses, ref[step:], spread)
    step9e("(d) the resumed steps within the spread rule")
    check(len(losses) == len(ref) - step and all(math.isfinite(v) for v in losses) and ok,
          f"fused preemption: resumed losses off by up to {worst} (spread {spread})")
    log(f"fused preemption: resumed at step {step}, {len(losses)} steps within the "
        f"spread rule (off by {worst:.3g}) [{card}]")
    return {"checkpoints_before_the_kill": victim_saves, "resumed_at": step,
            "restored_bitwise": True,
            "resumed_steps": len(losses), "max_diff_from_uninterrupted": worst}


def replay_hops(sampler, caps, seeds, num, key: int, n_id, what: str, step) -> list:
    """The hops of a trainer block keyed ``key`` (its sample stream,
    ``seeded_generator(device, key, 0)``), replayed one by one on the
    block's own draws: each ``uniform_hop`` bitwise ``uniform_hop_plain``,
    the last frontier bitwise the block's ``n_id``. ``step`` names each
    check first. Returns K1's check rows."""
    from quiver_tpu_torch.ops.kernels.fused import uniform_hop, uniform_hop_plain
    from quiver_tpu_torch.ops.reindex import reindex_layer
    from quiver_tpu_torch.ops.sample import hop_draws, seeded_generator

    B = seeds.shape[0]
    gen_seed = seeded_generator("cuda", key, 0).initial_seed()
    rows = (B,) + tuple(map(max, sampler._worst_caps(B), caps))
    cur, cnt, k1_rows = seeds, num, []
    for l, k in enumerate(sampler.sizes):
        jitter, rot = (d[:cur.shape[0]].contiguous() for d in hop_draws(
            (rows[l],), k, seeded_generator("cuda", gen_seed, l)))
        args = (sampler.topo.indptr, sampler.topo.indices, cur, cnt, jitter, rot)
        kern, plain = uniform_hop(*args), uniform_hop_plain(*args)
        sync()
        ok = all(equal(a, b) for a, b in zip(kern, plain))
        k1_rows.append({"case": f"{what} hop {l}: {cur.shape[0]} rows x {k} "
                                "(the block's draws) against the plain version",
                        "match": ok, "max_abs_err": max_err(kern, plain)})
        step(f"hop {l} bitwise its plain version")
        check(ok, f"{what} hop {l}: uniform_hop == plain")
        cur, cnt, _col, _ovf = reindex_layer(cur, cnt, kern[0], caps[l])
    step("the replayed hops give the block's n_id")
    check(equal(cur, n_id), f"{what}: the replayed hops give the block's n_id")
    return k1_rows


def fused_kernels(sampler, feat, labels_all, n):
    """(e) The kernels at this path's shapes: one ``issue_block`` (3
    ``uniform_hop`` and 1 ``tiered_gather`` launches), its hops replayed
    one by one on its own draws against ``uniform_hop_plain`` and its
    lookup against ``tiered_gather_plain``, bitwise; ``sample_padded``
    against ``sample`` (a sampler at the trainer's caps), bitwise; one
    card step against the same step on a CPU copy (dropout 0, SGD lr 0),
    phase 8's tolerances. Returns ``(K1 rows, K2 rows, result)``."""
    import copy

    import numpy as np
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, make_mesh
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather_plain
    from quiver_tpu_torch.parallel.trainer import fold_key

    trainer = fused_trainer(sampler, feat, dropout=0.0, optimizer="sgd0")
    caps, B = trainer.caps, EPOCH_BATCH
    seeds_np = np.random.default_rng(6).integers(0, n, B - 24)
    padded = np.full(B, -1, np.int32)
    padded[:len(seeds_np)] = seeds_np
    seeds, num = torch.from_numpy(padded).to("cuda"), torch.tensor(len(seeds_np), device="cuda")
    key = 77
    reset_launches()
    block = trainer.issue_block(seeds, num, key)
    sync()
    step9e("(e) one issue_block: 3 uniform_hop and 1 tiered_gather launches")
    expect_launches(read_launches(), {"uniform_hop": 3, "tiered_gather": 1},
                    "fused issue_block")
    k1_rows = replay_hops(sampler, caps, seeds, num, key, block.n_id, "fused trainer",
                          lambda what: step9e(f"(e) {what}"))
    want_x = tiered_gather_plain(block.n_id.to(torch.int32).contiguous(), feat.feature_order,
                                 feat.hot_rows, feat.hot, feat.cold)
    ok = equal(block.x, want_x)
    step9e("(e) issue_block's lookup bitwise tiered_gather_plain")
    check(ok, "fused trainer lookup == tiered_gather_plain")
    nv, nc, _b, _c = lookup_bytes(feat, block.n_id)
    k2_rows = [{"store": f"fused trainer (phase 9b's store: {feat.hot_rows} hot rows), "
                         f"one issue_block's n_id ({nv} ids, {nc} cold)",
                "ids": int(block.n_id.numel()), "hot_rows": feat.hot_rows, "match": ok,
                "max_abs_err": float((block.x - want_x).abs().max())}]
    # sample_padded against sample: two samplers at the trainer's caps over
    # its placement, at the same call count
    a_s, b_s = (GraphSageSampler(sampler.csr_topo, EPOCH_FANOUT, device="cuda",
                                 seed_capacity=B, seed=0, frontier_caps=caps,
                                 device_topo=sampler.topo) for _ in range(2))
    out = a_s.sample(seeds_np)
    got = b_s.sample_padded(seeds, num)
    pairs = [(got[0], out.n_id), (got[1], out.n_count), (got[3], out.overflow)]
    pairs += [(a.edge_index, b.edge_index) for a, b in zip(got[2], out.adjs)]
    step9e("(e) sample_padded == sample, bitwise")
    same = all(equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in pairs)
    check(same, "fused trainer: sample_padded == sample, bitwise")
    k1_rows.append({"case": f"sample_padded against sample ({len(seeds_np)} seeds, caps "
                            f"{list(caps)})", "match": same,
                    "max_abs_err": max_err(*zip(*pairs))})
    # one card step against the train half of the same step on a CPU twin
    # (the same sampler and store objects: only their static facts are read)
    cpu_model = copy.deepcopy(trainer.model).to("cpu")
    cpu = DistributedTrainer(make_mesh(devices=["cpu"]), sampler, feat, cpu_model,
                             torch.optim.SGD(cpu_model.parameters(), lr=0.0),
                             local_batch=B)
    blocks = []
    record_issues(trainer, blocks)
    loss_g = float(trainer.step(seeds_np, labels_all, key))
    grads_g = [p.grad.detach().cpu() for p in trainer._params()]
    b = blocks[0]
    loss_c, grads_c = cpu.train_block(b.n_id.cpu(), b.x.cpu(), [a.to("cpu") for a in b.adjs],
                                      b.num_seeds.cpu(), labels_all.cpu(),
                                      fold_key(key, 1, 0), False)
    loss_c = float(loss_c)
    rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_err = [float((g - c).abs().max()) / float(c.abs().max())
                for g, c in zip(grads_g, grads_c)]
    step9e("(e) one card step against the CPU's: loss 1e-5 relative, gradients 1e-4 x max |g|")
    check(rel <= 1e-5, f"fused step parity: loss {loss_g} (card) vs {loss_c} (CPU)")
    check(max(grad_err) <= 1e-4, f"fused step parity: gradient errors / max |g| {grad_err}")
    return k1_rows, k2_rows, {
        "step_parity": {"loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": rel,
                        "max_grad_err_over_max": max(grad_err), "rows": int(b.x.shape[0]),
                        "tolerance": "loss 1e-5 relative; each gradient 1e-4 x max |g|"},
        "sample_padded_equals_sample": same, "caps": list(caps)}


def fused_audit(sampler, feat, labels_all, n, card) -> dict:
    """(f) One ``DistributedTrainer.step`` at this path's full width,
    recorded by the program audit (``tools/audit/ir.record``): its kernel
    nodes equal the wrapper launches the step made (3 ``uniform_hop``, 1
    ``tiered_gather``), and its estimated growth (rounded to the
    allocator's 512 B blocks) stands beside the growth of
    ``max_memory_allocated`` over the same step."""
    import collections
    import gc

    import numpy as np
    import torch

    from quiver_tpu_torch.tools.audit import ir, mem

    trainer = fused_trainer(sampler, feat)
    rng = np.random.default_rng(9)
    trainer.step(rng.integers(0, n, EPOCH_BATCH), labels_all, 0)  # Adam's state exists
    seeds = rng.integers(0, n, EPOCH_BATCH)
    # the earlier drills' trainers sit in reference cycles: collected
    # during the step, they would free memory the step never held
    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    program = ir.record(lambda: trainer.step(seeds, labels_all, 1), name="fused step",
                        device="cuda")
    sync()
    record_s = time.perf_counter() - t0
    growth = torch.cuda.max_memory_allocated() - before
    launches = read_launches()
    nodes = collections.Counter(node.name for node in program.kernels)
    step9e("(f) the recorded step's kernel nodes are its launches: 3 uniform_hop and "
           "1 tiered_gather")
    expect_launches(launches, {"uniform_hop": 3, "tiered_gather": 1}, "recorded fused step")
    check(dict(nodes) == {k: v for k, v in launches.items() if v},
          f"recorded fused step: kernel nodes {dict(nodes)} against launches {launches}")
    est = mem.estimate_peak(program, mem.ALLOCATOR_ROUND)
    out = {"kernel_nodes": dict(nodes), "ops": len(program.ops),
           "estimated_growth_bytes": est.growth_bytes, "measured_growth_bytes": growth,
           "ratio": est.growth_bytes / growth if growth else None,
           "state_bytes": est.state_bytes, "record_s": record_s, "card": card}
    log(f"recorded fused step: {len(program.ops)} ops, kernel nodes {dict(nodes)}, estimated "
        f"growth {est.growth_bytes / 2**20:.2f} MiB against max_memory_allocated's "
        f"{growth / 2**20:.2f} MiB [{card}]")
    return out


def fused_phase(topo, feat, labels_all, card):
    """Phase 9e (see the module docstring). Returns ``(launches of the
    timed steps, K1's check rows, K2's check rows, result)``."""
    import numpy as np

    from quiver_tpu_torch import GraphSageSampler

    t0 = time.time()
    n = topo.node_count
    sampler = GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", mode="HBM",
                               seed_capacity=EPOCH_BATCH, seed=0, frontier_caps="auto")
    # bench_epoch --fused: auto caps planned from one draw of local_batch seeds
    sampler.sample(np.random.default_rng(2).integers(0, n, EPOCH_BATCH))
    sync()
    step9e("the fused hop and K2's lookup are the path's")
    check(sampler.kernel == "pallas" and feat.kernel == "pallas",
          "fused trainer: the fused hop and K2's lookup")
    caps = sampler._frontier_caps
    log(f"fused trainer set-up {time.time() - t0:.1f}s: caps {caps} "
        f"(worst case {sampler._worst_caps(EPOCH_BATCH)})")
    steps = fused_step_run(sampler, feat, labels_all, n, card)
    epochs, ref, spread, train_idx = fused_epochs(sampler, feat, labels_all, n, card)
    guard = fused_guard(sampler, feat, labels_all, n, card)
    preempt = fused_preempt(sampler, feat, labels_all, train_idx, ref, spread, card)
    k1_rows, k2_rows, kernels = fused_kernels(sampler, feat, labels_all, n)
    audit = fused_audit(sampler, feat, labels_all, n, card)
    result = {
        "config": "benchmarks/bench_epoch.py --fused defaults on phase 9b's store: "
                  "products-shaped graph, HBM topology, F=100 f32, 47 classes, 20% "
                  "cache, fanouts [15, 10, 5], batch 1024, auto caps planned at "
                  "local_batch, GraphSAGE hidden 256 x 3, Adam 1e-3, dropout 0.5, "
                  "make_mesh() (one worker)",
        "caps": list(caps), "worst_caps": list(sampler._worst_caps(EPOCH_BATCH)),
        "step": steps, "epoch": epochs, "guard": guard, "preempt": preempt,
        "kernels": kernels, "audit": audit, "card": card, "seconds": time.time() - t0}
    log(f"fused trainer phase {result['seconds']:.1f}s [{card}]")
    return steps["launches"], k1_rows, k2_rows, result


# -- phase 9f: the mesh-sharded feature store under DistributedTrainer ----------

SHARD_MESHES = ((1, 4), (2, 2))  # (data, feature) logical meshes of cuda:0
SHARD_L0, SHARD_L1 = 0.02, 0.18  # of phase 9b's rows on L0 and on L1; the rest cold
SHARD_TIMED = (5, 3)  # lookups per turn, turns per figure (in_turns)
# examples/train_multichip.py's defaults (:47-56)
MULTI_NODES, MULTI_DEG, MULTI_F, MULTI_CLASSES = 100_000, 25.0, 128, 47
MULTI_HIDDEN, MULTI_FANOUT, MULTI_BATCH = 256, [15, 10, 5], 256
# per device: 16,384 L1 rows of 512 B (32,768 over the 2 shards), 8,192 L0
# rows; the other 59,040 rows cold
MULTI_L1, MULTI_L0 = "8M", "4M"
MULTI_WARMUP, MULTI_STEPS, MULTI_DET_STEPS = 3, 10, 3


def step9f(what: str) -> None:
    """Name a phase 9f check on stderr before it runs."""
    log(f"phase 9f check: {what}")


def logical_mesh(data: int, feature: int):
    """A ``(data, feature)`` mesh whose every slot is ``cuda:0``."""
    from quiver_tpu_torch import make_mesh

    return make_mesh(data=data, feature=feature, devices=["cuda:0"] * (data * feature))


K2_LAUNCH_OF = {"gather_rows": "gather", "tiered_gather": "gather",
                "tiered_gather_dequant": "gather_dequant"}


@contextlib.contextmanager
def k2_timed():
    """Every K2 launch inside the block bracketed by two CUDA events on its
    stream (``ops/kernels/gather.py``'s ``launch`` wrapped for the block):
    nothing else runs on the stream between them, so their elapsed time is
    the kernel's device time. Yields the ``(launch entry, start, end)``
    list."""
    import torch

    from quiver_tpu_torch.ops.kernels import gather as k2

    real, timed = k2.launch, []

    def timed_launch(entry, index, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        stream = torch.cuda.current_stream(index)
        stream.record_event(start)
        real(entry, index, *args)
        stream.record_event(end)
        timed.append((entry, start, end))

    setattr(k2, "launch", timed_launch)
    try:
        yield timed
    finally:
        setattr(k2, "launch", real)


def k2_device_ms(lookups, calls: int = 5) -> dict:
    """K2's device time per call of each ``(name, fn, {K2 entry: launches
    per call})`` of ``lookups``: after one warm call, ``calls`` calls with
    every K2 launch timed by :func:`k2_timed`, which must see exactly the
    launches each entry makes, and their times summed. Events, not
    ``torch.profiler``: late in a smoke run a profiler session has missed
    every device row of a whole lookup."""
    import collections

    out = {}
    for name, fn, entries in lookups:
        per_call = collections.Counter()
        for entry, k in entries.items():
            per_call[K2_LAUNCH_OF[entry]] += k
        fn()
        sync()
        with k2_timed() as timed:
            for _ in range(calls):
                fn()
            sync()
        seen = collections.Counter(entry for entry, _, _ in timed)
        check(seen == collections.Counter({e: k * calls for e, k in per_call.items()}),
              f"K2 launches timed of {name}: {dict(seen)} in {calls} calls of {dict(per_call)}")
        out[name] = sum(a.elapsed_time(b) for _, a, b in timed) / calls
    return out


def sharded_store_phase(topo, feat_rep, pcie, card):
    """(a) Phase 9b's rows (the products-shaped graph, F = 100 f32 from
    ``default_rng(0)``) in a ``ShardedFeature`` on the logical meshes
    ``SHARD_MESHES``: 2% of the rows on L0, 18% on L1, the rest pinned. For
    the 3-hop frontier of 1024 seeds: the psum gather, the routed gather
    (uncapped, the planned cap, a cap of 1 that overflows) and phase 9b's
    replicated store's K2 lookup, bitwise each other and the numpy rows;
    the tier hits a numpy count; K2's launches per lookup exact; the psum,
    routed and replicated lookups timed in turns, K2's device ms of each
    and their common bound (GATHER_BOUND_RULE). Returns ``(K2 check rows,
    result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler, ShardedFeature

    t0 = time.time()
    n = topo.node_count
    x = np.random.default_rng(0).normal(size=(n, EPOCH_F)).astype(np.float32)
    row_b = EPOCH_F * 4
    sampler = GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", seed_capacity=EPOCH_BATCH,
                               seed=0, frontier_caps="auto")
    seeds = np.random.default_rng(7).integers(0, n, EPOCH_BATCH)
    sampler.sample(seeds)  # plans the caps, as phase 9e's sampler is planned
    ids = sampler.sample(seeds).n_id
    ids_np = ids.cpu().numpy()
    want = x[np.where(ids_np >= 0, ids_np, 0)]
    want[ids_np < 0] = 0
    want = torch.from_numpy(want).to("cuda")
    ref = feat_rep[ids]
    step9f("(a) phase 9b's replicated lookup gives the numpy rows")
    check(equal(ref, want), "phase 9b's store's lookup == the numpy rows")
    rows, result = [], {"ids": int(ids.numel()), "valid_ids": int((ids_np >= 0).sum()),
                        "meshes": {}}
    for data, fsize in SHARD_MESHES:
        t1 = time.time()
        store = ShardedFeature(
            logical_mesh(data, fsize), device_cache_size=int(SHARD_L1 * n) // fsize * row_b,
            csr_topo=topo, replicate_budget=int(SHARD_L0 * n) * row_b).from_cpu_tensor(x)
        setup_s = time.time() - t1
        label = f"({data}, {fsize})"
        step9f(f"(a) {label}: the split and the pinned cold tier")
        check(store.rep_rows == int(SHARD_L0 * n) and store.cold is not None
              and store.cold.is_pinned(), f"sharded store {label}: split and cold tier")
        order = store.feature_order[ids.clamp(min=0).long()].long()
        valid = ids >= 0
        end = store.rep_rows + store.hot_rows
        want_hits = [int((valid & (order < store.rep_rows)).sum()),
                     int((valid & (order >= store.rep_rows) & (order < end)).sum()),
                     int((valid & (order >= end)).sum())]
        local = -(-ids.numel() // (data * fsize))
        cap = store.hot.routed_cap(local)
        lookups = {"psum": dict(routed=False), "routed, uncapped": dict(routed=True,
                   routed_cap=None), f"routed, planned cap {cap}": dict(routed=True,
                   routed_cap=cap), "routed, cap 1": dict(routed=True, routed_cap=1)}
        got = {}
        for name, kw in lookups.items():
            reset_launches()
            out = store.gather(ids, **kw)
            sync()
            shards = fsize if not kw["routed"] else data * fsize
            step9f(f"(a) {label} {name}: {shards + 2} gather_rows launches, bitwise the "
                   "replicated lookup and the numpy rows, exact tier hits")
            expect_launches(read_launches(), {"gather_rows": shards + 2},
                            f"sharded store {label} {name}")
            check(equal(out, ref), f"sharded store {label} {name} == replicated lookup")
            check(store.last_tier_hits.tolist() == want_hits,
                  f"sharded store {label} {name}: hits {store.last_tier_hits.tolist()} "
                  f"against {want_hits}")
            got[name] = {"overflow": (int(store.last_routed_overflow) if kw["routed"]
                                      else 0), "launches": shards + 2}
            rows.append({"store": f"sharded store {label}, {name}: {int(ids.numel())} ids",
                         "match": True, "max_abs_err": float((out - want).abs().max())})
            del out
        step9f(f"(a) {label}: a cap of 1 overflows, the uncapped gather does not")
        check(got["routed, cap 1"]["overflow"] > 0 and got["routed, uncapped"]["overflow"] == 0,
              f"sharded store {label}: overflow {got}")
        # the three lookups in turns, K2's device time of each, one bound
        psum = lambda: store.gather(ids)  # noqa: E731
        routed = lambda: store.gather(ids, routed=True, routed_cap=cap)  # noqa: E731
        replicated = lambda: feat_rep[ids]  # noqa: E731
        t_psum = in_turns(psum, replicated, *SHARD_TIMED)
        t_routed = in_turns(routed, replicated, *SHARD_TIMED)
        nv, nc = want_hits[0] + want_hits[1] + want_hits[2], want_hits[2]
        B = int(ids.numel())
        dev_bytes = B * 4 + nv * 4 + (nv - nc) * row_b + B * row_b
        bound_s = max(dev_bytes / HBM_BYTES_PER_S, nc * row_b / pcie)
        t = {"psum_ms": t_psum["ms"], "psum_turns": t_psum["ms_turns"],
             "routed_ms": t_routed["ms"], "routed_turns": t_routed["ms_turns"],
             "replicated_ms": (t_psum["yard_ms"] + t_routed["yard_ms"]) / 2,
             "replicated_turns": t_psum["yard_turns"] + t_routed["yard_turns"],
             "k2_device_ms": k2_device_ms([
                 ("psum", psum, {"gather_rows": got["psum"]["launches"]}),
                 ("routed", routed, {"gather_rows": got[f"routed, planned cap {cap}"]
                                     ["launches"]}),
                 ("replicated", replicated, {"tiered_gather": 1})]),
             "bound_ms": bound_s * 1e3, "device_bytes": dev_bytes, "cold_bytes": nc * row_b}
        result["meshes"][label] = {"rep_rows": store.rep_rows, "hot_rows": store.hot_rows,
                                   "cold_rows": n - end, "tier_hits": want_hits,
                                   "planned_cap": cap, "lookups": got, "timing": t,
                                   "setup_s": setup_s}
        log(f"sharded store {label}: {store.rep_rows} L0 / {store.hot_rows} L1 / "
            f"{n - end} cold rows, hits {want_hits}; psum {t['psum_ms']:.4f} ms, routed "
            f"{t['routed_ms']:.4f} ms, replicated {t['replicated_ms']:.4f} ms; K2 device "
            f"{t['k2_device_ms']}; bound {t['bound_ms']:.4f} ms [{card}]")
        store.delete()
        del store
    result["seconds"] = time.time() - t0
    return rows, result


def multichip_setup():
    """``examples/train_multichip.py``'s graph, rows and labels (its
    generators: ``generate_pareto_graph(100000, 25.0, seed=0)``, then
    ``default_rng(0)`` for the F = 128 rows and the 47 labels)."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    rng = np.random.default_rng(0)
    topo = CSRTopo(edge_index=generate_pareto_graph(MULTI_NODES, MULTI_DEG, seed=0))
    n = topo.node_count
    x = rng.normal(size=(n, MULTI_F)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, MULTI_CLASSES, n).astype(np.int32)).to("cuda")
    return topo, x, labels


def multichip_trainer(topo, store, seed_sharding, topo_sharding="replicated"):
    """``DistributedTrainer`` on the ``(2, 2)`` logical mesh at the twin's
    width: GraphSAGE 256 x 3, Adam 1e-3, local batch 256, the default
    (worst-case) caps, ``replicate_budget=MULTI_L0``; ``init(0)``. With
    ``topo_sharding="mesh"`` the sampler's topology is partitioned over
    the mesh's feature axis (phase 9g)."""
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE

    mesh = logical_mesh(2, 2)
    where = ({"device": "cuda"} if topo_sharding == "replicated"
             else {"topo_sharding": "mesh", "mesh": mesh})
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, **where)
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES, num_layers=len(MULTI_FANOUT))
    trainer = DistributedTrainer(mesh, sampler, store, model.to("cuda"),
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding=seed_sharding,
                                 replicate_budget=MULTI_L0)
    trainer.init(0)
    return trainer


def multichip_losses(trainer, labels, steps: int, issued=None):
    """``steps`` steps on ``default_rng(5)``'s seeds, keyed 100 + i: the
    device losses (and, with ``issued``, each step's issued blocks)."""
    import numpy as np

    rng = np.random.default_rng(5)
    if issued is not None:
        issue = trainer._issue
        trainer._issue = lambda *a: issued.append(issue(*a)) or issued[-1]
    n = trainer.sampler.csr_topo.node_count
    return [trainer.step(rng.integers(0, n, trainer.global_batch), labels, 100 + i)
            for i in range(steps)]


def multichip_mode(topo, store, replicated, labels, seed_sharding, card):
    """(b) One ``seed_sharding``: ``MULTI_WARMUP`` steps, then
    ``MULTI_STEPS`` timed (each synchronised), exact K1 and K2 launches,
    peak memory, K1's and K2's device ms and the idle share of
    ``PROFILED_STEPS`` profiled steps; one step's ids and gathered rows
    bitwise the replicated store's; ``MULTI_DET_STEPS`` steps under
    deterministic kernels bitwise the replicated store's (and within the
    spread rule of two replicated runs), the main path's distances
    printed. Returns ``(launches of the timed steps, result)``."""
    import math

    import numpy as np
    import torch

    trainer = multichip_trainer(topo, store, seed_sharding)
    workers, groups = trainer.workers, trainer.data_size
    rng = np.random.default_rng(1)
    n = topo.node_count
    for i in range(MULTI_WARMUP):
        trainer.step(rng.integers(0, n, trainer.global_batch), labels, i)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for i in range(MULTI_STEPS):
        seeds = rng.integers(0, n, trainer.global_batch)
        t0 = time.perf_counter()
        losses.append(trainer.step(seeds, labels, 10 + i))
        sync()
        times.append(time.perf_counter() - t0)
    launches = read_launches()
    k1, k2 = 3 * workers, 4 * groups  # hops per worker; L0, 2 shards, cold per group
    step9f(f"(b) {seed_sharding}: exactly {k1} uniform_hop and {k2} gather_rows launches "
           "per step")
    expect_launches(launches, {"uniform_hop": k1 * MULTI_STEPS,
                               "gather_rows": k2 * MULTI_STEPS},
                    f"sharded trainer ({seed_sharding}) steps")
    losses = [float(v) for v in losses]
    step9f(f"(b) {seed_sharding}: finite step losses")
    check(all(math.isfinite(v) for v in losses), f"sharded trainer ({seed_sharding}) losses")
    step_ms = trimmed_mean(times) * 1e3
    r = {"workers": workers, "global_batch": trainer.global_batch, "caps": list(trainer.caps),
         "warmup": MULTI_WARMUP, "steps": MULTI_STEPS, "step_ms_trimmed_mean": step_ms,
         "steps_per_s": 1e3 / step_ms, "launches": launches,
         "launches_per_step": {"uniform_hop": k1, "gather_rows": k2},
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "loss_first_last": [losses[0], losses[-1]],
         "tier_hits_last_step": trainer.last_tier_hits.tolist(),
         "routed_overflow_last_step": int(trainer.last_routed_overflow)}
    step9f(f"(b) {seed_sharding}: the profiler sees the card")
    prof = profiled_idle(lambda: [trainer.step(rng.integers(0, n, trainer.global_batch),
                                               labels, 1000 + k)
                                  for k in range(PROFILED_STEPS)],
                         PROFILED_STEPS, step_ms, FUSED_KERNELS)
    ours = prof.pop("port_kernels_ms_per_step")
    prof["profiled_steps"] = prof.pop("steps")
    del prof["step_ms"]
    r.update(prof, k1_device_ms_per_step=ours["uniform_hop_kernel"],
             k2_device_ms_per_step=ours["gather_kernel"])
    del trainer
    # the same step on the replicated store: ids and rows bitwise
    issued = {}
    for name, feat in (("sharded", store), ("replicated", replicated)):
        issued[name] = []
        multichip_losses(multichip_trainer(topo, feat, seed_sharding), labels, 1,
                         issued[name])
    step9f(f"(b) {seed_sharding}: one step's ids and rows bitwise the replicated store's")
    pairs = [(a, b) for a, b in zip(issued["sharded"][0].blocks,
                                     issued["replicated"][0].blocks)]
    check(len(pairs) == workers and all(equal(a.n_id, b.n_id) and equal(a.x, b.x)
                                        for a, b in pairs),
          f"sharded trainer ({seed_sharding}): ids and rows == the replicated store's")
    rows = sum(int((a.n_id >= 0).sum()) for a, _ in pairs)
    del issued, pairs
    # the losses: main path (readings), then deterministic (checked)
    runs = {}
    for mode in ("main path", "deterministic"):
        ctx = deterministic_algorithms() if mode == "deterministic" else contextlib.nullcontext()
        with ctx:
            runs[mode] = {name: [float(v) for v in multichip_losses(
                multichip_trainer(topo, feat, seed_sharding), labels, MULTI_DET_STEPS)]
                for name, feat in (("sharded", store), ("replicated", replicated),
                                   ("replicated_again", replicated))}
    det = runs["deterministic"]
    spread = max(abs(a - b) for a, b in zip(det["replicated"], det["replicated_again"]))
    ok, worst = within_spread(det["sharded"], det["replicated"], spread)
    step9f(f"(b) {seed_sharding}: deterministic losses bitwise the replicated store's and "
           "within the spread rule")
    check(ok and det["sharded"] == det["replicated"],
          f"sharded trainer ({seed_sharding}): deterministic losses {det}")
    main = runs["main path"]
    r["losses"] = {"main_path": main, "deterministic": det,
                   "main_path_max_diff": max(abs(a - b) for a, b in zip(main["sharded"],
                                                                       main["replicated"])),
                   "main_path_replicated_spread": max(
                       abs(a - b) for a, b in zip(main["replicated"],
                                                  main["replicated_again"])),
                   "rule": "every step |sharded - replicated| <= 4 x max |replicated - "
                           "replicated again| + 1e-6 x |loss|, and bitwise, checked under "
                           "torch.use_deterministic_algorithms"}
    r["checked_rows_per_step"] = rows
    log(f"sharded trainer ({seed_sharding}): {r['steps_per_s']:.4g} steps/s "
        f"({step_ms:.3f} ms), idle share {r['idle_share']:.4f}, K1 "
        f"{r['k1_device_ms_per_step']:.4f} ms, K2 {r['k2_device_ms_per_step']:.4f} ms per "
        f"step, peak {r['peak_bytes'] / 2**30:.3f} GiB, hits {r['tier_hits_last_step']}, "
        f"main-path loss distance {r['losses']['main_path_max_diff']:.3g} [{card}]")
    return launches, r


def multichip_kernels(topo, store):
    """(c) The kernels at this path's shapes, bitwise their plain versions:
    the hops of one worker's ``sample_block`` replayed on its draws
    (``uniform_hop``), and ``gather_rows`` on the L0 block, on each L1
    shard and on the pinned cold rows with the ids a psum lookup of that
    frontier sends each. Returns ``(K1 rows, K2 rows)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch.ops.kernels.gather import gather_rows, gather_rows_plain

    trainer = multichip_trainer(topo, store, "data")
    sampler, caps, B = trainer.sampler, trainer.caps, MULTI_BATCH
    padded = np.full(B, -1, np.int32)
    padded[:B - 16] = np.random.default_rng(6).integers(0, topo.node_count, B - 16)
    seeds = torch.from_numpy(padded).to("cuda")
    num = torch.tensor(B - 16, device="cuda")
    key = 77
    reset_launches()
    n_id, _adjs = trainer.sample_block(seeds, num, key)
    sync()
    step9f("(c) one sample_block: 3 uniform_hop launches")
    expect_launches(read_launches(), {"uniform_hop": 3}, "sharded trainer sample_block")
    k1_rows = replay_hops(sampler, caps, seeds, num, key, n_id, "sharded trainer",
                          lambda what: step9f(f"(c) {what}"))
    t = store.feature_order[n_id.clamp(min=0).long()].long()
    valid = n_id >= 0
    end = store.rep_rows + store.hot_rows
    rps = store.hot.rows_per_shard
    cases = [("L0 block", store.rep, torch.where(valid & (t < store.rep_rows), t, -1)),
             ("cold rows (pinned, UVA)", store.cold,
              torch.where(valid & (t >= end), t - end, -1))]
    l1 = torch.where(valid & (t >= store.rep_rows) & (t < end), t - store.rep_rows, -1)
    for d, shard in enumerate(store.hot.shards):
        mine = (l1 >= 0) & (l1 // rps == d)
        cases.append((f"L1 shard {d}", shard, torch.where(mine, l1 - d * rps, -1)))
    k2_rows = []
    for name, table, ids in cases:
        ids = ids.to(torch.int32).contiguous()
        kern, plain = gather_rows(table, ids), gather_rows_plain(table, ids)
        ok = equal(kern, plain)
        step9f(f"(c) gather_rows on the {name} bitwise its plain version")
        check(ok, f"sharded trainer gather_rows on the {name} == plain")
        k2_rows.append({"store": f"sharded trainer, gather_rows on the {name}: "
                                 f"{int((ids >= 0).sum())} of {ids.numel()} lanes",
                        "match": ok, "max_abs_err": float((kern - plain).abs().max())})
    return k1_rows, k2_rows


def multichip_phase(card):
    """(b) and (c) over ``examples/train_multichip.py``'s configuration,
    then the twin itself on the card (in this process, as phase 9c runs
    its twins). Returns ``(launches by mode, K1 rows, K2 rows, result)``."""
    import io

    import torch

    from examples.train_multichip_torch import main as multichip_main

    from quiver_tpu_torch import Feature, ShardedFeature

    t0 = time.time()
    topo, x, labels = multichip_setup()
    store = ShardedFeature(logical_mesh(2, 2), device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0).from_cpu_tensor(x)
    replicated = Feature(device_cache_size=int(0.2 * topo.node_count) * MULTI_F * 4,
                         csr_topo=topo, device="cuda").from_cpu_tensor(x)
    del x
    n = topo.node_count
    step9f("(b) the store has an L0 block, two L1 shards and a pinned cold tier")
    check(store.rep_rows == 8192 and store.hot_rows == 32768 and store.cold.is_pinned(),
          f"multichip store split {store.rep_rows} / {store.hot_rows}")
    log(f"multichip set-up {time.time() - t0:.1f}s: {topo}, store {store.rep_rows} L0 / "
        f"{store.hot_rows} L1 / {n - store.rep_rows - store.hot_rows} cold rows")
    launches, modes = {}, {}
    for seed_sharding in ("data", "all"):
        launches[seed_sharding], modes[seed_sharding] = multichip_mode(
            topo, store, replicated, labels, seed_sharding, card)
        torch.cuda.empty_cache()
    k1_rows, k2_rows = multichip_kernels(topo, store)
    del store, replicated
    torch.cuda.empty_cache()
    t1 = time.time()
    args = ["--data-axis", "2", "--feature-axis", "2", "--steps", "30",
            "--seed-sharding", "all", "--replicate-budget", "4M"]
    text = io.StringIO()
    step9f("(b) the twin runs to its end and prints its tier hits")
    with contextlib.redirect_stdout(text):
        multichip_main(args)
    for line in text.getvalue().splitlines():
        log(f"train_multichip_torch: {line}")
    check("feature tier hits (last step): L0 replicated" in text.getvalue(),
          "the multichip twin prints its tier hits")
    twin = {"args": " ".join(args), "seconds": time.time() - t1,
            "stdout_tail": text.getvalue().splitlines()[-4:]}
    return launches, k1_rows, k2_rows, {
        "config": "examples/train_multichip.py defaults: generate_pareto_graph(100000, "
                  "25.0, seed=0), F=128 f32, 47 classes, GraphSAGE 256 x 3, fanouts "
                  "[15, 10, 5], local batch 256, Adam 1e-3, the default caps; a (2, 2) "
                  f"logical mesh of cuda:0; ShardedFeature device_cache_size={MULTI_L1}, "
                  f"replicate_budget={MULTI_L0} (8,192 L0 / 32,768 L1 / 59,040 cold rows); "
                  "the replicated yardstick Feature holds 20% of the rows",
        "modes": modes, "twin": twin, "card": card, "seconds": time.time() - t0}


def sharded_phase(topo, feat_rep, pcie, card):
    """Phase 9f (see the module docstring). Returns ``(launches of (b)'s
    timed steps by mode, K1 rows, K2 rows, result)``."""
    import torch

    t0 = time.time()
    k2_a, store = sharded_store_phase(topo, feat_rep, pcie, card)
    torch.cuda.empty_cache()
    launches, k1_rows, k2_b, multichip = multichip_phase(card)
    result = {"store": store, "trainer": multichip, "seconds": time.time() - t0}
    log(f"sharded phase {result['seconds']:.1f}s [{card}]")
    return launches, k1_rows, k2_a + k2_b, result


# -- phase 9g: the mesh-sharded topology and distributed sampling ---------------

# benchmarks/bench_sampler.py --topo-sharding mesh at its defaults: one
# global batch split over the mesh's workers, worst-case caps
DIST_MESH, DIST_FANOUT, DIST_BATCH, DIST_ALPHA = (1, 4), [15, 10, 5], 2048, 2.0
DIST_KEY, DIST_CALLS = 11, 3  # the sample calls' key; calls per timed turn
DIST_WINDOW = (0.25, 0.75)  # phase 7's window
DIST_HETERO_ALPHA = 2.0


def step9g(what: str) -> None:
    """Name a phase 9g check on stderr before it runs."""
    log(f"phase 9g check: {what}")


# the distributed samplers' owner-side K1 and K3 wrappers: (module, name)
OWNER_WRAPPERS = (("quiver_tpu_torch.sampling.dist", "select"),
                  ("quiver_tpu_torch.sampling.dist", "wselect"))


@contextlib.contextmanager
def owner_calls(wrappers=OWNER_WRAPPERS):
    """Every call of the kernel wrappers ``wrappers`` ((module, name),
    recorded where the path calls them; by default the distributed
    samplers' owner-side K1 ``select`` and K3 ``wselect``) inside the
    block, with its arguments and outputs (the wrappers still launch and
    count)."""
    import importlib

    calls, orig = [], {}

    def recording(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return call

    for mod, name in wrappers:
        m = importlib.import_module(mod)
        orig[mod, name] = getattr(m, name)
        setattr(m, name, recording(name, orig[mod, name]))
    try:
        yield calls
    finally:
        for (mod, name), fn in orig.items():
            setattr(importlib.import_module(mod), name, fn)


def call_rows(calls, what: str, plain: dict) -> dict:
    """Each recorded call against its plain version ``plain[name]`` on the
    same arguments (bitwise); the check rows by wrapper name."""
    import torch

    rows = {}
    for name, args, kwargs, out in calls:
        want = plain[name](*args, **kwargs)
        got, want = ((out,), (want,)) if isinstance(out, torch.Tensor) else (out, want)
        ok = all(equal(g, w) for g, w in zip(got, want))
        shape = list(got[0].shape)
        check(ok, f"{what}: {name} {shape} == its plain version")
        rows.setdefault(name, []).append({"case": f"{what}: {name} -> {shape}", "match": ok,
                                          "max_abs_err": max_err(got, want)})
    return rows


def owner_call_rows(calls, what: str) -> tuple[list, dict]:
    """Each recorded owner-side call against its plain version on the same
    arguments (bitwise, :func:`call_rows`), and the calls' bytes by
    SELECT_BOUND_RULE / WSELECT_BOUND_RULE at their shapes (``F * cap``
    rows, plus the fallback's, by ``k``). Returns ``(check rows, bound)``."""
    from types import SimpleNamespace

    from quiver_tpu_torch.ops.kernels.fused import select_plain, wselect_plain

    nbytes, shapes = 0, []
    for name, args, kwargs, out in calls:
        if name == "select":
            tables, start, offs, count = args
            S, k = offs.shape
            nbytes += select_bytes(start, offs, count)[0]
        else:
            indices, cw, start, deg, u, iters = args
            S, k = u.shape
            sec = wselect_sectors(SimpleNamespace(cum_weights=cw, search_iters=iters),
                                  start, deg, u, k, scale_u=kwargs.get("scale_u", True))
            nbytes += wselect_bytes(sec, S, k)[0]
        shapes.append([S, k])
    by_name = call_rows(calls, f"{what}: owner-side",
                        {"select": select_plain, "wselect": wselect_plain})
    rows = [row for name_rows in by_name.values() for row in name_rows]
    return rows, {"calls": len(calls), "shapes": shapes, "bound_bytes": nbytes,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def dist_sampler_case(topo, kind: str, card) -> tuple[dict, list, dict]:
    """(a) One draw of ``bench_sampler.py --topo-sharding mesh`` on the
    logical mesh ``DIST_MESH``: launches, workers bitwise the replicated
    sampler, the cap-1 and uncapped budgets, the owner-side calls against
    their plain versions, and edges/s. The routing's cost is the group
    entry (``sample_group`` on the packed device seeds, no host read) in
    turns with the replicated sampler's ``sample_padded`` per worker on
    the same seeds and draws; the public ``sample`` (host packing, the
    copy to the card, the counts read back) is timed apart. 5 profiled
    calls of each entry. Returns ``(launches, check rows, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops.sample import seeded_generator

    t0 = time.time()
    kw = {"uniform": {}, "weighted": {"weighted": True},
          "temporal": {"time_window": DIST_WINDOW}}[kind]
    entry = "wselect" if kind == "weighted" else "select"
    hop = {"uniform": "uniform_hop", "weighted": "weighted_hop", "temporal": "select"}[kind]
    smp = GraphSageSampler(topo, DIST_FANOUT, topo_sharding="mesh", mesh=logical_mesh(*DIST_MESH),
                           routed_alpha=DIST_ALPHA, seed=0, **kw)
    W = smp.workers
    cap = max(-(-DIST_BATCH // W), 128)
    rep = GraphSageSampler(topo, DIST_FANOUT, device="cuda", seed_capacity=cap, seed=0,
                           kernel="pallas", **kw)
    setup_s = time.time() - t0
    seeds = np.random.default_rng(9).integers(0, topo.node_count, DIST_BATCH)
    packed = torch.from_numpy(smp.shard_seeds(seeds, cap)).to("cuda")
    nums = [int(v) for v in (packed >= 0).sum(1)]
    num_dev = (packed >= 0).sum(1, dtype=torch.int32)
    # worker w of a call keyed DIST_KEY draws from fold_key(DIST_KEY, w):
    # the seed of seeded_generator(device, DIST_KEY, w)
    gens = [seeded_generator("cuda", DIST_KEY, w) for w in range(W)]
    smp.sample(seeds, key=1)  # warm-up
    sync()
    reset_launches()
    with owner_calls() as calls:
        out = smp.sample(seeds, key=DIST_KEY)
        sync()
    launches = read_launches()
    L = len(DIST_FANOUT)
    step9g(f"(a) {kind}: exactly {L * DIST_MESH[1]} {entry} launches a sample, no fused hop")
    expect_launches(launches, {entry: L * DIST_MESH[1]}, f"distributed {kind} sample")
    step9g(f"(a) {kind}: every owner-side {entry} bitwise {entry}_plain")
    rows, bound = owner_call_rows(calls, f"distributed {kind} sample")
    del calls
    overflow = smp.last_sample_overflow.tolist()
    n_id = out.n_id.reshape(W, -1)

    def replicated():
        return [rep.sample_padded(packed[w], nums[w], generator=gens[w]) for w in range(W)]

    def group():
        return smp.sample_group(packed, num_dev, generators=gens)

    reset_launches()
    want = replicated()
    sync()
    step9g(f"(a) {kind}: the replicated sampler runs {L} {hop} launches a worker")
    expect_launches(read_launches(), {hop: L * W}, f"replicated {kind} sample")
    step9g(f"(a) {kind}: every worker's n_id and edge_index bitwise the replicated sampler's")
    same = all(equal(n_id[w], want[w][0]) and all(
        equal(a.edge_index.reshape(2, W, -1)[:, w], b.edge_index)
        for a, b in zip(out.adjs, want[w][2])) for w in range(W))
    check(same, f"distributed {kind} sample == the replicated sampler per worker")
    rows.append({"case": f"distributed {kind} sample, {W} workers x {cap} seeds: ids and "
                         "edges against the replicated sampler", "match": same,
                 "max_abs_err": 0})
    budgets = {}
    for label, alpha in (("cap 1", 1e-9), ("uncapped", None)):
        smp.routed_alpha = alpha
        got = smp.sample(seeds, key=DIST_KEY)
        budgets[label] = smp.last_sample_overflow.tolist()
        step9g(f"(a) {kind}: the {label} budget gives the same sample")
        check(equal(got.n_id, out.n_id) and all(equal(a.edge_index, b.edge_index)
                                                for a, b in zip(got.adjs, out.adjs)),
              f"distributed {kind} sample, {label} budget == the planned one")
    smp.routed_alpha = DIST_ALPHA
    step9g(f"(a) {kind}: a cap of 1 overflows, the uncapped budget does not")
    check(sum(budgets["cap 1"]) > 0 and sum(budgets["uncapped"]) == 0,
          f"distributed {kind} overflow by budget {budgets}")
    # edges/s: the group entry in turns with the replicated sampler (a, b,
    # b, a) on the same device seeds and draws, which give the same sample
    edges = int(sum(out.edge_counts))
    rep_edges = int(torch.stack([c for r in want for c in r[4]]).sum())
    check(rep_edges == edges, f"distributed {kind}: {edges} edges, replicated {rep_edges}")
    step9g(f"(a) {kind}: the group entry on the packed seeds gives the public sample")
    got = group()
    check(equal(got[0].reshape(-1), out.n_id) and all(
        equal(a.edge_index, b.edge_index.transpose(0, 1).reshape(2, -1))
        for a, b in zip(out.adjs, got[2])),
        f"distributed {kind}: sample_group == sample")
    del got

    def timed(fn):
        sync()
        a = time.perf_counter()
        for _ in range(DIST_CALLS):
            fn()
        sync()
        return (time.perf_counter() - a) / DIST_CALLS

    public = lambda: smp.sample(seeds, key=DIST_KEY)  # noqa: E731
    turns = [timed(group), timed(replicated), timed(replicated), timed(group)]
    dist_s, rep_s = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    public_s = timed(public)
    kernel = "wselect_kernel" if kind == "weighted" else "select_kernel"
    step9g(f"(a) {kind}: the profiler sees the card")
    prof = profiled_idle(lambda: [group() for _ in range(PROFILED_STEPS)], PROFILED_STEPS,
                         dist_s * 1e3, (kernel,))
    k_ms = prof["port_kernels_ms_per_step"][kernel]
    check(k_ms > 0, f"distributed {kind}: the profiler saw {kernel}")
    prof_public = profiled_idle(lambda: [public() for _ in range(PROFILED_STEPS)],
                                PROFILED_STEPS, public_s * 1e3)
    r = {"sizes": DIST_FANOUT, "batch": DIST_BATCH, "workers": W, "seed_cap": cap,
         "caps": list(smp._caps_for(cap)), "routed_alpha": DIST_ALPHA,
         "hop_caps": _hop_caps(smp, cap),
         "launches": launches, "edges": edges, "sample_overflow": overflow,
         "overflow_by_budget": budgets, "timed": "sample_group on the packed device "
         "seeds (a) in turns with the replicated sample_padded per worker (b): a, b, b, a; "
         "the public sample (host packing, copy, counts read) apart",
         "dist_ms": dist_s * 1e3, "replicated_ms": rep_s * 1e3,
         "ms_turns": [t * 1e3 for t in turns], "edges_per_s": edges / dist_s,
         "replicated_edges_per_s": edges / rep_s, "ratio_to_replicated": dist_s / rep_s,
         "public_sample_ms": public_s * 1e3, "public_edges_per_s": edges / public_s,
         "public_idle_share": prof_public["idle_share"],
         "device_launches_per_sample": prof["device_launches_per_step"],
         "plan": {k: v for k, v in smp.topo.plan.items() if k != "shard_edges"},
         "shard_edges": smp.topo.plan["shard_edges"],
         f"{entry}_device_ms_per_sample": k_ms, "owner_side": bound,
         "bound_share": bound["bound_ms"] / k_ms, "idle_share": prof["idle_share"],
         "device_busy_ms_per_sample": prof["device_busy_ms_per_step"],
         "top_kernels_ms_per_sample": prof["top_kernels_ms_per_step"],
         "setup_s": setup_s, "seconds": time.time() - t0, "card": card}
    log(f"distributed {kind} sample_group: {r['edges_per_s']:.4g} edges/s ({r['dist_ms']:.3f} "
        f"ms) against the replicated {r['replicated_edges_per_s']:.4g} "
        f"({r['replicated_ms']:.3f} ms); public sample {r['public_sample_ms']:.3f} ms; "
        f"{entry} {k_ms:.4f} ms a sample (bound {bound['bound_ms']:.4f}); idle "
        f"{r['idle_share']:.4f} ({r['device_launches_per_sample']:.0f} device launches); "
        f"topology {smp.topo.plan['per_chip_bytes']} B a shard, "
        f"{smp.topo.plan['replicated_bytes']} B replicated [{card}]")
    return launches, rows, r


def _hop_caps(smp, cap: int) -> list:
    """The per-destination bucket capacity of each hop at seed capacity
    ``cap`` (``None``: uncapped)."""
    from quiver_tpu_torch.sampling.dist import routed_sample_cap

    widths = (cap,) + tuple(smp._caps_for(cap))[:-1]
    return [routed_sample_cap(S, smp.topo.num_shards, smp.routed_alpha) for S in widths]


def dist_sampler_phase(topo, topo_t, card) -> tuple[dict, list, dict]:
    """(a) over the serving graph (uniform, weighted) and phase 7's
    timestamped copy (temporal). Returns ``(launches by kind, check rows
    by entry, result by kind)``."""
    import torch

    launches, rows, result = {}, {"select": [], "wselect": []}, {}
    for kind, g in (("uniform", topo), ("weighted", topo), ("temporal", topo_t)):
        launches[kind], r_rows, result[kind] = dist_sampler_case(g, kind, card)
        rows["wselect" if kind == "weighted" else "select"].extend(r_rows)
        torch.cuda.empty_cache()
    return launches, rows, result


def topo_trainer_phase(card) -> tuple[dict, list, dict]:
    """(b) ``DistributedTrainer`` over a topology-sharded sampler at
    ``train_multichip``'s width on the ``(2, 2)`` logical mesh under
    ``seed_sharding="all"``, over phase 9f's sharded store: 3 + 10 steps,
    exact launches (``select`` 3 hops x 2 owners x 2 groups, ``gather_rows``
    4 per group, no ``uniform_hop``), peak memory, 5 profiled steps; one
    step's ids and rows bitwise the replicated topology's; 3 steps' losses
    as the main path runs and under deterministic kernels (bitwise, and
    within the spread rule). Returns ``(launches of the timed steps, the
    owner-side check rows, result)``."""
    import math

    import numpy as np
    import torch

    from quiver_tpu_torch import ShardedFeature

    t0 = time.time()
    topo, x, labels = multichip_setup()
    store = ShardedFeature(logical_mesh(2, 2), device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0).from_cpu_tensor(x)
    del x
    trainer = multichip_trainer(topo, store, "all", topo_sharding="mesh")
    groups, L = trainer.data_size, len(MULTI_FANOUT)
    rng = np.random.default_rng(1)
    n = topo.node_count
    for i in range(MULTI_WARMUP):
        trainer.step(rng.integers(0, n, trainer.global_batch), labels, i)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for i in range(MULTI_STEPS):
        seeds = rng.integers(0, n, trainer.global_batch)
        a = time.perf_counter()
        losses.append(trainer.step(seeds, labels, 10 + i))
        sync()
        times.append(time.perf_counter() - a)
    launches = read_launches()
    k1, k2 = L * trainer.feature_size * groups, 4 * groups
    step9g(f"(b) exactly {k1} select and {k2} gather_rows launches a step, no uniform_hop")
    expect_launches(launches, {"select": k1 * MULTI_STEPS, "gather_rows": k2 * MULTI_STEPS},
                    "topology-sharded trainer steps")
    losses = [float(v) for v in losses]
    step9g("(b) finite step losses")
    check(all(math.isfinite(v) for v in losses), "topology-sharded trainer losses")
    step_ms = trimmed_mean(times) * 1e3
    r = {"workers": trainer.workers, "global_batch": trainer.global_batch,
         "caps": list(trainer.caps), "warmup": MULTI_WARMUP, "steps": MULTI_STEPS,
         "step_ms_trimmed_mean": step_ms, "steps_per_s": 1e3 / step_ms,
         "launches": launches, "launches_per_step": {"select": k1, "gather_rows": k2},
         "peak_bytes": torch.cuda.max_memory_allocated(),
         "loss_first_last": [losses[0], losses[-1]],
         "sample_overflow_last_step": trainer.last_sample_overflow.tolist(),
         "routed_overflow_last_step": int(trainer.last_routed_overflow)}
    step9g("(b) the profiler sees the card")
    prof = profiled_idle(lambda: [trainer.step(rng.integers(0, n, trainer.global_batch),
                                               labels, 1000 + k)
                                  for k in range(PROFILED_STEPS)],
                         PROFILED_STEPS, step_ms, ("select_kernel", "gather_kernel"))
    ours = prof.pop("port_kernels_ms_per_step")
    prof["profiled_steps"] = prof.pop("steps")
    del prof["step_ms"]
    r.update(prof, k1_device_ms_per_step=ours["select_kernel"],
             k2_device_ms_per_step=ours["gather_kernel"])
    # one step's owner-side calls against their plain versions
    with owner_calls() as calls:
        trainer.step(rng.integers(0, n, trainer.global_batch), labels, 2000)
        sync()
    step9g("(b) one step's owner-side select calls bitwise select_plain")
    rows, r["owner_side"] = owner_call_rows(calls, "topology-sharded trainer step")
    del calls, trainer
    # the same step over the replicated topology: ids and rows bitwise
    issued = {}
    for mode in ("mesh", "replicated"):
        issued[mode] = []
        multichip_losses(multichip_trainer(topo, store, "all", topo_sharding=mode), labels, 1,
                         issued[mode])
    step9g("(b) one step's ids and rows bitwise the replicated topology's")
    pairs = list(zip(issued["mesh"][0].blocks, issued["replicated"][0].blocks))
    check(len(pairs) == 4 and all(equal(a.n_id, b.n_id) and equal(a.x, b.x)
                                  for a, b in pairs),
          "topology-sharded trainer: ids and rows == the replicated topology's")
    r["checked_rows_per_step"] = sum(int((a.n_id >= 0).sum()) for a, _ in pairs)
    del issued, pairs
    runs = {}
    for mode in ("main path", "deterministic"):
        ctx = deterministic_algorithms() if mode == "deterministic" else contextlib.nullcontext()
        with ctx:
            runs[mode] = {name: [float(v) for v in multichip_losses(
                multichip_trainer(topo, store, "all", topo_sharding=ts), labels,
                MULTI_DET_STEPS)]
                for name, ts in (("mesh", "mesh"), ("replicated", "replicated"),
                                 ("replicated_again", "replicated"))}
    det = runs["deterministic"]
    spread = max(abs(a - b) for a, b in zip(det["replicated"], det["replicated_again"]))
    ok, _worst = within_spread(det["mesh"], det["replicated"], spread)
    step9g("(b) deterministic losses bitwise the replicated topology's and within the "
           "spread rule")
    check(ok and det["mesh"] == det["replicated"],
          f"topology-sharded trainer: deterministic losses {det}")
    main = runs["main path"]
    r["losses"] = {"main_path": main, "deterministic": det,
                   "main_path_max_diff": max(abs(a - b) for a, b in zip(main["mesh"],
                                                                       main["replicated"])),
                   "rule": "every step |mesh - replicated| <= 4 x max |replicated - "
                           "replicated again| + 1e-6 x |loss|, and bitwise, checked under "
                           "torch.use_deterministic_algorithms"}
    r["config"] = ("examples/train_multichip.py defaults (as phase 9f (b)) with "
                   "GraphSageSampler(topo_sharding='mesh', routed_alpha=2.0) on the same "
                   "(2, 2) logical mesh, seed_sharding='all', phase 9f's ShardedFeature")
    r["seconds"] = time.time() - t0
    store.delete()
    log(f"topology-sharded trainer: {r['steps_per_s']:.4g} steps/s ({step_ms:.3f} ms), idle "
        f"share {r['idle_share']:.4f}, K1 select {r['k1_device_ms_per_step']:.4f} ms, K2 "
        f"{r['k2_device_ms_per_step']:.4f} ms a step, peak {r['peak_bytes'] / 2**30:.3f} GiB, "
        f"hop overflow {r['sample_overflow_last_step']}, main-path loss distance "
        f"{r['losses']['main_path_max_diff']:.3g} [{card}]")
    return launches, rows, r


def hetero_draw_fn(sampler):
    """``draw_fn(worker, hop, edge_type, deg)``: deterministic draws (the
    port's own, from a generator keyed by worker, hop and relation over
    the degrees' shape), so the distributed and the replicated sampler
    take the same ones."""
    from quiver_tpu_torch.ops.sample import draw_u01, seeded_generator, uniform_offsets

    def draw(w, hop, et, deg):
        g = seeded_generator("cuda", 31, w, hop, sampler._rel_index[et])
        k = sampler.sizes[hop][et]
        if et in sampler.weighted_rels:
            return draw_u01(deg.shape, k, g)
        return uniform_offsets(deg, k, g)

    return draw


def dist_hetero_phase(card) -> tuple[dict, dict, dict]:
    """(c) ``bench_rgcn.py``'s MAG-shaped graph at its defaults (fanouts
    [8, 4], batch 512 split over the workers) through ``DistHeteroSampler``
    on ``(1, 4)``, uniform and weighted: exact launches, every worker
    bitwise ``HeteroGraphSampler`` on its block with the same draws, the
    owner-side calls against their plain versions, and one R-GCN step on a
    worker's block on the card against the CPU's. Returns ``(launches by
    kind, check rows by entry, result)``."""
    import functools

    import numpy as np
    import torch

    from quiver_tpu_torch import DistHeteroSampler, HeteroFeature, HeteroGraphSampler
    from quiver_tpu_torch.models.rgcn import rgcn_schema

    t0 = time.time()
    topo, feats, labels_np, _rng = mag_graph()
    wrng = np.random.default_rng(8)
    for et in topo.edge_types:
        topo.set_edge_weight(et, np.exp(wrng.normal(size=topo.relations[et].edge_count)))
    feature = HeteroFeature.from_cpu_tensors(feats, device_cache_size="4G", device="cuda")
    labels_all = torch.from_numpy(labels_np).to("cuda")
    seeds = np.random.default_rng(10).integers(0, MAG_PAPERS, RGCN_BATCH)
    launches, rows, result = {}, {"select": [], "wselect": []}, {}
    for kind, weighted in (("uniform", False), ("weighted", True)):
        smp = DistHeteroSampler(topo, RGCN_FANOUT, "paper", mesh=logical_mesh(*DIST_MESH),
                                routed_alpha=DIST_HETERO_ALPHA, weighted=weighted, seed=0)
        W = smp.workers
        draw = hetero_draw_fn(smp)
        smp.sample(seeds, draw_fn=draw)  # warm-up
        sync()
        cap = -(-RGCN_BATCH // W)
        plans = smp._plan(max(cap, 128))
        hops = sum(len(active) for active, _, _ in plans)
        entry = "wselect" if weighted else "select"
        reset_launches()
        with owner_calls() as calls:
            out = smp.sample(seeds, draw_fn=draw)
            sync()
        launches[kind] = read_launches()
        step9g(f"(c) {kind}: exactly {hops * W} {entry} launches (relation hops x owners)")
        expect_launches(launches[kind], {entry: hops * W}, f"distributed hetero {kind} sample")
        step9g(f"(c) {kind}: every owner-side {entry} bitwise {entry}_plain")
        r_rows, bound = owner_call_rows(calls, f"distributed hetero {kind} sample")
        del calls
        rep = HeteroGraphSampler(topo, RGCN_FANOUT, "paper", seed_capacity=out.batch_size,
                                 weighted=weighted, seed=0, device="cuda")
        step9g(f"(c) {kind}: every worker bitwise HeteroGraphSampler on its block")
        same = True
        for w, blk in enumerate(np.array_split(seeds, W)):
            ref = rep.sample(blk, draw_fn=functools.partial(draw, w))
            same &= all(equal(out.n_id[t].reshape(W, -1)[w], ref.n_id[t]) for t in ref.n_id)
            for la, lb in zip(out.adjs, ref.adjs):
                same &= all(equal(la.adjs[et].edge_index.reshape(2, W, -1)[:, w],
                                  a.edge_index) for et, a in lb.adjs.items())
        check(same, f"distributed hetero {kind} sample == HeteroGraphSampler per worker")
        r_rows.append({"case": f"distributed hetero {kind} sample, {W} workers: ids and "
                               "edges against HeteroGraphSampler", "match": same,
                       "max_abs_err": 0})
        rows[entry].extend(r_rows)
        result[kind] = {"launches": launches[kind], "relation_hops": hops,
                        "overflow_by_rel": {f"{h}:{'-'.join(et)}": v for (h, et), v in
                                            smp.last_sample_overflow_by_rel.items()},
                        "owner_side": bound, "plan": {
                            k: v for k, v in smp.dev_topos.plan.items() if k != "relations"}}
        if kind == "uniform":
            # one R-GCN step on worker 0's block, card against CPU
            w0 = smp.sample_per_worker(seeds, draw_fn=draw)[0]
            x = feature[w0.n_id]
            seed_ids = w0.n_id["paper"][:w0.batch_size]
            model_args = (rgcn_schema(w0.adjs, {t: RGCN_F for t in topo.num_nodes}),
                          RGCN_HIDDEN, RGCN_CLASSES, "paper", len(RGCN_FANOUT))
            step9g("(c) one R-GCN step on a worker's block: card against CPU")
            result["rgcn_parity"] = rgcn_parity(model_args, w0, x,
                                                labels_all[seed_ids.clamp(min=0)],
                                                seed_ids >= 0)
        del smp, rep, out
    result["config"] = ("bench_rgcn.py defaults: the MAG-shaped graph (200,000 papers, "
                        "100,000 authors, 5,000 institutions), fanouts [8, 4], batch 512 "
                        "over the (1, 4) logical mesh (128 a worker), routed_alpha 2.0; "
                        "weighted: exp(N(0, 1)) weights on every relation")
    result["seconds"] = time.time() - t0
    log(f"distributed hetero: {result['seconds']:.1f}s; R-GCN parity loss rel err "
        f"{result['rgcn_parity']['loss_rel_err']:.3g} [{card}]")
    return launches, rows, result


def dist_phase(topo, topo_t, card):
    """Phase 9g (see the module docstring). Returns ``(launches by path,
    check rows by entry, result)``."""
    import torch

    t0 = time.time()
    l_a, rows, samplers = dist_sampler_phase(topo, topo_t, card)
    l_b, rows_b, trainer = topo_trainer_phase(card)
    torch.cuda.empty_cache()
    l_c, rows_c, hetero = dist_hetero_phase(card)
    torch.cuda.empty_cache()
    rows["select"] += rows_b + rows_c["select"]
    rows["wselect"] += rows_c["wselect"]
    result = {"samplers": samplers, "trainer": trainer, "hetero": hetero,
              "seconds": time.time() - t0}
    log(f"distributed phase {result['seconds']:.1f}s [{card}]")
    return {"sample": l_a, "trainer": l_b, "hetero": l_c}, rows, result



# -- phase 9h: the sharded store's int8 tiers, repin, row updates, the controller --

# benchmarks/bench_feature.py's feature-controller configuration
# (benchmarks/scoreboard.py:161-163: --policy shard --routed --routed-alpha 2
# --replicate-budget 16M --controller) on a logical mesh of 4, and its
# recorded trace (bench_feature.py:275-330): 4 batches of 65,536 ids, 80%
# of them on the 1,024 lowest-degree rows
CTL_MESH, CTL_REPLICATE, CTL_ALPHA = (1, 4), "16M", 2.0
CTL_TRACE_BATCHES, CTL_TRACE_IDS, CTL_TRACE_HOT, CTL_TRACE_SHARE = 4, 65_536, 1_024, 0.8
# the int8 trainer's store: phase 9f (b)'s split (8,192 L0 rows and 16,384
# L1 rows a shard, the rest cold) in 128 B code rows, the scales charged to
# the sharded budget first
CTL_L1, CTL_L0 = 4 * MULTI_NODES + 16_384 * MULTI_F, 8_192 * MULTI_F
CTL_ALPHA0, CTL_HEAT_BINS, CTL_EPOCH_STEPS = 0.25, 256, 8
INT8_KERNELS = ("uniform_hop_kernel", "select_kernel", "gather_dequant_kernel",
                "gather_kernel")


def step9h(what: str) -> None:
    """Name a phase 9h check on stderr before it runs."""
    log(f"phase 9h check: {what}")


def int8_rows(x, ids_np):
    """numpy's int8 rows of ``ids_np``: each row quantised on its own
    (bitwise the stores' per-row quantisation), codes times scale; zero
    rows on ``-1`` lanes."""
    import numpy as np

    from quiver_tpu_torch.feature.feature import quantize_rows_int8

    q, scale = quantize_rows_int8(x[np.maximum(ids_np, 0)])
    out = q.astype(np.float32) * scale[:, None]
    out[ids_np < 0] = 0
    return out


def dense_rows(x, ids_np):
    """numpy's float32 rows of ``ids_np``; zero rows on ``-1`` lanes."""
    import numpy as np

    out = x[np.maximum(ids_np, 0)]
    out[ids_np < 0] = 0
    return out


def frontier_ids(topo):
    """Phase 9f (a)'s ids: the 3-hop frontier of 1024 seeds at
    bench_epoch's fanouts (an auto sampler, planned by its first call)."""
    import numpy as np

    from quiver_tpu_torch import GraphSageSampler

    sampler = GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", seed_capacity=EPOCH_BATCH,
                               seed=0, frontier_caps="auto")
    seeds = np.random.default_rng(7).integers(0, topo.node_count, EPOCH_BATCH)
    sampler.sample(seeds)
    return sampler.sample(seeds).n_id


def tier_hits(store, ids):
    """A numpy count of the valid lanes per tier ``[L0, L1, cold]``."""
    import numpy as np

    t = store.feature_order.cpu().numpy()[np.maximum(ids, 0)]
    valid = ids >= 0
    end = store.rep_rows + store.hot_rows
    return [int((valid & (t < store.rep_rows)).sum()),
            int((valid & (t >= store.rep_rows) & (t < end)).sum()),
            int((valid & (t >= end)).sum())]


def int8_tier_checks(store, ids, what: str) -> list:
    """K2 on each int8 tier with the ids a psum lookup of ``ids`` sends it:
    the dequantising entry on the L0 block and the pinned cold rows, and on
    the L1 shards' summed codes with the L1 scales, bitwise
    ``tiered_gather_plain(..., scale)``; ``gather_rows`` on each L1 shard's
    codes bitwise ``gather_rows_plain``. Returns the check rows."""
    import torch

    from quiver_tpu_torch.ops.kernels.gather import (gather_rows, gather_rows_plain,
                                                     tiered_gather_dequant, tiered_gather_plain)

    t = store.feature_order[ids.clamp(min=0).long()].long()
    valid = ids >= 0
    end = store.rep_rows + store.hot_rows
    rps = store.hot.rows_per_shard
    l1 = torch.where(valid & (t >= store.rep_rows) & (t < end), t - store.rep_rows, -1)
    codes = None
    rows = []

    def row(name, entry, n, kern, plain):
        ok = equal(kern, plain)
        step9h(f"{what}: {entry} on the {name} bitwise its plain version")
        check(ok, f"{what}: {entry} on the {name} == plain")
        rows.append({"store": f"{what}, {entry} on the {name}: {n} lanes",
                     "match": ok, "max_abs_err": float((kern.float() - plain.float()).abs().max())})

    for d, shard in enumerate(store.hot.shards):
        mine = (l1 >= 0) & (l1 // rps == d)
        local = torch.where(mine, l1 - d * rps, -1).to(torch.int32).contiguous()
        kern = gather_rows(shard, local)
        row(f"L1 shard {d}", "gather_rows", int(mine.sum()), kern, gather_rows_plain(shard, local))
        codes = kern if codes is None else codes + kern
    lanes = torch.where(l1 >= 0, torch.arange(l1.numel(), device=l1.device), -1)
    cases = [("L0 block", store.rep, store._rep_scales[store.rep.device],
              torch.where(valid & (t < store.rep_rows), t, -1)),
             ("cold rows (pinned, UVA)", store.cold, store._cold_scale,
              torch.where(valid & (t >= end), t - end, -1)),
             ("L1 shards' summed codes", codes,
              torch.where(l1 >= 0, store.hot.scale[l1.clamp(min=0)], 0.0), lanes)]
    for name, table, scale, tier_ids in cases:
        args = (tier_ids.to(torch.int32).contiguous(), None, table.shape[0], table, None, scale)
        row(name, "tiered_gather_dequant", int((args[0] >= 0).sum()),
            tiered_gather_dequant(*args), tiered_gather_plain(*args))
    return rows


def int8_store_phase(topo, x, pcie, card):
    """(a) Phase 9f (a)'s rows stored as int8 on the meshes ``SHARD_MESHES``
    (2% on L0, 18% on L1 after the scales, the rest pinned): for the 3-hop
    frontier of 1024 seeds the psum and routed (uncapped, the planned cap,
    a cap of 1 that overflows) lookups bitwise the replicated int8
    ``Feature``'s lookup and the numpy int8 rows; the tier hits a numpy
    count; ``tiered_gather_dequant`` launches exact; each tier's call
    bitwise its plain version; the lookups timed in turns with the
    replicated one, K2's device ms and their bound. Returns ``(launches of
    the checked lookups, check rows, result)``."""
    import torch

    from quiver_tpu_torch import Feature, ShardedFeature

    t0 = time.time()
    n, F = x.shape
    ids = frontier_ids(topo)
    ids_np = ids.cpu().numpy()
    want = torch.from_numpy(int8_rows(x, ids_np)).to("cuda")
    replicated = Feature(device_cache_size=int(0.2 * n) * F * 4, csr_topo=topo, dtype="int8",
                         device="cuda").from_cpu_tensor(x)
    check(replicated.kernel == "pallas", "the int8 store's auto lookup resolves to K2")
    reset_launches()
    ref = replicated[ids]
    sync()
    step9h("(a) the replicated int8 lookup: one tiered_gather_dequant, the numpy int8 rows")
    expect_launches(read_launches(), {"tiered_gather_dequant": 1}, "replicated int8 lookup")
    check(equal(ref, want), "replicated int8 lookup == the numpy int8 rows")
    rows, launches = [], {}
    result = {"ids": int(ids.numel()), "valid_ids": int((ids_np >= 0).sum()), "meshes": {},
              "replicated_hot_rows": replicated.hot_rows}
    for data, fsize in SHARD_MESHES:
        t1 = time.time()
        l1_rows = int(SHARD_L1 * n) // fsize
        store = ShardedFeature(
            logical_mesh(data, fsize), device_cache_size=4 * n + l1_rows * F, csr_topo=topo,
            replicate_budget=int(SHARD_L0 * n) * F, dtype="int8").from_cpu_tensor(x)
        setup_s = time.time() - t1
        label = f"({data}, {fsize})"
        step9h(f"(a) {label}: the split after the scale charge and the pinned cold tier")
        check(store.rep_rows == int(SHARD_L0 * n) and store.hot_rows == l1_rows * fsize
              and store.cold.is_pinned() and store.scale.is_cuda,
              f"int8 sharded store {label}: split {store.rep_rows} / {store.hot_rows}")
        want_hits = tier_hits(store, ids_np)
        local = -(-ids.numel() // (data * fsize))
        cap = store.hot.routed_cap(local)
        got = {}
        for name, kw in {"psum": dict(routed=False),
                         "routed, uncapped": dict(routed=True, routed_cap=None),
                         f"routed, planned cap {cap}": dict(routed=True, routed_cap=cap),
                         "routed, cap 1": dict(routed=True, routed_cap=1)}.items():
            reset_launches()
            out = store.gather(ids, **kw)
            sync()
            # L0 and cold one dequantising launch each; each shard's codes
            # by gather_rows and one dequantising launch after their sum
            # (psum) or per feature group after the exchange (routed)
            want_k = ({"tiered_gather_dequant": data + 2, "gather_rows": data * fsize}
                      if kw["routed"] else {"tiered_gather_dequant": 3, "gather_rows": fsize})
            k = sum(want_k.values())
            step9h(f"(a) {label} {name}: K2 launches {want_k}, bitwise the "
                   "replicated int8 lookup and the numpy int8 rows, exact tier hits")
            expect_launches(read_launches(), want_k, f"int8 sharded store {label} {name}")
            check(equal(out, ref) and equal(out, want),
                  f"int8 sharded store {label} {name} == replicated int8 lookup")
            check(store.last_tier_hits.tolist() == want_hits,
                  f"int8 sharded store {label} {name}: hits {store.last_tier_hits.tolist()} "
                  f"against {want_hits}")
            got[name] = {"overflow": int(store.last_routed_overflow) if kw["routed"] else 0,
                         "launches": k, "k2": want_k}
            launches[f"{label} {name}"] = k
            rows.append({"store": f"int8 sharded store {label}, {name}: {int(ids.numel())} ids",
                         "match": True, "max_abs_err": float((out - want).abs().max())})
            del out
        step9h(f"(a) {label}: a cap of 1 overflows, the uncapped gather does not")
        check(got["routed, cap 1"]["overflow"] > 0 and got["routed, uncapped"]["overflow"] == 0,
              f"int8 sharded store {label}: overflow {got}")
        rows += int8_tier_checks(store, ids, f"int8 sharded store {label}")
        psum = lambda: store.gather(ids)  # noqa: E731
        routed = lambda: store.gather(ids, routed=True, routed_cap=cap)  # noqa: E731
        rep = lambda: replicated[ids]  # noqa: E731
        t_psum = in_turns(psum, rep, *SHARD_TIMED)
        t_routed = in_turns(routed, rep, *SHARD_TIMED)
        nv, nc, B = sum(want_hits), want_hits[2], int(ids.numel())
        dev_bytes = B * 4 + nv * 4 + nv * 4 + (nv - nc) * F + B * F * 4
        bound_s = max(dev_bytes / HBM_BYTES_PER_S, nc * F / pcie)
        t = {"psum_ms": t_psum["ms"], "psum_turns": t_psum["ms_turns"],
             "routed_ms": t_routed["ms"], "routed_turns": t_routed["ms_turns"],
             "replicated_ms": (t_psum["yard_ms"] + t_routed["yard_ms"]) / 2,
             "replicated_turns": t_psum["yard_turns"] + t_routed["yard_turns"],
             "k2_device_ms": k2_device_ms([
                 ("psum", psum, got["psum"]["k2"]),
                 ("routed", routed, got[f"routed, planned cap {cap}"]["k2"]),
                 ("replicated", rep, {"tiered_gather_dequant": 1})]),
             "bound_ms": bound_s * 1e3, "device_bytes": dev_bytes, "cold_bytes": nc * F}
        result["meshes"][label] = {"rep_rows": store.rep_rows, "hot_rows": store.hot_rows,
                                   "cold_rows": n - store.rep_rows - store.hot_rows,
                                   "tier_hits": want_hits, "planned_cap": cap, "lookups": got,
                                   "timing": t, "setup_s": setup_s}
        log(f"int8 sharded store {label}: {store.rep_rows} L0 / {store.hot_rows} L1 / "
            f"{n - store.rep_rows - store.hot_rows} cold rows, hits {want_hits}; psum "
            f"{t['psum_ms']:.4f} ms, routed {t['routed_ms']:.4f} ms, replicated "
            f"{t['replicated_ms']:.4f} ms; K2 device {t['k2_device_ms']}; bound "
            f"{t['bound_ms']:.4f} ms [{card}]")
        store.delete()
        del store
    del replicated
    result["seconds"] = time.time() - t0
    return launches, rows, result


def controller_store(topo, x, dtype):
    """bench_feature's feature-controller store on the logical mesh
    ``CTL_MESH``: a 20%-of-f32 budget split over the mesh, ``routed_alpha``
    2, a 16M L0 (float32 or int8 rows)."""
    from quiver_tpu_torch import ShardedFeature

    n, F = x.shape
    return ShardedFeature(logical_mesh(*CTL_MESH),
                          device_cache_size=int(0.2 * n) * F * 4 // CTL_MESH[1],
                          csr_topo=topo, routed_alpha=CTL_ALPHA, dtype=dtype,
                          replicate_budget=CTL_REPLICATE).from_cpu_tensor(x)


def store_state(store, ids):
    """What a rejected update must leave: the rows of ``ids`` (every
    flavour), the scales, the order, the host region, version and split."""
    return ([store.gather(ids, **kw).clone() for kw in (
                {}, {"routed": True, "routed_cap": None})],
            None if store.scale is None else store.scale.clone(),
            store.feature_order.clone(), store._region_host.clone(),
            store.version, store.rep_rows, store.hot_rows)


def same_state(a, b) -> bool:
    import torch

    for u, v in zip(a, b):
        if isinstance(u, list):
            if not all(equal(p, q) for p, q in zip(u, v)):
                return False
        elif isinstance(u, torch.Tensor):
            if not equal(u, v):
                return False
        elif u != v:
            return False
    return True


def controller_phase(topo, x, card):
    """(b) ``repin`` and the controller at bench_feature's
    feature-controller configuration, float32 and int8: the recorded trace
    feeds a ``CacheController`` and ``maybe_repin`` re-tiers the store; the
    trace's L0 hit rate before and after; a post-repin gather of every
    flavour bitwise the dense (int8: numpy int8) rows, launches exact. (c)
    On the repinned store one ``apply_row_updates`` touching an L0 row,
    every L1 shard's first row and cold rows: ``version`` bumped once, every
    flavour bitwise the dense rows with the rows patched; a duplicate id and
    a NaN row each rejected with the store bitwise unchanged. Returns
    ``(launches, rows, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CacheController
    from quiver_tpu_torch.control.freq import FreqSketch

    t0 = time.time()
    n, F = x.shape
    rng = np.random.default_rng(2)  # bench_feature's seed + 2
    hot = np.argsort(topo.degree.astype(np.int64), kind="stable")[:CTL_TRACE_HOT]
    trace = [np.where(rng.random(CTL_TRACE_IDS) < CTL_TRACE_SHARE,
                      rng.choice(hot, size=CTL_TRACE_IDS),
                      rng.integers(0, n, CTL_TRACE_IDS)).astype(np.int32)
             for _ in range(CTL_TRACE_BATCHES)]
    result, launches, rows = {}, {}, []
    os.makedirs(OUT_DIR, exist_ok=True)
    for dtype in (None, "int8"):
        label = "int8" if dtype else "float32"
        oracle = int8_rows if dtype else dense_rows
        entry = "tiered_gather_dequant" if dtype else "gather_rows"
        t1 = time.time()
        store = controller_store(topo, x, dtype)
        setup_s = time.time() - t1

        def l0_rate():
            order = store.feature_order.cpu().numpy()
            return sum(int((order[b] < store.rep_rows).sum()) for b in trace) / float(
                CTL_TRACE_BATCHES * CTL_TRACE_IDS)

        before = l0_rate()
        ctl = CacheController(sketch=FreqSketch(n, top_k=CTL_TRACE_HOT),
                              decision_log=os.path.join(OUT_DIR, f"ctl_decisions_{label}.jsonl"))
        for b in trace:
            ctl.observe_ids(b)
        split = (store.rep_rows, store.hot_rows)
        t1 = time.time()
        repinned = ctl.maybe_repin(store)
        repin_s = time.time() - t1
        after = l0_rate()
        step9h(f"(b) {label}: maybe_repin re-tiers once, the tiers keep their sizes, "
               "the trace's L0 hit rate rises")
        check(repinned and store.version == 1 and (store.rep_rows, store.hot_rows) == split
              and after > before, f"controller {label}: repin {repinned}, version "
              f"{store.version}, L0 hit rate {before} -> {after}")
        ids = torch.from_numpy(trace[0]).to("cuda")
        want = torch.from_numpy(oracle(x, trace[0])).to("cuda")
        cap = store.hot.routed_cap(CTL_TRACE_IDS // CTL_MESH[1])
        for name, kw in (("psum", {}), ("routed, uncapped", {"routed": True,
                                                            "routed_cap": None}),
                         (f"routed, cap {cap}", {"routed": True, "routed_cap": cap})):
            reset_launches()
            out = store.gather(ids, **kw)
            sync()
            # float32: one launch per tier table; int8: the shards' codes
            # (gather_rows), dequantised once after their sum or once per
            # feature group after the exchange
            groups, fsize = CTL_MESH
            want_k = ({entry: fsize + 2} if not dtype
                      else {entry: (groups if kw else 1) + 2,
                            "gather_rows": (groups if kw else 1) * fsize})
            step9h(f"(b) {label} post-repin {name} gather: K2 launches {want_k}, bitwise "
                   "the dense rows")
            expect_launches(read_launches(), want_k, f"controller {label} post-repin {name}")
            check(equal(out, want), f"controller {label} post-repin {name} == dense rows")
            launches[f"{label} post-repin {name}"] = sum(want_k.values())
            rows.append({"store": f"controller store ({label}) post-repin {name}: "
                                  f"{CTL_TRACE_IDS} ids", "match": True,
                         "max_abs_err": float((out - want).abs().max())})
        if dtype:
            rows += int8_tier_checks(store, ids, "controller store (int8) post-repin")
        # (c) one transaction in every tier: L0, each shard's first row, cold
        order = store.feature_order.cpu().numpy()
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        rps, end = store.hot.rows_per_shard, store.rep_rows + store.hot_rows
        slots = [0] + [store.rep_rows + d * rps for d in range(CTL_MESH[1])] + [end, n - 1]
        upd = inv[np.asarray(slots)]
        new = np.random.default_rng(3).normal(size=(len(upd), F)).astype(np.float32) + 50.0
        check_ids = np.concatenate([upd, trace[1][:8192]]).astype(np.int32)
        patched = x[np.maximum(check_ids, 0)]
        for j, u in enumerate(upd):
            patched[check_ids == u] = new[j]
        want = torch.from_numpy(oracle(patched, np.arange(len(check_ids)))).to("cuda")
        dev_ids = torch.from_numpy(check_ids).to("cuda")
        store.apply_row_updates(upd, new)
        step9h(f"(c) {label}: one update in every tier bumps version once; every flavour "
               "bitwise the patched dense rows")
        check(store.version == 2, f"row update {label}: version {store.version}")
        for name, kw in (("psum", {}), ("routed", {"routed": True}),
                         ("routed, cap 1", {"routed": True, "routed_cap": 1})):
            out = store.gather(dev_ids, **kw)
            check(equal(out, want), f"row update {label}: {name} == the patched rows")
            rows.append({"store": f"controller store ({label}) after a row update, {name}: "
                                  f"{len(check_ids)} ids", "match": True,
                         "max_abs_err": float((out - want).abs().max())})
        state = store_state(store, dev_ids)
        bad_nan = new[:2].copy()
        bad_nan[1, 3] = np.nan
        for what, args, match in (("a duplicate id", (upd[[0, 0]], new[:2]), "duplicate"),
                                  ("a NaN row", (upd[:2], bad_nan), "non-finite")):
            step9h(f"(c) {label}: {what} is rejected and the store stays bitwise as it was")
            try:
                store.apply_row_updates(*args)
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised is not None and match in raised and same_state(store_state(
                store, dev_ids), state), f"row update {label}: {what} -> {raised}")
        result[label] = {"split": list(split), "setup_s": setup_s,
                         "trace_l0_hit_rate": {"before": before, "after": after},
                         "repin_s": repin_s, "decisions": ctl.stats(),
                         "updated_rows": len(upd), "version": store.version}
        log(f"controller store ({label}): {split[0]} L0 / {split[1]} L1 rows; the trace's L0 "
            f"hit rate {before:.4f} -> {after:.4f} (repin {repin_s:.2f} s) [{card}]")
        store.delete()
        del store, state
    result["seconds"] = time.time() - t0
    return launches, rows, result


def degree_feed_check(topo, x):
    """(c) ``note_degree_update`` on an ``auto_split=True`` int8 store of
    phase 9f (b)'s rows with a controller attached: degrees that put every
    hit past L0 halve the boundary once, the controller gets the prior,
    the rows stay bitwise."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CacheController, ShardedFeature

    n = topo.node_count
    store = ShardedFeature(logical_mesh(2, 2), device_cache_size=CTL_L1, csr_topo=topo,
                           replicate_budget=CTL_L0, dtype="int8",
                           auto_split=True).from_cpu_tensor(x)
    ctl = CacheController().attach(store)
    ids = torch.arange(-1, n, dtype=torch.int32, device="cuda")
    before, rep0 = store.gather(ids).clone(), store.rep_rows
    inv = np.empty(n, np.int64)
    inv[store.feature_order.cpu().numpy()] = np.arange(n)
    deg = np.zeros(n, np.int64)
    deg[inv[rep0:rep0 + store.hot_rows]] = 100
    store.note_degree_update(deg)
    step9h("(c) note_degree_update on an auto_split store moves the boundary once, "
           "seeds the controller, keeps the rows")
    check(store.rep_rows == rep0 // 2 and ctl.sketch.state()["hitters"]
          and equal(store.gather(ids), before),
          f"degree feed: L0 {rep0} -> {store.rep_rows}")
    out = {"rep_rows": [rep0, store.rep_rows], "prior_hitters": len(ctl.sketch.state()["hitters"])}
    store.delete()
    return out


def control_trainer(topo, store, seed_sharding, topo_sharding, **kw):
    """``DistributedTrainer`` at train_multichip's width (GraphSAGE 256 x 3,
    Adam 1e-3, local batch 256, the default caps) over ``store`` on its
    mesh; ``init(0)``."""
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE

    where = ({"device": "cuda"} if topo_sharding == "replicated"
             else {"topo_sharding": "mesh", "mesh": store.mesh})
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, **where)
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES, num_layers=len(MULTI_FANOUT))
    trainer = DistributedTrainer(store.mesh, sampler, store, model.to("cuda"),
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding=seed_sharding, **kw)
    trainer.init(0)
    return trainer


def control_mode(topo, x, labels, seed_sharding, topo_sharding, card):
    """(d) One mode over an int8 ``auto_split`` store with
    ``controller=CacheController(heat_bins=256)`` and ``auto_alpha=True``
    from ``routed_alpha=0.25``: 3 + 10 steps (steps/s, peak memory),
    exact K1 and K2 launches every step (from the split after the step's
    tuner), alpha doubling after every overflowing step, the heat feed
    counting every valid lane, 5 profiled steps; 3 steps under
    deterministic kernels bitwise for auto_alpha against ``auto_alpha=False``
    uncapped and for a frozen controller against none; under ``"all"``
    one ``epoch_scan`` whose ``end_epoch`` repins (the next step runs), and
    a manual repin that raises ``VersionMismatchError`` until
    ``refresh()``. Returns ``(launches of the timed steps, result)``."""
    import math

    import numpy as np
    import torch

    from quiver_tpu_torch import CacheController, ShardedFeature, VersionMismatchError
    from quiver_tpu_torch.obs.registry import FEATURE_ROW_HEAT

    def store_():
        return ShardedFeature(logical_mesh(2, 2), device_cache_size=CTL_L1, csr_topo=topo,
                              replicate_budget=CTL_L0, dtype="int8",
                              auto_split=True).from_cpu_tensor(x)

    what = f"{seed_sharding}, {topo_sharding} topology"
    store = store_()
    check(store.rep_rows == 8192 and store.hot_rows == 32768 and store.cold.is_pinned(),
          f"int8 trainer store split {store.rep_rows} / {store.hot_rows}")
    ctl = CacheController(heat_bins=CTL_HEAT_BINS, repin_min_gain=0.0)
    trainer = control_trainer(topo, store, seed_sharding, topo_sharding,
                              routed_alpha=CTL_ALPHA0, auto_alpha=True, controller=ctl)
    check(trainer._heat_bins == CTL_HEAT_BINS and store._controller is ctl,
          f"{what}: the controller is attached and its heat feed registered")
    groups, F, n = trainer.data_size, trainer.feature_size, topo.node_count
    rng = np.random.default_rng(1)
    k1_name = "select" if topo_sharding == "mesh" else "uniform_hop"
    k1 = (len(MULTI_FANOUT) * F * groups if topo_sharding == "mesh"
          else len(MULTI_FANOUT) * trainer.workers)
    per_step, times, losses = [], [], []
    total = {}
    for i in range(MULTI_WARMUP + MULTI_STEPS):
        if i == MULTI_WARMUP:
            sync()
            torch.cuda.reset_peak_memory_stats()
        seeds = rng.integers(0, n, trainer.global_batch)
        reset_launches()
        a = time.perf_counter()
        losses.append(trainer.step(seeds, labels, 10 + i))
        sync()
        dt = time.perf_counter() - a
        got = read_launches()
        # per feature group: L0 and cold one dequantising launch each, each
        # shard's codes by gather_rows and one dequantising launch after
        # their sum (psum) or the exchange (routed)
        tiers = int(store.rep_rows > 0) + int(store.cold is not None)
        k2 = {"tiered_gather_dequant": groups * (tiers + 1), "gather_rows": groups * F}
        step9h(f"(d) {what} step {i}: exactly {k1} {k1_name} and K2 launches {k2}")
        expect_launches(got, {k1_name: k1, **k2}, f"{what} step {i}")
        ov = int(trainer.last_routed_overflow) + int(trainer.last_sample_overflow.sum())
        heat = int(trainer.metrics.value(FEATURE_ROW_HEAT).sum())
        step9h(f"(d) {what} step {i}: the heat histogram counts every valid lane once")
        check(heat == int(trainer.last_tier_hits.sum()), f"{what}: heat {heat} against hits "
              f"{trainer.last_tier_hits.tolist()}")
        per_step.append({"alpha": trainer.routed_alpha, "overflow": ov, "rep_rows": store.rep_rows,
                         "launches": {k1_name: k1, **k2}})
        if i >= MULTI_WARMUP:
            times.append(dt)
            for name, v in got.items():
                total[name] = total.get(name, 0) + v
    grew = 0
    for a, b in zip(per_step, per_step[1:]):
        if a["overflow"] > 0 and a["alpha"] < F:
            grew += 1
            check(b["alpha"] == min(2 * a["alpha"], F), f"{what}: alpha {a} -> {b}")
    step9h(f"(d) {what}: alpha doubles after each overflowing step"
           + (" (it overflowed)" if seed_sharding == "all" else " (nothing routes: no overflow)"))
    check(grew > 0 if seed_sharding == "all" else all(
        s["overflow"] == 0 and s["alpha"] == CTL_ALPHA0 for s in per_step),
        f"{what}: alphas {[(s['alpha'], s['overflow']) for s in per_step]}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"{what}: losses")
    step_ms = trimmed_mean(times) * 1e3
    r = {"workers": trainer.workers, "global_batch": trainer.global_batch,
         "caps": list(trainer.caps), "warmup": MULTI_WARMUP, "steps": MULTI_STEPS,
         "step_ms_trimmed_mean": step_ms, "steps_per_s": 1e3 / step_ms,
         "peak_bytes": torch.cuda.max_memory_allocated(), "per_step": per_step,
         "loss_first_last": [losses[0], losses[-1]], "alpha_growths": grew,
         "controller": ctl.stats()}
    step9h(f"(d) {what}: the profiler sees the card")
    prof = profiled_idle(lambda: [trainer.step(rng.integers(0, n, trainer.global_batch),
                                               labels, 1000 + k)
                                  for k in range(PROFILED_STEPS)],
                         PROFILED_STEPS, step_ms, INT8_KERNELS)
    ours = prof.pop("port_kernels_ms_per_step")
    prof["profiled_steps"] = prof.pop("steps")
    del prof["step_ms"]
    r.update(prof, k1_device_ms_per_step=ours["select_kernel" if topo_sharding == "mesh"
                                              else "uniform_hop_kernel"],
             k2_device_ms_per_step=ours["gather_dequant_kernel"] + ours["gather_kernel"])
    if seed_sharding == "all":
        # one epoch whose end repins; then a manual repin needs refresh()
        mat = trainer.pack_epoch(rng.integers(0, n, CTL_EPOCH_STEPS * trainer.global_batch),
                                 seed=3)
        v0 = store.version
        el = trainer.epoch_scan(mat, labels, 21)
        step9h(f"(d) {what}: epoch_scan's end_epoch repins, the trainer is refreshed and "
               "its next step runs")
        check(bool(torch.isfinite(el).all()) and store.version == v0 + 1
              and ctl.stats()["repins"] >= 1
              and trainer._bound_versions == trainer._current_versions(),
              f"{what}: epoch repin, version {v0} -> {store.version}, {ctl.stats()}")
        check(math.isfinite(float(trainer.step(rng.integers(0, n, trainer.global_batch),
                                                labels, 3000))), f"{what}: step after repin")
        probe = rng.integers(-1, n, 20_000).astype(np.int32)
        step9h(f"(d) {what}: the repinned store's rows bitwise the numpy int8 rows")
        check(equal(store.gather(torch.from_numpy(probe).to("cuda")),
                    torch.from_numpy(int8_rows(x, probe)).to("cuda")),
              f"{what}: repinned rows")
        store.repin(ctl.sketch.top_rows(64))
        step9h(f"(d) {what}: a repin without refresh() raises VersionMismatchError")
        try:
            trainer.step(rng.integers(0, n, trainer.global_batch), labels, 3001)
            raised = False
        except VersionMismatchError:
            raised = True
        check(raised, f"{what}: a stale trainer raised")
        trainer.refresh()
        check(math.isfinite(float(trainer.step(rng.integers(0, n, trainer.global_batch),
                                                labels, 3002))), f"{what}: step after refresh")
        r["epoch"] = {"steps": CTL_EPOCH_STEPS, "losses_first_last": [float(el[0]),
                                                                     float(el[-1])],
                      "version": store.version, "controller": ctl.stats()}
    del trainer
    store.delete()
    # bitwise under deterministic kernels: auto_alpha against fixed
    # uncapped, a frozen controller against none (each over a fresh store)
    det = {}
    with deterministic_algorithms():
        for name, kw in (("auto_alpha", {"routed_alpha": CTL_ALPHA0, "auto_alpha": True}),
                         ("uncapped", {"routed_alpha": None}),
                         ("frozen", {"controller": CacheController(frozen=True,
                                                                   heat_bins=CTL_HEAT_BINS)}),
                         ("none", {})):
            s = store_()
            det[name] = [float(v) for v in multichip_losses(
                control_trainer(topo, s, seed_sharding, topo_sharding, **kw), labels,
                MULTI_DET_STEPS)]
            s.delete()
    step9h(f"(d) {what}: deterministic losses bitwise: auto_alpha == uncapped, frozen "
           "controller == none")
    check(det["auto_alpha"] == det["uncapped"] and det["frozen"] == det["none"],
          f"{what}: deterministic losses {det}")
    r["deterministic_losses"] = det
    log(f"int8 controller trainer ({what}): {r['steps_per_s']:.4g} steps/s ({step_ms:.3f} ms), "
        f"idle share {r['idle_share']:.4f}, K1 {r['k1_device_ms_per_step']:.4f} ms, K2 "
        f"{r['k2_device_ms_per_step']:.4f} ms a step, peak {r['peak_bytes'] / 2**30:.3f} GiB, "
        f"alphas {[s['alpha'] for s in per_step]}, L0 rows {[s['rep_rows'] for s in per_step]} "
        f"[{card}]")
    return total, r


def control_phase(topo, pcie, card):
    """Phase 9h (see the module docstring). Returns ``(launches by path,
    K2 check rows, result)``."""
    import numpy as np
    import torch

    t0 = time.time()
    x = np.random.default_rng(0).normal(size=(topo.node_count, EPOCH_F)).astype(np.float32)
    l_a, rows, store = int8_store_phase(topo, x, pcie, card)
    torch.cuda.empty_cache()
    l_b, rows_b, ctl = controller_phase(topo, x, card)
    del x
    torch.cuda.empty_cache()
    t1 = time.time()
    mtopo, mx, labels = multichip_setup()
    degree = degree_feed_check(mtopo, mx)
    trainer, l_d = {}, {}
    for seed_sharding, topo_sharding in (("data", "replicated"), ("all", "mesh")):
        l_d[seed_sharding], trainer[seed_sharding] = control_mode(
            mtopo, mx, labels, seed_sharding, topo_sharding, card)
        torch.cuda.empty_cache()
    result = {"int8_store": store, "controller": ctl, "degree_feed": degree,
              "trainer": {"modes": trainer, "seconds": time.time() - t1,
                          "config": "examples/train_multichip.py defaults (phase 9f (b)) over "
                                    "an int8 auto_split ShardedFeature (8,192 L0 / 32,768 L1 / "
                                    "59,040 cold rows) with CacheController(heat_bins=256, "
                                    "repin_min_gain=0) and auto_alpha=True from "
                                    "routed_alpha=0.25; 'data' over the replicated sampler, "
                                    "'all' over a topology-sharded one"},
              "seconds": time.time() - t0}
    log(f"control phase {result['seconds']:.1f}s [{card}]")
    return {"store": l_a, "controller": l_b, "trainer": l_d}, rows + rows_b, result


# -- phase 9i: elastic resume across mesh shapes --------------------------------

ELASTIC_MESHES = (4, 2, 1)  # feature-axis sizes of the logical (1, F) meshes
ELASTIC_WORKERS = 4  # logical workers: 1, 2 and 4 blocks a slot
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_PREEMPT = 9, 3, 3  # epoch, checkpoint chunk, kill
SCRATCH = os.path.join(HERE, ".smoke_scratch")  # git-ignored; removed after each phase


def step9i(what: str) -> None:
    """Name a phase 9i check on stderr before it runs."""
    log(f"phase 9i check: {what}")


def elastic_trainer(topo, x, fsize: int, ckpt, plan=None, mesh=None):
    """The elastic trainer of phase 9i on the logical ``(1, fsize)`` mesh
    (or on ``mesh``, phase 9n's world) at ``train_multichip``'s width: a
    three-tier store (``MULTI_L1`` per device of L1, ``MULTI_L0`` of L0,
    the rest pinned), a topology-sharded sampler, GraphSAGE 256 x 3, Adam
    1e-3, local batch 256, ``logical_workers=ELASTIC_WORKERS``, checkpoints
    every ``ELASTIC_EVERY`` steps into ``ckpt``; ``init(0)``."""
    import torch

    from quiver_tpu_torch import (DistributedTrainer, GraphSageSampler, GraphSAGE,
                                  ShardedFeature)

    mesh = logical_mesh(1, fsize) if mesh is None else mesh
    store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0).from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, topo_sharding="mesh", mesh=mesh)
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES, num_layers=len(MULTI_FANOUT))
    trainer = DistributedTrainer(mesh, sampler, store, model.to("cuda"),
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding="all",
                                 logical_workers=ELASTIC_WORKERS, fault_plan=plan,
                                 checkpoint_dir=ckpt, checkpoint_every=ELASTIC_EVERY,
                                 checkpoint_keep=16)
    trainer.init(0)
    return trainer


def elastic_launches(fsize: int, steps: int) -> dict:
    """Exact K1 and K2 launches of ``steps`` elastic steps on ``(1,
    fsize)``: per step and per feature group's block, one owner-side
    ``select`` per owner per hop, and one ``gather_rows`` for L0, one per
    shard and one for the cold rows."""
    bpd = ELASTIC_WORKERS // fsize
    return {"select": steps * bpd * fsize * len(MULTI_FANOUT),
            "gather_rows": steps * bpd * (fsize + 2)}


def timed_epoch(trainer, seed_mat, labels, key, **kw):
    """``epoch_scan`` on the card, synchronised: ``(losses, seconds)``."""
    sync()
    t0 = time.perf_counter()
    losses = trainer.epoch_scan(seed_mat, labels, key, **kw)
    sync()
    return losses, time.perf_counter() - t0


def same_bits(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool((a.view(np.uint32) == b.view(np.uint32)).all())


def same_params(a: dict, b: dict) -> bool:
    """Two state dicts bitwise alike."""
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def elastic_int8_replan(topo, x, ids, card) -> dict:
    """(e) An int8 store on ``(1, 4)`` replanned onto ``(1, 2)`` and ``(1,
    1)``: its psum and routed lookups of a frontier bitwise the lookups
    before the replan, one ``tiered_gather_dequant`` for L0 and one for the
    cold rows, the shards' codes by ``gather_rows`` and one dequantising
    launch after their sum or the exchange, and its tiers as the budgets
    plan them."""
    from quiver_tpu_torch import ShardedFeature

    n = topo.node_count
    # per device: n / 8 L1 rows of MULTI_F code bytes after the (n,) f32
    # scales, n / 16 L0 rows; on (1, 4) the rest (7 / 16) cold
    store = ShardedFeature(logical_mesh(1, 4), device_cache_size=4 * n + (n // 8) * MULTI_F,
                           csr_topo=topo, replicate_budget=(n // 16) * MULTI_F,
                           dtype="int8").from_cpu_tensor(x)
    before = {"psum": store.gather(ids), "routed": store.gather(ids, routed=True)}
    tiers, out = {}, {}
    for fsize in ELASTIC_MESHES:
        if fsize != 4:
            t0 = time.perf_counter()
            store.replan(logical_mesh(1, fsize))
            out[f"replan_s_to_{fsize}"] = time.perf_counter() - t0
        tiers[fsize] = [store.rep_rows, store.hot_rows, n - store.rep_rows - store.hot_rows]
        for name, kw in (("psum", {}), ("routed", {"routed": True})):
            reset_launches()
            got = store.gather(ids, **kw)
            sync()
            # L0 and the cold rows, each shard's codes by gather_rows and
            # one dequantising launch after their sum or the exchange
            launches = {"tiered_gather_dequant": 3, "gather_rows": fsize}
            step9i(f"(e) int8 (1, {fsize}) {name}: bitwise the (1, 4) lookup, "
                   f"K2 launches {launches}")
            check(equal(got, before[name]), f"int8 replan (1, {fsize}) {name} bitwise")
            expect_launches(read_launches(), launches, f"int8 replan (1, {fsize}) {name}")
    step9i("(e) the int8 tiers follow the budgets: L0 kept, L1 shrinks with F")
    check(tiers[4][0] == tiers[2][0] == tiers[1][0]
          and tiers[4][1] == 2 * tiers[2][1] == 4 * tiers[1][1],
          f"int8 replan tiers {tiers}")
    store.delete()
    out["tiers"] = {f"(1, {f})": t for f, t in tiers.items()}
    log(f"int8 replan: tiers {out['tiers']} [{card}]")
    return out


def elastic_phase(card):
    """Phase 9i (see the module docstring). Returns ``(launches by mesh,
    result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import FaultPlan, GraphSageSampler, Preemption

    t0 = time.time()
    topo, x, labels = multichip_setup()
    n = topo.node_count
    train_idx = np.random.default_rng(3).permutation(n)[
        :ELASTIC_STEPS * ELASTIC_WORKERS * MULTI_BATCH]
    shutil.rmtree(SCRATCH, ignore_errors=True)
    result, launches, per_mesh = {}, {}, {}
    try:
        with deterministic_algorithms():
            # (a) the uninterrupted epoch on (1, 4), as the main path runs
            a = elastic_trainer(topo, x, 4, os.path.join(SCRATCH, "a"))
            seed_mat = a.pack_epoch(train_idx, seed=0)
            check(seed_mat.shape[0] == ELASTIC_STEPS, f"epoch of {seed_mat.shape[0]} steps")
            reset_launches()
            ref, secs = timed_epoch(a, seed_mat, labels, 7)
            launches["(1, 4)"] = read_launches()
            step9i(f"(a) (1, 4): {ELASTIC_STEPS} finite losses, exact K1 select and K2 "
                   "gather_rows launches")
            check(bool(torch.isfinite(ref).all()), "elastic (1, 4) losses finite")
            expect_launches(launches["(1, 4)"], elastic_launches(4, ELASTIC_STEPS),
                            "elastic epoch (1, 4)")
            ref = ref.cpu().numpy()
            final = {k: v.clone() for k, v in a.model.state_dict().items()}
            per_mesh["(1, 4)"] = {"steps_per_s": ELASTIC_STEPS / secs, "epoch_s": secs,
                                  "blocks_per_device": a.blocks_per_device}
            a.checkpointer.close()
            del a
            # (b) the same epoch preempted after its first chunk
            b = elastic_trainer(topo, x, 4, os.path.join(SCRATCH, "b"),
                                plan=FaultPlan(preempt_at_step=ELASTIC_PREEMPT))
            step9i(f"(b) a FaultPlan preempts the (1, 4) epoch at step {ELASTIC_PREEMPT}")
            try:
                b.epoch_scan(seed_mat, labels, 7)
                check(False, "the planned preemption raised")
            except Preemption:
                pass
            first = b.checkpointer.all_steps()[0]
            resumes = {}
            for fsize, pin in ((2, None), (1, first)):
                mesh = logical_mesh(1, fsize)
                sync()
                t1 = time.perf_counter()
                _, _, key, step, epoch = b.resume(mesh=mesh, checkpoint_step=pin)
                sync()
                resume_s = time.perf_counter() - t1
                label = f"(1, {fsize})"
                step9i(f"(c) resumed onto {label}: step {ELASTIC_EVERY}, "
                       f"{ELASTIC_WORKERS // fsize} blocks a slot, store and sampler "
                       "re-partitioned")
                check(step == ELASTIC_EVERY and b.blocks_per_device == ELASTIC_WORKERS // fsize
                      and b.feature.mesh is mesh and b.sampler.topo.num_shards == fsize,
                      f"elastic resume onto {label}")
                reset_launches()
                losses, secs = timed_epoch(b, seed_mat, labels, key, epoch=epoch,
                                           start_step=step)
                launches[label] = read_launches()
                step9i(f"(c) {label}: the remaining losses and the final parameters bitwise "
                       "the uninterrupted (1, 4) run's; exact launches")
                check(same_bits(losses.cpu().numpy(), ref[step:]),
                      f"elastic {label} losses bitwise the (1, 4) run's")
                check(same_params(b.model.state_dict(), final),
                      f"elastic {label} parameters bitwise the (1, 4) run's")
                expect_launches(launches[label], elastic_launches(fsize, ELASTIC_STEPS - step),
                                f"elastic epoch {label}")
                resumes[label] = resume_s
                per_mesh[label] = {"steps_per_s": (ELASTIC_STEPS - step) / secs,
                                   "epoch_s": secs, "resume_s": resume_s,
                                   "blocks_per_device": b.blocks_per_device,
                                   "tiers": [b.feature.rep_rows, b.feature.hot_rows,
                                             n - b.feature.rep_rows - b.feature.hot_rows]}
            b.checkpointer.close()
            del b
            # (d) the process-death flow: a trainer built afresh on (1, 2)
            fresh = elastic_trainer(topo, x, 2, os.path.join(SCRATCH, "b"))
            sync()
            t1 = time.perf_counter()
            _, _, key, step, epoch = fresh.resume(mesh=fresh.mesh, checkpoint_step=first)
            resume_s = time.perf_counter() - t1
            losses, secs = timed_epoch(fresh, seed_mat, labels, key, epoch=epoch,
                                       start_step=step)
            step9i("(d) a fresh (1, 2) trainer resuming the (1, 4) checkpoint: bitwise the "
                   "uninterrupted run")
            check(step == ELASTIC_EVERY and same_bits(losses.cpu().numpy(), ref[step:])
                  and same_params(fresh.model.state_dict(), final),
                  "a fresh (1, 2) trainer resumes the (1, 4) run bitwise")
            per_mesh["(1, 2), fresh trainer"] = {"steps_per_s": (ELASTIC_STEPS - step) / secs,
                                                 "epoch_s": secs, "resume_s": resume_s}
            fresh.checkpointer.close()
            del fresh
            # (e) the int8 store's replan
            ids = GraphSageSampler(topo, MULTI_FANOUT, seed=0, device="cuda").sample(
                train_idx[:MULTI_BATCH]).n_id
            result["int8_replan"] = elastic_int8_replan(topo, x, ids, card)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    result.update({"meshes": per_mesh, "losses": ref.tolist(),
                   "config": "examples/train_multichip.py defaults (phase 9f (b)): 100,000 "
                             "nodes, degree 25, F = 128 f32, 47 classes, GraphSAGE 256 x 3, "
                             "[15, 10, 5] x 256, Adam 1e-3; a three-tier store of 8M L1 and "
                             "4M L0 per device, a topology-sharded sampler, "
                             f"logical_workers={ELASTIC_WORKERS}, a {ELASTIC_STEPS}-step "
                             "epoch under deterministic kernels",
                   "seconds": time.time() - t0})
    log(f"elastic phase {result['seconds']:.1f}s: "
        + "; ".join(f"{k} {v['steps_per_s']:.2f} steps/s"
                    + (f", resume {v['resume_s']:.3f} s" if "resume_s" in v else "")
                    for k, v in per_mesh.items()) + f" [{card}]")
    return launches, result


# -- phase 9j: the out-of-core epoch ----------------------------------------------

# benchmarks/ooc_drill.py's defaults
OOC_BUDGET = 64 * 2**20  # address-space headroom; the rows are >= 4x it
OOC_F, OOC_DEG, OOC_HOT, OOC_BATCH = 128, 10, 0.1, 128
OOC_STEPS, OOC_EPOCHS, OOC_WINDOW, OOC_CACHE = 8, 2, 1024, 8
OOC_NODES = -(-int(4.2 * OOC_BUDGET) // (OOC_F * 4))  # 550,503
OOC_PROMOTE_ROWS = 4096  # the host cold cache maybe_promote fills


def step9j(what: str) -> None:
    """Name a phase 9j check on stderr before it runs."""
    log(f"phase 9j check: {what}")


def vm_rss() -> int:
    """This process's resident bytes (``VmRSS`` of ``/proc/self/status``)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("VmRSS not found in /proc/self/status")


def ooc_trainer(topo, feature):
    """The drill's ``DataParallelTrainer`` on the logical ``(2, 1)`` mesh:
    GraphSAGE 16 x 2 over 4 classes, SGD 1e-2, [5, 5] x 128."""
    import torch

    from quiver_tpu_torch import DataParallelTrainer, GraphSageSampler, GraphSAGE

    sampler = GraphSageSampler(topo, [5, 5], seed=3, seed_capacity=OOC_BATCH, device="cuda")
    model = GraphSAGE(OOC_F, 16, 4, num_layers=2).to("cuda")
    trainer = DataParallelTrainer(logical_mesh(2, 1), sampler, feature, model,
                                  torch.optim.SGD(model.parameters(), lr=1e-2),
                                  local_batch=OOC_BATCH)
    trainer.init(torch.Generator().manual_seed(0))
    return trainer


def ooc_epochs(trainer, idx, labels, epochs) -> tuple[list, list]:
    """``train_epoch`` for each of ``epochs`` (its dropout generator and
    permutation seeded by the epoch), through the Prefetcher at depth 2:
    ``(losses, seconds)``."""
    import numpy as np
    import torch

    losses, secs = [], []
    for epoch in epochs:
        sync()
        t0 = time.perf_counter()
        loss, steps = trainer.train_epoch(idx, labels, torch.Generator().manual_seed(epoch),
                                          rng=np.random.default_rng(epoch))
        sync()
        secs.append(time.perf_counter() - t0)
        check(steps == OOC_STEPS, f"out-of-core epoch delivered {steps}/{OOC_STEPS} steps")
        losses.append(loss)
    return losses, secs


def ooc_phase(card):
    """Phase 9j (see the module docstring). Returns ``(launches, K2 check
    rows, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import CacheController, CSRTopo, Feature, FreqSketch, MmapFeatureStore
    from quiver_tpu_torch.obs import MetricsRegistry, StepTimeline
    from quiver_tpu_torch.ops.kernels.gather import tiered_gather, tiered_gather_plain

    t0 = time.time()
    rng = np.random.default_rng(0)
    n, f = OOC_NODES, OOC_F
    topo = CSRTopo(edge_index=rng.integers(0, n, size=(2, OOC_DEG * n)).astype(np.int64))
    feat = rng.normal(size=(n, f)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to("cuda")
    hot_budget = int(OOC_HOT * n) * f * 4
    idx = rng.integers(0, n, OOC_STEPS * 2 * OOC_BATCH)
    graph_bytes = n * f * 4 + topo.indices.nbytes + topo.indptr.nbytes
    step9j(f"the graph's {graph_bytes / 1e6:.1f} MB are at least 4x the "
           f"{OOC_BUDGET / 2**20:.0f} MiB budget")
    check(graph_bytes >= 4 * OOC_BUDGET, f"graph {graph_bytes} B against budget {OOC_BUDGET} B")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    topo_dir, rows_dir = os.path.join(SCRATCH, "topo"), os.path.join(SCRATCH, "rows")
    result = {}
    try:
        t1 = time.perf_counter()
        topo.save(topo_dir, format="raw")
        MmapFeatureStore.write(rows_dir, feat, device_cache_size=hot_budget, csr_topo=topo)
        result["write_s"] = time.perf_counter() - t1
        epochs = list(range(2, 2 + OOC_EPOCHS))
        with deterministic_algorithms():
            # the in-RAM run: the same rows in a Feature (10% on the card, the
            # rest pinned)
            ram = Feature(device_cache_size=hot_budget, csr_topo=topo,
                          device="cuda").from_cpu_tensor(feat)
            tr = ooc_trainer(topo, ram)
            ooc_epochs(tr, idx, labels, [1])
            ram_losses, ram_s = ooc_epochs(tr, idx, labels, epochs)
            del tr, feat
            # the disk run: the topology mmap'd, the rows read with pread
            mtopo = CSRTopo.load(topo_dir, mmap=True)
            step9j("the topology loaded memory-mapped, its max degree from the manifest")
            check(isinstance(mtopo.indices, np.memmap) and mtopo._max_degree == topo.max_degree,
                  "CSRTopo.load(mmap=True)")
            metrics, timeline = MetricsRegistry(), StepTimeline()
            store = MmapFeatureStore(rows_dir, access="pread", window_rows=OOC_WINDOW,
                                     cache_windows=OOC_CACHE, host_cache_rows=OOC_PROMOTE_ROWS,
                                     metrics=metrics, timeline=timeline, device="cuda")
            step9j("the store's hot rows are the in-RAM store's, and its lookup is K2")
            check(store.hot_rows == ram.hot_rows and equal(store.hot, ram.hot)
                  and store.kernel == "pallas", "MmapFeatureStore hot tier")
            tr = ooc_trainer(mtopo, store)
            warm_losses, warm_s = ooc_epochs(tr, idx, labels, [1])
            rss0 = vm_rss()
            reset_launches()
            disk_losses, disk_s = ooc_epochs(tr, idx, labels, epochs)
            got = read_launches()
            rss1 = vm_rss()
            step9j("the measured epochs: exactly 2 uniform_hop and 2 tiered_gather launches a "
                   "step (one per worker's lookup), nothing else")
            expect_launches(got, {"uniform_hop": 2 * 2 * OOC_STEPS * OOC_EPOCHS,
                                  "tiered_gather": 2 * OOC_STEPS * OOC_EPOCHS},
                            "out-of-core epochs")
            step9j("the losses bitwise the in-RAM Feature's, epoch by epoch")
            check(disk_losses == ram_losses, f"out-of-core losses {disk_losses} against "
                  f"the in-RAM {ram_losses}")
            hits = int(store.stager.readahead_hits_total)
            step9j("readahead_hits > 0")
            check(hits > 0, "the stager's windowed reads amortised")
            step9j(f"VmRSS grew {(rss1 - rss0) / 2**20:.2f} MiB over the measured epochs, "
                   f"under the {OOC_BUDGET / 2**20:.0f} MiB budget")
            check(rss1 - rss0 < OOC_BUDGET, f"VmRSS growth {rss1 - rss0} B")
        # one lookup against K2's plain version on its own launch inputs, and
        # the lookup timed in turns with the in-RAM store's
        smp = tr.sampler
        n_id = smp.sample(idx[:OOC_BATCH]).n_id
        reset_launches()
        got_rows = store[n_id]
        staged = store._staging.rows[:n_id.numel()]
        t = torch.from_numpy(store._translate(n_id.cpu().numpy()).astype(np.int32))
        k_ids, _, _ = store._launch_args(t.to(n_id.device), staged)
        plain = tiered_gather_plain(k_ids, None, store.hot_rows, store.hot, staged)
        sync()
        step9j("one lookup: one tiered_gather launch over the pinned staged block, "
               "bitwise its plain version and the in-RAM lookup")
        check(staged.is_pinned() and read_launches()["tiered_gather"] == 1
              and equal(got_rows, plain) and equal(got_rows, ram[n_id]),
              "the out-of-core lookup's K2 launch")
        rows = [{"store": f"out-of-core store (pread, staged block over UVA): "
                          f"{n_id.numel()} ids", "match": True,
                 "max_abs_err": float((got_rows - plain).abs().max())}]
        t_look = in_turns(lambda: store[n_id], lambda: ram[n_id], 5, 3)
        cold = int(((store.feature_order[n_id.clamp(min=0).long()] >= store.hot_rows)
                    & (n_id >= 0)).sum())
        # the controller promotes the measured-hottest disk rows
        ctl = CacheController(sketch=FreqSketch(n)).attach(store)
        ctl.observe_ids(np.concatenate([idx] * 4))
        before_hits = store.cold_cache_hits_total
        ctl.end_epoch(feature=store)
        after = store[n_id]
        step9j("maybe_promote restages measured-hot disk rows; the lookups stay bitwise")
        check(ctl.stats()["ooc_promotions"] == 1 and 0 < store.staged_ids.size
              <= OOC_PROMOTE_ROWS and equal(after, got_rows), "maybe_promote")
        wait = timeline.summary().get("ooc.stage_wait")
        reads = timeline.summary().get("ooc.read")
        result.update({
            "nodes": n, "feature_dim": f, "graph_bytes": int(graph_bytes),
            "budget_bytes": OOC_BUDGET, "graph_over_budget": graph_bytes / OOC_BUDGET,
            "hot_rows": store.hot_rows, "losses": disk_losses, "in_ram_losses": ram_losses,
            "steps_per_s": [OOC_STEPS / s for s in disk_s],
            "in_ram_steps_per_s": [OOC_STEPS / s for s in ram_s],
            "warm_epoch_s": warm_s[0], "rss_growth_bytes": rss1 - rss0,
            "readahead_hits": hits, "page_reads": int(store.stager.page_reads_total),
            "stage_wait_s": 0.0 if wait is None else wait.total,
            "stage_wait_count": 0 if wait is None else wait.count,
            "window_read_ms_mean": None if reads is None else reads.mean * 1e3,
            "lookup": {"ids": int(n_id.numel()), "cold_lanes": cold,
                       "ms": t_look["ms"], "ms_turns": t_look["ms_turns"],
                       "in_ram_ms": t_look["yard_ms"], "in_ram_turns": t_look["yard_turns"],
                       "ratio": t_look["ratio"]},
            "promoted_rows": int(store.staged_ids.size),
            "cold_cache_hits": store.cold_cache_hits_total - before_hits,
            "config": "benchmarks/ooc_drill.py defaults: 550,503 nodes x 128 f32 (4.2x the "
                      "64 MiB budget), degree 10, 10% hot, [5, 5] x 128 on a logical (2, 1) "
                      "mesh, 8 steps x 2 measured epochs, pread windows of 1,024 rows, 8 "
                      "cached, the topology mmap'd; under deterministic kernels"})
        store.close()
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    result["seconds"] = time.time() - t0
    log(f"out-of-core phase {result['seconds']:.1f}s: {result['steps_per_s']} steps/s "
        f"(in RAM {result['in_ram_steps_per_s']}), lookup {t_look['ms']:.3f} ms against "
        f"{t_look['yard_ms']:.3f} in RAM, {hits} readahead hits, VmRSS +"
        f"{(rss1 - rss0) / 2**20:.2f} MiB [{card}]")
    return got, rows, result


# -- phase 9k: transactional streaming mutation and the native CSR build -----------

STREAM_DELTA = (4096, 1024, 512)  # inserts, deletes of live edges, row updates
STREAM_STEPS = 8  # the differential's epochs
STREAM_KEY = 29  # the mutate drill's sample key
PRODUCTS_DELTA = (1024, 256)  # the products-shaped commit: inserts, deletes


def step9k(what: str) -> None:
    """Name a phase 9k check on stderr before it runs."""
    log(f"phase 9k check: {what}")


def live_deletes(topo, count: int, rng):
    """``count`` live edges of ``topo`` as a ``(2, count)`` COO: the pairs
    at distinct CSR slots drawn at random."""
    import numpy as np

    slots = np.sort(rng.choice(topo.edge_count, count, replace=False))
    rows = np.searchsorted(topo.indptr.astype(np.int64), slots, side="right") - 1
    return np.stack([rows, topo.indices[slots].astype(np.int64)])


def final_coo(topo, deletes, inserts):
    """The COO a rebuild after a commit of ``inserts`` and ``deletes`` of
    live edges starts from: ``topo``'s edges in slot order, less the
    earliest remaining slot of each deleted pair, then the inserts (what
    ``merge_csr`` keeps, in a stable build's order)."""
    import numpy as np

    indptr = topo.indptr.astype(np.int64)
    keep = np.ones(topo.edge_count, bool)
    for s, d in deletes.T.tolist():
        lo, hi = int(indptr[s]), int(indptr[s + 1])
        keep[lo + np.flatnonzero((topo.indices[lo:hi] == d) & keep[lo:hi])[0]] = False
    rows = np.repeat(np.arange(topo.node_count, dtype=np.int64), np.diff(indptr))
    return np.concatenate([np.stack([rows[keep], topo.indices[keep].astype(np.int64)]),
                           inserts.astype(np.int64)], axis=1)


def stream_delta(topo, x, rng, inserts: int, deletes: int, updates: int, tiers=None):
    """A well-formed delta of ``inserts`` random edges, ``deletes`` live
    edges and ``updates`` new rows (the first three ids one from each of
    the ``tiers`` store's L0, L1 and cold tiers when given)."""
    import numpy as np

    from quiver_tpu_torch import DeltaBatch

    n = topo.node_count
    ids = rng.choice(n, updates, replace=False)
    if tiers is not None:
        order = tiers.feature_order
        order = np.arange(n) if order is None else np.asarray(order.cpu()).astype(np.int64)
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        firsts = inv[[0, tiers.rep_rows, tiers.rep_rows + tiers.hot_rows]]
        ids = np.concatenate([firsts, ids[~np.isin(ids, firsts)]])[:updates]
    return DeltaBatch(edge_inserts=rng.integers(0, n, size=(2, inserts)),
                      edge_deletes=live_deletes(topo, deletes, rng), update_ids=ids,
                      update_rows=rng.normal(size=(updates, x.shape[1])).astype(np.float32),
                      tag="drill")


def same_sample(a, b) -> bool:
    return equal(a.n_id, b.n_id) and all(equal(p.edge_index, q.edge_index)
                                         for p, q in zip(a.adjs, b.adjs))


def sampled_edges_real(per_worker, keys, n: int) -> int:
    """Every valid lane of every worker's sample is an edge of the CSR
    whose sorted keys are ``keys``; returns the edges checked."""
    import torch

    edges = 0
    for out in per_worker:
        n_id = out.n_id.to(torch.int64)
        for adj in out.adjs:
            src, dst = adj.edge_index[0].to(torch.int64), adj.edge_index[1].to(torch.int64)
            ok = (src >= 0) & (dst >= 0)
            check(real_edges(keys, n, n_id[dst[ok]], n_id[src[ok]]),
                  "every sampled edge lies in the merged CSR")
            edges += int(ok.sum())
    return edges


def mutate_drill(card):
    """(a) ``benchmarks/chaos.py``'s ``mutate`` drill at ``train_multichip``'s
    width; returns ``(launches, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import (CommitAborted, DeltaBatch, GraphSageSampler,
                                  ShardedFeature, StreamingGraph, VersionMismatchError)
    from quiver_tpu_torch.obs.registry import DELTAS_QUARANTINED

    topo, x, _ = multichip_setup()
    n = topo.node_count
    rng = np.random.default_rng(31)
    mesh = logical_mesh(1, 4)
    store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0).from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, topo_sharding="mesh", mesh=mesh)
    seeds = rng.permutation(n)[:4 * MULTI_BATCH]
    oracle = sampler.sample(seeds, key=STREAM_KEY)
    sg = StreamingGraph(topo, feature=store)
    nan_rows = np.ones((1, MULTI_F), np.float32)
    nan_rows[0, 7] = np.nan
    bad = [DeltaBatch(edge_inserts=np.array([[0], [n]]), tag="out of range"),
           DeltaBatch(update_ids=np.array([1]), update_rows=nan_rows, tag="NaN row"),
           DeltaBatch(edge_inserts=np.array([[1, 1], [2, 2]]), tag="duplicate insert")]
    step9k("(a) three malformed batches (out of range, NaN row, duplicate insert) "
           "quarantined, the counter reads 3, nothing staged")
    check(not any(sg.ingest(b) for b in bad) and len(sg.quarantined) == 3
          and int(np.asarray(sg.metrics.value(DELTAS_QUARANTINED))) == 3 and not sg.staged,
          f"malformed batches quarantined: {[q.reason[:60] for q in sg.quarantined]}")
    ins, dels, upd = STREAM_DELTA
    delta = stream_delta(topo, x, rng, ins, dels, upd, tiers=store)
    for stage in ("merge", "verify", "features"):
        check(sg.ingest(delta), f"the drill's delta is admitted ({stage})")
        try:
            sg.commit(inject_failure=stage)
            check(False, f"the injected {stage} failure raised")
        except CommitAborted:
            pass
        step9k(f"(a) an injected failure at {stage}: both versions 0, the sample bitwise "
               "the pre-commit oracle")
        check(topo.version == 0 and store.version == 0
              and same_sample(sampler.sample(seeds, key=STREAM_KEY), oracle),
              f"rollback at {stage}")
    sync()
    t0 = time.perf_counter()
    admitted = sg.ingest(delta)
    ingest_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    res = sg.commit()
    sync()
    commit_ms = 1e3 * (time.perf_counter() - t0)
    step9k(f"(a) the commit of {ins} inserts, {dels} deletes and {upd} row updates publishes "
           "version 1 on the topology and the store")
    check(admitted and res.version == 1 and topo.version == 1 and store.version == 1
          and (res.edges_inserted, res.edges_deleted, res.rows_updated) == (ins, dels, upd)
          and res.edge_count == topo.edge_count, f"commit {res}")
    step9k("(a) the stale sampler raises VersionMismatchError")
    try:
        sampler.sample(seeds, key=STREAM_KEY)
        check(False, "the stale sampler raised")
    except VersionMismatchError:
        pass
    t0 = time.perf_counter()
    sampler.refresh_topology()
    sync()
    refresh_ms = 1e3 * (time.perf_counter() - t0)
    reset_launches()
    per_worker = sampler.sample_per_worker(seeds, key=STREAM_KEY)
    sync()
    launches = {"sample": read_launches()}
    step9k("(a) after refresh_topology(): every sampled edge is an edge of the merged CSR, "
           f"{4 * len(MULTI_FANOUT)} owner-side select launches")
    expect_launches(launches["sample"], {"select": 4 * len(MULTI_FANOUT)},
                    "refreshed topology-sharded sample")
    edges = sampled_edges_real(per_worker, edge_keys(topo.indptr, topo.indices, n), n)
    ids = torch.from_numpy(delta.update_ids).to("cuda")
    want = torch.from_numpy(delta.update_rows)
    order = np.asarray(store.feature_order.cpu()).astype(np.int64)[delta.update_ids]
    tiers = np.bincount(np.searchsorted([store.rep_rows, store.rep_rows + store.hot_rows],
                                        order, side="right"), minlength=3)
    for name, kw in (("psum", {}), ("routed", {"routed": True})):
        reset_launches()
        got = store.gather(ids, **kw)
        sync()
        launches[f"gather_{name}"] = read_launches()
        step9k(f"(a) store.gather(update_ids) ({name}) bitwise the new rows in every tier "
               f"({tiers.tolist()} ids in L0 / L1 / cold)")
        check(bool((tiers > 0).all()) and equal(got.cpu(), want), f"updated rows ({name})")
    result = {"ingest_ms": ingest_ms, "commit_ms": commit_ms, "refresh_topology_ms": refresh_ms,
              "quarantined_at_ingest": len(bad), "rollbacks": 3, "sampled_edges": edges,
              "update_tiers": tiers.tolist(), "edges": topo.edge_count,
              "commit": res.__dict__}
    store.delete()
    log(f"mutate drill: ingest {ingest_ms:.2f} ms, commit {commit_ms:.2f} ms, "
        f"refresh_topology {refresh_ms:.2f} ms [{card}]")
    return launches, result


def stream_launches(steps: int) -> dict:
    """Exact K1 and K2 launches of ``steps`` steps of the ``(1, 4)``
    trainer under ``"all"``: one owner-side ``select`` per owner per hop;
    one ``gather_rows`` for L0, one per shard and one for the cold rows."""
    return {"select": steps * 4 * len(MULTI_FANOUT), "gather_rows": steps * (4 + 2)}


def stream_trainer(topo, x, state=None):
    """The differential's trainer on the logical ``(1, 4)`` mesh at
    ``train_multichip``'s width: a topology-sharded sampler, an f32
    three-tier store in identity row order (``csr_topo=None``: the
    differential compares graph content, not placement), GraphSAGE 256 x
    3, Adam 1e-3, ``seed_sharding="all"``; ``init(0)``, then ``state``
    (model and optimizer state dicts) when given."""
    import copy

    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE, ShardedFeature

    mesh = logical_mesh(1, 4)
    store = ShardedFeature(mesh, device_cache_size=MULTI_L1,
                           replicate_budget=MULTI_L0).from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, topo_sharding="mesh", mesh=mesh)
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES, num_layers=len(MULTI_FANOUT))
    trainer = DistributedTrainer(mesh, sampler, store, model.to("cuda"),
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding="all")
    trainer.init(0)
    if state is not None:
        trainer.model.load_state_dict(state[0])
        # the optimizer adopts the dict's tensors and steps them in place
        trainer.optimizer.load_state_dict(copy.deepcopy(state[1]))
    return trainer, store


def stream_epoch(trainer, seed_mat, labels, key: int, what: str):
    """One ``epoch_scan`` with its launches checked exactly:
    ``(losses on the host, seconds, launches)``."""
    reset_launches()
    losses, secs = timed_epoch(trainer, seed_mat, labels, key)
    launches = read_launches()
    expect_launches(launches, stream_launches(seed_mat.shape[0]), what)
    return losses.cpu().numpy(), secs, launches


def stream_differential(card):
    """(b) the epoch differential and its crash twin; returns ``(launches,
    result)``."""
    import copy

    import numpy as np

    from quiver_tpu_torch import (CSRTopo, CommitAborted, StreamingGraph,
                                  VersionMismatchError)

    topo, x, labels = multichip_setup()
    n = topo.node_count
    rng = np.random.default_rng(37)
    g0 = (topo.indptr.copy(), topo.indices.copy())
    train_idx = rng.permutation(n)[:STREAM_STEPS * 4 * MULTI_BATCH]
    ins, dels, upd = STREAM_DELTA
    delta = stream_delta(topo, x, rng, ins, dels, upd)
    final = final_coo(topo, delta.edge_deletes, delta.edge_inserts)
    x_final = x.copy()
    x_final[delta.update_ids] = delta.update_rows
    out, launches = {}, {}
    with deterministic_algorithms():
        inc, store = stream_trainer(topo, x)
        seed_mat = inc.pack_epoch(train_idx, seed=0)
        check(seed_mat.shape[0] == STREAM_STEPS, f"epoch of {seed_mat.shape[0]} steps")
        step9k(f"(b) epoch 0 ({STREAM_STEPS} steps): finite losses, exact select and "
               "gather_rows launches")
        l0, s0, launches["epoch_0"] = stream_epoch(inc, seed_mat, labels, 7, "stream epoch 0")
        check(bool(np.isfinite(l0).all()), "epoch 0 losses finite")
        state = ({k: v.clone() for k, v in inc.model.state_dict().items()},
                 copy.deepcopy(inc.optimizer.state_dict()))
        sg = StreamingGraph(topo, feature=store)
        check(sg.ingest(delta), "the differential's delta is admitted")
        res = sg.commit()
        step9k("(b) after the commit step() raises until refresh()")
        try:
            inc.step(train_idx[:inc.global_batch], labels, 3)
            check(False, "the stale trainer raised")
        except VersionMismatchError:
            pass
        t0 = time.perf_counter()
        inc.refresh()
        sync()
        out["refresh_ms"] = 1e3 * (time.perf_counter() - t0)
        step9k("(b) epoch 1 on the mutated state: exact launches")
        l1, s1, launches["epoch_1"] = stream_epoch(inc, seed_mat, labels, 21, "stream epoch 1")
        reb_topo = CSRTopo(edge_index=final)
        step9k("(b) the merged CSR bitwise the rebuild's (dtypes included)")
        check(all(getattr(topo, a).dtype == getattr(reb_topo, a).dtype
                  and np.array_equal(getattr(topo, a), getattr(reb_topo, a))
                  for a in ("indptr", "indices"))
              and topo.max_degree == reb_topo.max_degree and topo.eid is None,
              "merged CSR == rebuild")
        reb, _ = stream_trainer(reb_topo, x_final, state)
        lr, sr, launches["rebuild_epoch_1"] = stream_epoch(reb, seed_mat, labels, 21,
                                                            "rebuild epoch 1")
        step9k("(b) epoch 1: the samples, losses and parameters bitwise the rebuilt trainer's")
        seeds = train_idx[:inc.global_batch]
        check(same_sample(inc.sampler.sample(seeds, key=33), reb.sampler.sample(seeds, key=33)),
              "epoch-1 samples bitwise")
        check(same_bits(l1, lr) and same_params(inc.model.state_dict(), reb.model.state_dict()),
              "incremental epoch 1 bitwise the rebuild's")
        del inc, reb, store
        # the crash twin: a verify failure between the epochs changes nothing
        crash, cstore = stream_trainer(CSRTopo(indptr=g0[0], indices=g0[1]), x)
        lc0, _, _ = stream_epoch(crash, seed_mat, labels, 7, "crash twin epoch 0")
        csg = StreamingGraph(crash.sampler.csr_topo, feature=cstore)
        check(csg.ingest(delta), "the crash twin's delta is admitted")
        try:
            csg.commit(inject_failure="verify")
            check(False, "the injected verify failure raised")
        except CommitAborted:
            pass
        lc1, _, _ = stream_epoch(crash, seed_mat, labels, 21, "crash twin epoch 1")
        none, _ = stream_trainer(CSRTopo(indptr=g0[0], indices=g0[1]), x, state)
        ln1, _, _ = stream_epoch(none, seed_mat, labels, 21, "uncrashed epoch 1")
        step9k("(b) the crash twin: versions 0, no refresh, both epochs bitwise the "
               "uncrashed run")
        check(crash.sampler.csr_topo.version == 0 and cstore.version == 0
              and same_bits(lc0, l0) and same_bits(lc1, ln1)
              and same_params(crash.model.state_dict(), none.model.state_dict()),
              "a crashed commit leaves the run bitwise")
    out.update({"steps_per_s": {"epoch_0": STREAM_STEPS / s0, "epoch_1": STREAM_STEPS / s1,
                                "rebuild_epoch_1": STREAM_STEPS / sr},
                "losses_epoch_1": l1.tolist(), "commit": res.__dict__})
    log(f"stream differential: epoch 0 {STREAM_STEPS / s0:.2f}, epoch 1 "
        f"{STREAM_STEPS / s1:.2f}, rebuilt {STREAM_STEPS / sr:.2f} steps/s, refresh "
        f"{out['refresh_ms']:.2f} ms [{card}]")
    return launches, out


def native_builds(card):
    """(c) the native CSR build at the products-shaped graph, one
    commit at that scale, and bench_rgcn's typed graph."""
    import numpy as np

    from quiver_tpu_torch import CSRTopo, DeltaBatch, HeteroCSRTopo, StreamingGraph, native
    from quiver_tpu_torch.utils.graphgen import generate_pareto_graph

    step9k("(c) the native host library builds (g++ -O3 -fopenmp) and loads")
    check(native.available, "native.available on the card machine")
    ei = generate_pareto_graph(PRODUCTS_NODES, PRODUCTS_AVG_DEG, seed=0)
    seconds, topos = {"native": [], "numpy": []}, {}
    for _ in range(2):
        for mode in ("native", "numpy"):
            topos.pop(mode, None)
            t0 = time.perf_counter()
            topos[mode] = CSRTopo(edge_index=ei, use_native=mode == "native")
            seconds[mode].append(time.perf_counter() - t0)
    a, b = topos["native"], topos.pop("numpy")
    step9k(f"(c) CSRTopo at {a.edge_count:,} edges: the native build bitwise the numpy "
           "build, dtypes included")
    check(all(getattr(a, k).dtype == getattr(b, k).dtype
              and np.array_equal(getattr(a, k), getattr(b, k))
              for k in ("indptr", "indices", "eid")), "native CSR == numpy CSR")
    del b, ei
    rng = np.random.default_rng(41)
    ins = rng.integers(0, a.node_count, size=(2, PRODUCTS_DELTA[0]))
    dele = live_deletes(a, PRODUCTS_DELTA[1], rng)
    final = final_coo(a, dele, ins)
    sg = StreamingGraph(a)
    t0 = time.perf_counter()
    admitted = sg.ingest(DeltaBatch(edge_inserts=ins, edge_deletes=dele))
    ingest_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    res = sg.commit()
    commit_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    reb = CSRTopo(edge_index=final, use_native=True)
    rebuild_s = time.perf_counter() - t0
    step9k(f"(c) a commit of {PRODUCTS_DELTA[0]} inserts and {PRODUCTS_DELTA[1]} deletes: "
           "the merged CSR bitwise the native rebuild of the final COO")
    check(admitted and res.version == 1
          and all(getattr(a, k).dtype == getattr(reb, k).dtype
                  and np.array_equal(getattr(a, k), getattr(reb, k))
                  for k in ("indptr", "indices")), "products commit == rebuild")
    del a, reb, final
    num_nodes, edges = mag_edges(np.random.default_rng(0))
    hetero = {}
    for mode in ("native", "numpy"):
        t0 = time.perf_counter()
        hetero[mode] = HeteroCSRTopo(num_nodes, edges, use_native=mode == "native")
        seconds[f"hetero_{mode}"] = time.perf_counter() - t0
    step9k("(c) bench_rgcn's HeteroCSRTopo: every relation native bitwise numpy")
    check(all(getattr(hetero["native"].relations[et], k).dtype
              == getattr(hetero["numpy"].relations[et], k).dtype
              and np.array_equal(getattr(hetero["native"].relations[et], k),
                                 getattr(hetero["numpy"].relations[et], k))
              for et in edges for k in ("indptr", "indices", "eid")), "hetero native == numpy")
    out = {"threads": native.num_threads(), "build_s": seconds,
           "edges": res.edge_count, "ingest_ms": ingest_ms, "commit_ms": commit_ms,
           "rebuild_s": rebuild_s}
    log(f"native builds ({out['threads']} threads): CSR native {seconds['native']} s, numpy "
        f"{seconds['numpy']} s; commit at {res.edge_count:,} edges: ingest {ingest_ms:.2f} ms, "
        f"commit {commit_ms:.1f} ms, native rebuild {rebuild_s:.2f} s [{card}]")
    return out


def stream_phase(card):
    """Phase 9k (see the module docstring). Returns ``(launches, result)``."""
    t0 = time.time()
    launches_a, drill = mutate_drill(card)
    launches_b, diff = stream_differential(card)
    builds = native_builds(card)
    result = {"drill": drill, "differential": diff, "native": builds,
              "config": "examples/train_multichip.py's width (100,000 nodes, degree 25, "
                        "F = 128 f32, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3) on a "
                        "logical (1, 4) mesh, 8M L1 and 4M L0 per device; a delta of 4,096 "
                        "inserts, 1,024 deletes and 512 row updates; 8-step epochs under "
                        "deterministic kernels; the products-shaped graph "
                        "(generate_pareto_graph(2450000, 50.5, seed=0)) built natively and "
                        "with numpy, one commit of 1,024 inserts and 256 deletes on it",
              "seconds": time.time() - t0}
    return {**launches_a, **launches_b}, result


# -- phase 9m: the trainers over a world of processes (one rank over nccl) -------

WORLD_STEPS = 4  # checked steps of each trainer, under deterministic kernels
WORLD_TIMED = 20  # steps per turn; turns world, logical, logical, world
WORLD_DP_SEEDS = 4 * MULTI_BATCH  # the DataParallelTrainer epoch: 4 steps
WORLD_FLAVOURS = (("routed f32", "all", None), ("psum int8", "data", "int8"))
# K2 launches per step of a (1, 1) three-tier store: L0, the one shard and
# the cold rows (int8: the shard's codes by gather_rows, then one
# dequantising launch for L0, the summed codes and the cold rows)
WORLD_K2 = {None: {"gather_rows": 3}, "int8": {"gather_rows": 1, "tiered_gather_dequant": 3}}
TWO_RANKS_S = 60  # the 2-rank nccl attempt's deadline


def step9m(what: str) -> None:
    """Name a phase 9m check on stderr before it runs."""
    log(f"phase 9m check: {what}")


def world_trainer(topo, x, mesh, seed_sharding, dtype):
    """Phase 9f (b)'s trainer (the twin's width: GraphSAGE 256 x 3, Adam
    1e-3, [15, 10, 5] x 256, the worst-case caps) on ``mesh`` over a fresh
    three-tier store of 8M L1 and 4M L0 per device, f32 or int8, with the
    non-finite guard on; ``init(0)``."""
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE, ShardedFeature

    store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0, dtype=dtype,
                           kernel="pallas").from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, device="cuda", kernel="pallas")
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES,
                      num_layers=len(MULTI_FANOUT)).to("cuda")
    trainer = DistributedTrainer(mesh, sampler, store, model,
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding=seed_sharding,
                                 nonfinite_guard=True)
    trainer.init(0)
    return trainer


def world_steps(trainer, labels, steps: int, key0: int) -> list:
    """``steps`` steps on ``default_rng(key0)``'s seeds, keyed ``key0 + i``:
    each step's loss, tier hits and routed overflow, on the card."""
    import numpy as np

    rng = np.random.default_rng(key0)
    n = trainer.sampler.csr_topo.node_count
    out = []
    for i in range(steps):
        loss = trainer.step(rng.integers(0, n, trainer.global_batch), labels, key0 + i)
        out.append((loss, trainer.last_tier_hits.clone(),
                    trainer.last_routed_overflow.clone()))
    return out


def same_steps(a, b) -> bool:
    return len(a) == len(b) and all(equal(x, y) for sa, sb in zip(a, b)
                                    for x, y in zip(sa, sb))


def timed_turns(world_fn, logical_fn) -> dict:
    """Steps/s of the two forms, timed in turns (world, logical, logical,
    world), each turn ``WORLD_TIMED`` synchronised steps."""
    turns = {"world": [], "logical": []}
    for form, fn in (("world", world_fn), ("logical", logical_fn),
                     ("logical", logical_fn), ("world", world_fn)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        turns[form].append(WORLD_TIMED / (time.perf_counter() - t0))
    return {f"{form}_steps_per_s": sum(v) / len(v) for form, v in turns.items()} | {
        "turns_steps_per_s": turns}


def world_flavour(topo, x, labels, meshes, seed_sharding, dtype, card) -> tuple[dict, dict]:
    """One ``DistributedTrainer`` flavour on the world ``(1, 1)`` mesh and
    the logical one: ``WORLD_STEPS`` steps of each under deterministic
    kernels (losses, tier hits, overflow, guard counters and parameters
    bitwise; exact K1 and K2 launches, the world's equal to the logical
    form's; every collective on CUDA tensors), then steps/s in turns on the
    main path. Returns ``(the world run's launches, result)``."""
    import math

    from quiver_tpu_torch.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED
    from quiver_tpu_torch.parallel import world

    wmesh, lmesh = meshes
    what = f"{seed_sharding} over {'int8' if dtype else 'f32'}"
    runs, launches, params, guard = {}, {}, {}, {}
    with deterministic_algorithms():
        trainers = {"world": world_trainer(topo, x, wmesh, seed_sharding, dtype),
                    "logical": world_trainer(topo, x, lmesh, seed_sharding, dtype)}
        for form, trainer in trainers.items():
            reset_launches()
            world.reset_calls()
            runs[form] = world_steps(trainer, labels, WORLD_STEPS, 100)
            sync()
            launches[form] = read_launches()
            if form == "world":
                calls = dict(world.CALLS)
            params[form] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            guard[form] = [trainer.metrics.value(GUARD_SKIPPED),
                           trainer.metrics.value(GUARD_NONFINITE)]
    step9m(f"{what}: losses, tier hits, overflow, guard counters and parameters bitwise "
           "the logical (1, 1) mesh's (deterministic kernels)")
    check(same_steps(runs["world"], runs["logical"])
          and all(equal(params["world"][k], v) for k, v in params["logical"].items())
          and all(equal(a, b) for a, b in zip(guard["world"], guard["logical"])),
          f"world trainer ({what}) == the logical mesh's")
    want = {"uniform_hop": 3 * WORLD_STEPS,
            **{k: v * WORLD_STEPS for k, v in WORLD_K2[dtype].items()}}
    step9m(f"{what}: exactly 3 uniform_hop and {WORLD_K2[dtype]} K2 launches per step, "
           "in both forms")
    expect_launches(launches["world"], want, f"world trainer ({what})")
    check(launches["logical"] == launches["world"], f"world trainer ({what}): the logical "
          f"form launched {launches['logical']}")
    step9m(f"{what}: every collective ran on CUDA tensors")
    check(calls and all(dev == "cuda" for _, dev in calls),
          f"world trainer ({what}): collectives {calls}")
    per_step = {prim: n / WORLD_STEPS for (prim, _), n in calls.items()}
    timing = timed_turns(
        lambda: world_steps(trainers["world"], labels, WORLD_TIMED, 200),
        lambda: world_steps(trainers["logical"], labels, WORLD_TIMED, 200))
    losses = [float(v[0]) for v in runs["world"]]
    check(all(math.isfinite(v) for v in losses), f"world trainer ({what}): finite losses")
    r = {"seed_sharding": seed_sharding, "dtype": dtype or "float32",
         "split": [trainers["world"].feature.rep_rows, trainers["world"].feature.hot_rows],
         "losses": losses, "launches": launches["world"], "collectives_per_step": per_step,
         "collective_devices": sorted({dev for _, dev in calls}), **timing}
    log(f"world trainer ({what}): world {timing['world_steps_per_s']:.4g} steps/s, "
        f"logical {timing['logical_steps_per_s']:.4g} steps/s (in turns), collectives per "
        f"step {per_step} [{card}]")
    return launches["world"], r


def world_dp(topo, x, labels, meshes, card) -> tuple[dict, dict]:
    """``DataParallelTrainer`` on the world ``(1, 1)`` mesh and the
    logical one, over one replicated ``Feature`` (20% of the rows on the
    card): a 4-step epoch each under deterministic kernels, the mean loss
    and the parameters bitwise, exact launches."""
    import numpy as np
    import torch

    from quiver_tpu_torch import DataParallelTrainer, Feature, GraphSageSampler, GraphSAGE

    feature = Feature(device_cache_size=int(0.2 * topo.node_count) * MULTI_F * 4,
                      csr_topo=topo, device="cuda", kernel="pallas").from_cpu_tensor(x)
    out, launches, params = {}, {}, {}
    with deterministic_algorithms():
        for form, mesh in zip(("world", "logical"), meshes):
            sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, device="cuda",
                                       kernel="pallas")
            model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES,
                              num_layers=len(MULTI_FANOUT)).to("cuda")
            trainer = DataParallelTrainer(mesh, sampler, feature, model,
                                          torch.optim.Adam(model.parameters(), lr=1e-3),
                                          local_batch=MULTI_BATCH)
            trainer.init(torch.Generator().manual_seed(0))
            reset_launches()
            out[form] = trainer.train_epoch(np.arange(WORLD_DP_SEEDS), labels,
                                            torch.Generator().manual_seed(7), depth=0)
            sync()
            launches[form] = read_launches()
            params[form] = {k: v.clone() for k, v in model.state_dict().items()}
    steps = out["world"][1]
    step9m("DataParallelTrainer: the epoch's mean loss and parameters bitwise the logical "
           "(1, 1) mesh's, 3 uniform_hop and 1 tiered_gather launches per step")
    check(out["world"] == out["logical"] and steps == WORLD_DP_SEEDS // MULTI_BATCH
          and all(equal(params["world"][k], v) for k, v in params["logical"].items()),
          f"world DataParallelTrainer {out}")
    expect_launches(launches["world"], {"uniform_hop": 3 * steps, "tiered_gather": steps},
                    "world DataParallelTrainer")
    check(launches["logical"] == launches["world"], "world DataParallelTrainer: the logical "
          f"form launched {launches['logical']}")
    log(f"world DataParallelTrainer: {steps} steps, mean loss {out['world'][0]:.6f} [{card}]")
    return launches["world"], {"steps": steps, "mean_loss": out["world"][0],
                               "launches": launches["world"]}


def two_ranks_one_card(store: str) -> dict:
    """A 2-rank ``nccl`` world on the one card, tried once: each rank joins
    through a file store on ``cuda:0`` and all-reduces one CUDA tensor.
    Returns what happened and the tail of what each rank printed; nothing
    routes around a refusal (no host-staged collective, no CPU
    fallback)."""
    code = ("import sys, torch\n"
            "from quiver_tpu_torch.parallel.mesh import init_distributed, "
            "shutdown_distributed\n"
            "rank = int(sys.argv[1])\n"
            "init_distributed('file://' + sys.argv[2], 2, rank, device='cuda:0')\n"
            "try:\n"
            "    t = torch.full((4,), float(rank + 1), device='cuda:0')\n"
            "    torch.distributed.all_reduce(t)\n"
            "    torch.cuda.synchronize()\n"
            "    print('all_reduce', t.tolist(), flush=True)\n"
            "finally:\n"
            "    shutdown_distributed()\n")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    tails, codes = [], []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(TWO_RANKS_S - (time.time() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += f"\n(no exit within {TWO_RANKS_S} s; killed)"
        codes.append(p.returncode)
        tails.append([ln for ln in text.splitlines() if ln.strip()][-6:])
    ran = codes == [0, 0] and all(any("all_reduce" in ln for ln in t) for t in tails)
    return {"ran": ran, "exit_codes": codes, "rank_output_tails": tails,
            "seconds": time.time() - t0}


def world_phase(card):
    """Phase 9m (see the module docstring). Returns ``(launches by
    trainer, result)``."""
    import torch

    from quiver_tpu_torch import make_mesh
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    t0 = time.time()
    topo, x, labels = multichip_setup()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    launches, flavours = {}, {}
    try:
        step9m("init_distributed over nccl, a world of one through a file store")
        dev = init_distributed(f"file://{os.path.join(SCRATCH, 'world_store')}", 1, 0,
                               device="cuda")
        check(dev == torch.device("cuda", 0) and torch.distributed.get_backend() == "nccl",
              f"world of one: {dev}, {torch.distributed.get_backend()}")
        wmesh = make_mesh(data=1, feature=1)
        check(type(wmesh).__name__ == "WorldMesh" and wmesh.slot == (0, 0),
              f"world mesh {wmesh!r}")
        meshes = (wmesh, logical_mesh(1, 1))
        for name, seed_sharding, dtype in WORLD_FLAVOURS:
            launches[name], flavours[name] = world_flavour(
                topo, x, labels, meshes, seed_sharding, dtype, card)
            torch.cuda.empty_cache()
        launches["dp"], dp = world_dp(topo, x, labels, meshes, card)
    finally:
        shutdown_distributed()
    step9m("a 2-rank nccl world on the one card, tried once")
    two = two_ranks_one_card(os.path.join(SCRATCH, "two_store"))
    log(f"2-rank nccl world on one card: ran={two['ran']}, exit codes "
        f"{two['exit_codes']}, last lines {two['rank_output_tails']}")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    del x
    return launches, {
        "config": "phase 9f (b)'s: examples/train_multichip.py defaults (100,000 nodes, "
                  "degree 25, F = 128, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3, "
                  "the worst-case caps), 8M L1 and 4M L0 per device; a world of one rank "
                  "over nccl (file store) against the logical (1, 1) mesh of cuda:0",
        "trainer": flavours, "data_parallel": dp, "two_ranks_one_card": two,
        "card": card, "seconds": time.time() - t0}


# -- phase 9n: the topology-sharded trainer, samplers and elastic resume over a world --

WORLD_TOPO_STEPS = 4  # checked steps of each kind, under deterministic kernels
WORLD_TOPO_KINDS = (("uniform", False), ("weighted", True))
WORLD_TOPO_WEIGHTS = 12  # seed of the trainer graph's exp(N(0, 1)) weights


def step9n(what: str) -> None:
    """Name a phase 9n check on stderr before it runs."""
    log(f"phase 9n check: {what}")


def world_topo_trainer(topo, x, mesh, weighted):
    """Phase 9g (b)'s trainer (9f (b)'s width under ``"all"`` over a
    topology-sharded sampler, uniform or weighted) on ``mesh`` over a fresh
    three-tier store of 8M L1 and 4M L0 per device, the guard on;
    ``init(0)``."""
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSageSampler, GraphSAGE, ShardedFeature

    store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                           replicate_budget=MULTI_L0, kernel="pallas").from_cpu_tensor(x)
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, topo_sharding="mesh", mesh=mesh,
                               weighted=weighted, kernel="pallas")
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES,
                      num_layers=len(MULTI_FANOUT)).to("cuda")
    trainer = DistributedTrainer(mesh, sampler, store, model,
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding="all",
                                 nonfinite_guard=True)
    trainer.init(0)
    return trainer


def world_topo_steps(trainer, labels, steps: int, key0: int) -> list:
    """:func:`world_steps` with each step's per-hop overflow as well."""
    import numpy as np

    rng = np.random.default_rng(key0)
    n = trainer.sampler.csr_topo.node_count
    out = []
    for i in range(steps):
        loss = trainer.step(rng.integers(0, n, trainer.global_batch), labels, key0 + i)
        out.append((loss, trainer.last_tier_hits.clone(), trainer.last_routed_overflow.clone(),
                    trainer.last_sample_overflow.clone()))
    return out


def world_topo_kind(topo, x, labels, meshes, weighted, card) -> tuple[dict, list, dict]:
    """(a) One kind of the topology-sharded trainer on the world ``(1, 1)``
    mesh and the logical one: ``WORLD_TOPO_STEPS`` steps of each under
    deterministic kernels (losses, tier hits, routed and per-hop overflow,
    guard counters and parameters bitwise; exactly one owner-side K1
    ``select`` or K3 ``wselect`` per hop and 3 K2 ``gather_rows`` a step in
    both forms; every collective on CUDA tensors), one recorded world
    step's owner-side calls against their plain versions, the shard's
    topology bytes on the card, then steps/s in turns on the main path.
    Returns ``(the world run's launches, check rows, result)``."""
    import math

    from quiver_tpu_torch.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED
    from quiver_tpu_torch.parallel import world

    wmesh, lmesh = meshes
    kind = "weighted" if weighted else "uniform"
    entry = "wselect" if weighted else "select"
    L = len(MULTI_FANOUT)
    runs, launches, params, guard = {}, {}, {}, {}
    with deterministic_algorithms():
        trainers = {"world": world_topo_trainer(topo, x, wmesh, weighted),
                    "logical": world_topo_trainer(topo, x, lmesh, weighted)}
        for form, trainer in trainers.items():
            reset_launches()
            world.reset_calls()
            runs[form] = world_topo_steps(trainer, labels, WORLD_TOPO_STEPS, 300)
            sync()
            launches[form] = read_launches()
            if form == "world":
                calls = dict(world.CALLS)
            params[form] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            guard[form] = [trainer.metrics.value(GUARD_SKIPPED),
                           trainer.metrics.value(GUARD_NONFINITE)]
    step9n(f"(a) {kind}: losses, tier hits, routed and per-hop overflow, guard counters and "
           "parameters bitwise the logical (1, 1) mesh's (deterministic kernels)")
    check(same_steps(runs["world"], runs["logical"])
          and all(equal(params["world"][k], v) for k, v in params["logical"].items())
          and all(equal(a, b) for a, b in zip(guard["world"], guard["logical"])),
          f"world topology-sharded trainer ({kind}) == the logical mesh's")
    want = {entry: L * WORLD_TOPO_STEPS, "gather_rows": 3 * WORLD_TOPO_STEPS}
    step9n(f"(a) {kind}: exactly {L} owner-side {entry} and 3 gather_rows launches a step, "
           "in both forms")
    expect_launches(launches["world"], want, f"world topology-sharded trainer ({kind})")
    check(launches["logical"] == launches["world"], f"world topology-sharded trainer "
          f"({kind}): the logical form launched {launches['logical']}")
    step9n(f"(a) {kind}: every collective ran on CUDA tensors")
    check(calls and all(dev == "cuda" for _, dev in calls),
          f"world topology-sharded trainer ({kind}): collectives {calls}")
    per_step = {prim: n / WORLD_TOPO_STEPS for (prim, _), n in calls.items()}
    trainer = trainers["world"]
    with owner_calls() as recorded:
        world_topo_steps(trainer, labels, 1, 400)
        sync()
    step9n(f"(a) {kind}: one world step's {L} owner-side {entry} calls bitwise {entry}_plain")
    check(len(recorded) == L, f"world step's owner-side calls: {len(recorded)}")
    rows, owner = owner_call_rows(recorded, f"world topology-sharded trainer ({kind}) step")
    del recorded
    part = trainer.sampler.topo
    tensors = [t for ts in (part.indptr, part.indices, part.cum_weights) if ts for t in ts]
    step9n(f"(a) {kind}: the rank holds one shard of the topology, on the card")
    check(part.member == 0 and part.held_bytes == part.plan["per_chip_bytes"]
          and all(t.is_cuda for t in tensors), f"world topology shard {part.plan}")
    timing = timed_turns(
        lambda: world_topo_steps(trainers["world"], labels, WORLD_TIMED, 500),
        lambda: world_topo_steps(trainers["logical"], labels, WORLD_TIMED, 500))
    losses = [float(v[0]) for v in runs["world"]]
    check(all(math.isfinite(v) for v in losses), f"world topology trainer ({kind}): losses")
    r = {"kind": kind, "losses": losses, "launches": launches["world"],
         "launches_per_step": {entry: L, "gather_rows": 3},
         "sample_overflow": [v[3].tolist() for v in runs["world"]],
         "collectives_per_step": per_step,
         "collective_devices": sorted({dev for _, dev in calls}), "owner_side": owner,
         "topology_bytes": {"shard_on_card": part.held_bytes,
                            "replicated": part.plan["replicated_bytes"],
                            "shards": part.num_shards},
         **timing}
    log(f"world topology-sharded trainer ({kind}): world {timing['world_steps_per_s']:.4g} "
        f"steps/s, logical {timing['logical_steps_per_s']:.4g} steps/s (in turns), "
        f"collectives per step {per_step}, shard {part.held_bytes} B on the card [{card}]")
    for t in trainers.values():
        t.feature.delete()
    return launches["world"], rows, r


def world_hetero(meshes, card) -> tuple[dict, dict]:
    """(b) ``DistHeteroSampler`` at ``bench_rgcn.py``'s configuration on
    the world ``(1, 1)`` mesh and the logical one, uniform and weighted, on
    the same draws: ids of every type, every relation's edge list and the
    overflow bitwise; one owner-side launch per relation hop in both
    forms. Returns ``(launches by kind, result)``."""
    import numpy as np

    from quiver_tpu_torch import DistHeteroSampler

    topo, _feats, _labels, _rng = mag_graph()
    del _feats
    wrng = np.random.default_rng(8)
    for et in topo.edge_types:
        topo.set_edge_weight(et, np.exp(wrng.normal(size=topo.relations[et].edge_count)))
    seeds = np.random.default_rng(10).integers(0, MAG_PAPERS, RGCN_BATCH)
    launches, result = {}, {}
    for kind, weighted in (("uniform", False), ("weighted", True)):
        entry = "wselect" if weighted else "select"
        outs, got = {}, {}
        for form, mesh in zip(("world", "logical"), meshes):
            smp = DistHeteroSampler(topo, RGCN_FANOUT, "paper", mesh=mesh,
                                    routed_alpha=DIST_HETERO_ALPHA, weighted=weighted, seed=0)
            reset_launches()
            outs[form] = smp.sample(seeds, draw_fn=hetero_draw_fn(smp))
            sync()
            got[form] = read_launches()
            hops = sum(len(active) for active, _, _ in smp._plan(outs[form].batch_size))
        a, b = outs["world"], outs["logical"]
        step9n(f"(b) {kind}: the world sample bitwise the logical (1, 1) one; {hops} "
               f"{entry} launches in both forms")
        same = (set(a.n_id) == set(b.n_id) and all(equal(a.n_id[t], b.n_id[t]) for t in b.n_id)
                and equal(a.overflow, b.overflow)
                and all(equal(la.adjs[et].edge_index, x.edge_index)
                        for la, lb in zip(a.adjs, b.adjs) for et, x in lb.adjs.items()))
        check(same, f"world DistHeteroSampler ({kind}) == the logical mesh's")
        expect_launches(got["world"], {entry: hops}, f"world DistHeteroSampler ({kind})")
        check(got["logical"] == got["world"], f"world DistHeteroSampler ({kind}): logical "
              f"launched {got['logical']}")
        launches[kind] = got["world"]
        result[kind] = {"launches": got["world"], "relation_hops": hops,
                        "sampled_ids": {t: int((v >= 0).sum()) for t, v in a.n_id.items()}}
    result["config"] = ("bench_rgcn.py defaults: the MAG-shaped graph, fanouts [8, 4], batch "
                        "512 on one worker, routed_alpha 2.0; weighted: exp(N(0, 1)) weights")
    log(f"world DistHeteroSampler: {result['uniform']['relation_hops']} relation hops, "
        f"bitwise the logical form, uniform and weighted [{card}]")
    return launches, result


def world_elastic(topo, x, labels, wmesh, card) -> tuple[dict, dict]:
    """(c) ``logical_workers=4`` on the world of one: the 9-step epoch
    preempted at step 3 (a checkpoint every 3); the group torn down; a
    fresh world of one (a new file store) and a new trainer resuming with
    ``resume(mesh=trainer.mesh)``: its tail bitwise the uninterrupted
    logical ``(1, 4)`` run's, exact launches; the same checkpoint resumed
    on the logical ``(1, 2)`` mesh, bitwise too. Under deterministic
    kernels. Returns ``(the resumed world's launches, result)``; the
    process group stays up (the new world's)."""
    import numpy as np

    from quiver_tpu_torch import FaultPlan, Preemption, make_mesh
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    n = topo.node_count
    train_idx = np.random.default_rng(3).permutation(n)[
        :ELASTIC_STEPS * ELASTIC_WORKERS * MULTI_BATCH]
    ckpt = os.path.join(SCRATCH, "world_elastic")
    out = {}
    with deterministic_algorithms():
        ref_tr = elastic_trainer(topo, x, 4, os.path.join(SCRATCH, "logical_full"))
        seed_mat = ref_tr.pack_epoch(train_idx, seed=0)
        ref = ref_tr.epoch_scan(seed_mat, labels, 7).cpu().numpy()
        final = {k: v.clone() for k, v in ref_tr.model.state_dict().items()}
        ref_tr.checkpointer.close()
        del ref_tr
        w = elastic_trainer(topo, x, 1, ckpt, plan=FaultPlan(preempt_at_step=ELASTIC_PREEMPT),
                            mesh=wmesh)
        step9n(f"(c) the world of one's elastic epoch is preempted at step {ELASTIC_PREEMPT}")
        try:
            w.epoch_scan(seed_mat, labels, 7)
            check(False, "the planned preemption raised")
        except Preemption:
            pass
        w.checkpointer.close()
        del w
        shutdown_distributed()
        t0 = time.perf_counter()
        init_distributed(f"file://{os.path.join(SCRATCH, 'world_store_2')}", 1, 0,
                         device="cuda")
        fresh = elastic_trainer(topo, x, 1, ckpt, mesh=make_mesh(data=1, feature=1))
        sync()
        t1 = time.perf_counter()
        _, _, key, step, epoch = fresh.resume(mesh=fresh.mesh)
        sync()
        out["resume_s"] = time.perf_counter() - t1
        out["new_world_and_trainer_s"] = t1 - t0
        reset_launches()
        losses, secs = timed_epoch(fresh, seed_mat, labels, key, epoch=epoch, start_step=step)
        launches = read_launches()
        step9n("(c) a fresh world of one resumes it: the tail bitwise the uninterrupted "
               "logical (1, 4) run's, exact launches")
        check(step == ELASTIC_PREEMPT and same_bits(losses.cpu().numpy(), ref[step:])
              and same_params(fresh.model.state_dict(), final),
              "the fresh world's resumed tail == the uninterrupted (1, 4) run's")
        expect_launches(launches, elastic_launches(1, ELASTIC_STEPS - step),
                        "the fresh world's resumed tail")
        out["world_steps_per_s"] = (ELASTIC_STEPS - step) / secs
        fresh.checkpointer.close()
        del fresh
        l2 = elastic_trainer(topo, x, 2, ckpt)
        _, _, key, step, epoch = l2.resume(mesh=l2.mesh, checkpoint_step=0)
        losses, secs = timed_epoch(l2, seed_mat, labels, key, epoch=epoch, start_step=step)
        step9n("(c) the world's checkpoint resumed on the logical (1, 2) mesh: bitwise too")
        check(step == ELASTIC_PREEMPT and same_bits(losses.cpu().numpy(), ref[step:])
              and same_params(l2.model.state_dict(), final),
              "the world's checkpoint on the logical (1, 2) mesh == the (1, 4) run")
        out["logical_12_steps_per_s"] = (ELASTIC_STEPS - step) / secs
        l2.checkpointer.close()
        del l2
    out["losses"] = ref.tolist()
    log(f"world elastic resume: resumed in {out['resume_s']:.3f} s (new world and trainer "
        f"{out['new_world_and_trainer_s']:.2f} s), tail {out['world_steps_per_s']:.3g} "
        f"steps/s; logical (1, 2) {out['logical_12_steps_per_s']:.3g} steps/s [{card}]")
    return launches, out


def world_topo_phase(card):
    """Phase 9n (see the module docstring). Returns ``(launches by path,
    owner-side check rows by entry, result)``."""
    import numpy as np
    import torch

    from quiver_tpu_torch import make_mesh
    from quiver_tpu_torch.parallel import world
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    t0 = time.time()
    topo, x, labels = multichip_setup()
    # the weighted kind's weights (the uniform samplers read none of them)
    topo.set_edge_weight(np.exp(np.random.default_rng(WORLD_TOPO_WEIGHTS).normal(
        size=topo.edge_count)).astype(np.float32))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    launches, rows, result = {}, {"select": [], "wselect": []}, {}
    try:
        step9n("init_distributed over nccl, a world of one through a file store")
        init_distributed(f"file://{os.path.join(SCRATCH, 'world_store')}", 1, 0, device="cuda")
        wmesh = make_mesh(data=1, feature=1)
        check(type(wmesh).__name__ == "WorldMesh" and torch.distributed.get_backend() == "nccl",
              f"world mesh {wmesh!r}")
        meshes = (wmesh, logical_mesh(1, 1))
        trainers = {}
        for kind, weighted in WORLD_TOPO_KINDS:
            launches[kind], r_rows, trainers[kind] = world_topo_kind(
                topo, x, labels, meshes, weighted, card)
            rows["wselect" if weighted else "select"] += r_rows
            torch.cuda.empty_cache()
        result["trainer"] = trainers
        launches["hetero"], result["hetero"] = world_hetero(meshes, card)
        torch.cuda.empty_cache()
        launches["elastic"], result["elastic"] = world_elastic(topo, x, labels, wmesh, card)
        result["collectives"] = {f"{p}:{d}": n for (p, d), n in world.CALLS.items()}
    finally:
        shutdown_distributed()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    del x
    result["config"] = ("phase 9g (b)'s: examples/train_multichip.py defaults (100,000 nodes, "
                        "degree 25, F = 128, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3, "
                        "the worst-case caps) under seed_sharding='all' over a "
                        "topology-sharded sampler (uniform; weighted: exp(N(0, 1)) weights), "
                        "8M L1 and 4M L0 per device; a world of one rank over nccl (file "
                        "store) against the logical (1, 1) mesh of cuda:0; phase 9i's elastic "
                        "epoch across two successive worlds of one")
    result["card"] = card
    result["seconds"] = time.time() - t0
    log(f"phase 9n {result['seconds']:.1f}s [{card}]")
    return launches, rows, result


# -- phase 9o: the adaptive tuners over a world of processes (one rank over nccl) --

WORLD_CTL_MODES = (("data", "replicated"), ("all", "mesh"))
WORLD_CTL_UPDATES = 64  # rows a commit updates in each tier
# the trainer's starting L0: half the store's 4M ceiling of int8 rows, so
# the split tuner has room to move the boundary
WORLD_CTL_L0 = 16_384 * MULTI_F
# the kernel wrappers of the path at their call sites: (module, name)
PATH_WRAPPERS = (("quiver_tpu_torch.ops.sample", "uniform_hop"),
                 ("quiver_tpu_torch.sampling.dist", "select"),
                 ("quiver_tpu_torch.feature.shard", "gather_rows"),
                 ("quiver_tpu_torch.feature.shard", "tiered_gather_dequant"))


def step9o(what: str) -> None:
    """Name a phase 9o check on stderr before it runs."""
    log(f"phase 9o check: {what}")


def world_ctl_launches(trainer, k1: str) -> dict:
    """A step's K1 and K2 launches on a ``(1, 1)`` mesh from the store's
    split after the step's tuner: 3 hops; the L0 and cold tiers one
    dequantising launch each, the shard's codes one ``gather_rows`` and
    their dequantisation one more."""
    store = trainer.feature
    tiers = int(store.rep_rows > 0) + int(store.cold is not None)
    return {k1: len(MULTI_FANOUT), "gather_rows": 1, "tiered_gather_dequant": tiers + 1}


def world_ctl_state(trainer) -> tuple:
    """What the tuners decided and read after a step: alpha, the split,
    the store's version and order, the overflow counts, the tier hits and
    the heat histogram (on the card)."""
    from quiver_tpu_torch.obs.registry import FEATURE_ROW_HEAT

    store = trainer.feature
    return (trainer.routed_alpha, store.rep_rows, store.version,
            store.feature_order.clone(), trainer.last_routed_overflow.clone(),
            trainer.last_sample_overflow.clone(), trainer.last_tier_hits.clone(),
            trainer.metrics.value(FEATURE_ROW_HEAT).clone())


def world_ctl_updates(store, rng):
    """``WORLD_CTL_UPDATES`` node ids in each tier of ``store`` (L0, the L1
    shard, the cold rows) and their new rows."""
    import numpy as np

    order = store.feature_order.cpu().numpy().astype(np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    end = store.rep_rows + store.hot_rows
    t = np.concatenate([rng.choice(lo_hi[1] - lo_hi[0], WORLD_CTL_UPDATES, replace=False)
                        + lo_hi[0] for lo_hi in ((0, store.rep_rows),
                                                  (store.rep_rows, end),
                                                  (end, order.shape[0])) if lo_hi[1] > lo_hi[0]])
    return inv[t], rng.normal(size=(t.shape[0], MULTI_F)).astype(np.float32)


def world_ctl_run(trainer, labels, k1: str) -> dict:
    """The checked run of one form: 3 + 10 steps, one epoch_scan whose
    ``end_epoch`` repins, a commit of row updates into every tier, the
    trainer's ``refresh`` and the next step: each step's loss and tuner
    state, the launches of each step (and of the epoch) against the split,
    the decisions, the fresh rows and the parameters."""
    import numpy as np
    import torch

    from quiver_tpu_torch.streaming import DeltaBatch, StreamingGraph

    store = trainer.feature
    n, gb = trainer.sampler.csr_topo.node_count, trainer.global_batch
    rng = np.random.default_rng(1)
    out = {"losses": [], "states": [], "launches": [], "want": []}
    for i in range(MULTI_WARMUP + MULTI_STEPS):
        reset_launches()
        out["losses"].append(trainer.step(rng.integers(0, n, gb), labels, 10 + i))
        sync()
        out["launches"].append(read_launches())
        out["want"].append(world_ctl_launches(trainer, k1))
        out["states"].append(world_ctl_state(trainer))
    mat = trainer.pack_epoch(rng.integers(0, n, CTL_EPOCH_STEPS * gb), seed=3)
    reset_launches()
    out["epoch"] = trainer.epoch_scan(mat, labels, 21)
    sync()
    out["launches"].append(read_launches())
    out["want"].append({k: v * CTL_EPOCH_STEPS
                        for k, v in world_ctl_launches(trainer, k1).items()})
    out["states"].append(world_ctl_state(trainer))
    out["repinned"] = trainer._bound_versions == trainer._current_versions()
    ids, rows = world_ctl_updates(store, np.random.default_rng(2))
    graph = StreamingGraph(trainer.sampler.csr_topo, feature=store)
    check(graph.ingest(DeltaBatch(update_ids=ids, update_rows=rows)), "the update batch")
    result = graph.commit()
    out["stale"] = trainer._bound_versions != trainer._current_versions()
    trainer.refresh()
    out["fresh"] = equal(store.gather(torch.from_numpy(ids).to("cuda")),
                         torch.from_numpy(int8_rows(rows, np.arange(ids.shape[0]))).to("cuda"))
    out["commit"] = (result.rows_updated, store.version)
    reset_launches()
    out["losses"].append(trainer.step(rng.integers(0, n, gb), labels, 4000))
    sync()
    out["launches"].append(read_launches())
    out["want"].append(world_ctl_launches(trainer, k1))
    out["states"].append(world_ctl_state(trainer))
    out["decisions"] = list(trainer.controller.decisions)
    out["params"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return out


def world_ctl_mode(topo, x, labels, meshes, seed_sharding, topo_sharding, card):
    """One mode on the world ``(1, 1)`` mesh and the logical one (see the
    module docstring). Returns ``(the world run's launches, check rows by
    wrapper, result)``."""
    import math

    import numpy as np
    import torch

    from quiver_tpu_torch import CacheController, ShardedFeature
    from quiver_tpu_torch.ops.kernels.fused import select_plain, uniform_hop_plain
    from quiver_tpu_torch.ops.kernels.gather import gather_rows_plain, tiered_gather_plain
    from quiver_tpu_torch.parallel import world

    def trainer_on(mesh):
        store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                               replicate_budget=MULTI_L0, dtype="int8", auto_split=True,
                               kernel="pallas").from_cpu_tensor(x)
        ctl = CacheController(heat_bins=CTL_HEAT_BINS, repin_min_gain=0.0)
        return control_trainer(topo, store, seed_sharding, topo_sharding,
                                routed_alpha=CTL_ALPHA0, auto_alpha=True, controller=ctl,
                                replicate_budget=WORLD_CTL_L0)

    wmesh, lmesh = meshes
    what = f"{seed_sharding}, {topo_sharding} topology"
    k1 = "select" if topo_sharding == "mesh" else "uniform_hop"
    runs, calls = {}, None
    with deterministic_algorithms():
        trainers = {"world": trainer_on(wmesh), "logical": trainer_on(lmesh)}
        for form, trainer in trainers.items():
            world.reset_calls()
            runs[form] = world_ctl_run(trainer, labels, k1)
            if form == "world":
                calls = dict(world.CALLS)
    w, lg = runs["world"], runs["logical"]
    step9o(f"{what}: 3 + 10 steps, the epoch, the commit and the next step bitwise the "
           "logical (1, 1) mesh's: losses, alpha, split, version, order, overflow, tier "
           "hits, heat, decisions and parameters (deterministic kernels)")
    check(all(equal(a, b) for a, b in zip(w["losses"], lg["losses"]))
          and equal(w["epoch"], lg["epoch"])
          and all(same_state(a, b) for a, b in zip(w["states"], lg["states"]))
          and w["decisions"] == lg["decisions"] and w["commit"] == lg["commit"]
          and all(equal(w["params"][k], v) for k, v in lg["params"].items()),
          f"world controlled trainer ({what}) == the logical mesh's")
    kinds = [d["decision"] for d in w["decisions"]]
    splits = [s[1] for s in w["states"]]
    step9o(f"{what}: the split tuner moved the L0/L1 boundary from its start below the "
           "ceiling (the world resplit re-placed the rank's L0 and L1)")
    check("split" in kinds and splits[0] * MULTI_F <= WORLD_CTL_L0 and len(set(splits)) > 1,
          f"world controlled trainer ({what}): L0 rows {splits}, decisions {kinds}")
    step9o(f"{what}: the epoch's end repinned (the trainer refreshed), the commit published "
           "fresh rows in every tier, a stale trainer until refresh()")
    check(w["repinned"] and "repin" in kinds and w["states"][-2][2] == 1 and w["stale"]
          and w["fresh"] and w["commit"] == (3 * WORLD_CTL_UPDATES, 2),
          f"world controlled trainer ({what}): decisions {kinds}, commit {w['commit']}")
    if seed_sharding == "all":
        step9o(f"{what}: alpha grew after overflowing steps")
        check("alpha" in kinds and w["states"][-1][0] > CTL_ALPHA0,
              f"{what}: alphas {[s[0] for s in w['states']]}")
    step9o(f"{what}: exact K1 and K2 launches every step and the epoch, in both forms")
    for i, (got, want) in enumerate(zip(w["launches"], w["want"])):
        expect_launches(got, want, f"world controlled trainer ({what}) part {i}")
    check(w["launches"] == lg["launches"], f"{what}: the logical form launched "
          f"{lg['launches']}")
    step9o(f"{what}: every collective ran on CUDA tensors")
    check(calls and all(dev == "cuda" for _, dev in calls)
          and calls.get(("all_reduce", "cuda"), 0) > 0,
          f"world controlled trainer ({what}): collectives {calls}")
    trainer = trainers["world"]
    with owner_calls(PATH_WRAPPERS) as recorded:
        trainer.step(np.random.default_rng(9).integers(0, topo.node_count,
                                                       trainer.global_batch), labels, 5000)
        sync()
    step9o(f"{what}: one world step's K1 and K2 calls bitwise their plain versions")
    rows = call_rows(recorded, f"world controlled trainer ({what}) step",
                     {"uniform_hop": uniform_hop_plain, "select": select_plain,
                      "gather_rows": gather_rows_plain,
                      "tiered_gather_dequant": tiered_gather_plain})
    want = world_ctl_launches(trainer, k1)
    check({k: len(v) for k, v in rows.items()} == want,
          f"{what}: recorded calls {[c[0] for c in recorded]}")
    del recorded
    timing = timed_turns(
        lambda: world_steps(trainers["world"], labels, WORLD_TIMED, 200),
        lambda: world_steps(trainers["logical"], labels, WORLD_TIMED, 200))
    losses = [float(v) for v in w["losses"]]
    check(all(math.isfinite(v) for v in losses), f"{what}: finite losses")
    total = {}
    for got in w["launches"]:
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    per_step = {prim: n for (prim, _), n in calls.items()}
    r = {"seed_sharding": seed_sharding, "topology": topo_sharding,
         "alphas": [s[0] for s in w["states"]], "rep_rows": [s[1] for s in w["states"]],
         "decisions": kinds, "loss_first_last": [losses[0], losses[-1]],
         "epoch_losses_first_last": [float(w["epoch"][0]), float(w["epoch"][-1])],
         "commit_rows": w["commit"][0], "launches": total,
         "collectives_in_checked_run": per_step,
         "checked_steps": MULTI_WARMUP + MULTI_STEPS + CTL_EPOCH_STEPS + 1, **timing}
    log(f"world controlled trainer ({what}): world {timing['world_steps_per_s']:.4g} "
        f"steps/s, logical {timing['logical_steps_per_s']:.4g} steps/s (in turns), alphas "
        f"{r['alphas']}, L0 rows {r['rep_rows']}, decisions {kinds} [{card}]")
    for t in trainers.values():
        t.feature.delete()
    torch.cuda.empty_cache()
    return total, rows, r


def world_control_phase(card):
    """Phase 9o (see the module docstring). Returns ``(launches by mode,
    check rows by wrapper, result)``."""
    import torch

    from quiver_tpu_torch import make_mesh
    from quiver_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    t0 = time.time()
    topo, x, labels = multichip_setup()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    launches, modes = {}, {}
    rows = {"uniform_hop": [], "select": [], "gather_rows": [], "tiered_gather_dequant": []}
    try:
        step9o("init_distributed over nccl, a world of one through a file store")
        init_distributed(f"file://{os.path.join(SCRATCH, 'world_store')}", 1, 0, device="cuda")
        wmesh = make_mesh(data=1, feature=1)
        check(type(wmesh).__name__ == "WorldMesh" and torch.distributed.get_backend() == "nccl",
              f"world mesh {wmesh!r}")
        meshes = (wmesh, logical_mesh(1, 1))
        for seed_sharding, topo_sharding in WORLD_CTL_MODES:
            launches[seed_sharding], r_rows, modes[seed_sharding] = world_ctl_mode(
                topo, x, labels, meshes, seed_sharding, topo_sharding, card)
            for k, v in r_rows.items():
                rows[k] += v
    finally:
        shutdown_distributed()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    del x
    result = {"modes": modes, "card": card,
              "config": "examples/train_multichip.py defaults (100,000 nodes, degree 25, "
                        "F = 128, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3, the "
                        "worst-case caps) over an int8 auto_split ShardedFeature of 8M L1 and "
                        "4M L0 per device with CacheController(heat_bins=256, "
                        "repin_min_gain=0) and auto_alpha=True from routed_alpha=0.25; "
                        "'data' over the replicated sampler, 'all' over a topology-sharded "
                        "one; a world of one rank over nccl (file store) against the logical "
                        "(1, 1) mesh of cuda:0",
              "seconds": time.time() - t0}
    log(f"phase 9o {result['seconds']:.1f}s [{card}]")
    return launches, rows, result


# -- phase 9p: the reindex's dedup strategies -------------------------------------

DEDUPS = ("sort", "map")
DEDUP_REPS = 25  # CUDA-event timings per strategy per turn (two turns)
DEDUP_SERVE_BUCKET = 8  # the ladder's largest bucket: 8 lanes of one seed


def step9p(what: str) -> None:
    """Name a phase 9p check on stderr before it runs."""
    log(f"phase 9p check: {what}")


@contextlib.contextmanager
def recorded_hops():
    """Record the inputs ``(cur, cur_n, nbr, cap)`` of every
    ``reindex_hop`` the samplers run in the block."""
    from quiver_tpu_torch.sampling import sampler as sampler_mod

    hops, orig = [], sampler_mod.reindex_hop

    def rec(cur, cur_n, nbr, cap, eids=None, **kw):
        hops.append((cur, cur_n, nbr, cap))
        return orig(cur, cur_n, nbr, cap, eids, **kw)

    sampler_mod.reindex_hop = rec
    try:
        yield hops
    finally:
        sampler_mod.reindex_hop = orig


def same_sample(a, b) -> bool:
    """Two ``SampleOutput``s bitwise: ids, counts and every edge list."""
    return (equal(a.n_id, b.n_id) and int(a.n_count) == int(b.n_count)
            and int(a.overflow) == int(b.overflow)
            and all(equal(x.edge_index, y.edge_index) for x, y in zip(a.adjs, b.adjs)))


def event_ms(fn) -> float:
    """One call of ``fn`` between CUDA events, in ms."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_reindex(hops, node_bound: int) -> list:
    """Each recorded hop's ``reindex_layer`` under every strategy on the
    same inputs, in turns (sort, map, map, sort),
    ``DEDUP_REPS`` calls a turn after one untimed, each between CUDA
    events: the eager call (the host's launches and the card's work, what
    a caller on an idle card waits for) and the replay of a CUDA graph
    captured from one call (the card's work alone); the median of each
    strategy's ``2 * DEDUP_REPS``; and each strategy's peak memory growth
    over one call (the map's scratch)."""
    import functools

    import torch

    from quiver_tpu_torch.ops.reindex import dedup_bound, reindex_layer

    out = []
    for l, (cur, cur_n, nbr, cap) in enumerate(hops):
        # a count given as an int would be copied to the card inside the
        # capture, which capture forbids
        cur_n = torch.as_tensor(cur_n, device=cur.device)
        calls = {d: functools.partial(reindex_layer, cur, cur_n, nbr, cap,
                                      node_bound=dedup_bound(d, node_bound))
                 for d in DEDUPS}
        graphs = {}
        for d in DEDUPS:
            calls[d]()
            sync()
            graphs[d] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[d]):
                calls[d]()
        times = {d: [] for d in DEDUPS}
        replay = {d: [] for d in DEDUPS}
        for d in DEDUPS + DEDUPS[::-1]:
            calls[d]()
            graphs[d].replay()
            sync()
            for _ in range(DEDUP_REPS):
                times[d].append(event_ms(calls[d]))
                replay[d].append(event_ms(graphs[d].replay))
        del graphs
        peak = {}
        for d in DEDUPS:
            sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            calls[d]()
            sync()
            peak[d] = torch.cuda.max_memory_allocated() - base
        rows = cur.reshape(-1, cur.shape[-1]).shape[0]
        out.append({"hop": l, "rows": rows, "seed_lanes": int(cur.shape[-1]),
                    "lanes": int(cur.shape[-1] * (1 + nbr.shape[-1])), "cap": int(cap),
                    "ms": {d: statistics.median(t) for d, t in times.items()},
                    "ms_turns": {d: [statistics.median(t[:DEDUP_REPS]),
                                     statistics.median(t[DEDUP_REPS:])]
                                 for d, t in times.items()},
                    "replay_ms": {d: statistics.median(t) for d, t in replay.items()},
                    "replay_ms_turns": {d: [statistics.median(t[:DEDUP_REPS]),
                                            statistics.median(t[DEDUP_REPS:])]
                                        for d, t in replay.items()},
                    "map_scratch_bytes": rows * node_bound * 4,
                    "peak_growth_bytes": peak})
    return out


def dedup_samplers(topo, dev_topo, card) -> tuple[dict, dict]:
    """(a) ``GraphSageSampler`` under each strategy over one placement, on
    the same draws: bench_epoch's [15, 10, 5] x 1024 (auto caps; the
    planning call, then a planned one) and the serving fanouts [5, 5] x 8
    (uniform and weighted); every output bitwise across the strategies,
    the same launches; each hop's reindex timed on the planned call's
    inputs and at the ladder's shape (8 lanes of one seed); the map once
    more under ``torch.use_deterministic_algorithms(True)``. Returns
    ``(launches by strategy, result)``."""
    import functools

    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops.sample import hop_draws, seeded_generator
    from quiver_tpu_torch.sampling.sampler import multilayer_sample

    n = topo.node_count
    rng = np.random.default_rng(91)
    calls = [rng.integers(0, n, EPOCH_BATCH) for _ in range(2)]
    serve_seeds = rng.integers(0, n, DEDUP_SERVE_BUCKET)
    launches, outs, samplers = {}, {}, {}
    for d in DEDUPS:
        smp = samplers[d] = GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", seed=0,
                                             frontier_caps="auto", dedup=d,
                                             device_topo=dev_topo)
        check(smp.dedup == d, f"sampler dedup {smp.dedup!r}")
        sync()
        reset_launches()
        outs[d] = [smp.sample(seeds) for seeds in calls]
        for weighted in (False, True):
            serve = GraphSageSampler(topo, [5, 5], device="cuda", seed=0, seed_capacity=8,
                                     weighted=weighted, dedup=d, device_topo=dev_topo)
            outs[d].append(serve.sample(serve_seeds))
        sync()
        launches[d] = read_launches()
    step9p("(a) every sample bitwise across sort and map")
    for d in DEDUPS[1:]:
        check(all(same_sample(a, b) for a, b in zip(outs[d], outs["sort"])),
              f"(a) dedup={d!r} samples == dedup='sort' samples")
        check(samplers[d]._frontier_caps == samplers["sort"]._frontier_caps,
              f"(a) dedup={d!r} planned caps")
    reruns = samplers["sort"].reruns
    step9p("(a) the same launches under every strategy")
    want = {"uniform_hop": len(EPOCH_FANOUT) * (len(calls) + reruns) + 2, "weighted_hop": 2}
    for d in DEDUPS:
        check(samplers[d].reruns == reruns, f"(a) dedup={d!r} reruns {samplers[d].reruns}")
        expect_launches(launches[d], want, f"(a) dedup={d!r} samplers")
    # each hop's reindex, timed on a planned call's inputs and at the
    # ladder's shape (8 lanes of one seed, its lane caps, the hop's bits)
    with recorded_hops() as epoch_hops:
        samplers["sort"].sample(calls[1])
    lane_caps = GraphSageSampler(topo, [5, 5], device="cuda", seed=0,
                                 device_topo=dev_topo)._worst_caps(1)
    g = seeded_generator("cuda", 92)
    bits = [hop_draws((DEDUP_SERVE_BUCKET, c), k, g)
            for c, k in zip((1,) + lane_caps[:-1], (5, 5))]
    lanes = torch.from_numpy(serve_seeds.astype(np.int32)).to("cuda")[:, None]
    ones = torch.ones(DEDUP_SERVE_BUCKET, dtype=torch.int32, device="cuda")
    with recorded_hops() as serve_hops:
        multilayer_sample(dev_topo, lanes, ones, (5, 5), lane_caps,
                          bits=lambda l, _shape: bits[l])
    step9p("(a) each hop's reindex timed under every strategy")
    timed = {"epoch": time_reindex(epoch_hops, n), "serve": time_reindex(serve_hops, n)}
    # the whole planned sample, in turns
    sample_ms = {d: [] for d in DEDUPS}
    for d in DEDUPS + DEDUPS[::-1]:
        sample_ms[d].append(cuda_ms(functools.partial(samplers[d].sample, calls[1]), 3, 5))
    # the map (and, beside it, the others) under deterministic algorithms
    step9p("(a) dedup='map' once under torch.use_deterministic_algorithms(True)")
    deterministic = {}

    def planned(d):
        return GraphSageSampler(topo, EPOCH_FANOUT, device="cuda", seed=0, dedup=d,
                                frontier_caps=samplers["sort"]._frontier_caps,
                                device_topo=dev_topo)

    ref = planned("sort").sample(calls[0])
    for d in DEDUPS:
        fresh = planned(d)
        got, raised = None, None
        torch.use_deterministic_algorithms(True)
        try:
            got = fresh.sample(calls[0])
            sync()
        except RuntimeError as e:
            # the answer this check records is PyTorch's refusal alone;
            # any other error fails the run
            if "does not have a deterministic implementation" not in str(e):
                raise
            raised = str(e).splitlines()[0][:300]
        finally:
            torch.use_deterministic_algorithms(False)
        deterministic[d] = {"raised": raised, "bitwise_sort_sampler":
                            None if got is None else same_sample(got, ref)}
        check(got is None or deterministic[d]["bitwise_sort_sampler"],
              f"(a) deterministic dedup={d!r} sample")
    log("phase 9p (a) reindex ms per hop, eager | replayed (sort / map): "
        + "; ".join(f"{shape} hop {h['hop']} "
                    + " / ".join(f"{h['ms'][d]:.4f}" for d in DEDUPS) + " | "
                    + " / ".join(f"{h['replay_ms'][d]:.4f}" for d in DEDUPS)
                    for shape, hs in timed.items() for h in hs)
        + f"; deterministic {deterministic} [{card}]")
    return launches, {
        "config": "bench_epoch.py's [15, 10, 5] x 1024 (auto caps) and the serving fanouts "
                  "[5, 5] x 8 on the products-shaped graph; one placement shared by every "
                  "sampler",
        "planned_caps": list(samplers["sort"]._frontier_caps), "reruns": reruns,
        "lane_caps": list(lane_caps), "launches": launches, "reindex": timed,
        "sample_ms": {d: statistics.median(t) for d, t in sample_ms.items()},
        "sample_ms_turns": sample_ms, "deterministic": deterministic,
        "timing": f"CUDA events around each eager call and around each replay of a CUDA "
                  f"graph of one call, the median of {2 * DEDUP_REPS} in two turns (sort, "
                  "map, map, sort)"}


def served_batches(server) -> int:
    """The batches ``server`` has sampled so far."""
    st = server.timeline.stats("sample")
    return 0 if st is None else st.count


def dedup_servers(args, topo, dev_topo, store, card) -> tuple[dict, dict]:
    """(b) One ``InferenceServer`` per strategy over one placement, one
    store and one program cache under ``SCRATCH``: every server captures
    its own programs (the strategy forks the sample programs'
    fingerprint, so the map server takes nothing of the sort's), the
    capture's launches, then ``args.requests`` closed-loop queries twice,
    the servers in turns (sort, map, map, sort); each pass's
    answers bitwise across the strategies and its launches the same
    (replayed hops, eager lookups); queries/s of every pass."""
    import numpy as np
    import torch

    from quiver_tpu_torch import GraphSAGE, GraphSageSampler, InferenceServer
    from quiver_tpu_torch.serving.aot import AOTExecutableCache

    F = store.size(1)
    servers, warm = {}, {}
    cache = AOTExecutableCache(os.path.join(SCRATCH, "aot"))
    for i, d in enumerate(DEDUPS):
        smp = GraphSageSampler(topo, [5, 5], device="cuda", seed=0, dedup=d,
                               device_topo=dev_topo)
        torch.manual_seed(0)
        model = GraphSAGE(F, 256, 47, num_layers=2)
        server = servers[d] = InferenceServer(smp, model, store, device="cuda", max_batch=8,
                                              seed=0, aot_cache=cache)
        sync()
        base = torch.cuda.memory_allocated()
        reset_launches()
        captures = server.warmup()
        sync()
        buckets = len(server.batcher.buckets)
        step9p(f"(b) dedup={d!r}: {2 * buckets} programs captured into the shared cache, "
               "no hit")
        check(captures == 2 * buckets and cache.stores == 2 * buckets * (i + 1)
              and cache.hits == 0,
              f"(b) dedup={d!r} captures {captures}, cache {cache.stores} stored, "
              f"{cache.hits} hits")
        expect_launches(read_launches(), {"uniform_hop": 2 * 2 * buckets},
                        f"(b) dedup={d!r} warm-up")
        warm[d] = {"captures": captures,
                   "allocated_growth_bytes": torch.cuda.memory_allocated() - base}
    nodes = np.random.default_rng(args.seed + 9).integers(0, topo.node_count, args.requests)
    passes = {d: [] for d in DEDUPS}
    for d in DEDUPS + DEDUPS[::-1]:
        sync()
        reset_launches()
        before = served_batches(servers[d])
        t0 = time.perf_counter()
        reqs = closed_loop(servers[d], nodes, 8)
        sync()
        wall = time.perf_counter() - t0
        batches = served_batches(servers[d]) - before
        expect_launches(read_launches(), {"tiered_gather": batches},
                        f"(b) dedup={d!r} pass", replayed={"uniform_hop": 2 * batches})
        out = np.stack([r.result for r in reqs])
        check(out.shape == (args.requests, 47) and bool(np.isfinite(out).all())
              and all(r.overflow == 0 for r in reqs), f"(b) dedup={d!r} answers")
        passes[d].append({"qps": len(reqs) / wall, "answers": out, "batches": batches})
    step9p("(b) every pass's answers bitwise across sort and map")
    for d in DEDUPS[1:]:
        for a, b in zip(passes[d], passes["sort"]):
            check(np.array_equal(a["answers"], b["answers"]),
                  f"(b) dedup={d!r} answers == dedup='sort' answers")
    qps = {d: [p["qps"] for p in ps] for d, ps in passes.items()}
    log("phase 9p (b) queries/s (sort / map): " + " / ".join(
        f"{statistics.mean(qps[d]):.1f}" for d in DEDUPS) + f" [{card}]")
    batches = passes["sort"][0]["batches"]
    return {d: {"uniform_hop": 2 * batches, "tiered_gather": batches} for d in DEDUPS}, {
        "config": "phase 4's server (GraphSAGE 100 x 256 x 47, [5, 5], max_batch 8) over "
                  "a hot-only store, one sampler per strategy on one placement, one "
                  "AOTExecutableCache for both servers",
        "warmup": warm, "qps": qps, "queries": args.requests, "batches": batches}


def dedup_trainer(topo, store, card) -> tuple[dict, dict]:
    """(c) ``DistributedTrainer`` over a topology-sharded sampler on the
    logical ``(1, 4)`` mesh, ``"all"``, per strategy (the map bounded by
    the global node count): 3 steps from ``init(0)`` under deterministic
    kernels; losses and parameters bitwise across the strategies, the
    same launches."""
    import numpy as np
    import torch

    from quiver_tpu_torch import DistributedTrainer, GraphSAGE, GraphSageSampler

    n = topo.node_count
    labels = torch.from_numpy(np.random.default_rng(93).integers(0, 47, n)
                              .astype(np.int32)).to("cuda")
    rng = np.random.default_rng(94)
    steps = [rng.integers(0, n, MULTI_BATCH * 4) for _ in range(MULTI_DET_STEPS)]
    runs, launches = {}, {}
    for d in DEDUPS:
        mesh = logical_mesh(1, 4)
        smp = GraphSageSampler(topo, MULTI_FANOUT, seed=0, topo_sharding="mesh", mesh=mesh,
                               dedup=d)
        model = GraphSAGE(store.size(1), MULTI_HIDDEN, 47, num_layers=len(MULTI_FANOUT))
        trainer = DistributedTrainer(mesh, smp, store, model.to("cuda"),
                                     torch.optim.Adam(model.parameters(), lr=1e-3),
                                     local_batch=MULTI_BATCH, seed_sharding="all")
        trainer.init(0)
        sync()
        reset_launches()
        t0 = time.perf_counter()
        with deterministic_algorithms():
            losses = [trainer.step(s, labels, 300 + i) for i, s in enumerate(steps)]
            sync()
        launches[d] = read_launches()
        runs[d] = {"losses": torch.stack([torch.as_tensor(v) for v in losses]).cpu(),
                   "seconds": time.perf_counter() - t0,
                   "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                   "sample_overflow": trainer.last_sample_overflow.clone()}
        del trainer, smp
    step9p("(c) losses, parameters and overflow bitwise across sort and map; "
           "the same launches")
    for d in DEDUPS[1:]:
        check(equal(runs[d]["losses"], runs["sort"]["losses"])
              and equal(runs[d]["sample_overflow"], runs["sort"]["sample_overflow"])
              and all(equal(v, runs["sort"]["params"][k]) for k, v in runs[d]["params"].items()),
              f"(c) dedup={d!r} trainer == dedup='sort' trainer")
        check(launches[d] == launches["sort"], f"(c) dedup={d!r} launches {launches[d]}")
    check(launches["sort"]["select"] > 0 and launches["sort"]["tiered_gather"] > 0,
          f"(c) launches {launches['sort']}")
    return launches, {
        "config": f"the products-shaped graph partitioned over the (1, 4) logical mesh, "
                  f"GraphSAGE {store.size(1)} x {MULTI_HIDDEN} x 47 x {len(MULTI_FANOUT)}, "
                  f"{MULTI_FANOUT} x {MULTI_BATCH} a worker, Adam 1e-3, seed_sharding='all', "
                  "the hot-only store of (b); deterministic kernels",
        "steps": MULTI_DET_STEPS, "losses": runs["sort"]["losses"].tolist(),
        "seconds": {d: r["seconds"] for d, r in runs.items()}, "launches": launches}


def dedup_typed(card) -> tuple[dict, dict]:
    """(d) ``HeteroGraphSampler`` and ``DistHeteroSampler`` (``(1, 4)``)
    per strategy at ``bench_rgcn.py``'s defaults (the MAG-shaped graph,
    [8, 4] x 512): each strategy's samples bitwise the sort's, the same
    launches."""
    import numpy as np

    from quiver_tpu_torch import DistHeteroSampler, HeteroCSRTopo, HeteroGraphSampler

    num_nodes, edges = mag_edges(np.random.default_rng(0))
    topo = HeteroCSRTopo(num_nodes, edges)
    seeds = np.random.default_rng(95).integers(0, MAG_PAPERS, RGCN_BATCH)
    outs, launches = {}, {}
    for d in DEDUPS:
        rep = HeteroGraphSampler(topo, RGCN_FANOUT, "paper", seed=0, dedup=d, device="cuda")
        dist = DistHeteroSampler(topo, RGCN_FANOUT, "paper", mesh=logical_mesh(*DIST_MESH),
                                 routed_alpha=DIST_HETERO_ALPHA, seed=0, dedup=d)
        sync()
        reset_launches()
        outs[d] = (rep.sample(seeds), dist.sample(seeds, key=7))
        sync()
        launches[d] = read_launches()
    step9p("(d) typed samples bitwise across sort and map; the same launches")
    for d in DEDUPS[1:]:
        for got, want in zip(outs[d], outs["sort"]):
            check(all(equal(got.n_id[t], want.n_id[t]) for t in want.n_id)
                  and all(equal(la.adjs[et].edge_index, a.edge_index)
                          for la, lb in zip(got.adjs, want.adjs) for et, a in lb.adjs.items()),
                  f"(d) dedup={d!r} typed sample == dedup='sort'")
        check(launches[d] == launches["sort"], f"(d) dedup={d!r} launches {launches[d]}")
    check(launches["sort"]["uniform_hop"] == RGCN_HOPS and launches["sort"]["select"] > 0,
          f"(d) launches {launches['sort']}")
    return launches, {"config": "bench_rgcn.py defaults: the MAG-shaped graph, [8, 4] x 512; "
                                "HeteroGraphSampler and DistHeteroSampler on (1, 4)",
                      "launches": launches}


def dedup_phase(args, topo, x_all, card) -> tuple[dict, dict]:
    """Phase 9p (see the module docstring). Returns ``(launches by part and
    strategy, result)``."""
    import torch

    from quiver_tpu_torch import Feature
    from quiver_tpu_torch.ops.reindex import resolve_dedup

    t0 = time.time()
    step9p("dedup='auto' resolves to 'sort' on the card")
    check(resolve_dedup("auto") == "sort", f"auto dedup {resolve_dedup('auto')!r}")
    dev_topo = topo.to_device("GPU", "cuda", with_weights=True)
    launches, result = {}, {"card": card}
    launches["samplers"], result["samplers"] = dedup_samplers(topo, dev_topo, card)
    n, F = x_all.shape
    store = Feature(device_cache_size=n * F * 4, device="cuda").from_cpu_tensor(x_all)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    try:
        launches["servers"], result["servers"] = dedup_servers(args, topo, dev_topo, store,
                                                               card)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    del dev_topo
    torch.cuda.empty_cache()
    launches["trainer"], result["trainer"] = dedup_trainer(topo, store, card)
    del store
    torch.cuda.empty_cache()
    launches["typed"], result["typed"] = dedup_typed(card)
    result["seconds"] = time.time() - t0
    log(f"phase 9p {result['seconds']:.1f}s [{card}]")
    return launches, result


# -- phase 9q: the layer-wise inference's QUIVER_INFER_AGG switch ------------------

INFER_AGG_VALUES = ("scatter", "scan")  # after one warm-up pass
INFER_CHUNK = 1 << 21  # the SAGE, GCN and GIN passes' default chunk (the plain mean's)
INFER_LAYERS = 2  # the 9q SAGE's layers: one segment_mean launch each
SEGMENT_WIDTHS = (EPOCH_F, EPOCH_HIDDEN)  # the layers' input widths
SEGMENT_BOUND_RULE = (
    "device memory at 3.35 TB/s: each edge's source row read once (F x 4 B) "
    "and its 4 B id, 8 B of indptr per row, each output row written once; "
    "rows drawn again may come from L2, so the kernel can pass this bound"
)


def step9q(what: str) -> None:
    """Name a phase 9q check on stderr before it runs."""
    log(f"phase 9q check: {what}")


@contextlib.contextmanager
def infer_agg(value: str):
    """``QUIVER_INFER_AGG`` set to ``value`` in the block, restored after."""
    old = os.environ.get("QUIVER_INFER_AGG")
    os.environ["QUIVER_INFER_AGG"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QUIVER_INFER_AGG", None)
        else:
            os.environ["QUIVER_INFER_AGG"] = old


def agg_turns(label: str, run, shape: tuple, card) -> tuple[dict, dict]:
    """``run()``, one whole layer-wise pass: a warm-up pass, then one pass
    under each of ``INFER_AGG_VALUES``, each ending in a synchronise,
    timed on the host clock, its peak memory growth read, and its launches
    counted (exactly ``INFER_LAYERS`` ``segment_mean`` launches and nothing
    else). Then the log-probs are finite and of ``shape``, and bitwise the
    same under both values. Returns ``(result, the log-probs by value)``."""
    import torch

    run()
    sync()
    res, out = {}, {}
    for s in INFER_AGG_VALUES:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with infer_agg(s):
            out[s] = run()
        sync()
        secs = time.perf_counter() - t0
        got = read_launches()
        expect_launches(got, {"segment_mean": INFER_LAYERS}, f"{label}, {s} pass")
        res[s] = {"pass_s": secs, "nodes_per_s": shape[0] / secs,
                  "peak_growth_bytes": torch.cuda.max_memory_allocated() - base,
                  "segment_mean_launches": got["segment_mean"],
                  "gather_rows_launches": got["gather_rows"]}
    step9q(f"{label}: finite {shape} log-probs, \"scan\" bitwise \"scatter\"")
    for s, logp in out.items():
        check(tuple(logp.shape) == shape and bool(torch.isfinite(logp).all()),
              f"{label}, {s}: finite {shape} log-probs")
    check(equal(out["scan"], out["scatter"]), f"{label}: \"scan\" bitwise \"scatter\"")
    res["card"] = card
    log(f"{label}: nodes/s {[round(res[s]['nodes_per_s']) for s in INFER_AGG_VALUES]}; "
        f"peak growth {[round(res[s]['peak_growth_bytes'] / 2**30, 3) for s in INFER_AGG_VALUES]}"
        f" GiB ({', '.join(INFER_AGG_VALUES)}) [{card}]")
    return res, out


AGG_PROFILE_PAD_S = 1.0  # idle host time on each side of 9q's profiled pass


def agg_profile(run, pass_s: list) -> dict:
    """One more pass under ``torch.profiler``: the device's busy time (the
    union of its intervals), the idle share against the mean of the
    unprofiled passes (``pass_s``), and the costliest kernels. The profiler
    keeps only the device records it dates inside its window; unpadded, the
    whole smoke's 9q kept no device record of a 0.1-s pass where a fresh
    process kept all of them, so the window opens and closes
    ``AGG_PROFILE_PAD_S`` away from the pass (idle padding adds no busy
    time), and ``device_lead_ms`` reads how far the first device record
    is dated after the pass's first host operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(AGG_PROFILE_PAD_S)
        run()
        sync()
        time.sleep(AGG_PROFILE_PAD_S)
    kernels, _ = device_ms(prof, 1)
    busy = device_union_ms(prof, 1)
    wall_ms = 1e3 * sum(pass_s) / len(pass_s)
    starts = {kind: [e.time_range.start for e in prof.events()
                     if (e.device_type == torch.autograd.DeviceType.CUDA) == kind
                     and not annotation(e)] for kind in (True, False)}
    lead = (min(starts[True]) - min(starts[False])) / 1e3 if all(starts.values()) else None
    check(busy > 0, f"the profiler saw the card: {len(prof.events())} events, device rows "
          f"{ {k[:40]: round(v, 3) for k, v in kernels.items()} }, device lead {lead} ms")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    named = {}
    for k, v in top:  # names cut to 100 characters; sum those that meet
        named[k[:100]] = named.get(k[:100], 0.0) + v
    log(f"(a) SAGE HBM under the profiler: busy {busy:.2f} ms of {wall_ms:.2f}, device "
        f"lead {lead} ms; top {[(k[:60], round(v, 2)) for k, v in top[:4]]}")
    return {"device_busy_ms": busy, "unprofiled_pass_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms, "device_lead_ms": lead,
            "top_kernels_ms": named}


def infer_agg_full_width(topo, x_dev, card) -> dict:
    """(a) SAGE at bench_infer's defaults, HBM and HOST."""
    import functools

    from quiver_tpu_torch.models import inference

    n = topo.node_count
    res = {"config": "benchmarks/bench_infer.py defaults on the serving graph "
                     f"({n} nodes, {topo.edge_count} edges), F=100 f32, hidden 256, "
                     f"47 classes, {INFER_LAYERS} layers"}
    sage = make_family("sage", EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, INFER_LAYERS,
                       dropout=0.0)
    sage = sage.to("cuda").eval()
    outs = {}
    for mode in ("HBM", "HOST"):
        run = functools.partial(inference.sage_layerwise_inference, sage, topo, x_dev,
                                mode=mode, device="cuda")
        res[f"sage_{mode}"], outs[mode] = agg_turns(
            f"(a) SAGE {mode}", run, (n, EPOCH_CLASSES), card)
        if mode == "HBM":
            res["sage_HBM"]["profile"] = agg_profile(
                run, [res["sage_HBM"][s]["pass_s"] for s in INFER_AGG_VALUES])
    step9q("(a) SAGE: HOST bitwise HBM")
    hbm, host = outs["HBM"]["scatter"], outs["HOST"]["scatter"]
    err = float((host - hbm).abs().max()) / float(hbm.abs().max())
    check(equal(host, hbm), f"(a) SAGE: HOST against HBM {err} x max |out|")
    res["sage_host_against_hbm"] = {"err_over_max": err, "bitwise": True}
    return res


def infer_agg_bad_value(card) -> dict:
    """(b) A misspelt ``QUIVER_INFER_AGG`` raises ``ValueError`` from the
    SAGE pass and not from GAT's, on ``small_graphs()``' first graph."""
    import numpy as np
    import torch

    from quiver_tpu_torch.models import inference

    label, st = small_graphs()[0][:2]
    xs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(st.node_count, EPOCH_F)).astype(np.float32)).to("cuda")
    sage = make_family("sage", EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, 2, dropout=0.0)
    gat = make_family("gat", EPOCH_F, EPOCH_HIDDEN, EPOCH_CLASSES, 2, dropout=0.0)
    before = os.environ.get("QUIVER_INFER_AGG")
    step9q("(b) QUIVER_INFER_AGG=scna raises ValueError from the SAGE pass, not from GAT's")
    with infer_agg("scna"):
        try:
            inference.sage_layerwise_inference(sage.to("cuda"), st, xs, device="cuda")
            raised = None
        except ValueError as e:
            raised = str(e)
        logp = inference.gat_layerwise_inference(gat.to("cuda"), st, xs, device="cuda")
    check(raised is not None and "QUIVER_INFER_AGG" in raised,
          f"(b) the SAGE pass under a misspelt value raised {raised!r}")
    check(bool(torch.isfinite(logp).all()), "(b) GAT under a misspelt value: finite")
    check(os.environ.get("QUIVER_INFER_AGG") == before, "(b) the environment is restored")
    return {"bad_value_error": raised, "gat_ran": True, "graph": label, "card": card}


def segment_turns(kernel_fn, plain_fn, warm: int = 1, iters: int = 5) -> dict:
    """Kernel and plain version timed by CUDA events in turns (plain,
    kernel, kernel, plain), each turn the mean of ``iters`` calls after
    ``warm``; each figure the mean of its two turns."""
    import torch

    def turn(fn, n):
        for _ in range(warm):
            fn()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    p1, k1, k2, p2 = (turn(plain_fn, 1), turn(kernel_fn, iters), turn(kernel_fn, iters),
                      turn(plain_fn, 1))
    return {"ms": (k1 + k2) / 2, "ms_turns": [k1, k2], "plain_ms": (p1 + p2) / 2,
            "plain_turns": [p1, p2]}


def segment_phase(topo, x_dev) -> tuple[list, dict]:
    """(c) ``segment_mean`` on the serving graph at the layers' widths:
    bitwise its plain version (ids on the card, and at F = 100 pinned on
    the host too), one launch a call; timed against the plain version, the
    chunked, sorted accumulate the passes ran before the kernel, which is
    the yardstick too (no single PyTorch call takes a CSR segment mean).
    Returns ``(check rows, timing at F = 100 with every width's figures)``."""
    import torch

    from quiver_tpu_torch.core.memory import to_pinned_host
    from quiver_tpu_torch.ops.kernels.segment import segment_mean, segment_mean_plain

    indptr = torch.from_numpy(topo.indptr).to(torch.int64).to("cuda")
    ids = torch.from_numpy(topo.indices).to("cuda")
    pinned_ids = to_pinned_host(topo.indices, "cuda")[0]
    n, E = topo.node_count, topo.edge_count
    g = torch.Generator(device="cuda")
    g.manual_seed(31)
    rows, widths = [], {}
    for F in SEGMENT_WIDTHS:
        table = x_dev if F == x_dev.shape[1] else torch.randn(
            n, F, device="cuda", generator=g)
        want = segment_mean_plain(indptr, ids, table, INFER_CHUNK)
        for where, e in (("device", ids), ("pinned", pinned_ids)):
            if where == "pinned" and F != EPOCH_F:
                continue
            step9q(f"(c) segment_mean at F = {F}, ids {where}: one launch, bitwise plain")
            before = segment_mean.launches
            got = segment_mean(indptr, e, table)
            sync()
            ok = equal(got, want)
            rows.append({"table": f"serving graph, F = {F} f32, ids {where}",
                         "rows": n, "edges": E, "match": ok,
                         "max_abs_err": float((got - want).abs().max())})
            check(ok and segment_mean.launches == before + 1,
                  f"(c) segment_mean at F = {F}, ids {where} against plain")
            del got
        del want
        t = segment_turns(lambda: segment_mean(indptr, ids, table),
                          lambda: segment_mean_plain(indptr, ids, table, INFER_CHUNK))
        t["bound_ms"] = (E * (F * 4 + 4) + (n + 1) * 8 + n * F * 4) / 3.35e12 * 1e3
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["speedup_over_plain"] = t["plain_ms"] / t["ms"]
        widths[F] = t
        log(f"(c) segment_mean F = {F}: {t['ms']:.3f} ms against plain {t['plain_ms']:.1f} "
            f"ms, bound {t['bound_ms']:.2f} ms ({t['bound_share']:.3f})")
        del table
        torch.cuda.empty_cache()
    timing = dict(widths[EPOCH_F], shape=[n, E, EPOCH_F], library_ms=None,
                  widths={str(F): t for F, t in widths.items()})
    return rows, timing


def infer_agg_phase(topo, x_all, card) -> tuple[dict, list, dict, dict]:
    """Phase 9q (see the module docstring). Returns ``(segment_mean
    launches of a HOST SAGE pass by value, its check rows, its timing,
    result)``."""
    import torch

    t0 = time.time()
    x_dev = torch.from_numpy(x_all).to("cuda")
    result = infer_agg_full_width(topo, x_dev, card)
    result["bad_value"] = infer_agg_bad_value(card)
    checks, timing = segment_phase(topo, x_dev)
    result["segment_mean"] = timing
    del x_dev
    torch.cuda.empty_cache()
    result["seconds"] = time.time() - t0
    log(f"phase 9q {result['seconds']:.1f}s [{card}]")
    launches = {s: result["sage_HOST"][s]["segment_mean_launches"] for s in INFER_AGG_VALUES}
    return launches, checks, timing, result


# -- phase 9r: one process over distinct devices (the card and the host) ---------

MIXED_STEPS = 4  # checked steps of each run, under deterministic kernels
MIXED_TIMED = 2  # steps a turn of the figures (turns: mixed, one-card, one-card, mixed)
MIXED_DRAW_SEED = 27  # the numpy seed every step's draws come from
CARD, HOST = "cuda:0", "cpu"
MIXED_MESHES = {(2, 1): [CARD, HOST], (1, 2): [CARD, HOST],
                (2, 2): [CARD, HOST, CARD, HOST]}
# (name, store, dtype, seed sharding, topology sharding, weighted, meshes)
MIXED_CASES = (
    ("replicated f32", "replicated", None, "all", "replicated", False,
     ((2, 1), (1, 2), (2, 2))),
    ("psum int8", "sharded", "int8", "data", "replicated", False, ((1, 2), (2, 2))),
    ("routed f32", "sharded", None, "all", "replicated", False, ((1, 2), (2, 2))),
    ("topology weighted", "sharded", None, "all", "mesh", True, ((1, 2), (2, 2))),
)
# the float tolerance, stated before the first run: each step's loss within
# 1e-4 relative of the one-card twin's, and over all the parameters
# ||p_mixed - p_card|| at most 1e-2 x ||p_card - p_0|| (the host's GEMMs
# and reductions round differently from the card's; Adam can turn a
# near-zero gradient's sign, so single elements are not bounded tighter)
MIXED_LOSS_RTOL = 1e-4
MIXED_PARAM_RATIO = 1e-2
MIXED_ELASTIC_STEPS = 4  # the resumed drill's epoch; preempted at step 2
MIXED_TUNED_STEPS = 2  # tuned steps after the resumed epoch


def step9r(what: str) -> None:
    """Name a phase 9r check on stderr before it runs."""
    log(f"phase 9r check: {what}")


def mixed_mesh(shape, devices=None):
    """The ``shape`` mesh over ``devices`` (default the card repeated)."""
    from quiver_tpu_torch import make_mesh

    data, feature = shape
    return make_mesh(data=data, feature=feature, devices=devices or [CARD] * (data * feature))


def mixed_draws(weighted: bool):
    """``draw_fn(key, worker, layer, deg)`` of every 9r trainer: numpy
    draws from ``(MIXED_DRAW_SEED, key, worker, layer)``, so a host slot
    draws what a card slot draws (a card's Philox stream has no host
    twin): stratified row-local offsets (uniform; every lane of a row of
    degree at most k), or ``u01`` in [0, 1) (weighted)."""
    import numpy as np
    import torch

    def draw(key, w, layer, deg):
        rng = np.random.default_rng([MIXED_DRAW_SEED, int(key) & (2**64 - 1), int(w), layer])
        k = MULTI_FANOUT[layer]
        d = deg.cpu().numpy().astype(np.int64)[:, None]
        if weighted:
            return torch.from_numpy(rng.random((d.shape[0], k), dtype=np.float32))
        i = np.arange(k)[None, :]
        strata = np.floor(d * (i + rng.random((d.shape[0], k))) / k).astype(np.int64)
        off = np.where(d > k, np.minimum(strata, d - 1), np.minimum(i, np.maximum(d - 1, 0)))
        return torch.from_numpy(off.astype(np.int32))

    return draw


def mixed_setup():
    """Phase 9f (b)'s graph, rows and labels, with phase 9n's exp(N(0, 1))
    edge weights for the weighted sampler."""
    import numpy as np

    topo, x, labels = multichip_setup()
    topo.set_edge_weight(np.exp(np.random.default_rng(WORLD_TOPO_WEIGHTS).normal(
        size=topo.edge_count)).astype(np.float32))
    return topo, x, labels


def mixed_trainer(topo, x, mesh, case, **kw):
    """A 9r ``DistributedTrainer`` on ``mesh``: 9f (b)'s width (GraphSAGE
    256 x 3, Adam 1e-3, [15, 10, 5] x 256, worst-case caps), dropout 0 (a
    host slot's dropout stream cannot replay the card's), the guard on,
    every kernel asked for (``"pallas"``), over a ``Feature`` with 20% of
    the rows on the lead device or a three-tier ``ShardedFeature`` of 8M L1
    and 4M L0 per device; the numpy draws; ``init(0)``."""
    import torch

    from quiver_tpu_torch import (DistributedTrainer, Feature, GraphSageSampler, GraphSAGE,
                                  ShardedFeature)

    _name, store_kind, dtype, seed_sharding, topo_sharding, weighted, _ = case
    lead = mesh.devices.flat[0]
    if store_kind == "replicated":
        store = Feature(device_cache_size=int(0.2 * topo.node_count) * MULTI_F * 4,
                        csr_topo=topo, device=lead, kernel="pallas").from_cpu_tensor(x)
    else:
        store = ShardedFeature(mesh, device_cache_size=MULTI_L1, csr_topo=topo,
                               replicate_budget=MULTI_L0, dtype=dtype,
                               kernel="pallas").from_cpu_tensor(x)
    where = ({"topo_sharding": "mesh", "mesh": mesh} if topo_sharding == "mesh"
             else {"device": lead})
    sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, weighted=weighted,
                               kernel="pallas", **where)
    model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES,
                      num_layers=len(MULTI_FANOUT), dropout=0.0).to(lead)
    trainer = DistributedTrainer(mesh, sampler, store, model,
                                 torch.optim.Adam(model.parameters(), lr=1e-3),
                                 local_batch=MULTI_BATCH, seed_sharding=seed_sharding,
                                 nonfinite_guard=True, **kw)
    trainer.init(0)
    trainer.draw_fn = mixed_draws(weighted)
    return trainer


def mixed_expected(trainer, steps: int) -> dict:
    """The card's launches of ``steps`` steps of a 9r trainer, by where
    each runs: a worker's composed hops (``select``, or ``wselect``
    weighted) and its replicated lookup (one K2) on its slot's device; a
    topology-sharded group's hops one launch per owner on a card per hop;
    a sharded lookup's L0, cold and int8 dequantising launches on the
    device it runs on (a worker's under ``"data"``, its group's first
    member's when routed), one ``gather_rows`` per shard on a card. Launches
    on the host are none: a wrapper given host tensors runs its plain
    version and counts nothing."""
    import collections

    import torch

    from quiver_tpu_torch.parallel.mesh import FEATURE_AXIS, axis_devices

    def card(d):
        return torch.device(d).type == "cuda"

    store, L = trainer.feature, len(MULTI_FANOUT)
    hop = "wselect" if trainer.sampler.weighted else "select"
    int8 = getattr(store, "storage_dtype", None) == torch.int8
    owners = sum(card(d) for d in axis_devices(trainer.mesh, FEATURE_AXIS))
    workers = [trainer._worker_device(w) for w in range(trainer.workers)]
    groups = ([trainer._worker_device(m[0]) for m in trainer._group_members()]
              if trainer.seed_sharding == "all" else [])
    want = collections.Counter()
    if trainer.topo_sharded:
        want[hop] += L * owners * len(groups)
    else:
        want[hop] += L * sum(card(d) for d in workers)
    if not trainer._sharded:
        want["tiered_gather_dequant" if int8 else "tiered_gather"] += sum(
            card(d) for d in workers)
    else:
        tier = "tiered_gather_dequant" if int8 else "gather_rows"
        for dev in (groups if trainer._routed else workers):
            want[tier] += card(dev) * (bool(store.rep_rows) + (store.cold is not None))
            if store.hot_rows:
                want["gather_rows"] += owners
                want["tiered_gather_dequant"] += card(dev) * int8
    return {k: v * steps for k, v in want.items() if v}


def mixed_blocks(trainer, into: list):
    """Make ``trainer`` append, for each step it issues, each worker's
    block as host copies (ids, frontier size, rows, edge lists, valid
    seeds) and whether its tensors lie on its slot's device."""
    import torch

    issue = trainer._issue

    def recording(*a, **kw):
        step = issue(*a, **kw)
        rows = []
        for w, b in enumerate(step.blocks):
            dev = torch.device(trainer._worker_device(w))
            tensors = [b.n_id, b.x, b.num_seeds] + [a.edge_index for a in b.adjs]
            rows.append({"n_id": b.n_id.cpu(), "frontier": int((b.n_id >= 0).sum()),
                         "x": b.x.cpu(), "edges": [a.edge_index.cpu() for a in b.adjs],
                         "num": int(b.num_seeds), "placed": all(t.device == dev
                                                                for t in tensors)})
        into.append(rows)
        return step

    trainer._issue = recording


def mixed_steps(trainer, labels, steps: int, key0: int) -> list:
    """``steps`` steps on ``default_rng(key0)``'s seeds, keyed ``key0 +
    i``: each step's loss and its integer outputs, read on the host."""
    import numpy as np

    rng = np.random.default_rng(key0)
    n = trainer.sampler.csr_topo.node_count
    out = []
    for i in range(steps):
        loss = trainer.step(rng.integers(0, n, trainer.global_batch), labels, key0 + i)
        out.append(mixed_outputs(trainer, loss))
    return out


def mixed_outputs(trainer, loss) -> dict:
    """One step's (or epoch's) loss and integer outputs, on the host."""
    from quiver_tpu_torch.obs.registry import GUARD_NONFINITE, GUARD_SKIPPED

    m = trainer.metrics
    return {"loss": loss.cpu(), "hits": trainer.last_tier_hits.cpu(),
            "routed_overflow": trainer.last_routed_overflow.cpu(),
            "sample_overflow": trainer.last_sample_overflow.cpu(),
            "guard": [m.value(GUARD_SKIPPED).cpu(), m.value(GUARD_NONFINITE).cpu()]}


def same_ints(a: list, b: list) -> bool:
    """The integer outputs of two runs' steps bitwise (loss apart)."""
    return len(a) == len(b) and all(
        equal(x[k], y[k]) for x, y in zip(a, b)
        for k in ("hits", "routed_overflow", "sample_overflow")) and all(
        equal(p, q) for x, y in zip(a, b) for p, q in zip(x["guard"], y["guard"]))


def same_blocks(a: list, b: list) -> bool:
    """Two runs' recorded blocks bitwise: ids, frontier sizes, rows, edge
    lists and valid seeds, step by step and worker by worker."""
    return len(a) == len(b) and all(
        len(s) == len(t) and all(
            x["frontier"] == y["frontier"] and x["num"] == y["num"]
            and equal(x["n_id"], y["n_id"]) and equal(x["x"], y["x"])
            and len(x["edges"]) == len(y["edges"])
            and all(equal(e, f) for e, f in zip(x["edges"], y["edges"]))
            for x, y in zip(s, t))
        for s, t in zip(a, b))


def close_floats(losses, want, params, want_params, params0) -> dict:
    """The float outputs against the one-card run's: the largest relative
    loss difference and the parameters' distance over their update
    (``||p - p_card|| / ||p_card - p_0||`` over every parameter), each with
    whether it is within 9r's tolerance."""
    import torch

    rel = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
              for a, b in zip(losses, want))
    flat = lambda d: torch.cat([v.double().reshape(-1).cpu() for v in d.values()])  # noqa: E731
    p, q, p0 = flat(params), flat(want_params), flat(params0)
    ratio = float((p - q).norm() / max(float((q - p0).norm()), 1e-30))
    return {"loss_rel": rel, "param_ratio": ratio, "param_max_abs": float((p - q).abs().max()),
            "ok": rel <= MIXED_LOSS_RTOL and ratio <= MIXED_PARAM_RATIO}


def host_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def mixed_case_mesh(topo, x, labels, case, shape, card) -> tuple[dict, dict, tuple]:
    """(a) One configuration on one mixed mesh and on the one-card mesh of
    its shape: ``MIXED_STEPS`` steps each under deterministic kernels, the
    blocks, tier hits, overflows and guard counters bitwise, every worker's
    tensors on its slot's device, the card's launches exact (the one-card
    run's by the same rule), the floats within tolerance. Returns ``(the
    mixed run's launches, result, (mixed trainer, one-card trainer))``."""
    name = case[0]
    what = f"{name} on {shape} over {MIXED_MESHES[shape]}"
    runs, blocks, launches, params, params0, trainers = {}, {}, {}, {}, {}, {}
    with deterministic_algorithms():
        for form, devices in (("card", None), ("mixed", MIXED_MESHES[shape])):
            trainer = mixed_trainer(topo, x, mixed_mesh(shape, devices), case)
            params0[form] = host_state(trainer.model)
            blocks[form] = []
            mixed_blocks(trainer, blocks[form])
            reset_launches()
            runs[form] = mixed_steps(trainer, labels, MIXED_STEPS, 300)
            sync()
            launches[form] = read_launches()
            params[form] = host_state(trainer.model)
            trainers[form] = trainer
    step9r(f"{what}: sampled ids, frontier sizes, gathered rows, tier hits, overflow and "
           "guard counters bitwise the one-card mesh's")
    check(same_blocks(blocks["mixed"], blocks["card"])
          and same_ints(runs["mixed"], runs["card"]), f"{what}: integer outputs")
    step9r(f"{what}: every worker's ids, rows, edges and seeds on its slot's device")
    check(all(r["placed"] for s in blocks["mixed"] for r in s), f"{what}: placement")
    for form in ("card", "mixed"):
        want = mixed_expected(trainers[form], MIXED_STEPS)
        step9r(f"{what}: the {form} run's card launches exactly {want}")
        expect_launches(launches[form], want, f"{what} ({form})")
    for trainer in trainers.values():
        del trainer._issue  # the recording: the figures time the main path
    step9r(f"{what}: losses within {MIXED_LOSS_RTOL} relative, parameters within "
           f"{MIXED_PARAM_RATIO} of their update")
    floats = close_floats([r["loss"] for r in runs["mixed"]], [r["loss"] for r in runs["card"]],
                          params["mixed"], params["card"], params0["card"])
    check(floats["ok"], f"{what}: floats {floats}")
    check(params0["mixed"].keys() == params0["card"].keys()
          and all(equal(params0["mixed"][k], v) for k, v in params0["card"].items()),
          f"{what}: the same initial parameters")
    replicas = sorted(str(d) for d in trainers["mixed"]._replicas.copies)
    log(f"{what}: loss rel {floats['loss_rel']:.3g}, parameters {floats['param_ratio']:.3g} "
        f"of their update (max |d| {floats['param_max_abs']:.3g}); card launches "
        f"{launches['mixed']} against the one-card {launches['card']}; replicas {replicas}")
    return launches["mixed"], {
        "losses": [float(r["loss"]) for r in runs["mixed"]],
        "card_losses": [float(r["loss"]) for r in runs["card"]],
        "launches": launches["mixed"], "card_launches": launches["card"],
        "floats": floats, "replicas": replicas,
        "workers": [str(trainers["mixed"]._worker_device(w))
                    for w in range(trainers["mixed"].workers)]}, (
        trainers["mixed"], trainers["card"])


def mixed_turns(trainers, labels, card) -> dict:
    """Steps/s of a mixed mesh and its one-card twin, in turns (mixed,
    one-card, one-card, mixed), each turn ``MIXED_TIMED`` synchronised
    steps of the main path (kernels as they come)."""
    turns = {"mixed": [], "card": []}
    for form, trainer in (("mixed", trainers[0]), ("card", trainers[1]),
                          ("card", trainers[1]), ("mixed", trainers[0])):
        sync()
        t0 = time.perf_counter()
        mixed_steps(trainer, labels, MIXED_TIMED, 400)
        sync()
        turns[form].append(MIXED_TIMED / (time.perf_counter() - t0))
    return {f"{form}_steps_per_s": sum(v) / len(v) for form, v in turns.items()} | {
        "turns_steps_per_s": turns, "card": card}


def mixed_dp(topo, x, labels, card) -> tuple[dict, dict]:
    """(b) ``DataParallelTrainer`` on ``(2, 1)`` over the card and the
    host and on the one-card ``(2, 1)``: a 4-step epoch each under its
    ``Prefetcher`` (depth 2, a side stream for the card's slot only) and
    deterministic kernels, one ``Feature`` (20% on the card) and the numpy
    draws by the sampler's call number: the batches bitwise, placed on
    their slots, the card's launches exact (3 ``select`` and 1
    ``tiered_gather`` a card block), the floats within tolerance."""
    import torch

    from quiver_tpu_torch import DataParallelTrainer, Feature, GraphSageSampler, GraphSAGE

    draws = mixed_draws(False)
    out, blocks, launches, params, params0 = {}, {}, {}, {}, {}
    with deterministic_algorithms():
        for form, devices in (("card", None), ("mixed", MIXED_MESHES[(2, 1)])):
            mesh = mixed_mesh((2, 1), devices)
            feature = Feature(device_cache_size=int(0.2 * topo.node_count) * MULTI_F * 4,
                              csr_topo=topo, device=CARD, kernel="pallas").from_cpu_tensor(x)
            sampler = GraphSageSampler(topo, MULTI_FANOUT, seed=0, device=CARD,
                                       kernel="pallas")
            model = GraphSAGE(MULTI_F, MULTI_HIDDEN, MULTI_CLASSES,
                              num_layers=len(MULTI_FANOUT), dropout=0.0).to(CARD)
            trainer = DataParallelTrainer(mesh, sampler, feature, model,
                                          torch.optim.Adam(model.parameters(), lr=1e-3),
                                          local_batch=MULTI_BATCH)
            trainer.init(torch.Generator().manual_seed(0))
            params0[form] = host_state(model)
            trainer.draw_fn = lambda call, layer, deg: draws(call, 0, layer, deg)
            blocks[form], step = [], trainer.step

            def recording(batches, *a, into=blocks[form], tr=trainer, step=step):
                into.append([{"n_id": b.out.n_id.cpu(), "frontier": int((b.out.n_id >= 0).sum()),
                              "x": b.x.cpu(), "edges": [e.edge_index.cpu() for e in b.out.adjs],
                              "num": int(b.out.batch_size),
                              "placed": all(t.device == torch.device(tr.mesh.devices[w, 0])
                                            for t in (b.out.n_id, b.x))}
                             for w, b in enumerate(batches)])
                return step(batches, *a)

            trainer.step = recording
            reset_launches()
            out[form] = trainer.train_epoch(torch.arange(4 * 2 * MULTI_BATCH).numpy(), labels,
                                            torch.Generator().manual_seed(7), depth=2)
            sync()
            launches[form] = read_launches()
            params[form] = host_state(model)
    steps = out["mixed"][1]
    step9r("(b) DataParallelTrainer (2, 1) over the card and the host: the epoch's batches "
           "bitwise the one-card mesh's, each on its slot's device")
    check(steps == 4 and same_blocks(blocks["mixed"], blocks["card"])
          and all(r["placed"] for s in blocks["mixed"] for r in s), "mixed DataParallelTrainer")
    for form, card_blocks in (("card", 2 * steps), ("mixed", steps)):
        want = {"select": len(MULTI_FANOUT) * card_blocks, "tiered_gather": card_blocks}
        step9r(f"(b) the {form} epoch's card launches exactly {want}")
        expect_launches(launches[form], want, f"mixed DataParallelTrainer ({form})")
    floats = close_floats([out["mixed"][0]], [out["card"][0]], params["mixed"], params["card"],
                          params0["card"])
    step9r("(b) the mean loss and the parameters within tolerance")
    check(floats["ok"], f"mixed DataParallelTrainer: floats {floats}")
    log(f"mixed DataParallelTrainer: {steps} steps, mean loss {out['mixed'][0]:.6f} "
        f"(one-card {out['card'][0]:.6f}), parameters {floats['param_ratio']:.3g} of their "
        f"update [{card}]")
    return launches["mixed"], {"steps": steps, "mean_loss": out["mixed"][0],
                               "card_mean_loss": out["card"][0], "floats": floats,
                               "launches": launches["mixed"],
                               "card_launches": launches["card"]}


def mixed_elastic_trainer(topo, x, mesh, ckpt=None, plan=None):
    """(c)'s trainer: 4 logical workers under ``"all"`` over a routed f32
    three-tier store with ``auto_alpha`` and an attached
    ``CacheController`` (``routed_alpha`` 0.5, so the tuner has overflow to
    read), the replicated sampler; checkpoints every 2 steps."""
    from quiver_tpu_torch import CacheController

    kw = {"logical_workers": 4, "auto_alpha": True, "controller": CacheController(),
          "routed_alpha": 0.5, "fault_plan": plan}
    if ckpt is not None:
        kw.update(checkpoint_dir=ckpt, checkpoint_every=2)
    return mixed_trainer(topo, x, mesh, MIXED_CASES[2], **kw)


def mixed_decisions(trainer) -> tuple:
    """The tuners' state a decision leaves: the routed budget, the L0/L1
    boundary and the store's version (one bump per repin)."""
    return (trainer.routed_alpha, trainer.feature.rep_rows, trainer.feature.version)


def mixed_elastic(topo, x, labels, card) -> tuple[dict, dict]:
    """(c) An elastic run checkpointed on the one-card ``(1, 4)`` and
    resumed with ``resume(mesh=)`` onto ``(2, 2)`` over the card and the
    host, against its one-card twin resumed onto the one-card ``(2, 2)``
    and the uninterrupted one-card ``(2, 2)`` epoch, under deterministic
    kernels: the resumed steps' blocks and integer outputs bitwise the
    uninterrupted run's, the floats within tolerance; then the tuners'
    decisions (the epoch's end, ``MIXED_TUNED_STEPS`` tuned steps) equal
    the twin's. Returns ``(the mixed tail's launches, result)``."""
    import torch

    from quiver_tpu_torch import Preemption
    from quiver_tpu_torch.resilience.faults import FaultPlan

    steps, stop = MIXED_ELASTIC_STEPS, 2
    out, blocks, decisions, launches = {}, {}, {}, {}
    with deterministic_algorithms():
        ref = mixed_elastic_trainer(topo, x, mixed_mesh((2, 2)))
        seed_mat = ref.pack_epoch(torch.arange(steps * ref.global_batch).numpy(), seed=3)
        blocks["uninterrupted"] = []
        mixed_blocks(ref, blocks["uninterrupted"])
        losses = ref.epoch_scan(seed_mat, labels, 31)
        out["uninterrupted"] = (losses.cpu(), ref.last_tier_hits.cpu(),
                                ref.last_routed_overflow.cpu(), host_state(ref.model))
        del ref
        params0 = None
        for form, devices in (("card", None), ("mixed", MIXED_MESHES[(2, 2)])):
            ckpt = os.path.join(SCRATCH, f"elastic_{form}")
            trainer = mixed_elastic_trainer(topo, x, mixed_mesh((1, 4)), ckpt,
                                            FaultPlan(preempt_at_step=stop))
            params0 = params0 or host_state(trainer.model)
            try:
                trainer.epoch_scan(seed_mat, labels, 31)
                raise AssertionError("the planned preemption did not fire")
            except Preemption:
                pass
            t0 = time.time()
            _, _, key, step, epoch = trainer.resume(mesh=mixed_mesh((2, 2), devices))
            resume_s = time.time() - t0
            check((key, step) == (31, stop), f"(c) {form}: resumed at {(key, step)}")
            blocks[form] = []
            mixed_blocks(trainer, blocks[form])
            reset_launches()
            tail = trainer.epoch_scan(seed_mat, labels, key, epoch=epoch, start_step=step)
            sync()
            launches[form] = read_launches()
            out[form] = (tail.cpu(), trainer.last_tier_hits.cpu(),
                         trainer.last_routed_overflow.cpu(), host_state(trainer.model))
            del trainer._issue
            # the epoch's end (a possible repin), then each tuned step's
            # decisions (made before it) and the counts it leaves
            decisions[form] = [mixed_decisions(trainer)]
            for i in range(MIXED_TUNED_STEPS):
                (s,) = mixed_steps(trainer, labels, 1, 500 + i)
                decisions[form].append(mixed_decisions(trainer) + (
                    int(s["routed_overflow"]), s["hits"].tolist()))
            out[form] += (resume_s,)
    u, m, c = out["uninterrupted"], out["mixed"], out["card"]
    # the tiers keep the degree order of the (1, 4) placement (its L1 span
    # shuffled over (1, 4)'s device rows) and the routed budget is the one
    # the tuner chose at the resume, so the hits and the overflow are held
    # to the one-card twin's
    step9r("(c) the resumed steps' ids, frontier sizes and rows bitwise the uninterrupted "
           "one-card (2, 2) epoch's, the tier hits and routed overflow the one-card twin's, "
           "each block on its slot's device")
    check(same_blocks(blocks["mixed"], blocks["uninterrupted"][stop:])
          and same_blocks(blocks["card"], blocks["uninterrupted"][stop:])
          and equal(m[1], c[1]) and equal(m[2], c[2])
          and all(r["placed"] for s in blocks["mixed"] for r in s), "(c) elastic integers")
    step9r("(c) the resumed losses and parameters within tolerance of the uninterrupted run")
    floats = close_floats(m[0].tolist(), u[0][stop:].tolist(), m[3], u[3], params0)
    check(floats["ok"], f"(c) elastic floats {floats}")
    step9r("(c) the tuners (controller, auto_alpha) decide the same on the mixed mesh as on "
           "the one-card twin: alpha, the L0 boundary, repins, every tuned step's overflow "
           "and hits")
    check(decisions["mixed"] == decisions["card"], f"(c) decisions {decisions}")
    log(f"(c) elastic resume onto {MIXED_MESHES[(2, 2)]}: tail losses {m[0].tolist()}, "
        f"resume {m[4]:.2f} s (one-card {c[4]:.2f} s), decisions {decisions['mixed']}, "
        f"floats {floats} [{card}]")
    return launches["mixed"], {
        "tail_losses": m[0].tolist(), "uninterrupted_losses": u[0].tolist(),
        "floats": floats, "decisions": decisions["mixed"], "resume_s": m[4],
        "card_resume_s": c[4], "launches": launches["mixed"],
        "card_launches": launches["card"]}


def mixed_two_cards(topo, x, labels, card) -> dict:
    """(d) Where the machine has two cards: (a)'s routed f32 store on
    ``(2, 2)`` over ``cuda:0`` and ``cuda:1``, the trainer's own draws,
    under deterministic kernels: losses, integer outputs and parameters
    bitwise the one-card mesh's."""
    import torch

    if torch.cuda.device_count() < 2:
        log("9r (d): not run, 1 card")
        return {"ran": False, "reason": f"{torch.cuda.device_count()} card"}
    two = ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    runs, params = {}, {}
    with deterministic_algorithms():
        for form, devices in (("card", None), ("two", two)):
            trainer = mixed_trainer(topo, x, mixed_mesh((2, 2), devices), MIXED_CASES[2])
            trainer.draw_fn = None
            runs[form] = mixed_steps(trainer, labels, MIXED_STEPS, 300)
            params[form] = host_state(trainer.model)
    step9r("(d) two cards: every output bitwise the one-card logical mesh's")
    check(same_ints(runs["two"], runs["card"])
          and all(equal(a["loss"], b["loss"]) for a, b in zip(runs["two"], runs["card"]))
          and all(equal(params["two"][k], v) for k, v in params["card"].items()),
          "(d) two cards")
    return {"ran": True, "losses": [float(r["loss"]) for r in runs["two"]], "card": card}


def multi_device_phase(card):
    """Phase 9r (see the module docstring). Returns ``(the card's launches
    of the mixed runs by check, result)``."""
    import torch

    t0 = time.time()
    topo, x, labels = mixed_setup()
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    launches, cases, figures = {}, {}, {}
    try:
        for case in MIXED_CASES:
            for shape in case[6]:
                label = f"{case[0]} {shape}"
                launches[label], cases[label], pair = mixed_case_mesh(
                    topo, x, labels, case, shape, card)
                figures[label] = mixed_turns(pair, labels, card)
                log(f"{label} over {MIXED_MESHES[shape]}: "
                    f"{figures[label]['mixed_steps_per_s']:.4g} steps/s, one-card "
                    f"{figures[label]['card_steps_per_s']:.4g} steps/s (in turns) [{card}]")
                del pair
                torch.cuda.empty_cache()
        launches["dp"], dp = mixed_dp(topo, x, labels, card)
        torch.cuda.empty_cache()
        launches["elastic"], elastic = mixed_elastic(topo, x, labels, card)
        torch.cuda.empty_cache()
        two = mixed_two_cards(topo, x, labels, card)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    del x
    result = {
        "config": "phase 9f (b)'s: examples/train_multichip.py defaults (100,000 nodes, "
                  "degree 25, F = 128, GraphSAGE 256 x 3, [15, 10, 5] x 256, Adam 1e-3, "
                  "the worst-case caps), a Feature with 20% of the rows on the lead device "
                  "or 8M L1 and 4M L0 per device, the guard on, numpy draws; logical meshes "
                  "over the card and the host against the one-card meshes of their shapes",
        "tolerance": {"loss_rtol": MIXED_LOSS_RTOL, "param_ratio": MIXED_PARAM_RATIO},
        "trainer": cases, "figures": figures, "data_parallel": dp, "elastic": elastic,
        "two_cards": two, "not_run_here": (
            [] if two["ran"] else ["two cards in one process (9r (d))",
                                   "NVLink peer copies", "an nccl world of more than one rank"]),
        "card": card, "seconds": time.time() - t0}
    log(f"phase 9r {result['seconds']:.1f}s [{card}]")
    return launches, result


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
    # phase 2b: the port's static lint over the shipped tree, on this
    # Python (stdlib ast; it imports nothing it lints); a finding fails
    from quiver_tpu_torch.tools.lint import lint_paths

    t0 = time.time()
    lint = lint_paths([pkg, os.path.join(HERE, "chip_smoke.py"),
                       *sorted(glob.glob(os.path.join(HERE, "examples", "*_torch.py")))])
    lint_s = time.time() - t0
    check(not lint.findings, "graftlint: " + "; ".join(
        f"{f.path}:{f.line}: {f.rule}" for f in lint.findings))
    lint_row = {"files": len(lint.files), "findings": 0, "suppressed": len(lint.suppressed),
                "annotations": len(lint.annotations), "seconds": lint_s}
    log(f"graftlint: {len(lint.files)} files clean ({len(lint.suppressed)} suppressed) "
        f"in {lint_s:.1f}s")
    # phase 2c: the program audit over the registry's recorded programs
    audit = audit_phase(card)
    # the native host library (CSR builds; phase 9k requires it)
    from quiver_tpu_torch import native

    t0 = time.time()
    host_ok = native.available
    host_build_s = time.time() - t0
    log(f"native host library: available {host_ok}, {host_build_s:.1f}s, "
        f"{native.num_threads()} threads")

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
    t_cold = cold_rates(feat_q, feat_cold, 65_536, pcie, rng)
    log(f"cold rows over UVA, 65,536 ids: int8 {t_cold['int8_cold_bytes_per_s'] / 1e9:.4g} "
        f"GB/s, f32 {t_cold['f32_cold_bytes_per_s'] / 1e9:.4g} GB/s, pinned copy "
        f"{pcie / 1e9:.4g} GB/s")
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
    t_q_serve = time_lookup(feat_q, look_ids, pcie, 200, 7)
    log(f"int8 serving lookup, 384 ids: {t_q_serve['ms']:.4f} ms (staged lookup in torch "
        f"ops {t_q_serve['yard_ms']:.4f}, bound {t_q_serve['bound_ms']:.4f})")
    del feat_q
    lap("int8 serving")

    # phases 6 and 7: sampler entry points
    samp_u = sampler_phase(topo, card, weighted=False)
    log(f"uniform sampler: {samp_u['edges_per_s']:.4g} sampled edges/s")
    samp_w = sampler_phase(topo, card, weighted=True)
    log(f"weighted sampler: {samp_w['edges_per_s']:.4g} sampled edges/s")
    samp_t, topo_t = sampler_temporal_phase(topo, args, card)
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
    epoch, epoch_feat, epoch_labels = epoch_phase(topo, card)
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
    # phase 9e: the fused trainer (DistributedTrainer) over phase 9b's
    # store: bench_epoch --fused's steps, the 64-step epoch at depth 0 and
    # 1, the guard and preemption drills, its kernels against their plain
    # versions and its step against the CPU's
    launches_f, k1_rows_f, k2_rows_f, fused = fused_phase(topo, epoch_feat, epoch_labels,
                                                          card)
    torch.cuda.empty_cache()
    lap("phase 9e (fused trainer)")
    # phase 9f: the mesh-sharded store on logical meshes of this card, then
    # DistributedTrainer over it at train_multichip's width, and the twin
    launches_s, k1_rows_s, k2_rows_s, sharded = sharded_phase(topo, epoch_feat, pcie, card)
    del epoch_feat, epoch_labels
    torch.cuda.empty_cache()
    lap("phase 9f (sharded store)")
    # phase 9g: the topology partitioned over logical meshes of this card,
    # the distributed samplers (homogeneous and typed) and
    # DistributedTrainer over a topology-sharded sampler
    launches_g, rows_g, dist = dist_phase(topo, topo_t, card)
    del topo_t
    torch.cuda.empty_cache()
    lap("phase 9g (distributed sampling)")
    # phase 9h: the sharded store's int8 tiers, repin, row updates and the
    # controller, then DistributedTrainer(auto_alpha=, controller=) over an
    # int8 auto_split store
    launches_c, rows_c, control = control_phase(topo, pcie, card)
    torch.cuda.empty_cache()
    lap("phase 9h (int8 sharded store, controller)")
    # phase 9i: elastic resume across logical mesh shapes, (1, 4) -> (1, 2)
    # -> (1, 1), at train_multichip's width
    launches_e, elastic = elastic_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9i (elastic resume)")
    # phase 9j: the out-of-core epoch at benchmarks/ooc_drill.py's defaults
    launches_j, rows_j, ooc = ooc_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9j (out-of-core epoch)")
    # phase 9k: streaming mutation under the topology-sharded trainer (the
    # mutate drill, the epoch differential and its crash twin), then the
    # native CSR build at the products-shaped graph
    launches_k, stream = stream_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9k (streaming mutation, native CSR build)")
    # phase 9m: the trainers over a world of one process (nccl) against the
    # logical (1, 1) mesh, then a 2-rank nccl world tried on the one card
    launches_m, world_res = world_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9m (a world of processes)")
    # phase 9n: the topology-sharded trainer, DistHeteroSampler and the
    # elastic resume over a world of one process (nccl) against the logical
    # meshes, the resume across two successive worlds
    launches_n, rows_n, world_topo = world_topo_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9n (topology-sharded world, checkpoints, elastic resume)")
    # phase 9o: the controller, auto_alpha, the split tuner, the epoch's
    # repin and a commit of row updates over a world of one process (nccl)
    # against the logical (1, 1) mesh, both seed shardings
    launches_ctl, rows_ctl, world_ctl = world_control_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9o (the adaptive tuners over a world)")
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
    # phase 9p: the reindex's sort and map strategies on the serving
    # graph: the samplers, the captured ladder, the (1, 4) trainer and the
    # typed samplers, bitwise across the strategies, each reindex timed
    launches_p, dedup = dedup_phase(args, topo, x_all, card)
    torch.cuda.empty_cache()
    lap("phase 9p (dedup strategies)")
    # phase 9q: the layer-wise inference's QUIVER_INFER_AGG switch, SAGE HBM
    # and HOST at full width under both values, a misspelt value
    launches_agg, agg_checks, t_seg, infer_aggs = infer_agg_phase(topo, x_all, card)
    torch.cuda.empty_cache()
    lap("phase 9q (layer-wise aggregation switch)")
    # phase 9r: one process over distinct devices: both trainers on logical
    # meshes of the card and the host against the one-card meshes
    launches_r, multi = multi_device_phase(card)
    torch.cuda.empty_cache()
    lap("phase 9r (one process over distinct devices)")
    mixed_of = lambda entry: {k: v.get(entry, 0) for k, v in launches_r.items()}  # noqa: E731
    for mode in ("sampled", "layerwise", "int8_sampled"):
        log(f"planted:20000 {mode}: test acc {accept[mode]['test_acc']:.4f} "
            f"(feature-only Bayes {accept[mode]['feature_bayes_acc']:.4f})")

    k1, k2 = "quiver_tpu/ops/pallas/fused.py:75", "quiver_tpu/ops/pallas/gather.py:28"
    k3 = "quiver_tpu/ops/pallas/fused.py:113"
    kernels = [
        kernel_row("select", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   samp_t["launches"]["select"],
                   "temporal sampler (and the offs/draw_fn seams)",
                   sel + rows_h["select"] + rows_g["select"] + rows_n["select"]
                   + rows_ctl["select"], t_sel,
                   {"stock_ms": t_sel["stock_ms"], "ratio_to_stock": t_sel["ratio_to_stock"],
                    "dist_sample_launches": {k: launches_g["sample"][k]["select"]
                                             for k in ("uniform", "temporal")},
                    "topo_sharded_trainer_launches": launches_g["trainer"]["select"],
                    "int8_controller_trainer_launches": launches_c["trainer"]["all"]["select"],
                    "elastic_trainer_launches": {m: v["select"] for m, v in launches_e.items()},
                    "stream_launches": {k: v["select"] for k, v in launches_k.items()},
                    "dist_hetero_launches": launches_g["hetero"]["uniform"]["select"],
                    "world_topo_trainer_launches": launches_n["uniform"]["select"],
                    "world_hetero_launches": launches_n["hetero"]["uniform"]["select"],
                    "world_elastic_launches": launches_n["elastic"]["select"],
                    "world_control_trainer_launches": launches_ctl["all"]["select"],
                    "mixed_mesh_launches": mixed_of("select"),
                    "owner_side": {
                        **{k: {"device_ms_per_sample": dist["samplers"][k][
                            "select_device_ms_per_sample"],
                            **dist["samplers"][k]["owner_side"]}
                           for k in ("uniform", "temporal")},
                        "trainer": {"device_ms_per_step": dist["trainer"][
                            "k1_device_ms_per_step"], **dist["trainer"]["owner_side"]}},
                    "shape": [t_sel["rows"], t_sel["k"]], "bound_rule": SELECT_BOUND_RULE,
                    "library": "none: its yardstick is the stock index_select "
                               "of the already-computed slots"},
                   card, name),
        kernel_row("uniform_hop", "quiver_tpu_torch/ops/kernels/select.cu", k1,
                   launches_u["uniform_hop"], "uniform serving",
                   hop + rows_h["uniform_hop"] + k1_rows_o + k1_rows_f + k1_rows_s
                   + rows_ctl["uniform_hop"], t_hop,
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
                    "rgcn_stream_launches": launches_h["rgcn_stream"]["uniform"]["uniform_hop"],
                    "saint_rw_launches": launches_h["saint"]["uniform_hop"],
                    "fused_trainer_launches": launches_f["uniform_hop"],
                    "sharded_trainer_launches": {
                        mode: v["uniform_hop"] for mode, v in launches_s.items()},
                    "world_trainer_launches": {k: v["uniform_hop"]
                                               for k, v in launches_m.items()},
                    "int8_controller_trainer_launches": launches_c["trainer"]["data"][
                        "uniform_hop"],
                    "world_control_trainer_launches": launches_ctl["data"]["uniform_hop"],
                    "ooc_epoch_launches": launches_j["uniform_hop"],
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
                   "edge sampler's endpoints)", gat + win_checks + k2_rows_s
                   + rows_ctl["gather_rows"], t_win,
                   {"shape": [t_win["ids"], t_win["row_bytes"]],
                    "sharded_trainer_launches": {
                        mode: v["gather_rows"] for mode, v in launches_s.items()},
                    "topo_sharded_trainer_launches": launches_g["trainer"]["gather_rows"],
                    "world_trainer_launches": {k: launches_m[k]["gather_rows"]
                                               for k, _, _ in WORLD_FLAVOURS},
                    "world_topo_trainer_launches": {
                        k: launches_n[k]["gather_rows"] for k in ("uniform", "weighted",
                                                                   "elastic")},
                    "elastic_trainer_launches": {m: v["gather_rows"]
                                                 for m, v in launches_e.items()},
                    "stream_launches": {k: v["gather_rows"] for k, v in launches_k.items()},
                    "world_control_trainer_launches": {
                        k: v["gather_rows"] for k, v in launches_ctl.items()},
                    "mixed_mesh_launches": mixed_of("gather_rows"),
                    "sharded_lookup": {mesh: r["timing"] for mesh, r in
                                       sharded["store"]["meshes"].items()},
                    "ratio_to_library": t_win["ratio_to_library"],
                    "bound_rule": WINDOW_BOUND_RULE,
                    "serving_shape": {key: t_gat[key] for key in (
                        "ms", "plain_ms", "library_ms", "ratio_to_library", "bound_ms",
                        "bound_share", "ids", "row_bytes")},
                    "library": "torch.index_select"},
                   card, name),
        kernel_row("tiered_gather", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_u["tiered_gather"], "uniform serving (hot-only store)",
                   tier + rows_h["tiered_gather"] + k2_rows_o + k2_rows_f + rows_j, t_tier,
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
                    "rgcn_stream_launches": {k: v["tiered_gather"]
                                             for k, v in launches_h["rgcn_stream"].items()},
                    "fused_trainer_launches": launches_f["tiered_gather"],
                    "world_dp_launches": launches_m["dp"]["tiered_gather"],
                    "mixed_mesh_launches": mixed_of("tiered_gather"),
                    "ooc_epoch_launches": launches_j["tiered_gather"],
                    "ooc_lookup": ooc["lookup"],
                    "beyond_hbm": {
                        "launches": {k: v["tiered_gather"] for k, v in launches_o.items()},
                        "lookup": {key: t_off_lookup[key] for key in (
                            "ids", "cold_rows", "cold_bytes", "ms", "plain_ms", "yard_ms",
                            "bound_ms", "bound_share")}}},
                   card, name),
        kernel_row("tiered_gather_dequant", "quiver_tpu_torch/ops/kernels/gather.cu", k2,
                   launches_qa["tiered_gather_dequant"],
                   "int8 training (a) (also int8 training (b), int8 serving and every int8 "
                   "tier of the sharded store)",
                   deq + rows_c + rows_ctl["tiered_gather_dequant"], t_q,
                   {"yardstick": t_q["yardstick"], "yard_ms": t_q["yard_ms"],
                    "ratio_to_yard": t_q["ratio_to_yard"],
                    "shape": [t_q["ids"], t_q["stored_row_bytes"]],
                    "config": "bench_feature.py: 2,450,000 rows x F=100 stored "
                              "int8 under int(0.2 n) * F * 4 B, 65,536 uniform ids",
                    "bound_rule": GATHER_BOUND_RULE,
                    "serve_launches": launches_q["tiered_gather_dequant"],
                    "train_b_launches": launches_qb["tiered_gather_dequant"],
                    "train_lookup_in_turns": train_qa["lookup_in_turns"],
                    "train_b_lookup_in_turns": train_qb["lookup_in_turns"],
                    "serving_shape": {key: t_q_serve[key] for key in (
                        "ids", "ms", "ms_turns", "plain_ms", "yard_ms", "yard_turns",
                        "ratio_to_yard", "bound_ms", "bound_share", "cold_rows")},
                    "cold_read": t_cold,
                    "sharded_int8_lookup_launches": launches_c["store"],
                    "controller_store_launches": launches_c["controller"],
                    "sharded_int8_trainer_launches": {
                        mode: v["tiered_gather_dequant"]
                        for mode, v in launches_c["trainer"].items()},
                    "world_int8_trainer_launches": launches_m["psum int8"][
                        "tiered_gather_dequant"],
                    "world_control_trainer_launches": {
                        k: v["tiered_gather_dequant"] for k, v in launches_ctl.items()},
                    "mixed_mesh_launches": mixed_of("tiered_gather_dequant"),
                    "sharded_int8_lookup": {mesh: r["timing"] for mesh, r in
                                            control["int8_store"]["meshes"].items()},
                    "library": "none: no single PyTorch call dequantises a "
                               "tiered lookup; its yardstick is the staged "
                               "lookup in stock torch ops"},
                   card, name),
        kernel_row("wselect", "quiver_tpu_torch/ops/kernels/wselect.cu", k3,
                   serve_w["parity"]["launches"]["wselect"],
                   "weighted serving's single-query oracle (ladder parity)",
                   wsel + rows_g["wselect"] + rows_n["wselect"], t_wsel,
                   {"shape": [t_wsel["rows"], t_wsel["k"]],
                    "dist_sample_launches": launches_g["sample"]["weighted"]["wselect"],
                    "dist_hetero_launches": launches_g["hetero"]["weighted"]["wselect"],
                    "world_topo_trainer_launches": launches_n["weighted"]["wselect"],
                    "world_hetero_launches": launches_n["hetero"]["weighted"]["wselect"],
                    "mixed_mesh_launches": mixed_of("wselect"),
                    "owner_side": {"device_ms_per_sample": dist["samplers"]["weighted"][
                        "wselect_device_ms_per_sample"],
                        **dist["samplers"]["weighted"]["owner_side"]},
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
                    "rgcn_stream_weighted_launches": launches_h["rgcn_stream"]["weighted"][
                        "weighted_hop"],
                    "library": K3_LIBRARY + "; its yardstick is the composed path"},
                   card, name),
        kernel_row("segment_mean", "quiver_tpu_torch/ops/kernels/segment.cu",
                   "none: the JAX package's XLA scatter or cumsum scan "
                   "(quiver_tpu/models/inference.py)", launches_agg["scatter"],
                   "layer-wise inference (the SAGE, GCN, GIN and R-GCN passes; the refresher)",
                   agg_checks, t_seg,
                   {"shape": t_seg["shape"], "widths": t_seg["widths"],
                    "bound_rule": SEGMENT_BOUND_RULE,
                    "layerwise_host_launches": launches_agg,
                    "acceptance_layerwise_launches":
                        accept["layerwise"]["launches"]["segment_mean"],
                    "library": "none: no single PyTorch call takes a CSR segment mean; "
                               "its yardstick is the plain version, the chunked, sorted "
                               "index_put_ accumulate (chunk 2^21)"},
                   card, name),
    ]
    check(len(kernels) == len(ENTRIES)
          and all(k["launches"] > 0 and k["match"] for k in kernels)
          and launches_q["tiered_gather_dequant"] > 0
          and launches_qb["tiered_gather_dequant"] > 0
          and all(v["uniform_hop"] > 0 and v["gather_rows"] > 0
                  for v in launches_s.values())
          and all(v["tiered_gather_dequant"] > 0 for v in launches_c["trainer"].values())
          and launches_c["trainer"]["data"]["uniform_hop"] > 0
          and launches_c["trainer"]["all"]["select"] > 0
          and launches_j["tiered_gather"] > 0 and launches_j["uniform_hop"] > 0
          and all(v["uniform_hop"] > 0 for v in launches_m.values())
          and launches_m["psum int8"]["tiered_gather_dequant"] > 0
          and launches_m["dp"]["tiered_gather"] > 0
          and launches_agg["scatter"] > 0 and launches_agg["scan"] == launches_agg["scatter"]
          and all(launches_r[f"replicated f32 {s}"]["select"] > 0
                  and launches_r[f"replicated f32 {s}"]["tiered_gather"] > 0
                  for s in ((2, 1), (1, 2), (2, 2)))
          and all(launches_r[f"psum int8 {s}"]["tiered_gather_dequant"] > 0
                  and launches_r[f"routed f32 {s}"]["gather_rows"] > 0
                  and launches_r[f"topology weighted {s}"]["wselect"] > 0
                  for s in ((1, 2), (2, 2)))
          and launches_r["dp"]["select"] > 0 and launches_r["elastic"]["gather_rows"] > 0
          and all(v["select"] > 0 and v["gather_rows"] > 0 for v in launches_e.values())
          and all(launches_k[k]["select"] > 0 and launches_k[k]["gather_rows"] > 0
                  for k in ("epoch_0", "epoch_1"))
          and launches_k["sample"]["select"] > 0 and launches_k["gather_psum"]["gather_rows"] > 0
          and all(v["uniform_hop"] > 0 and v["weighted_hop"] > 0
                  for v in launches_p["samplers"].values())
          and all(v["select"] > 0 and v["tiered_gather"] > 0
                  for v in launches_p["trainer"].values())
          and all(v[k] > 0 for k, v in (("select", launches_g["sample"]["uniform"]),
                                        ("wselect", launches_g["sample"]["weighted"]),
                                        ("select", launches_g["trainer"]),
                                        ("select", launches_g["hetero"]["uniform"]),
                                        ("wselect", launches_g["hetero"]["weighted"]),
                                        ("select", launches_n["uniform"]),
                                        ("wselect", launches_n["weighted"]),
                                        ("select", launches_n["hetero"]["uniform"]),
                                        ("wselect", launches_n["hetero"]["weighted"]),
                                        ("select", launches_n["elastic"]),
                                        ("gather_rows", launches_n["uniform"]),
                                        ("uniform_hop", launches_ctl["data"]),
                                        ("select", launches_ctl["all"]),
                                        ("gather_rows", launches_ctl["data"]),
                                        ("gather_rows", launches_ctl["all"]),
                                        ("tiered_gather_dequant", launches_ctl["data"]),
                                        ("tiered_gather_dequant", launches_ctl["all"]))),
          "every kernel launched on its main path and every entry matched")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"kernels": kernels, "bulk": bulk, "int8_lookup": t_q,
                       "int8_serving_lookup": t_q_serve, "cold_read": t_cold,
                       "serve": {"uniform": serve_u, "weighted": serve_w,
                                 "int8": serve_q},
                       "elections": elect, "telemetry": telemetry,
                       "serve_idle": idle, "degraded": degraded, "fleet": fleet,
                       "sampler": samplers, "train": train,
                       "train_int8_a": train_qa, "train_int8_b": train_qb,
                       "acceptance": accept, "epoch": epoch, "hetero_saint": hetero,
                       "beyond_hbm": offload, "fused_trainer": fused,
                       "sharded": sharded, "distributed": dist, "control": control,
                       "elastic": elastic, "ooc": ooc, "stream": stream,
                       "world": world_res, "world_topo": world_topo,
                       "world_control": world_ctl, "dedup": dedup,
                       "infer_agg": infer_aggs, "multi_device": multi, "lint": lint_row,
                       "audit": audit,
                       "build_s": build_s, "host_build_s": host_build_s,
                       "graph_s": graph_s, "phase_s": phase_s,
                       "graph": {"nodes": topo.node_count,
                                 "edges": topo.edge_count,
                                 "max_degree": topo.max_degree}}, fh, indent=1)
    print(json.dumps({"lint": lint_row}), flush=True)
    print(json.dumps({"audit": audit}), flush=True)
    print(json.dumps({"bulk": bulk, "int8_lookup": t_q, "int8_serving_lookup": t_q_serve,
                      "cold_read": t_cold, "card": card}), flush=True)
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
    print(json.dumps({"fused_trainer": fused}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"distributed": dist}), flush=True)
    print(json.dumps({"control": {k: v for k, v in control.items() if k != "trainer"}}),
          flush=True)
    print(json.dumps({"control_trainer": {
        mode: {k: v for k, v in r.items() if k != "per_step"}
        for mode, r in control["trainer"]["modes"].items()}}), flush=True)
    print(json.dumps({"elastic": elastic}), flush=True)
    print(json.dumps({"ooc": ooc}), flush=True)
    print(json.dumps({"stream": stream}), flush=True)
    print(json.dumps({"world": world_res}), flush=True)
    print(json.dumps({"world_topo": world_topo}), flush=True)
    print(json.dumps({"world_control": world_ctl}), flush=True)
    print(json.dumps({"dedup": dedup}), flush=True)
    print(json.dumps({"infer_agg": infer_aggs}), flush=True)
    print(json.dumps({"multi_device": multi}), flush=True)
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
