"""``DistGraphSageSampler`` of quiver_tpu_torch against quiver_tpu's, on the
CPU: the sampling contracts of ``tests/test_sharded_topology.py``.

JAX runs its sampler in ``shard_map`` on the forced host devices; the port
runs the same mesh on a device that repeats (``["cpu"] * W``), a feature
group at a time. Both sides get the same draws: the port's ``draw_fn``
replays JAX's key chain (``fold_in(key, worker)``, one ``split`` per
layer, then the stratum and rotation keys of a uniform or temporal hop,
or ``uniform(sub, (S, k))`` of a weighted one).

Tolerance: bitwise for everything (ids, edge lists, counts, the per-hop
overflow vectors, planned caps, error types and messages).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from quiver_tpu.utils.graphgen import generate_pareto_graph  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops.sample import seeded_generator  # noqa: E402
from quiver_tpu_torch.sampling.dist import DistGraphSageSampler  # noqa: E402

from test_torch_hetero import _jax_offsets  # noqa: E402

SIZES = (4, 3)
CAP = 32
WINDOW = (0.2, 0.8)


def jax_dist_draw_fn(key, weighted: bool, sizes=SIZES):
    """``draw_fn(worker, layer, deg)`` replaying the draws of JAX's
    distributed sample keyed ``key``."""
    subs = {}

    def draw(w, layer, deg):
        if w not in subs:
            k, subs[w] = jax.random.fold_in(key, w), []
            for _ in sizes:
                k, sub = jax.random.split(k)
                subs[w].append(sub)
        sub, k = subs[w][layer], sizes[layer]
        if weighted:
            return torch.from_numpy(np.array(jax.random.uniform(
                sub, (deg.shape[0], k), jnp.float32)))
        return torch.from_numpy(np.array(_jax_offsets(sub, jnp.asarray(deg.numpy()), k)))

    return draw


def _graph(kind=None):
    """The 500-node Pareto graph of JAX's tests in both packages, with its
    weights (``kind="weighted"``) or timestamps (``"temporal"``)."""
    ei = generate_pareto_graph(500, 6.0, seed=0)
    out = []
    for mod in (qt, qj):
        topo = mod.CSRTopo(edge_index=ei)
        if kind == "weighted":
            topo.set_edge_weight(np.random.default_rng(5).random(topo.edge_count) + 0.1)
        elif kind == "temporal":
            topo.set_edge_time(np.random.default_rng(8).random(topo.edge_count))
        out.append(topo)
    return out


def _kw(kind):
    return {"weighted": {"weighted": True}, "temporal": {"time_window": WINDOW}}.get(kind, {})


def _samplers(kind, D, F, alpha, **extra):
    tt, tj = _graph(kind)
    common = dict(seed=7, seed_capacity=CAP, topo_sharding="mesh", routed_alpha=alpha,
                  **_kw(kind), **extra)
    port = qt.GraphSageSampler(tt, list(SIZES), dedup="sort",
                               mesh=qt.make_mesh(data=D, feature=F, devices=["cpu"] * (D * F)),
                               **common)
    jx = qj.GraphSageSampler(tj, list(SIZES), dedup="sort",
                             mesh=make_mesh_j(data=D, feature=F, devices=jax.devices()[:D * F]),
                             **common)
    return port, jx, tt


def _seeds(n, W, rng_seed):
    return np.random.default_rng(rng_seed).integers(0, n, CAP * W - 5)


def _assert_same_output(ot, oj):
    assert ot.batch_size == oj.batch_size
    assert np.array_equal(ot.n_id.numpy(), np.asarray(oj.n_id))
    assert len(ot.adjs) == len(oj.adjs)
    for a, b in zip(ot.adjs, oj.adjs):
        assert np.array_equal(a.edge_index.numpy(), np.asarray(b.edge_index))
        assert a.size == b.size and a.fanout == b.fanout


CASES = [("uniform", 1, 8, 2.0), ("uniform", 2, 2, 0.25), ("weighted", 1, 2, None),
         ("weighted", 1, 4, 0.25), ("temporal", 1, 2, 2.0), ("temporal", 1, 4, 0.25)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{c[3]}")
def case(request):
    """One configuration: the port's and JAX's samplers, a seed batch, and
    JAX's ``sample`` and ``sample_per_worker`` of it (keyed alike)."""
    kind, D, F, alpha = request.param
    port, jx, tt = _samplers(kind, D, F, alpha)
    seeds = _seeds(tt.node_count, D * F, D * F)
    key = jax.random.PRNGKey(3 + F)
    out = jx.sample(seeds, key=key)
    ov = np.asarray(jx.last_sample_overflow)
    return {"kind": kind, "port": port, "seeds": seeds, "key": key, "out": out,
            "overflow": ov, "per": jx.sample_per_worker(seeds, key=key),
            "draw": jax_dist_draw_fn(key, kind == "weighted"), "alpha": alpha}


def test_sample_bitwise_jax(case):
    """``sample``: the worker-major ``n_id``, every ``edge_index``, the
    counts and the per-hop overflow vector, bitwise JAX's."""
    port = case["port"]
    got = port.sample(case["seeds"], draw_fn=case["draw"])
    want = case["out"]
    _assert_same_output(got, want)
    assert int(got.n_count) == int(want.n_count) and int(got.overflow) == int(want.overflow)
    assert got.edge_counts == want.edge_counts
    assert got.frontier_counts == want.frontier_counts
    ov = port.last_sample_overflow
    assert ov.dtype == torch.int32 and np.array_equal(ov.numpy(), case["overflow"])
    if case["alpha"] is None:
        assert not ov.any()
    elif case["alpha"] < 1:
        assert int(ov.sum()) > 0  # the fallback served lanes, exactly


def test_sample_per_worker_bitwise_jax_and_replicated(case):
    """``sample_per_worker`` bitwise JAX's, and each worker's block bitwise
    the port's replicated ``GraphSageSampler.sample(draw_fn=)`` on it."""
    port = case["port"]
    per = port.sample_per_worker(case["seeds"], draw_fn=case["draw"])
    assert len(per) == port.workers == len(case["per"])
    rep = qt.GraphSageSampler(port.csr_topo, list(SIZES), device="cpu", seed=7,
                              seed_capacity=CAP, **_kw(case["kind"]))
    for w, (got, want, blk) in enumerate(zip(per, case["per"],
                                             np.array_split(case["seeds"], port.workers))):
        _assert_same_output(got, want)
        ref = rep.sample(blk, draw_fn=functools.partial(case["draw"], w))
        assert torch.equal(got.n_id, ref.n_id), w
        for a, b in zip(got.adjs, ref.adjs):
            assert torch.equal(a.edge_index, b.edge_index) and a.size == b.size


@pytest.mark.parametrize("kind", ["uniform", "weighted", "temporal"])
def test_generator_draws_equal_replicated_sample_padded(kind):
    """The port's own draws: worker ``w`` of a call keyed ``key`` draws
    what the replicated ``sample_padded`` draws from a generator seeded
    ``fold_key(key, w)``, bitwise, over a capped plan that overflows."""
    port, _, tt = _samplers(kind, 2, 2, 0.25)
    seeds = _seeds(tt.node_count, 4, 11)
    per = port.sample_per_worker(seeds, key=21)
    assert int(port.last_sample_overflow.sum()) > 0
    rep = qt.GraphSageSampler(tt, list(SIZES), device="cpu", seed=7, seed_capacity=CAP,
                              **_kw(kind))
    for w, (got, blk) in enumerate(zip(per, np.array_split(seeds, 4))):
        padded = torch.full((CAP,), -1, dtype=torch.int32)
        padded[:len(blk)] = torch.from_numpy(blk.astype(np.int32))
        n_id, _, adjs, *_ = rep.sample_padded(padded, len(blk),
                                              generator=seeded_generator("cpu", 21, w))
        assert torch.equal(got.n_id, n_id), w
        assert all(torch.equal(a.edge_index, b.edge_index) for a, b in zip(got.adjs, adjs))


@pytest.mark.parametrize("weighted", [False, True])
def test_forced_overflow_exact(weighted):
    """Every seed on shard 0's rows and a budget of one lane per bucket:
    the buckets overflow, the fallback serves every lane exactly, and the
    sample is bitwise the uncapped one (``routed_alpha=None``, no
    overflow)."""
    kind = "weighted" if weighted else "uniform"
    tight, _, tt = _samplers(kind, 1, 4, 0.01)
    loose, _, _ = _samplers(kind, 1, 4, None)
    seeds = np.random.default_rng(2).integers(0, tight.topo.rows_per_shard, CAP * 4)
    draw = jax_dist_draw_fn(jax.random.PRNGKey(9), weighted)
    a = tight.sample(seeds, draw_fn=draw)
    b = loose.sample(seeds, draw_fn=draw)
    assert tight.last_sample_overflow.shape == (2,)
    assert int(tight.last_sample_overflow.sum()) > 0
    assert not loose.last_sample_overflow.any()
    assert torch.equal(a.n_id, b.n_id)
    assert all(torch.equal(x.edge_index, y.edge_index) for x, y in zip(a.adjs, b.adjs))


def test_auto_caps_planned_and_regrown_as_jax():
    """``frontier_caps="auto"``: the first call plans the caps from the
    worker maxima, a wider batch overflows them and regrows them (one
    rerun), and every call's caps and sample are JAX's."""
    port, jx, tt = _samplers(None, 1, 4, 2.0, frontier_caps="auto")
    n = tt.node_count
    batches = [np.arange(8), np.random.default_rng(3).integers(0, n, CAP * 4 - 1),
               np.random.default_rng(4).integers(0, n, CAP * 4 - 3)]
    caps = []
    for c, seeds in enumerate(batches):
        key = jax.random.PRNGKey(40 + c)
        want = jx.sample(seeds, key=key)
        got = port.sample(seeds, draw_fn=jax_dist_draw_fn(key, False))
        assert port._frontier_caps == jx._frontier_caps, c
        _assert_same_output(got, want)
        assert int(got.overflow) == int(want.overflow) == 0
        caps.append(port._frontier_caps)
    assert caps[1] != caps[0] and port.reruns >= 1  # regrown after call 0


def test_sample_group_matches_sample():
    """The trainer's group entry: a feature group's ``(F, cap)`` blocks
    from per-worker generators give each worker's ``sample`` block, and
    its per-hop overflow is the group's share."""
    port, _, tt = _samplers(None, 1, 4, 0.25)
    seeds = _seeds(tt.node_count, 4, 5)
    per = port.sample_per_worker(seeds, key=8)
    packed = torch.from_numpy(port.shard_seeds(seeds, CAP))
    num = (packed >= 0).sum(1, dtype=torch.int32)
    gens = [seeded_generator("cpu", 8, w) for w in range(4)]
    n_id, n_count, adjs, overflow, _, _, hop_ov = port.sample_group(packed, num, generators=gens)
    assert torch.equal(hop_ov, port.last_sample_overflow) and int(hop_ov.sum()) > 0
    for w in range(4):
        assert torch.equal(n_id[w], per[w].n_id)
        assert all(torch.equal(a.edge_index[w], b.edge_index)
                   for a, b in zip(adjs, per[w].adjs))
    assert not overflow.any() and n_count.shape == (4,)
    with pytest.raises(TypeError, match="sample_group"):
        port.sample_padded(packed[0], 3)


def test_constructor_guards_match_jax():
    """The constructor's checks: the port raises JAX's exception type with
    JAX's message for each, and the replicated path is untouched."""
    ei = generate_pareto_graph(200, 6.0, seed=0)
    tt, tj = qt.CSRTopo(edge_index=ei), qj.CSRTopo(edge_index=ei)
    mt = qt.make_mesh(data=1, feature=8, devices=["cpu"] * 8)
    mj = make_mesh_j(data=1, feature=8, devices=jax.devices()[:8])
    bad = [{"mesh": None}, {"topo_sharding": "nope"}, {"weighted": True},
           {"time_window": (0.0, 1.0)}, {"with_eid": True}, {"kernel": "cuda"},
           {"mode": "HOST"}, {"routed_alpha": -2.0}, {"device_topo": object()}]
    for kw in bad:
        errs = []
        for mod, topo, mesh in ((qt, tt, mt), (qj, tj, mj)):
            args = {"topo_sharding": "mesh", "mesh": mesh, **kw}
            with pytest.raises(Exception) as info:
                mod.GraphSageSampler(topo, [4], **args)
            errs.append((type(info.value).__name__, str(info.value)))
        assert errs[0] == errs[1], kw
    w = np.ones(tt.edge_count, np.float32)
    tt.set_edge_weight(w)
    assert isinstance(qt.GraphSageSampler(tt, [4], topo_sharding="mesh", mesh=mt,
                                          weighted=True), DistGraphSageSampler)
    rep = qt.GraphSageSampler(tt, [4], device="cpu")
    assert rep.topo_sharding == "replicated" and not isinstance(rep, DistGraphSageSampler)
    dist = DistGraphSageSampler(tt, [4], mesh=mt, routed_alpha=None)
    assert dist.topo_sharding == "mesh" and dist.workers == 8 and dist.routed_alpha is None
    assert dist.last_sample_overflow is None


def test_shared_sampler_helpers():
    """The helpers every sampler of the package shares: the seed guard,
    the one host read of a run's counts (scalars or per-type dicts, in
    their structure), and the per-worker seed blocks (``np.array_split``,
    -1 padded, the capacity named when a block overflows it)."""
    from quiver_tpu_torch.parallel.mesh import shard_seed_blocks
    from quiver_tpu_torch.sampling.sampler import check_seed_range, read_counts

    check_seed_range(np.array([0, 9]), 10)
    check_seed_range(np.array([], np.int64), 0)
    for bad in ([-1, 3], [0, 10]):
        with pytest.raises(ValueError, match=r"seed ids must be in \[0, 10\)"):
            check_seed_range(np.array(bad), 10)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    assert read_counts(i32(2), [i32(5), i32(7)]) == (2, [5, 7])
    assert read_counts(i32(0), [{"a": i32(1), "b": i32(4)}, {"a": i32(3)}]) == (
        0, [{"a": 1, "b": 4}, {"a": 3}])
    blocks = shard_seed_blocks(np.arange(10), 4, 3)
    assert blocks.dtype == np.int32 and blocks.tolist() == [
        [0, 1, 2], [3, 4, 5], [6, 7, -1], [8, 9, -1]]
    with pytest.raises(ValueError, match="per-worker block 3 exceeds local_batch 2"):
        shard_seed_blocks(np.arange(10), 4, 2, "local_batch")
