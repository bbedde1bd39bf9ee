"""``DistHeteroSampler`` and ``HeteroShardedTopology`` of quiver_tpu_torch
against quiver_tpu's, on the CPU: the contracts of
``tests/test_dist_hetero.py``.

JAX runs its sampler in ``shard_map`` on the forced host devices; the port
runs the same ``(1, F)`` mesh on a device that repeats, a feature group at
a time. Both get the same draws: the port's ``draw_fn`` replays JAX's key
chain (``fold_in(key, worker)``, then one ``split`` per active relation
per hop in the planner's order, the stratum and rotation keys of a
uniform relation or ``uniform(sub, (S, k))`` of a weighted one). The
R-GCN step carries JAX's parameters across with ``flax_rgcn_to_state_dict``
(dropout 0).

Tolerances: bitwise for ids, edge lists, per-(hop, relation) overflow,
partitions, error types and messages; one R-GCN step's loss within 1e-5
relative and the parameters after one SGD step within 1e-6 absolute and
1e-5 relative (the frameworks sum in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.core.hetero_sharded import HeteroShardedTopology as HeteroShardedJ  # noqa: E402
from quiver_tpu.parallel import train as train_j  # noqa: E402
from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import convert  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402

from test_torch_hetero import _jax_offsets, both_topos  # noqa: E402
from test_torch_rgcn import _inputs, _jax_layers, _pair, _tables  # noqa: E402

SIZES = [3, 2]


def jax_dist_hetero_draw_fn(sampler, key):
    """``draw_fn(worker, hop, edge_type, deg)`` replaying JAX's distributed
    hetero draws keyed ``key``: each worker's (hop, relation) takes the
    next ``split`` of ``fold_in(key, worker)`` the first time it is drawn,
    and the same key again on a regrowth rerun."""
    state = {}

    def draw(w, hop, et, deg):
        st = state.setdefault(w, {"key": jax.random.fold_in(key, w), "subs": {}})
        if (hop, et) not in st["subs"]:
            st["key"], st["subs"][(hop, et)] = jax.random.split(st["key"])
        sub, k = st["subs"][(hop, et)], sampler.sizes[hop][et]
        if et in sampler.weighted_rels:
            return torch.from_numpy(np.array(jax.random.uniform(
                sub, (deg.shape[0], k), jnp.float32)))
        return torch.from_numpy(np.array(_jax_offsets(sub, jnp.asarray(deg.numpy()), k)))

    return draw


def _meshes(F):
    return (qt.make_mesh(data=1, feature=F, devices=["cpu"] * F),
            make_mesh_j(data=1, feature=F, devices=jax.devices()[:F]))


def _samplers(F, weighted, alpha, seed=0, sizes=SIZES, **kw):
    tj, tt, _ = both_topos(seed, weights=weighted)
    mt, mj = _meshes(F)
    port = qt.DistHeteroSampler(tt, list(sizes), "paper", mesh=mt, routed_alpha=alpha,
                                weighted=weighted, seed=0, **kw)
    jx = qj.DistHeteroSampler(tj, list(sizes), "paper", mesh=mj, routed_alpha=alpha,
                              weighted=weighted, seed=0, **kw)
    return port, jx


def _assert_same_block(got, want):
    """One worker's (or the whole) typed sample: ``n_id`` of every type and
    every relation's edge list, bitwise (JAX's dicts come back sorted, so
    by key)."""
    assert set(got.n_id) == set(want.n_id)
    for t in want.n_id:
        assert np.array_equal(got.n_id[t].numpy(), np.asarray(want.n_id[t])), t
    assert len(got.adjs) == len(want.adjs)
    for la, lb in zip(got.adjs, want.adjs):
        assert set(la.adjs) == set(lb.adjs)
        for et, a in la.adjs.items():
            b = lb.adjs[et]
            assert np.array_equal(a.edge_index.numpy(), np.asarray(b.edge_index)), et
            assert a.size == b.size and a.fanout == b.fanout


CASES = [(2, False, 2.0), (4, False, 0.25), (4, True, 0.25), (2, True, None)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"F{c[0]}-{'weighted' if c[1] else 'uniform'}-{c[2]}")
def case(request):
    F, weighted, alpha = request.param
    port, jx = _samplers(F, weighted, alpha)
    seeds = np.arange(48)
    key = jax.random.PRNGKey(7)
    return {"F": F, "alpha": alpha, "port": port, "seeds": seeds, "key": key,
            "out": jx.sample(seeds, key=key), "per": jx.sample_per_worker(seeds, key=key),
            "by_rel": jx.last_sample_overflow_by_rel, "slots": jx.overflow_slots,
            "plan": HeteroShardedJ(jx.mesh, jx.topo, weighted_rels=jx.weighted_rels).plan}


def test_sample_bitwise_jax(case):
    """The worker-major sample, each worker's block and the per-(hop,
    relation) overflow, bitwise JAX's; the partition's plan is JAX's."""
    port = case["port"]
    assert port.overflow_slots == case["slots"]
    assert port.dev_topos.plan == case["plan"]
    draw = jax_dist_hetero_draw_fn(port, case["key"])
    got = port.sample(case["seeds"], draw_fn=draw)
    _assert_same_block(got, case["out"])
    assert int(got.overflow) == int(case["out"].overflow)
    assert got.frontier_counts == case["out"].frontier_counts
    assert port.last_sample_overflow_by_rel == case["by_rel"]
    total = sum(case["by_rel"].values())
    assert total == 0 if case["alpha"] is None or case["alpha"] >= 1 else total > 0
    per = port.sample_per_worker(case["seeds"], draw_fn=draw)
    assert len(per) == case["F"]
    for got_w, want_w in zip(per, case["per"]):
        _assert_same_block(got_w, want_w)


def test_workers_bitwise_replicated(case):
    """The port's own contract: each worker's block is the replicated
    ``HeteroGraphSampler``'s on that block with the same draws."""
    port, F = case["port"], case["F"]
    draw = jax_dist_hetero_draw_fn(port, case["key"])
    per = port.sample_per_worker(case["seeds"], draw_fn=draw)
    rep = qt.HeteroGraphSampler(port.topo, list(SIZES), "paper", seed_capacity=per[0].batch_size,
                                weighted=bool(port.weighted_rels), device="cpu")
    for w, blk in enumerate(np.array_split(case["seeds"], F)):
        ref = rep.sample(blk, draw_fn=lambda hop, et, deg, w=w: draw(w, hop, et, deg))
        for t in ref.n_id:
            assert torch.equal(per[w].n_id[t], ref.n_id[t]), (w, t)
        for la, lb in zip(per[w].adjs, ref.adjs):
            for et, a in lb.adjs.items():
                assert torch.equal(la.adjs[et].edge_index, a.edge_index), (w, et)


@pytest.mark.parametrize("weighted", [False, True])
def test_forced_overflow_exact(weighted):
    """A budget of one lane per bucket overflows every hop; the fallback
    serves the lanes exactly: the sample is the uncapped one's, and the
    generator draws of the port are the same on both."""
    tight, _ = _samplers(4, weighted, 0.01)
    loose, _ = _samplers(4, weighted, None)
    seeds = np.arange(80)
    a, b = tight.sample(seeds, key=5), loose.sample(seeds, key=5)
    assert sum(tight.last_sample_overflow_by_rel.values()) > 0
    assert sum(loose.last_sample_overflow_by_rel.values()) == 0
    for t in a.n_id:
        assert torch.equal(a.n_id[t], b.n_id[t])
    for la, lb in zip(a.adjs, b.adjs):
        assert all(torch.equal(la.adjs[et].edge_index, lb.adjs[et].edge_index)
                   for et in la.adjs)


def test_constructor_guards_match_jax():
    tj, tt, _ = both_topos(0)
    mt, mj = _meshes(2)
    bad = [{"mesh": None}, {"with_eid": True}, {"mode": "HOST"}, {"routed_alpha": 0.0},
           {"weighted": True}]
    for kw in bad:
        errs = []
        for cls, topo, mesh in ((qt.DistHeteroSampler, tt, mt), (qj.DistHeteroSampler, tj, mj)):
            with pytest.raises(Exception) as info:
                cls(topo, [3], "paper", **{"mesh": mesh, **kw})
            errs.append((type(info.value).__name__, str(info.value)))
        assert errs[0] == errs[1], kw
    with pytest.raises(ValueError, match="kernel"):
        qt.DistHeteroSampler(tt, [3], "paper", mesh=mt, kernel="cuda")
    with pytest.raises(ValueError, match="unknown weighted relations"):
        qt.HeteroShardedTopology(mt, tt, weighted_rels=[("a", "b", "c")])
    s = qt.DistHeteroSampler(tt, [3], "paper", mesh=mt)
    assert s.workers == 2 and s.last_sample_overflow is None
    assert s.last_sample_overflow_by_rel is None


def test_dist_hetero_rgcn_loss_parity():
    """One R-GCN step on the distributed sample (JAX's test's F = 2, block
    16 = capacity, fanouts [4, 3]): each worker's loss and gradients on
    its block, the mean over the workers, one SGD step; the port's loss
    and parameters against JAX's."""
    F, cap = 2, 16
    port, jx = _samplers(F, False, 2.0, seed=5, sizes=[4, 3], seed_capacity=cap)
    num_nodes = port.topo.num_nodes
    seeds = np.random.default_rng(0).integers(0, num_nodes["paper"], F * cap)
    key = jax.random.PRNGKey(0)
    per_j = jx.sample_per_worker(seeds, key=key)
    per_t = port.sample_per_worker(seeds, draw_fn=jax_dist_hetero_draw_fn(port, key))
    widths = {t: 8 for t in num_nodes}
    tables = _tables(num_nodes, widths)
    labels = np.random.default_rng(1).integers(0, 5, num_nodes["paper"]).astype(np.int32)
    mask = np.ones(cap, bool)
    xs = [_inputs(o, tables) for o in per_t]
    mj, params, mt = _pair(per_t[0], xs[0], widths, num_bases=0)

    def loss_j(p, x, layers, lab):
        logp = mj.apply({"params": p}, {t: jnp.asarray(v) for t, v in x.items()}, layers,
                        train=True)
        return train_j.cross_entropy_on_seeds(logp, jnp.asarray(lab), jnp.asarray(mask))

    grad_j = jax.jit(jax.value_and_grad(loss_j))
    opt = torch.optim.SGD(mt.parameters(), lr=0.1)
    opt.zero_grad()
    mt.train()
    losses_j, losses_t, grads = [], [], None
    for w, blk in enumerate(np.array_split(seeds, F)):
        _assert_same_block(per_t[w], per_j[w])
        lab = labels[blk]
        lj, gj = grad_j(params, xs[w], _jax_layers(per_t[w].adjs), lab)
        losses_j.append(float(lj))
        grads = gj if grads is None else jax.tree_util.tree_map(jnp.add, grads, gj)
        logp = mt({t: torch.from_numpy(v) for t, v in xs[w].items()}, per_t[w].adjs)
        lt = train_t.cross_entropy_on_seeds(logp, torch.from_numpy(lab), torch.from_numpy(mask))
        (lt / F).backward()
        losses_t.append(lt.item())
    opt.step()
    np.testing.assert_allclose(np.mean(losses_t), np.mean(losses_j), rtol=1e-5)
    new = jax.tree_util.tree_map(lambda p, g: np.asarray(p - 0.1 * g / F), params, grads)
    want = convert.flax_rgcn_to_state_dict(new)
    got = mt.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
