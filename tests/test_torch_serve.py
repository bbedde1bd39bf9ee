"""The serving slice as a whole: quiver_tpu_torch's InferenceServer
against quiver_tpu's, on the same graph, features, parameters and
``(node, seq)`` stream.

The port's ``draw_fn`` replays the JAX server's key chain
(``fold_in(PRNGKey(seed), seq)``, ``split`` per layer, then ``split`` into
``kj, kr`` for a uniform hop or the unsplit ``uniform`` block for a
weighted one), so both sides draw the same offsets. The ``weighted``
servers sample every hop in proportion to exp(N(0,1)) edge weights.

Tolerance: bitwise for sampled ids and edges (compared through
``oracle_sample`` on both sides); served log-probs within atol = rtol =
1e-5 (float32, different summation orders). The port's ladder against the
port's own oracle: bitwise, log-probs included (the ladder runs the
forward per lane at the oracle's shapes).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.ops.sample import rotate_offsets, stratified_offsets  # noqa: E402
from quiver_tpu.parallel.train import empty_adjs, init_model  # noqa: E402
from quiver_tpu.serving.coalesce import ladder_buckets as buckets_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.serving.coalesce import ladder_buckets as buckets_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, HID, CLS, SIZES, SEED = 12, 16, 5, (4, 3), 3


def jax_draw_fn(seed, sizes, weighted=False):
    """``draw_fn(seq, layer, deg)`` replaying the JAX ladder's draws:
    offsets, or the ``u01`` block of a weighted hop."""
    base = jax.random.PRNGKey(seed)

    def draw(seq, layer, deg):
        key = jax.random.fold_in(base, seq)
        for _ in range(layer + 1):
            key, sub = jax.random.split(key)
        if weighted:
            return torch.from_numpy(np.array(jax.random.uniform(
                sub, (deg.shape[0], sizes[layer]), jnp.float32)))
        kj, kr = jax.random.split(sub)
        d = jnp.asarray(deg.numpy())
        off, _ = stratified_offsets(kj, d, sizes[layer])
        return torch.from_numpy(np.array(rotate_offsets(kr, off, d, sizes[layer])))
    return draw


@pytest.fixture(scope="module", params=["hot", "tiered", "weighted"])
def servers(request):
    coo = generate_pareto_graph(400, 6.0, seed=5)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    weighted = request.param == "weighted"
    if weighted:
        w = np.exp(np.random.default_rng(10).normal(size=coo.shape[1])).astype(np.float32)
        tj.set_edge_weight(w)
        tt.set_edge_weight(w)
    x = np.random.default_rng(5).normal(size=(400, F)).astype(np.float32)
    if request.param in ("hot", "weighted"):
        fj = qj.Feature(device_cache_size="1G").from_cpu_tensor(x)
        ft = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x)
    else:  # 100 hot rows by degree, 300 cold
        fj = qj.Feature(device_cache_size=100 * F * 4, csr_topo=tj).from_cpu_tensor(x)
        ft = qt.Feature(device_cache_size=100 * F * 4, csr_topo=tt,
                        device="cpu").from_cpu_tensor(x)
    mj = SageJ(hidden=HID, num_classes=CLS, num_layers=2)
    adjs = empty_adjs(list(SIZES), batch=2, node_count=400)
    params = init_model(mj, jax.random.PRNGKey(SEED),
                        np.zeros((adjs[0].size[0], F), np.float32), adjs)
    mt = qt.GraphSAGE(F, HID, CLS, num_layers=2)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    sj = qj.InferenceServer(
        qj.GraphSageSampler(tj, list(SIZES), seed=SEED, weighted=weighted),
        mj, params, fj, buckets=(1, 2), seed=SEED)
    st = qt.InferenceServer(
        qt.GraphSageSampler(tt, list(SIZES), device="cpu", seed=SEED, weighted=weighted),
        mt, ft, device="cpu", buckets=(1, 2), seed=SEED,
        draw_fn=jax_draw_fn(SEED, SIZES, weighted))
    sj.warmup()
    st.warmup()
    return sj, st


def test_oracle_sample_bitwise(servers):
    sj, st = servers
    for node, seq in [(0, 0), (7, 1), (123, 2), (399, 17), (50, 4)]:
        nj, ej, oj = sj._ladder.oracle_sample(sj.sampler.topo, node, seq, sj._base_key)
        nt, et, ot = st.ladder.oracle_sample(node, seq)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        assert len(et) == len(ej)
        for a, b in zip(et, ej):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(ot) == int(oj)


def test_served_logprobs_match_jax(servers):
    sj, st = servers
    nodes = np.random.default_rng(0).integers(0, 400, 5)
    rj = sj.serve(nodes)
    rt = st.serve(nodes)
    assert [(r.node, r.seq) for r in rt] == [(r.node, r.seq) for r in rj]
    for a, b in zip(rt, rj):
        assert a.result.shape == (CLS,) and a.overflow == b.overflow == 0
        np.testing.assert_allclose(a.result, b.result, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(np.exp(a.result).sum(), 1.0, atol=1e-5)


def test_port_ladder_equals_port_oracle_every_bucket(servers):
    _sj, st = servers
    lad = st.ladder
    picks = [(3, 100), (250, 101), (17, 102)]
    for bucket in st.batcher.buckets:
        for group in (picks[:bucket], picks[1:bucket]):  # full and padded
            seeds = torch.full((bucket,), -1, dtype=torch.int32)
            seqs = [None] * bucket
            for j, (node, seq) in enumerate(group):
                seeds[j], seqs[j] = node, seq
            n_ids, eis, _ = lad.sample_exec(bucket)(seeds, seqs)
            x = st.feature[n_ids.reshape(-1)].reshape(bucket, lad.lane_caps[-1], F)
            logp = lad.forward_exec(bucket)(x, eis).numpy()
            for j, (node, seq) in enumerate(group):
                o_nid, o_eis, _ = lad.oracle_sample(node, seq)
                np.testing.assert_array_equal(n_ids[j].numpy(), o_nid.numpy())
                for e, oe in zip(eis, o_eis):
                    np.testing.assert_array_equal(e[j].numpy(), oe.numpy())
                np.testing.assert_array_equal(logp[j], st.oracle(node, seq))


def test_port_generator_draws_reproducible_per_seq():
    """Without draw_fn the port's own draws make a response a function of
    (node, seq): two servers agree, and a lane equals its oracle."""
    _check_own_draws(weighted=False)


def test_port_weighted_draws_reproducible_per_seq():
    """The same for a weighted sampler's own ``u01`` draws."""
    _check_own_draws(weighted=True)


def _check_own_draws(weighted):
    coo = generate_pareto_graph(300, 8.0, seed=1)
    tt = qt.CSRTopo(edge_index=coo, edge_weight=np.random.default_rng(2).random(coo.shape[1]))
    x = np.random.default_rng(1).normal(size=(300, F)).astype(np.float32)
    out = []
    for _ in range(2):
        torch.manual_seed(0)
        st = qt.InferenceServer(
            qt.GraphSageSampler(tt, [5, 5], device="cpu", weighted=weighted),
            qt.GraphSAGE(F, HID, CLS),
            qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(x),
            device="cpu", max_batch=4, seed=7)
        reqs = st.serve([1, 2, 3, 250, 250])
        out.append(np.stack([r.result for r in reqs]))
        for r in reqs:
            np.testing.assert_array_equal(r.result, st.oracle(r.node, r.seq))
    np.testing.assert_array_equal(out[0], out[1])
    stats = st.stats()
    assert stats["requests"] == 5 and set(qt.InferenceServer.STAGES) <= set(stats["stages"])
    assert stats["stages"]["queue_wait"]["count"] == 5  # StageStats.as_dict()
    assert stats["stages"]["sample"]["stage"] == "sample"


def test_version_check_and_refresh():
    tt = qt.CSRTopo(edge_index=generate_pareto_graph(200, 4.0, seed=2))
    st = qt.InferenceServer(
        qt.GraphSageSampler(tt, [3], device="cpu"), qt.GraphSAGE(4, 8, 3, num_layers=1),
        qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(
            np.ones((200, 4), np.float32)), device="cpu", max_batch=2)
    st.serve([5])
    tt._version += 1  # what a committed mutation does
    with pytest.raises(qt.VersionMismatchError):
        st.serve([5])
    st.refresh()
    assert st.serve([5])[0].result.shape == (3,)


def test_ladder_buckets_match():
    for m in (1, 2, 8, 64):
        assert buckets_t(m) == buckets_j(m)


def test_server_without_device_raises_on_cpu_only_torch():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    tt = qt.CSRTopo(edge_index=generate_pareto_graph(100, 3.0, seed=0))
    sampler = qt.GraphSageSampler(tt, [2], device="cpu")
    feat = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(
        np.zeros((100, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.InferenceServer(sampler, qt.GraphSAGE(4, 4, 2, num_layers=1), feat)


def test_import_pulls_no_jax():
    """The port and chip_smoke.py import neither JAX nor quiver_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import quiver_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(quiver_tpu_torch.__path__, 'quiver_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'optax', 'quiver_tpu.')) or m == 'quiver_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
