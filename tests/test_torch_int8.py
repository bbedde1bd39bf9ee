"""int8 feature storage in quiver_tpu_torch against quiver_tpu's:
``quantize_rows_int8``, the int8 budget rule, ``Feature(dtype="int8")``
lookups in every store layout, one GraphSAGE train step over an int8
store, and an ``InferenceServer`` over one.

The JAX store runs ``kernel="xla"``, as the JAX package's own int8 tests
run it on the CPU; the port's lookups run K2's plain versions
(``tiered_gather_plain`` with ``scale``).

Tolerances: codes, scales, hot-row counts and looked-up rows bitwise (the
dequantisation is one float32 multiply per element on both sides); the
train step as ``tests/test_torch_train.py`` states it (loss 1e-6
relative, each gradient within 1e-5 x its max |g|); served log-probs
against JAX within atol = rtol = 1e-5, as ``tests/test_torch_serve.py``;
the port's ladder against its own oracle bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.feature.feature import quantize_rows_int8 as quantize_j  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel import train as train_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.datasets import planted_partition  # noqa: E402
from quiver_tpu_torch.feature.feature import quantize_rows_int8 as quantize_t  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.ops.kernels.gather import tiered_gather_dequant  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

N, F = 600, 10


@pytest.fixture(scope="module")
def data():
    coo = generate_pareto_graph(N, 6.0, seed=21)
    x = (np.random.default_rng(21).normal(size=(N, F)) * 3).astype(np.float32)
    x[[0, 17, 599]] = 0.0  # all-zero rows: scale 0, exact zeros back
    return coo, x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_rows_int8_bitwise(data, dtype):
    _, x = data
    x = x.astype(dtype)
    qa, sa = quantize_t(x)
    qb, sb = quantize_j(x)
    assert qa.dtype == np.int8 and sa.dtype == np.float32
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_array_equal(sa.view(np.uint32), sb.view(np.uint32))
    assert not sa[[0, 17, 599]].any() and not qa[[0, 17, 599]].any()


@pytest.mark.parametrize("budget", [0, 4 * N - 1, 4 * N, 4 * N + F - 1, 4 * N + F,
                                    4 * N + 250 * F + 3, 4 * N + N * F, "1G"])
def test_int8_hot_rows_match_jax(data, budget):
    """Below, at and above the 4 B per row the scales take first."""
    _, x = data
    fj = qj.Feature(device_cache_size=budget, dtype="int8").from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, dtype="int8", device="cpu").from_cpu_tensor(x)
    assert ft.hot_rows == fj.hot_rows
    assert ft.dtype == torch.int8 and ft.scale.dtype == torch.float32
    assert ft.scale.shape == (N,) and (ft.cold is None) == (fj.cold is None)


@pytest.mark.parametrize("store", ["hot", "cold", "split"])
@pytest.mark.parametrize("reorder", [False, True])
def test_int8_lookup_bitwise_jax(data, store, reorder):
    coo, x = data
    budget = {"hot": "1G", "cold": 0, "split": 4 * N + 200 * F}[store]
    tj = qj.CSRTopo(edge_index=coo) if reorder else None
    tt = qt.CSRTopo(edge_index=coo) if reorder else None
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, kernel="xla",
                    dtype="int8").from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, csr_topo=tt, dtype="int8",
                    device="cpu").from_cpu_tensor(x)
    assert ft.hot_rows == fj.hot_rows
    assert (ft.feature_order is not None) == (reorder and store != "hot")
    if ft.feature_order is not None:
        np.testing.assert_array_equal(ft.feature_order.numpy(), np.asarray(fj.feature_order))
    np.testing.assert_array_equal(ft.scale.numpy().view(np.uint32),
                                  np.asarray(fj.scale).view(np.uint32))
    rng = np.random.default_rng(len(store) + reorder)
    n_id = rng.integers(0, N, 301).astype(np.int32)
    n_id[rng.random(301) < 0.2] = -1
    n_id[:3] = [0, 17, N - 1]
    want = np.asarray(fj[jnp.asarray(n_id)])
    before = tiered_gather_dequant.launches
    got = ft[torch.from_numpy(n_id)].numpy()
    assert tiered_gather_dequant.launches == before  # CPU tensors never launch
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[n_id < 0].any()
    # the quantisation error bound of the JAX package's own test
    bound = np.abs(x).max(axis=1) / 254.0 + 1e-7
    ok = n_id >= 0
    assert np.all(np.abs(got[ok] - x[n_id[ok]]) <= bound[n_id[ok]][:, None])


# -- one GraphSAGE train step over an int8 store --------------------------

SIZES, BATCH, HID, SEED = (4, 3), 64, 32, 5


def test_train_step_over_int8_store_matches_jax():
    """The same batch through both int8 stores (rows bitwise), then one
    step's loss and gradients against ``jax.value_and_grad``."""
    from test_torch_train import _jax_draws  # JAX's sampler draws, replayed

    ds = planted_partition(n=1500, num_classes=5, feature_dim=12, seed=2)
    budget = 4 * 1500 + 300 * 12
    ft = qt.Feature(device_cache_size=budget, csr_topo=ds.topo, dtype="int8",
                    device="cpu").from_cpu_tensor(ds.features)
    dsj = qj.planted_partition(n=1500, num_classes=5, feature_dim=12, seed=2)
    fj = qj.Feature(device_cache_size=budget, csr_topo=dsj.topo, kernel="xla",
                    dtype="int8").from_cpu_tensor(dsj.features)
    assert ft.hot_rows == fj.hot_rows == 300
    sampler = qt.GraphSageSampler(ds.topo, list(SIZES), device="cpu",
                                  seed_capacity=BATCH, seed=SEED)
    seeds = ds.train_idx[:50]  # a padded batch: masked rows
    out = sampler.sample(seeds, draw_fn=_jax_draws(SEED, 1, SIZES))
    x = ft[out.n_id]
    xj = fj[jnp.asarray(out.n_id.numpy())]
    np.testing.assert_array_equal(x.numpy().view(np.uint32), np.asarray(xj).view(np.uint32))
    seed_ids = out.n_id[:BATCH]
    mask = (torch.arange(BATCH) < len(seeds)) & (seed_ids >= 0)
    labels = torch.from_numpy(ds.labels)[seed_ids.clamp(min=0)]
    adjs_j = [qj.sampling.sampler.Adj(jnp.asarray(a.edge_index.numpy()), None, a.size,
                                      a.fanout) for a in out.adjs]

    mj = SageJ(hidden=HID, num_classes=ds.num_classes, num_layers=2, dropout=0.0)
    params = train_j.init_model(mj, jax.random.PRNGKey(0), xj, adjs_j)
    mt = qt.GraphSAGE(ds.feature_dim, HID, ds.num_classes, num_layers=2, dropout=0.0)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))

    def loss_fn(p):
        logits = mj.apply({"params": p}, xj, adjs_j, train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return train_j.cross_entropy_on_seeds(logits, jnp.asarray(labels.numpy()),
                                              jnp.asarray(mask.numpy()))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    step = train_t.make_train_step(mt, torch.optim.SGD(mt.parameters(), lr=0.0))
    loss_t = step(x, out.adjs, labels, mask)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6, atol=0)
    for i, conv in enumerate(mt.convs):
        g = grads_j[f"conv{i}"]
        for got, want in ((conv.lin_l.weight.grad, np.asarray(g["lin_l"]["kernel"]).T),
                          (conv.lin_l.bias.grad, np.asarray(g["lin_l"]["bias"])),
                          (conv.lin_r.weight.grad, np.asarray(g["lin_r"]["kernel"]).T)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


# -- an InferenceServer over an int8 store ---------------------------------


def test_server_over_int8_store():
    """Served log-probs against the JAX server over the same int8 store
    (JAX's draws replayed), and the port's ladder == its oracle bitwise at
    every bucket, full and padded."""
    from test_torch_serve import jax_draw_fn  # JAX's ladder draws, replayed

    Fs, cls, sizes, seed = 12, 5, (4, 3), 3
    coo = generate_pareto_graph(400, 6.0, seed=5)
    tj, tt = qj.CSRTopo(edge_index=coo), qt.CSRTopo(edge_index=coo)
    x = np.random.default_rng(5).normal(size=(400, Fs)).astype(np.float32)
    budget = 4 * 400 + 100 * Fs  # 100 hot rows by degree, 300 cold
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, kernel="xla",
                    dtype="int8").from_cpu_tensor(x)
    ft = qt.Feature(device_cache_size=budget, csr_topo=tt, dtype="int8",
                    device="cpu").from_cpu_tensor(x)
    mj = SageJ(hidden=16, num_classes=cls, num_layers=2)
    adjs = train_j.empty_adjs(list(sizes), batch=2, node_count=400)
    params = train_j.init_model(mj, jax.random.PRNGKey(seed),
                                np.zeros((adjs[0].size[0], Fs), np.float32), adjs)
    mt = qt.GraphSAGE(Fs, 16, cls, num_layers=2)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    sj = qj.InferenceServer(qj.GraphSageSampler(tj, list(sizes), seed=seed),
                            mj, params, fj, buckets=(1, 2), seed=seed)
    st = qt.InferenceServer(qt.GraphSageSampler(tt, list(sizes), device="cpu", seed=seed),
                            mt, ft, device="cpu", buckets=(1, 2), seed=seed,
                            draw_fn=jax_draw_fn(seed, sizes))
    nodes = np.random.default_rng(0).integers(0, 400, 5)
    rj, rt = sj.serve(nodes), st.serve(nodes)
    for a, b in zip(rt, rj):
        assert a.result.shape == (cls,) and a.overflow == b.overflow == 0
        np.testing.assert_allclose(a.result, b.result, atol=1e-5, rtol=1e-5)

    lad = st.ladder
    picks = [(3, 100), (250, 101), (17, 102)]
    for bucket in st.batcher.buckets:
        for group in (picks[:bucket], picks[1:bucket]):
            seeds = torch.full((bucket,), -1, dtype=torch.int32)
            seqs = [None] * bucket
            for j, (node, seq) in enumerate(group):
                seeds[j], seqs[j] = node, seq
            n_ids, eis, _ = lad.sample_exec(bucket)(seeds, seqs)
            xs = st.feature[n_ids.reshape(-1)].reshape(bucket, lad.lane_caps[-1], Fs)
            assert xs.dtype == torch.float32
            logp = lad.forward_exec(bucket)(xs, eis).numpy()
            for j, (node, seq) in enumerate(group):
                o_nid, _, _ = lad.oracle_sample(node, seq)
                np.testing.assert_array_equal(n_ids[j].numpy(), o_nid.numpy())
                np.testing.assert_array_equal(logp[j], st.oracle(node, seq))


def test_twin_trains_over_an_int8_store(capsys):
    """``examples/train_sage_torch.py --int8``: the store holds int8 codes
    (about four times the rows of the f32 budget on the device), the
    losses stay finite; ``--bf16 --int8`` is refused."""
    import math
    import re

    from examples.train_sage_torch import main, parse_args, setup

    argv = ["--dataset", "planted:1500:4", "--epochs", "2", "--batch", "128",
            "--hidden", "16", "--fanout", "5", "3", "--device", "cpu"]
    run = setup(parse_args(argv + ["--int8"]))
    f32 = setup(parse_args(argv))
    assert run.feature.dtype == torch.int8 and run.feature.scale is not None
    n, dim = run.feature.shape
    budget = int(0.2 * n) * dim * 4
    assert f32.feature.hot_rows == budget // (dim * 4)
    assert run.feature.hot_rows == min(n, max(budget - 4 * n, 0) // dim)
    capsys.readouterr()
    acc, _ = main(argv + ["--int8"])
    losses = [float(v) for v in re.findall(r"Loss: (\S+),", capsys.readouterr().out)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert 0.0 <= acc <= 1.0
    with pytest.raises(ValueError, match="pick one"):
        setup(parse_args(argv + ["--int8", "--bf16"]))
