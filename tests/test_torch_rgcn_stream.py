"""The streamed R-GCN step of quiver_tpu_torch
(``HeteroGraphSampler.sample_padded``, ``parallel/train.py``
``hetero_stream_steps``) against quiver_tpu's compiled hetero ``run``
(``HeteroGraphSampler._compiled``) and ``benchmarks/bench_rgcn.py
--stream``'s scan body.

Inputs are shared: numpy-seeded typed graphs (``tests/test_hetero.py``'s
toy and power-law schemas), JAX's draws replayed under the key its
compiled ``run`` takes (``jax_key_draw_fn``), and flax parameters carried
across by ``flax_rgcn_to_state_dict``.

Tolerances:
- sampling: bitwise (ids, counts, every ``Adj``, overflow and the per-hop
  unique counts are integers), against JAX's ``run`` and against the
  port's own ``sample``;
- 4 streamed steps (dropout 0, Adam 5e-3 on both sides) against a
  ``lax.scan`` of the benchmark's step: each loss within 1e-6 relative,
  each final parameter within 1e-5 x its max |p|
  (``tests/test_torch_rgcn.py``'s step tolerances); the summed overflow
  exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax import lax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import rgcn as rgcn_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import convert  # noqa: E402
from quiver_tpu_torch.models.rgcn import RGCN, rgcn_schema  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402

from test_torch_hetero import (CITES, assert_same_output, both_topos,  # noqa: E402
                               jax_draw_fn, jax_key_draw_fn, powerlaw_topos)
from test_torch_rgcn import _jax_layers, _randomise  # noqa: E402

HID, CLS, LR = 16, 5, 5e-3


def _padded(seeds, cap):
    out = np.full(cap, -1, np.int32)
    out[:len(seeds)] = seeds
    return out


def _as_output(res, batch):
    """A ``run``/``sample_padded`` tuple as a ``HeteroSampleOutput``."""
    frontier, counts, layers, overflow, fcounts = res
    return qt.HeteroSampleOutput(frontier, counts, batch, layers, overflow, fcounts)


def _samplers(case):
    """(JAX sampler, port sampler, seed capacity, planning batch) of one
    case, both auto samplers with the same cap overrides."""
    if case.startswith("toy"):
        tj, tt, _ = both_topos(seed=3, weights=True)
        sizes, cap, n = [3, 2], 32, 120
    else:
        tj, tt = powerlaw_topos(weights=True)
        sizes, cap, n = [4, 3], 128, 3000
    kw = {"seed_capacity": cap, "frontier_caps": "auto", "seed": 4}
    if "weighted" in case:
        kw["weighted"] = [CITES]
    sj = qj.HeteroGraphSampler(tj, sizes, "paper", dedup="sort", **kw)
    st = qt.HeteroGraphSampler(tt, sizes, "paper", device="cpu", **kw)
    return sj, st, cap, np.random.default_rng(0).integers(0, n, cap)


@pytest.mark.parametrize("case", ["toy_uniform", "toy_weighted", "powerlaw_uniform",
                                  "powerlaw_weighted", "powerlaw_small_cap"])
def test_sample_padded_bitwise_jax_compiled_run(case):
    sj, st, cap, plan_batch = _samplers(case)
    # plan both samplers' caps on one batch under the same draws
    oj = sj.sample(plan_batch)
    assert_same_output(st.sample(plan_batch, draw_fn=jax_draw_fn(st, 4, 1)), oj)
    assert st._cap_overrides == sj._cap_overrides is not None
    if case.endswith("small_cap"):
        # every type at the floor of a planned cap: the hops overflow
        small = tuple({t: 1 for t in layer} for layer in sj._cap_overrides)
        sj._cap_overrides = st._cap_overrides = small
    rng = np.random.default_rng(1)
    seeds = _padded(rng.integers(0, st.topo.num_nodes["paper"], cap - 5), cap)
    key = jax.random.PRNGKey(17)
    run = sj._compiled(cap)
    want = _as_output(run(sj.dev_topos, jnp.asarray(seeds), jnp.int32(cap - 5), key), cap)
    for num in (cap - 5, torch.tensor(cap - 5, dtype=torch.int32)):
        got = st.sample_padded(torch.from_numpy(seeds), num,
                               draw_fn=jax_key_draw_fn(st, key))
        assert_same_output(_as_output(got, cap), want)
    if case.endswith("small_cap"):
        assert int(want.overflow) > 0
    else:
        assert int(want.overflow) == 0


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_padded_bitwise_own_sample(weighted):
    """``sample_padded`` with neither generator nor ``draw_fn`` draws from
    the sampler's own stream, as ``sample`` does; with a generator, from
    its initial seed, read and not advanced."""
    _, tt, _ = both_topos(seed=5, weights=weighted)
    kw = {"seed_capacity": 32, "seed": 2, "weighted": weighted, "with_eid": True}
    a = qt.HeteroGraphSampler(tt, [3, 2], "paper", device="cpu", **kw)
    b = qt.HeteroGraphSampler(tt, [3, 2], "paper", device="cpu", **kw)
    seeds = np.random.default_rng(3).integers(0, 120, 27)
    want = a.sample(seeds)
    got = b.sample_padded(torch.from_numpy(_padded(seeds, 32)), torch.tensor(27))
    assert_same_output(_as_output(got, 27), want)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    one, two = (b.sample_padded(torch.from_numpy(_padded(seeds, 32)), 27, generator=g)
                for _ in range(2))
    assert torch.equal(g.get_state(), state)
    assert_same_output(_as_output(one, 27), _as_output(two, 27))


# -- 4 streamed steps against bench_rgcn.py --stream's scan body -------------


def _tables(num_nodes, width=8, seed=2):
    rng = np.random.default_rng(seed)
    return {t: rng.normal(size=(n, width)).astype(np.float32)
            for t, n in num_nodes.items()}


def _jax_stream(sj, feature, labels_all, params, seed_mat, key0, batch):
    """``bench_rgcn.py``'s ``scan_train`` (:238-259) over ``seed_mat``:
    its step (:159-173) at dropout 0 with optax ``adam``."""
    model = rgcn_j.RGCN(hidden=HID, num_classes=CLS, target_type="paper",
                        num_layers=2, dropout=0.0)
    tx = optax.adam(LR)
    run = sj._compiled(batch)

    def step(p, o, x_dict, layers, labels, mask, key):
        def loss_fn(q):
            logp = model.apply({"params": q}, x_dict, layers, train=True,
                               rngs={"dropout": key})
            ll = jnp.take_along_axis(logp, jnp.clip(labels, 0)[:, None], axis=1)[:, 0]
            w = mask.astype(logp.dtype)
            return -(ll * w).sum() / jnp.maximum(w.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    @jax.jit
    def scan_train(p, o, dev_topos, seed_mat, key0):
        keys = jax.random.split(key0, seed_mat.shape[0])

        def body(carry, xs):
            p, o, oflo = carry
            seeds, k = xs
            ks, kd = jax.random.split(k)
            frontier, counts, layers, overflow, _ = run(dev_topos, seeds,
                                                        jnp.int32(batch), ks)
            seed_ids = frontier["paper"][:batch]
            labels = labels_all[jnp.clip(seed_ids, 0)]
            p, o, loss = step(p, o, feature[frontier], layers, labels, seed_ids >= 0, kd)
            return (p, o, oflo + overflow), loss

        (p, o, oflo), losses = lax.scan(body, (p, o, jnp.zeros((), jnp.int32)),
                                        (seed_mat, keys))
        return p, losses, oflo

    return scan_train(params, tx.init(params), sj.dev_topos, jnp.asarray(seed_mat), key0)


@pytest.mark.parametrize("weighted", [False, True])
def test_four_streamed_steps_match_jax_scan(weighted):
    tj, tt, _ = both_topos(seed=6, weights=weighted)
    batch, steps = 32, 4
    kw = {"seed_capacity": batch, "seed": 0, "weighted": weighted}
    sj = qj.HeteroGraphSampler(tj, [3, 2], "paper", dedup="sort", **kw)
    st = qt.HeteroGraphSampler(tt, [3, 2], "paper", device="cpu", **kw)
    tables = _tables(tt.num_nodes)
    fj = qj.HeteroFeature.from_cpu_tensors(tables, device_cache_size="1G")
    ft = qt.HeteroFeature.from_cpu_tensors(tables, device_cache_size="1G", device="cpu")
    rng = np.random.default_rng(7)
    labels = rng.integers(0, CLS, tt.num_nodes["paper"]).astype(np.int32)
    seed_mat = rng.integers(0, tt.num_nodes["paper"], (steps, batch)).astype(np.int32)
    seed_mat[-1, -3:] = -1  # padded lanes are masked out of the loss

    # the flax tree's shapes from one sample's layers, drawn from numpy
    out = st.sample(seed_mat[0])
    widths = {t: 8 for t in tt.num_nodes}
    mj = rgcn_j.RGCN(hidden=HID, num_classes=CLS, target_type="paper", num_layers=2,
                     dropout=0.0)
    xj = {t: jnp.zeros((v.shape[0], 8), jnp.float32) for t, v in out.n_id.items()}
    shapes = jax.eval_shape(lambda: mj.init({"params": jax.random.PRNGKey(0)}, xj,
                                            _jax_layers(out.adjs)))["params"]
    params = _randomise(shapes, 3)
    mt = RGCN(rgcn_schema(out.adjs, widths), HID, CLS, "paper", num_layers=2, dropout=0.0)
    mt.load_state_dict(convert.flax_rgcn_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))

    key0 = jax.random.PRNGKey(5)
    p_j, losses_j, oflo_j = _jax_stream(sj, fj, jnp.asarray(labels), params, seed_mat,
                                        key0, batch)
    step_keys = [jax.random.split(k)[0] for k in jax.random.split(key0, steps)]
    draws = {}

    def draw_fn(t, hop, et, deg):
        if t not in draws:
            draws[t] = jax_key_draw_fn(st, step_keys[t])
        return draws[t](hop, et, deg)

    step = train_t.make_train_step(mt, torch.optim.Adam(mt.parameters(), lr=LR))
    losses_t, oflo_t = train_t.hetero_stream_steps(
        st, ft, torch.from_numpy(labels), step, torch.from_numpy(seed_mat),
        torch.tensor(batch, dtype=torch.int32), 0, draw_fn=draw_fn)
    assert losses_t.shape == (steps,) and int(oflo_t) == int(oflo_j) == 0
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-6, atol=0)
    want = convert.flax_rgcn_to_state_dict(jax.tree_util.tree_map(np.asarray, p_j))
    got = dict(mt.named_parameters())
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_stream_keys_steps_as_the_trainer():
    """Step ``t`` samples from ``(fold_key(key0, 0, t), 0)`` and drops out
    from ``(..., 1)``: the stream's losses are those of a loop of the same
    calls, and its overflow their sum."""
    from quiver_tpu_torch.ops.sample import fold_key, seeded_generator

    _, tt, _ = both_topos(seed=2)
    st = qt.HeteroGraphSampler(tt, [3, 2], "paper", seed_capacity=32, device="cpu")
    tables = _tables(tt.num_nodes)
    ft = qt.HeteroFeature.from_cpu_tensors(tables, device_cache_size=0, device="cpu")
    labels = torch.from_numpy(np.random.default_rng(1).integers(0, CLS, 120))
    seed_mat = torch.from_numpy(
        np.random.default_rng(2).integers(0, 120, (3, 32)).astype(np.int32))
    out = st.sample(seed_mat[0].numpy())
    schema = rgcn_schema(out.adjs, {t: 8 for t in tt.num_nodes})
    runs = []
    for streamed in (True, False):
        model = RGCN(schema, HID, CLS, "paper", num_layers=2, dropout=0.5)
        train_t.init_model(model, torch.Generator().manual_seed(0))
        step = train_t.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
        if streamed:
            losses, ovf = train_t.hetero_stream_steps(st, ft, labels, step, seed_mat, 32, 9)
        else:
            losses, ovf = [], 0
            for t in range(3):
                k = fold_key(9, 0, t)
                res = st.sample_padded(seed_mat[t], 32, generator=seeded_generator("cpu", k, 0))
                ids = res[0]["paper"][:32]
                losses.append(step(ft[res[0]], res[2], labels[ids.clamp(min=0)], ids >= 0,
                                   seeded_generator("cpu", k, 1)))
                ovf += int(res[3])
            losses = torch.stack(losses)
        runs.append((losses, int(ovf), [p.detach().clone() for p in model.parameters()]))
    (la, oa, pa), (lb, ob, pb) = runs
    assert torch.equal(la, lb) and oa == ob
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
