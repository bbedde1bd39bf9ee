"""The training slice of quiver_tpu_torch against quiver_tpu's:
``parallel/train.py`` (init, empty Adjs, the masked NLL, train and eval
steps), training-mode dropout, Adam, and the torch twin of
``examples/train_sage.py`` as a whole.

Inputs are shared: the port's sampler fed JAX's draws (``draw_fn``) gives
the JAX sampler's Adjs bitwise, the features come from the same numpy
seed, and the parameters are flax's, carried across by
``models/convert.py``. Dropout is 0 wherever the two are compared.

Tolerances, float32 throughout:
- ``empty_adjs``, eval-step counts, dropout masks and ``init_model``
  draws from one generator: bitwise;
- ``cross_entropy_on_seeds``: 1e-6 relative;
- one step's loss against ``jax.value_and_grad``: 1e-6 relative; each
  gradient against the transposed flax gradient within 1e-5 x its max |g|
  (the two frameworks sum the products and the segment means in
  different orders);
- Adam from the same three gradients: parameters within 1e-6 absolute;
- three full train steps: losses within 1e-5 relative (after a real Adam
  step parameters are not compared: a float-noise sign flip of a tiny
  gradient moves a parameter by about 2 lr, with no effect on the loss
  beyond that gradient's size);
- ``init_model``'s empirical std at 602 x 256 within 3% of flax's, every
  |w| within two of its truncated normal's stds; the dropout keep share
  within 5 binomial sigmas of 1 - p.
"""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.ops import sample as sample_j  # noqa: E402
from quiver_tpu.parallel import train as train_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.datasets import planted_partition  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE as SageT, dropout  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402

SIZES, BATCH, HID, SEED = (4, 3), 64, 32, 5


def _jax_draws(seed, call, sizes):
    """``draw_fn(layer, deg)`` replaying the JAX sampler's draws of call
    ``call`` (``fold_in(PRNGKey(seed), call)``, split per layer)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), call)
    subs = []
    for _ in sizes:
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draw(l, deg):
        kj, kr = jax.random.split(subs[l])
        d = jnp.asarray(deg.numpy())
        off, _ = sample_j.stratified_offsets(kj, d, sizes[l])
        return torch.from_numpy(np.array(sample_j.rotate_offsets(kr, off, d, sizes[l])))
    return draw


@pytest.fixture(scope="module")
def setup():
    """A planted graph, its port feature store and three training batches
    sampled under JAX's draws (as torch tensors and as JAX arrays)."""
    ds = planted_partition(n=1500, num_classes=5, feature_dim=12, seed=2)
    feat = qt.Feature(device_cache_size=300 * 12 * 4, csr_topo=ds.topo,
                      device="cpu").from_cpu_tensor(ds.features)
    sampler = qt.GraphSageSampler(ds.topo, list(SIZES), device="cpu",
                                  seed_capacity=BATCH, seed=SEED)
    labels_all = torch.from_numpy(ds.labels)
    batches = []
    for call in (1, 2, 3):
        seeds = ds.train_idx[(call - 1) * BATCH:call * BATCH]
        if call == 3:
            seeds = seeds[:50]  # a padded batch: masked rows
        out = sampler.sample(seeds, draw_fn=_jax_draws(SEED, call, SIZES))
        x = feat[out.n_id]
        seed_ids = out.n_id[:BATCH]
        mask = (torch.arange(BATCH) < len(seeds)) & (seed_ids >= 0)
        labels = labels_all[seed_ids.clamp(min=0)]
        adjs_j = [qj.sampling.sampler.Adj(jnp.asarray(a.edge_index.numpy()), None,
                                          a.size, a.fanout) for a in out.adjs]
        batches.append({"x": x, "adjs": out.adjs, "labels": labels, "mask": mask,
                        "xj": jnp.asarray(x.numpy()), "adjs_j": adjs_j,
                        "labels_j": jnp.asarray(labels.numpy()),
                        "mask_j": jnp.asarray(mask.numpy())})
    return ds, batches


def _models(ds, batch):
    mj = SageJ(hidden=HID, num_classes=ds.num_classes, num_layers=2, dropout=0.0)
    params = train_j.init_model(mj, jax.random.PRNGKey(0), batch["xj"], batch["adjs_j"])
    mt = SageT(ds.feature_dim, HID, ds.num_classes, num_layers=2, dropout=0.0)
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return mj, params, mt


def _grad_pairs(mt, grads_j):
    """(port .grad, flax grad transposed to torch's layout) per tensor."""
    pairs = []
    for i, conv in enumerate(mt.convs):
        g = grads_j[f"conv{i}"]
        pairs += [(conv.lin_l.weight.grad, np.asarray(g["lin_l"]["kernel"]).T),
                  (conv.lin_l.bias.grad, np.asarray(g["lin_l"]["bias"])),
                  (conv.lin_r.weight.grad, np.asarray(g["lin_r"]["kernel"]).T)]
    return pairs


@pytest.mark.parametrize("node_count", [None, 300, 100_000])
@pytest.mark.parametrize("sizes,batch", [((25, 10), 1024), ((4, 3, 2), 64)])
def test_empty_adjs_bitwise(sizes, batch, node_count):
    want = train_j.empty_adjs(list(sizes), batch, node_count)
    got = train_t.empty_adjs(list(sizes), batch, node_count, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.size == w.size and g.fanout == w.fanout and g.e_id is None
        assert g.edge_index.dtype == torch.int32
        np.testing.assert_array_equal(g.edge_index.numpy(), np.asarray(w.edge_index))


def test_cross_entropy_on_seeds_matches():
    rng = np.random.default_rng(0)
    logits = np.log(rng.dirichlet(np.ones(7), 40)).astype(np.float32)
    labels = rng.integers(0, 7, 40).astype(np.int32)
    labels[::5] = -1
    mask = rng.random(40) < 0.7
    mask[::5] = False
    for m in (mask, np.zeros(40, bool)):  # all masked: 0, not nan
        want = float(train_j.cross_entropy_on_seeds(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m)))
        got = float(train_t.cross_entropy_on_seeds(
            torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_loss_and_gradients_match_jax(setup):
    """One step's loss and gradients, through ``make_train_step`` (SGD at
    lr 0 keeps the parameters, and the step leaves its gradients in
    ``.grad``)."""
    ds, batches = setup
    b = batches[2]  # the padded batch
    mj, params, mt = _models(ds, b)

    def loss_fn(p):
        logits = mj.apply({"params": p}, b["xj"], b["adjs_j"], train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return train_j.cross_entropy_on_seeds(logits, b["labels_j"], b["mask_j"])

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    step = train_t.make_train_step(mt, torch.optim.SGD(mt.parameters(), lr=0.0))
    loss_t = step(b["x"], b["adjs"], b["labels"], b["mask"])
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6, atol=0)
    for got, want in _grad_pairs(mt, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_adam_matches_optax():
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * s
              for k, v in p0.items()} for s in (1.0, 1e-3, 20.0)]
    tx = optax.adam(1e-2)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = torch.optim.Adam(pt.values(), lr=1e-2)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in pt.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]),
                                       rtol=0, atol=1e-6)


def test_train_and_eval_steps_match_jax(setup):
    """Three full steps (forward, backward, Adam) and an eval step after
    each: losses within 1e-5 relative, counts equal."""
    ds, batches = setup
    mj, params, mt = _models(ds, batches[0])
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step_j = jax.jit(train_j.make_train_step(mj, tx))
    eval_j = jax.jit(train_j.make_eval_step(mj))
    step_t = train_t.make_train_step(mt, torch.optim.Adam(mt.parameters(), lr=1e-2))
    eval_t = train_t.make_eval_step(mt)
    for i, b in enumerate(batches):
        params, opt_state, loss_j = step_j(params, opt_state, b["xj"], b["adjs_j"],
                                           b["labels_j"], b["mask_j"],
                                           jax.random.PRNGKey(i))
        loss_t = step_t(b["x"], b["adjs"], b["labels"], b["mask"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5, atol=0)
        cj, tj = eval_j(params, b["xj"], b["adjs_j"], b["labels_j"], b["mask_j"])
        ct, tt = eval_t(b["x"], b["adjs"], b["labels"], b["mask"])
        assert (int(ct), int(tt)) == (int(cj), int(tj))
    assert int(tt) == 50  # the padded batch counts only its real seeds


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_mask_from_generator(p):
    x = torch.ones(400, 250)
    a = dropout(x, p, torch.Generator().manual_seed(7))
    b = dropout(x, p, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, p, torch.Generator().manual_seed(8)))
    kept = a != 0
    n = x.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    assert torch.equal(dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))


def test_model_dropout_modes(setup):
    """Training draws its masks from the generator; eval mode ignores it
    and is the dropout-free forward, bitwise."""
    ds, batches = setup
    b = batches[0]
    mt = SageT(ds.feature_dim, HID, ds.num_classes, dropout=0.5)
    train_t.init_model(mt, torch.Generator().manual_seed(0))
    plain = SageT(ds.feature_dim, HID, ds.num_classes, dropout=0.0)
    plain.load_state_dict(mt.state_dict())
    with torch.no_grad():
        mt.eval()
        ev = mt(b["x"], b["adjs"])
        g = torch.Generator().manual_seed(4)
        before = g.get_state()
        assert torch.equal(mt(b["x"], b["adjs"], g), ev)
        assert torch.equal(g.get_state(), before)  # nothing drawn
        assert torch.equal(plain.train()(b["x"], b["adjs"]), ev)
        mt.train()
        t1 = mt(b["x"], b["adjs"], torch.Generator().manual_seed(4))
        t2 = mt(b["x"], b["adjs"], torch.Generator().manual_seed(4))
        assert torch.equal(t1, t2) and not torch.equal(t1, ev)
        with pytest.raises(ValueError, match="generator"):
            mt(b["x"], b["adjs"])


def test_init_model_matches_flax_distribution():
    mt = SageT(602, 256, 41)
    train_t.init_model(mt, torch.Generator().manual_seed(0))
    again = train_t.init_model(SageT(602, 256, 41), torch.Generator().manual_seed(0))
    for (name, p), q in zip(mt.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
    w = mt.convs[0].lin_l.weight.detach().numpy()
    assert w.shape == (256, 602)
    std = math.sqrt(1 / 602) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std
    assert not mt.convs[0].lin_l.bias.detach().any()
    kernel = fnn.Dense(256).init(jax.random.PRNGKey(0), jnp.zeros((1, 602)))[
        "params"]["kernel"]
    flax_std = float(np.asarray(kernel).std())
    assert abs(w.std() / flax_std - 1) < 0.03
    assert abs(mt.convs[1].lin_r.weight.detach().numpy().std() * math.sqrt(256) - 1) < 0.03


def _losses(text):
    return [float(v) for v in re.findall(r"Loss: (\S+),", text)]


def test_twin_reaches_acceptance_on_cpu(capsys):
    """``tests/test_datasets.py``'s acceptance run, on the port: test
    accuracy >= 0.85 and >= feature-only Bayes + 0.15."""
    from examples.train_sage_torch import main

    acc, ds = main(["--dataset", "planted:4000:6", "--epochs", "8", "--batch", "256",
                    "--hidden", "64", "--fanout", "10", "5", "--feature-dim", "6",
                    "--device", "cpu"])
    bayes = ds.meta["feature_bayes_acc"]
    assert acc >= 0.85, f"test acc {acc} below the acceptance bar"
    assert acc >= bayes + 0.15, f"acc {acc} does not clear feature Bayes {bayes}"
    out = capsys.readouterr().out
    assert len(_losses(out)) == 8 and "Test Acc:" in out


@pytest.mark.parametrize("extra", [["--eval", "layerwise"], ["--bf16"]])
def test_twin_short_runs_finish(capsys, extra):
    from examples.train_sage_torch import main

    acc, _ = main(["--dataset", "planted:1500:4", "--epochs", "2", "--batch", "128",
                   "--hidden", "16", "--fanout", "5", "3", "--device", "cpu"] + extra)
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert 0.0 <= acc <= 1.0


def test_twin_raises_without_a_card(monkeypatch):
    from examples.train_sage_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--dataset", "planted:500:3", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_t.empty_adjs([3], 8)
