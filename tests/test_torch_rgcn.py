"""R-GCN of quiver_tpu_torch (``models/rgcn.py``, ``rgcn_layerwise_inference``,
``flax_rgcn_to_state_dict``) against quiver_tpu's, and the torch twin of
``examples/train_rgcn_hetero.py``.

Inputs are shared: the port's sampler draws one sample of
``tests/test_hetero.py``'s toy schema (120 papers, 60 authors, 20
institutions), its layers go through both packages, and the flax
parameters (redrawn from numpy so that biases are not zero) are carried
across by ``flax_rgcn_to_state_dict``. Dropout is 0 wherever the two are
compared.

Tolerances, float32 throughout (the frameworks sum in different orders):
- log-probs, forward and layer-wise: within 1e-5 relative plus 1e-5 of
  the largest magnitude absolute;
- one step's loss: 1e-6 relative; each gradient within 1e-5 x its max |g|
  (``tests/test_torch_families.py``'s tolerances);
- the layer-wise pass against the port's own sampled model at full
  fanout: rtol 2e-4, atol 2e-5 (``tests/test_inference.py``'s oracle).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import inference as inference_j  # noqa: E402
from quiver_tpu.models import rgcn as rgcn_j  # noqa: E402
from quiver_tpu.parallel import train as train_j  # noqa: E402
from quiver_tpu.sampling import hetero as hetero_j  # noqa: E402
from quiver_tpu.sampling import sampler as sampler_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import convert, inference  # noqa: E402
from quiver_tpu_torch.models.rgcn import RGCN, rgcn_schema  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402

from test_torch_hetero import toy_schema  # noqa: E402

HID, CLS = 16, 5
WIDTHS = {"uniform": {"paper": 8, "author": 8, "inst": 8},
          "mixed": {"paper": 24, "author": 8, "inst": 4}}


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def graph():
    num_nodes, edges = toy_schema(seed=5)
    return (qj.HeteroCSRTopo(num_nodes, edges), qt.HeteroCSRTopo(num_nodes, edges),
            num_nodes)


def _tables(num_nodes, widths, seed=2):
    rng = np.random.default_rng(seed)
    return {t: rng.normal(size=(n, widths[t])).astype(np.float32)
            for t, n in num_nodes.items()}


def _inputs(out, tables):
    """Each type's rows for a sample's ``n_id`` (zeros on -1 lanes)."""
    x = {}
    for t, ids in out.n_id.items():
        ids = ids.numpy()
        x[t] = np.where((ids >= 0)[:, None], tables[t][np.maximum(ids, 0)], 0).astype(
            np.float32)
    return x


def _jax_layers(layers):
    """The port's HeteroLayers as the JAX package's (jnp arrays)."""
    return [hetero_j.HeteroLayer(
        {et: sampler_j.Adj(jnp.asarray(a.edge_index.numpy()), None, a.size, a.fanout)
         for et, a in layer.adjs.items()}, dict(layer.src_caps), dict(layer.dst_caps))
        for layer in layers]


def _randomise(shapes, seed):
    """A flax parameter tree of these shapes, drawn from numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.4).astype(np.float32), shapes)


def _pair(out, x, widths, num_bases, seed=3):
    """(JAX model, its randomised params, the port model loaded with them)."""
    mj = rgcn_j.RGCN(hidden=HID, num_classes=CLS, target_type="paper", num_layers=2,
                     num_bases=num_bases, dropout=0.0)
    xj = {t: jnp.asarray(v) for t, v in x.items()}
    # the flax tree's shapes, traced without running the init
    shapes = jax.eval_shape(lambda: mj.init({"params": jax.random.PRNGKey(0)}, xj,
                                            _jax_layers(out.adjs)))["params"]
    params = _randomise(shapes, seed)
    mt = RGCN(rgcn_schema(out.adjs, widths), HID, CLS, "paper", num_layers=2,
              num_bases=num_bases, dropout=0.0)
    state = convert.flax_rgcn_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(state) == sorted(mt.state_dict())  # one to one onto flax's tree
    mt.load_state_dict(state)
    return mj, params, mt


@pytest.mark.parametrize("num_bases,widths", [(0, "uniform"), (3, "uniform"), (3, "mixed"),
                                              (0, "mixed")])
def test_forward_loss_and_gradients_match_jax(graph, num_bases, widths):
    tj, tt, num_nodes = graph
    out = qt.HeteroGraphSampler(tt, [3, 2], "paper", seed_capacity=16, seed=1,
                                device="cpu").sample(np.arange(16))
    x = _inputs(out, _tables(num_nodes, WIDTHS[widths]))
    mj, params, mt = _pair(out, x, WIDTHS[widths], num_bases)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, CLS, 16).astype(np.int32)
    mask = rng.random(16) < 0.8
    layers_j = _jax_layers(out.adjs)
    xj = {t: jnp.asarray(v) for t, v in x.items()}

    def loss_fn(p):
        logp = mj.apply({"params": p}, xj, layers_j, train=True)
        return train_j.cross_entropy_on_seeds(logp, jnp.asarray(labels),
                                              jnp.asarray(mask)), logp

    (loss_j, logp_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    mt.train()
    logp_t = mt({t: torch.from_numpy(v) for t, v in x.items()}, out.adjs)
    _close(logp_t.detach().numpy(), logp_j)
    loss_t = train_t.cross_entropy_on_seeds(logp_t, torch.from_numpy(labels),
                                            torch.from_numpy(mask))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6, atol=0)
    want = convert.flax_rgcn_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    got = dict(mt.named_parameters())
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name].grad.numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(w.numpy()).max(), err_msg=name)


@pytest.mark.parametrize("num_bases", [0, 3])
def test_layerwise_matches_jax_hbm_and_host(graph, num_bases):
    tj, tt, num_nodes = graph
    widths = WIDTHS["mixed"]
    out = qt.HeteroGraphSampler(tt, [3, 2], "paper", seed_capacity=16, seed=2,
                                device="cpu").sample(np.arange(16))
    tables = _tables(num_nodes, widths, seed=6)
    mj, params, mt = _pair(out, _inputs(out, tables), widths, num_bases, seed=7)
    want = np.asarray(inference_j.rgcn_layerwise_inference(mj, params, tj, tables,
                                                            chunk=97))
    got = {mode: inference.rgcn_layerwise_inference(mt, tt, tables, chunk=97, mode=mode,
                                                    device="cpu").numpy()
           for mode in ("HBM", "HOST")}
    assert want.shape == (num_nodes["paper"], CLS)
    _close(got["HBM"], want)
    np.testing.assert_array_equal(got["HOST"], got["HBM"])


@pytest.mark.parametrize("num_bases", [0, 3])
def test_layerwise_equals_sampled_model_at_full_fanout(graph, num_bases):
    """With fanout -1 every in-edge of every relation is sampled, so the
    sampled model's seed rows equal the whole-graph pass."""
    _, tt, num_nodes = graph
    widths = WIDTHS["mixed"]
    seeds = np.arange(40)
    out = qt.HeteroGraphSampler(tt, [-1, -1], "paper", seed_capacity=40,
                                device="cpu").sample(seeds)
    assert int(out.overflow) == 0
    tables = _tables(num_nodes, widths, seed=8)
    mt = RGCN(rgcn_schema(out.adjs, widths), HID, CLS, "paper", num_bases=num_bases)
    train_t.init_model(mt, torch.Generator().manual_seed(5))
    mt.eval()
    with torch.no_grad():
        sampled = mt({t: torch.from_numpy(v) for t, v in _inputs(out, tables).items()},
                     out.adjs).numpy()
    full = inference.rgcn_layerwise_inference(mt, tt, tables, chunk=67,
                                              device="cpu").numpy()[seeds]
    np.testing.assert_allclose(sampled, full, rtol=2e-4, atol=2e-5)


def test_schema_init_and_contract(graph):
    _, tt, num_nodes = graph
    widths = WIDTHS["mixed"]
    out = qt.HeteroGraphSampler(tt, [3, 2], "paper", seed_capacity=16,
                                device="cpu").sample(np.arange(16))
    schema = rgcn_schema(out.adjs, widths)
    assert schema["in_dims"] == widths
    # the deepest layer serves paper and author (inst only sends), the last
    # layer paper alone, through its two relations
    assert sorted(schema["layers"][0]["self"]) == ["author", "paper"]
    assert len(schema["layers"][0]["rels"]) == 3
    assert schema["layers"][1] == {"self": ["paper"],
                                   "rels": sorted(out.adjs[1].adjs, key=str)}
    model = RGCN(schema, HID, CLS, "paper", num_bases=2)
    train_t.init_model(model, torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert {"conv0.bases_24", "conv0.bases_8", "conv0.bases_4", "conv1.bases_16",
            "conv0.self_paper.weight", "conv1.coef_paper__cites__paper"} <= set(names)
    assert not any(n.startswith("conv0.rel_") for n in names)
    for n, p in names.items():
        assert torch.isfinite(p).all() and (p.abs().sum() > 0 or n.endswith("bias")), n
    x = {t: torch.from_numpy(v) for t, v in _inputs(out, _tables(num_nodes, widths)).items()}
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(x, out.adjs)
    a = model(x, out.adjs, torch.Generator().manual_seed(1))
    b = model(x, out.adjs, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (16, CLS)
    with pytest.raises(ValueError, match="hetero layers"):
        model(x, out.adjs[:1])
    with pytest.raises(ValueError, match="schema has"):
        RGCN(schema, HID, CLS, "paper", num_layers=3)
    other = qt.HeteroGraphSampler(tt, [{("paper", "cites", "paper"): 2}, 2], "paper",
                                  device="cpu").sample(np.arange(16))
    with pytest.raises(ValueError, match="build the model from a schema"):
        RGCN(rgcn_schema(other.adjs, widths), HID, CLS, "paper").eval()(x, out.adjs)
    bf = RGCN(schema, HID, CLS, "paper", dtype="bfloat16").eval()
    train_t.init_model(bf, torch.Generator().manual_seed(0))
    logp = bf(x, out.adjs)
    assert logp.dtype == torch.float32 and torch.isfinite(logp).all()
    assert all(p.dtype == torch.float32 for p in bf.parameters())


def test_twin_trains_on_cpu(capsys):
    from examples.train_rgcn_hetero_torch import main

    losses = main(["--papers", "2000", "--steps", "3", "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
