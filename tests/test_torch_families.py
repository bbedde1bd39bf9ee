"""GCN, GIN and GAT of quiver_tpu_torch (``models/gcn.py``, ``gin.py``,
``gat.py``, the softmaxes and counts of ``models/layers.py``) against
quiver_tpu's.

Inputs are shared: the same numpy features and edge blocks go through
both packages, and the flax parameters (randomised from numpy so that
biases and ``eps`` are not zero) are carried across by
``models/convert.py``. Dropout is 0 wherever the two are compared.

Tolerances, float32 throughout (the frameworks sum in different orders):
- a conv's output, and a model's log-probs: within 1e-5 relative plus
  1e-5 of the largest magnitude absolute;
- one step's loss: 1e-6 relative; each gradient within 1e-5 x its max
  |g| (``tests/test_torch_train.py``'s tolerances);
- ``fanout_softmax`` against ``segment_softmax`` and against JAX's:
  within 1e-6 absolute (weights lie in [0, 1]);
- ``occurrence_counts`` and ``zero_scatter_counts``: bitwise;
- GAT's padding lanes: bitwise nothing changes; an isolated destination
  gets exactly its bias.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import gat as gat_j, gcn as gcn_j, gin as gin_j  # noqa: E402
from quiver_tpu.models import layers as layers_j  # noqa: E402
from quiver_tpu.parallel import train as train_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.models import convert  # noqa: E402
from quiver_tpu_torch.models import gat as gat_t, gcn as gcn_t, gin as gin_t  # noqa: E402
from quiver_tpu_torch.models import layers as layers_t  # noqa: E402
from quiver_tpu_torch.parallel import train as train_t  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

FAMILIES = ("gcn", "gin", "gat")
F_IN, HID, CLS, HEADS = 12, 16, 5, 3


def _randomise(params, seed):
    """Every leaf of a flax tree redrawn from numpy (biases and eps too)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.4).astype(np.float32), params)


def _conv_pair(family, in_ch, out_ch, seed, **kw):
    """(JAX conv, its randomised params, the port conv loaded with them)."""
    x0 = jnp.zeros((6, in_ch), jnp.float32)
    ei0 = jnp.asarray(np.array([[0, 1], [0, 1]], np.int32))
    if family == "gcn":
        cj, ct, conv_sd = (gcn_j.GCNConv(out_ch), gcn_t.GCNConv(in_ch, out_ch),
                           convert.flax_gcn_to_state_dict)
    elif family == "gin":
        cj = gin_j.GINConv(out_ch, mlp_hidden=HID, train_eps=kw.get("train_eps", False))
        ct = gin_t.GINConv(in_ch, out_ch, mlp_hidden=HID,
                           train_eps=kw.get("train_eps", False))
        conv_sd = convert.flax_gin_to_state_dict
    else:
        cj = gat_j.GATConv(out_ch, heads=HEADS, concat=kw.get("concat", True))
        ct = gat_t.GATConv(in_ch, out_ch, heads=HEADS, concat=kw.get("concat", True))
        conv_sd = convert.flax_gat_to_state_dict
    params = _randomise(cj.init(jax.random.PRNGKey(seed), x0, ei0, 2)["params"], seed)
    sd = conv_sd({"conv0": params})
    ct.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    return cj, params, ct


def _model_pair(family, seed, train_eps=False):
    """(JAX model, randomised params, the port model loaded with them)."""
    if family == "gcn":
        mj = gcn_j.GCN(hidden=HID, num_classes=CLS, num_layers=2, dropout=0.0)
        mt = gcn_t.GCN(F_IN, HID, CLS, num_layers=2, dropout=0.0)
        conv_sd = convert.flax_gcn_to_state_dict
    elif family == "gin":
        mj = gin_j.GIN(hidden=HID, num_classes=CLS, num_layers=2, dropout=0.0,
                       train_eps=train_eps)
        mt = gin_t.GIN(F_IN, HID, CLS, num_layers=2, dropout=0.0, train_eps=train_eps)
        conv_sd = convert.flax_gin_to_state_dict
    else:
        mj = gat_j.GAT(hidden=HID, num_classes=CLS, num_layers=2, heads=HEADS,
                       dropout=0.0)
        mt = gat_t.GAT(F_IN, HID, CLS, num_layers=2, heads=HEADS, dropout=0.0)
        conv_sd = convert.flax_gat_to_state_dict
    adjs = train_j.empty_adjs([3, 3], batch=8, node_count=400)
    x0 = np.zeros((adjs[0].size[0], F_IN), np.float32)
    params = _randomise(train_j.init_model(mj, jax.random.PRNGKey(seed), x0, adjs), seed)
    mt.load_state_dict(conv_sd(params))
    return mj, params, mt


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _regular_block(num_src, num_dst, fanout, seed, holes=0.25):
    """A regular-layout edge block (lane s*fanout + k targets s) with a
    share of -1 lanes, and two destinations with no valid lane at all."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, num_dst * fanout).astype(np.int32)
    dst = np.repeat(np.arange(num_dst, dtype=np.int32), fanout)
    src[rng.random(src.shape) < holes] = -1
    src[:fanout] = -1
    src[3 * fanout:4 * fanout] = -1
    dst = np.where(src >= 0, dst, -1).astype(np.int32)
    return np.stack([src, dst])


@pytest.fixture(scope="module")
def batch():
    """One sampled batch of a pareto graph (the port's sampler, uniform
    [4, 3] x 24 seeds, 8 of them padding), its features, labels and mask."""
    coo = generate_pareto_graph(400, 6.0, seed=2)
    topo = qt.CSRTopo(edge_index=coo)
    sampler = qt.GraphSageSampler(topo, [4, 3], device="cpu", seed_capacity=32, seed=3)
    seeds = np.arange(0, 400, 17)[:24]
    out = sampler.sample(seeds)
    rng = np.random.default_rng(4)
    table = rng.normal(size=(400, F_IN)).astype(np.float32)
    n_id = out.n_id.numpy()
    x = np.where((n_id >= 0)[:, None], table[np.maximum(n_id, 0)], 0).astype(np.float32)
    cap = out.adjs[-1].size[1]
    labels = rng.integers(0, CLS, cap).astype(np.int32)
    mask = np.arange(cap) < len(seeds)
    return {"x": x, "adjs": out.adjs, "labels": labels, "mask": mask}


def _adjs(adjs, dense: bool):
    """The port's Adjs and JAX Adjs of the same edges; ``dense=False``
    drops the fanout claim, so both take the segment path."""
    t = [qt.Adj(a.edge_index, None, a.size, a.fanout if dense else None) for a in adjs]
    j = [qj.sampling.sampler.Adj(jnp.asarray(a.edge_index.numpy()), None, a.size,
                                 a.fanout if dense else None) for a in adjs]
    return t, j


@pytest.mark.parametrize("path", ["dense", "segment"])
@pytest.mark.parametrize("family", FAMILIES)
def test_conv_forward_matches_jax(family, path):
    num_src, num_dst, fanout = 30, 10, 4
    ei = _regular_block(num_src, num_dst, fanout, seed=len(family))
    x = np.random.default_rng(1).normal(size=(num_src, F_IN)).astype(np.float32)
    if path == "segment":  # a shuffled, irregular block with padding lanes
        perm = np.random.default_rng(2).permutation(ei.shape[1])
        ei = np.concatenate([ei[:, perm], np.full((2, 5), -1, np.int32)], axis=1)
    fan = fanout if path == "dense" else None
    cj, params, ct = _conv_pair(family, F_IN, 7, seed=3)
    want = cj.apply({"params": params}, jnp.asarray(x), jnp.asarray(ei), num_dst, fan)
    with torch.no_grad():
        got = ct(torch.from_numpy(x), torch.from_numpy(ei), num_dst, fan)
    _close(got.numpy(), want)


@pytest.mark.parametrize("path", ["dense", "segment"])
@pytest.mark.parametrize("family", FAMILIES)
def test_model_logprobs_loss_and_gradients_match_jax(batch, family, path):
    mj, params, mt = _model_pair(family, seed=5)
    adjs_t, adjs_j = _adjs(batch["adjs"], path == "dense")
    xj, lab_j, mask_j = (jnp.asarray(batch[k]) for k in ("x", "labels", "mask"))

    def loss_fn(p):
        logits = mj.apply({"params": p}, xj, adjs_j, train=True)
        return train_j.cross_entropy_on_seeds(logits, lab_j, mask_j), logits

    (loss_j, logp_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    mt.train()
    logp_t = mt(torch.from_numpy(batch["x"]), adjs_t)
    _close(logp_t.detach().numpy(), logp_j)
    loss_t = train_t.cross_entropy_on_seeds(logp_t, torch.from_numpy(batch["labels"]),
                                            torch.from_numpy(batch["mask"]))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6, atol=0)
    want = convert_grads(family, grads_j)
    got = dict(mt.named_parameters())
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name].grad.numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def convert_grads(family, grads_j):
    """flax gradients in the port's parameter names and layouts."""
    fn = {"gcn": convert.flax_gcn_to_state_dict, "gin": convert.flax_gin_to_state_dict,
          "gat": convert.flax_gat_to_state_dict}[family]
    return {k: v.numpy() for k, v in fn(jax.tree_util.tree_map(np.asarray, grads_j)).items()}


def test_gin_train_eps_matches_jax(batch):
    """A learnable eps: a 0-d parameter carried across, used in the
    forward, and its gradient within the stated tolerance."""
    mj, params, mt = _model_pair("gin", seed=6, train_eps=True)
    assert "eps" in params["conv0"]
    assert mt.convs[0].eps.shape == () and mt.convs[0].eps.requires_grad
    assert mt.convs[1].eps.item() == pytest.approx(float(params["conv1"]["eps"]))
    adjs_t, adjs_j = _adjs(batch["adjs"], True)

    def loss_fn(p):
        logits = mj.apply({"params": p}, jnp.asarray(batch["x"]), adjs_j)
        return train_j.cross_entropy_on_seeds(logits, jnp.asarray(batch["labels"]),
                                              jnp.asarray(batch["mask"]))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    loss_t = train_t.cross_entropy_on_seeds(
        mt(torch.from_numpy(batch["x"]), adjs_t), torch.from_numpy(batch["labels"]),
        torch.from_numpy(batch["mask"]))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6, atol=0)
    for i in (0, 1):
        w = float(grads_j[f"conv{i}"]["eps"])
        np.testing.assert_allclose(float(mt.convs[i].eps.grad), w, rtol=1e-5, atol=1e-7)
    fixed = gin_t.GIN(F_IN, HID, CLS)
    assert not any("eps" in name for name, _ in fixed.named_parameters())
    assert fixed.convs[0].eps == 0.0


def test_gat_padding_lanes_change_nothing():
    ei = _regular_block(8, 4, 4, seed=0, holes=0.0)[:, 4:]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32))
    conv = gat_t.GATConv(6, 4, heads=2)
    padded = np.concatenate([ei, np.full((2, 7), -1, np.int32)], axis=1)
    with torch.no_grad():
        a = conv(x, torch.from_numpy(ei), 4)
        b = conv(x, torch.from_numpy(padded), 4)
    assert a.shape == (4, 8) and torch.isfinite(a).all()
    assert torch.equal(a, b)


@pytest.mark.parametrize("concat", [True, False])
def test_gat_isolated_destination_gets_bias_only(concat):
    """All 6 edges target destination 0; destination 1 has none."""
    ei = np.stack([np.arange(6, dtype=np.int32), np.zeros(6, np.int32)])
    x = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    cj, params, ct = _conv_pair("gat", 3, 4, seed=1, concat=concat)
    with torch.no_grad():
        got = ct(torch.from_numpy(x), torch.from_numpy(ei), 2)
    assert torch.equal(got[1], ct.bias.detach())
    want = cj.apply({"params": params}, jnp.asarray(x), jnp.asarray(ei), 2)
    _close(got.numpy(), want)


@pytest.mark.parametrize("heads", [None, 3])
def test_fanout_softmax_matches_segment_softmax_and_jax(heads):
    num_dst, fanout = 9, 5
    ei = _regular_block(20, num_dst, fanout, seed=3)
    src, dst = ei
    valid = (src >= 0) & (dst >= 0)
    shape = (src.shape[0],) + ((heads,) if heads else ())
    logits = (np.random.default_rng(4).normal(size=shape) * 3).astype(np.float32)
    lt, vt = torch.from_numpy(logits), torch.from_numpy(valid)
    dense = layers_t.fanout_softmax(lt, vt, num_dst, fanout)
    dst_safe = torch.from_numpy(np.where(valid, dst, num_dst))
    seg = layers_t.segment_softmax(lt, dst_safe, vt, num_dst)
    np.testing.assert_allclose(dense.numpy(), seg.numpy(), rtol=0, atol=1e-6)
    want_d = layers_j.fanout_softmax(jnp.asarray(logits), jnp.asarray(valid), num_dst, fanout)
    want_s = layers_j.segment_softmax(jnp.asarray(logits), jnp.asarray(dst_safe.numpy()),
                                      jnp.asarray(valid), num_dst)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want_d), rtol=0, atol=1e-6)
    np.testing.assert_allclose(seg.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    assert not dense.numpy()[~valid].any()
    sums = dense.reshape((num_dst, fanout) + shape[1:]).sum(1).numpy()
    has = valid.reshape(num_dst, fanout).any(1)
    np.testing.assert_allclose(sums[has], 1.0, atol=1e-6)
    assert not sums[~has].any()  # all-invalid rows: weight 0, not nan


@pytest.mark.parametrize("strategy", ["scan", "scatter"])
def test_occurrence_counts_bitwise_jax(monkeypatch, strategy):
    rng = np.random.default_rng(5)
    n = 50
    ids = rng.integers(0, n, 400).astype(np.int32)
    valid = rng.random(400) < 0.7
    ids[~valid] = -1
    monkeypatch.setattr(layers_t, "_counts_strategy", strategy)
    monkeypatch.setattr(layers_j, "_counts_strategy", strategy)
    got = layers_t.occurrence_counts(torch.from_numpy(ids), torch.from_numpy(valid), n)
    want = np.asarray(layers_j.occurrence_counts(jnp.asarray(ids), jnp.asarray(valid), n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.bincount(ids[valid], minlength=n))
    zs = layers_t.zero_scatter_counts(torch.from_numpy(ids), torch.from_numpy(valid), n,
                                      dtype=torch.int32)
    np.testing.assert_array_equal(
        zs.numpy(), np.asarray(layers_j.zero_scatter_counts(
            jnp.asarray(ids), jnp.asarray(valid), n, dtype=jnp.int32)))


def test_counts_strategy_resolves_once(monkeypatch):
    monkeypatch.setattr(layers_t, "_counts_strategy", None)
    monkeypatch.delenv("QUIVER_COUNTS", raising=False)
    assert layers_t.resolve_counts_strategy() == "scatter"
    monkeypatch.setenv("QUIVER_COUNTS", "scan")
    assert layers_t.resolve_counts_strategy() == "scatter"  # read once
    monkeypatch.setattr(layers_t, "_counts_strategy", None)
    assert layers_t.resolve_counts_strategy() == "scan"
    monkeypatch.setattr(layers_t, "_counts_strategy", None)
    monkeypatch.setenv("QUIVER_COUNTS", "bogus")
    with pytest.raises(ValueError, match="QUIVER_COUNTS"):
        layers_t.resolve_counts_strategy()


@pytest.mark.parametrize("family", FAMILIES)
def test_layout_check_applies_to_every_family(monkeypatch, family):
    """Under QUIVER_CHECK a fanout claim the edges break raises; with the
    check off the same block runs."""
    ei = _regular_block(30, 10, 4, seed=7)
    swapped = ei.copy()
    swapped[:, 4] = (3, 2)  # a valid lane of seed 1 that targets seed 2
    _, _, ct = _conv_pair(family, F_IN, 7, seed=3)
    x = torch.randn(30, F_IN)
    monkeypatch.setattr(layers_t, "_check_cache", True)
    with torch.no_grad():
        ct(x, torch.from_numpy(ei), 10, 4)  # the true layout passes
        with pytest.raises(AssertionError, match="QUIVER_CHECK"):
            ct(x, torch.from_numpy(swapped), 10, 4)
    monkeypatch.setattr(layers_t, "_check_cache", False)
    with torch.no_grad():
        ct(x, torch.from_numpy(swapped), 10, 4)


@pytest.mark.parametrize("family", FAMILIES)
def test_init_model_draws_every_parameter(family):
    """``init_model`` from one generator is deterministic, and sets the
    parameters outside the Linear layers: GAT's attention vectors within
    glorot's bound, biases zero."""
    make = {"gcn": lambda: gcn_t.GCN(F_IN, HID, CLS),
            "gin": lambda: gin_t.GIN(F_IN, HID, CLS, train_eps=True),
            "gat": lambda: gat_t.GAT(F_IN, HID, CLS, heads=HEADS)}[family]
    a = train_t.init_model(make(), torch.Generator().manual_seed(0))
    b = train_t.init_model(make(), torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    if family == "gat":
        att = a.convs[0].att_l.detach()
        assert att.abs().max() <= (6 / (HEADS + HID)) ** 0.5 and att.abs().max() > 0
        assert not a.convs[0].bias.detach().any()
    if family == "gcn":
        assert not a.convs[1].bias.detach().any()
    if family == "gin":
        assert a.convs[0].eps.item() == 0.0


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_compute_close_to_float32(batch, family):
    """``dtype="bfloat16"`` computes the products in bf16 with float32
    parameters; log-probs stay within bf16's 3e-2 of the float32 model's."""
    _, _, mt = _model_pair(family, seed=8)
    make = {"gcn": gcn_t.GCN, "gin": gin_t.GIN}.get(family)
    half = (make(F_IN, HID, CLS, dropout=0.0, dtype="bfloat16") if make else
            gat_t.GAT(F_IN, HID, CLS, heads=HEADS, dropout=0.0, dtype="bfloat16"))
    half.load_state_dict(mt.state_dict())
    x = torch.from_numpy(batch["x"])
    with torch.no_grad():
        want = mt.eval()(x, batch["adjs"])
        got = half.eval()(x, batch["adjs"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-2 * float(want.abs().max()))
