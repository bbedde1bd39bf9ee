"""quiver_tpu_torch GraphSAGE (with parameters converted from flax by
``models/convert.py``) and its layers against quiver_tpu's flax model.

Tolerance: float32 log-probs and layer outputs within atol = rtol = 1e-5
(the two frameworks sum in different orders). bf16 compute within
atol = 5e-2, rtol = 0: both frameworks round the products, the
aggregation and the bias add to bf16 (8 bits of mantissa), at places that
differ, and the error reaches the log-probs through two layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.models import layers as lj  # noqa: E402
from quiver_tpu.models.sage import GraphSAGE as SageJ  # noqa: E402
from quiver_tpu.parallel.train import init_model  # noqa: E402

from quiver_tpu_torch.models import layers as lt  # noqa: E402
from quiver_tpu_torch.models.convert import flax_sage_to_state_dict  # noqa: E402
from quiver_tpu_torch.models.sage import GraphSAGE as SageT  # noqa: E402
from quiver_tpu_torch.sampling.sampler import Adj  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402

F, HID, CLS = 12, 16, 5


@pytest.fixture(scope="module")
def sampled():
    topo = qj.CSRTopo(edge_index=generate_pareto_graph(500, 7.0, seed=1))
    sampler = qj.GraphSageSampler(topo, [4, 3], seed=2, kernel="xla")
    out = sampler.sample(np.arange(0, 40, 3))
    x = np.random.default_rng(1).normal(
        size=(out.adjs[0].size[0], F)).astype(np.float32)
    return x, out.adjs


def _port_adjs(adjs, regular=True):
    return [Adj(torch.from_numpy(np.array(a.edge_index)), None, a.size,
                fanout=a.fanout if regular else None) for a in adjs]


def _jax_adjs(adjs, regular=True):
    return [a if regular else qj.sampling.sampler.Adj(a.edge_index, None, a.size)
            for a in adjs]


@pytest.mark.parametrize("dtype,atol,rtol", [(None, 1e-5, 1e-5), ("bfloat16", 5e-2, 0)])
@pytest.mark.parametrize("regular", [True, False])
def test_graphsage_matches_flax(sampled, dtype, atol, rtol, regular):
    x, adjs = sampled
    mj = SageJ(hidden=HID, num_classes=CLS, num_layers=2, dtype=dtype)
    params = init_model(mj, jax.random.PRNGKey(0), x, adjs)
    want = np.asarray(mj.apply({"params": params}, jnp.asarray(x),
                               _jax_adjs(adjs, regular)))
    mt = SageT(F, HID, CLS, num_layers=2, dtype=dtype).eval()
    mt.load_state_dict(flax_sage_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = mt(torch.from_numpy(x), _port_adjs(adjs, regular)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_graphsage_batched_lanes_equal_single(sampled):
    """Leading dims are independent graphs (the serving ladder's lanes)."""
    x, adjs = sampled
    torch.manual_seed(0)
    mt = SageT(F, HID, CLS).eval()
    pa = _port_adjs(adjs)
    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    batched = [Adj(torch.stack([a.edge_index] * 2), None, a.size, a.fanout) for a in pa]
    with torch.no_grad():
        both = mt(xs, batched)
        for b in range(2):
            np.testing.assert_allclose(both[b].numpy(), mt(xs[b], pa).numpy(),
                                       atol=1e-5, rtol=1e-5)


def test_convert_transposes_kernels():
    params = {"conv0": {"lin_l": {"kernel": np.ones((3, 2)), "bias": np.zeros(2)},
                        "lin_r": {"kernel": np.arange(6.0).reshape(3, 2)}}}
    sd = flax_sage_to_state_dict(params)
    assert sd["convs.0.lin_l.weight"].shape == (2, 3)
    np.testing.assert_array_equal(sd["convs.0.lin_r.weight"].numpy(),
                                  np.arange(6.0).reshape(3, 2).T)
    with pytest.raises(ValueError):
        flax_sage_to_state_dict({})


@pytest.mark.parametrize("fanout", [4, None])
def test_aggregation_layers_match(fanout):
    rng = np.random.default_rng(4)
    num_dst, k = 6, 4
    x = rng.normal(size=(30, F)).astype(np.float32)
    src = rng.integers(0, 30, num_dst * k).astype(np.int32)
    src[rng.random(num_dst * k) < 0.3] = -1
    dst = np.repeat(np.arange(num_dst, dtype=np.int32), k)
    mj, vj = lj.gather_src(jnp.asarray(x), jnp.asarray(src))
    mt, vt = lt.gather_src(torch.from_numpy(x), torch.from_numpy(src))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    want = lj.segment_mean_aggregate(mj, jnp.asarray(dst), vj, num_dst, fanout=fanout)
    got = lt.segment_mean_aggregate(mt, torch.from_numpy(dst), vt, num_dst, fanout=fanout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        lt.fanout_sum_aggregate(mt, vt, num_dst, k).numpy(),
        np.asarray(lj.fanout_sum_aggregate(mj, vj, num_dst, k)), atol=1e-5, rtol=1e-5)
