"""``GraphSageSampler.sample_padded`` of quiver_tpu_torch: the fused train
step's sampler call.

- Bitwise ``sample`` for the same seeds, caps and draws: under a shared
  ``draw_fn``, and from the sampler's own stream (two samplers of one
  seed, one calling ``sample`` and one ``sample_padded``), uniform (both
  hop paths) and weighted.
- Bitwise the JAX package's ``sample_padded`` under JAX's draws (the
  port's ``draw_fn`` replays JAX's per-layer key chain).
- No host read: with ``Tensor.item``, ``tolist``, ``__int__``,
  ``__bool__``, ``__float__``, ``__index__`` and ``numpy`` made to raise,
  a call still runs (here on CPU tensors, where the kernels' plain
  versions run; there is no card to synchronise with).
- An auto-caps sampler is neither planned nor regrown: it samples at the
  caps it has, and its overflow comes back as a tensor.
- A ``generator`` plays a JAX key: read, not advanced.

Tolerance: every output is integer; every comparison is bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
from quiver_tpu.ops.sample import rotate_offsets, stratified_offsets  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402

SIZES = (4, 3)
CAP = 32


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(0)
    return rng.integers(0, 300, size=(2, 3000))


def _padded(seeds, cap=CAP):
    out = np.full(cap, -1, np.int32)
    out[:len(seeds)] = seeds
    return torch.from_numpy(out)


def _same(a, b):
    """Bitwise equality of two sampler results (tensors, Adjs, tuples)."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, qt.Adj):
        return _same(a.edge_index, b.edge_index) and a.size == b.size \
            and a.fanout == b.fanout and _same(a.e_id, b.e_id)
    if a is None:
        return b is None
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and torch.equal(a, b)


def _as_sample_output(out):
    n_id, n_count, adjs, overflow, edge_counts, frontier_counts = out
    return (n_id, n_count, adjs, overflow, edge_counts, frontier_counts)


def _of_sample(out):
    return (out.n_id, out.n_count, out.adjs, out.overflow, out.edge_counts,
            out.frontier_counts)


def _draw_fn(seed):
    """Offsets from a seeded numpy stream, the same for both callers."""
    def draw(layer, deg):
        rng = np.random.default_rng(seed + layer)
        d = deg.numpy().astype(np.int64)
        k = SIZES[layer]
        return torch.from_numpy(
            (rng.integers(0, 1 << 30, (d.shape[0], k)) % np.maximum(d, 1)[:, None])
            .astype(np.int32))
    return draw


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_equals_sample_under_draw_fn(coo, kernel):
    topo = qt.CSRTopo(edge_index=coo)
    sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu",
                                  seed_capacity=CAP, kernel=kernel)
    seeds = np.random.default_rng(1).integers(0, 300, 20)
    want = _of_sample(sampler.sample(seeds, draw_fn=_draw_fn(5)))
    got = sampler.sample_padded(_padded(seeds), 20, draw_fn=_draw_fn(5))
    assert _same(_as_sample_output(got), want)


@pytest.mark.parametrize("kernel,weighted", [("pallas", False), ("xla", False),
                                             ("pallas", True)])
def test_equals_sample_from_own_stream(coo, kernel, weighted):
    topo = qt.CSRTopo(edge_index=coo)
    if weighted:
        topo.set_edge_weight(np.random.default_rng(2).random(coo.shape[1])
                             .astype(np.float32) + 0.1)

    def make():
        return qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed=7,
                                   seed_capacity=CAP, kernel=kernel,
                                   weighted=weighted)

    a, b = make(), make()
    for call in range(3):
        seeds = np.random.default_rng(10 + call).integers(0, 300, 17 + call)
        want = _of_sample(a.sample(seeds))
        got = b.sample_padded(_padded(seeds), torch.tensor(len(seeds)))
        assert _same(_as_sample_output(got), want), call
    assert a._call == b._call == 3


def _jax_draw_fn(key):
    """JAX ``multilayer_sample``'s uniform draws: ``split`` per layer, then
    ``split`` into the stratum and rotation keys."""
    subs = []
    for _ in SIZES:
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draw(layer, deg):
        kj, kr = jax.random.split(subs[layer])
        d = jnp.asarray(deg.numpy())
        off, _ = stratified_offsets(kj, d, SIZES[layer])
        return torch.from_numpy(np.array(rotate_offsets(kr, off, d, SIZES[layer])))
    return draw


@pytest.mark.parametrize("num", [CAP, 13])
def test_equals_jax_sample_padded(coo, num):
    sampler_j = qj.GraphSageSampler(qj.CSRTopo(edge_index=coo), list(SIZES),
                                    seed_capacity=CAP)
    sampler = qt.GraphSageSampler(qt.CSRTopo(edge_index=coo), list(SIZES),
                                  device="cpu", seed_capacity=CAP)
    seeds = np.random.default_rng(4).integers(0, 300, num)
    key = jax.random.PRNGKey(11)
    want = sampler_j.sample_padded(sampler_j.topo, jnp.asarray(_padded(seeds).numpy()),
                                   jnp.int32(num), key)
    got = sampler.sample_padded(_padded(seeds), num, draw_fn=_jax_draw_fn(key))
    n_id, n_count, adjs, overflow, edge_counts, frontier_counts = got
    np.testing.assert_array_equal(n_id.numpy(), np.asarray(want[0]))
    assert int(n_count) == int(want[1]) and int(overflow) == int(want[3])
    assert len(adjs) == len(want[2])
    for a, aj in zip(adjs, want[2]):
        np.testing.assert_array_equal(a.edge_index.numpy(), np.asarray(aj.edge_index))
        assert a.size == tuple(aj.size) and a.fanout == aj.fanout
    assert [int(c) for c in edge_counts] == [int(c) for c in want[4]]
    assert [int(c) for c in frontier_counts] == [int(c) for c in want[5]]


class _NoHostRead:
    """Make every host read of a tensor raise while active."""

    NAMES = ("item", "tolist", "__int__", "__bool__", "__float__", "__index__",
             "numpy")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def fn(*_a, **_k):
                raise AssertionError(f"host read: Tensor.{name}")
            return fn

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.mark.parametrize("kernel,weighted", [("pallas", False), ("xla", False),
                                             ("pallas", True)])
def test_no_host_read(coo, kernel, weighted):
    topo = qt.CSRTopo(edge_index=coo)
    if weighted:
        topo.set_edge_weight(np.ones(coo.shape[1], np.float32))
    sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=CAP,
                                  kernel=kernel, weighted=weighted)
    seeds = _padded(np.arange(20))
    num = torch.tensor(20, dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    sampler.kernel  # resolved before the call, as a trainer's init does
    with _NoHostRead():
        out = sampler.sample_padded(seeds, num, generator=gen)
    assert out[0].shape == (sampler._caps_for(CAP)[-1],)
    with pytest.raises(AssertionError, match="host read"), _NoHostRead():
        torch.tensor(1).item()  # the guard itself works


def test_auto_caps_neither_planned_nor_regrown(coo):
    topo = qt.CSRTopo(edge_index=coo)
    sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=CAP,
                                  frontier_caps="auto")
    sampler.sample(np.arange(4))  # plans small caps from a small batch
    caps = sampler._frontier_caps
    assert caps is not None
    n_id, _, adjs, overflow, _, frontier_counts = sampler.sample_padded(
        _padded(np.arange(100, 132)), CAP)
    assert sampler._frontier_caps == caps and sampler.reruns == 0
    assert n_id.shape == (caps[-1],) and isinstance(overflow, torch.Tensor)
    assert int(overflow) > 0  # 32 seeds overflow caps planned from 4
    assert [a.size[0] for a in adjs[::-1]] == list(caps)


def test_generator_is_read_not_advanced(coo):
    topo = qt.CSRTopo(edge_index=coo)
    sampler = qt.GraphSageSampler(topo, list(SIZES), device="cpu", seed_capacity=CAP)
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    seeds = _padded(np.arange(30))
    a = sampler.sample_padded(seeds, 30, generator=gen)
    b = sampler.sample_padded(seeds, 30, generator=gen)
    assert _same(a, b) and torch.equal(gen.get_state(), state)
    assert sampler._call == 0
    other = sampler.sample_padded(seeds, 30, generator=torch.Generator().manual_seed(10))
    assert not torch.equal(other[0], a[0])
