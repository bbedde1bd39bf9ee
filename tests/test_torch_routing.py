"""``BucketRoute`` of quiver_tpu_torch (``parallel/routing.py``) against
quiver_tpu's, on the CPU.

JAX plans one route per device inside ``shard_map`` over a ``feature``
axis of F forced host devices and exchanges with ``all_to_all``, ``psum``
and ``all_gather``; the port plans the F members' request vectors at once
in one process. Both serve the same ids from the same per-owner tables:
owner ``d`` answers the ids in ``[d * R, (d + 1) * R)`` with its rows (or,
with a payload, ``id * 1000 + payload``), and zero for every other id.

Tolerance: bitwise for every answer, and the overflow counts equal, for
uncapped and capped buckets, an explicit cap with invalid lanes, a forced
overflow served by the fallback, a clean batch (overflow 0), and an
exchange with a payload (the cases of ``tests/test_routed_cap.py:29-90``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from quiver_tpu.parallel.mesh import make_mesh as make_mesh_j, shard_map  # noqa: E402
from quiver_tpu.parallel.routing import BucketRoute as BucketRouteJ  # noqa: E402

from quiver_tpu_torch.obs.registry import ROUTED_OVERFLOW, MetricsRegistry  # noqa: E402
from quiver_tpu_torch.parallel.routing import BucketRoute  # noqa: E402

R = 50  # rows each owner holds
W = 6  # row width


def _tables(F):
    return np.random.default_rng(F).normal(size=(F, R, W)).astype(np.float32)


def _jax_route(ids, valid, tables, cap, payload=None):
    """JAX's route of the ``(F, L)`` requests (one row per device of a
    ``(1, F)`` mesh): ``(answers (F, L, ...), overflow)``."""
    F = ids.shape[0]
    mesh = make_mesh_j(data=1, feature=F, devices=jax.devices()[:F])

    def body(ids, valid, table, *pay):
        my = jax.lax.axis_index("feature")
        route = BucketRouteJ(ids[0], valid[0], ids[0] // R, axis="feature",
                             num_shards=F, cap=cap)

        def serve(req, p=None):
            mine = (req >= 0) & (req // R == my)
            if p is None:
                rows = table[0][jnp.where(mine, req - my * R, 0)]
                return jnp.where(mine[:, None], rows, 0)
            return jnp.where(mine, req * 1000 + p, 0)

        out = route.exchange(serve, pay[0][0] if pay else None)
        return out[None], route.overflow[None]

    args = [jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(tables)]
    if payload is not None:
        args.append(jnp.asarray(payload))
    fn = shard_map(body, mesh=mesh, in_specs=tuple(P("feature") for _ in args),
                   out_specs=(P("feature"), P("feature")), check_vma=False)
    out, ov = jax.jit(fn)(*args)
    return np.asarray(out), int(np.asarray(ov)[0])


def _port_route(ids, valid, tables, cap, payload=None, tape=None):
    F = ids.shape[0]
    t_ids, t_valid = torch.from_numpy(ids), torch.from_numpy(valid)
    route = BucketRoute(t_ids, t_valid, torch.div(t_ids, R, rounding_mode="floor"),
                        num_shards=F, cap=cap, tape=tape)
    table = torch.from_numpy(tables)

    def serve(d, req, p=None):
        mine = (req >= 0) & (torch.div(req, R, rounding_mode="floor") == d)
        if p is None:
            rows = table[d][torch.where(mine, req - d * R, 0)]
            return torch.where(mine[:, None], rows, 0.0)
        return torch.where(mine, req * 1000 + p, 0)

    out = route.exchange(serve, None if payload is None else torch.from_numpy(payload))
    return out.numpy(), route


def _requests(F, L, rng, owners=None, invalid=0):
    """``(F, L)`` int32 ids (owned by ``owners`` when given) with
    ``invalid`` lanes of each row set to -1, and their valid mask."""
    hi = F * R if owners is None else owners * R
    ids = rng.integers(0, hi, (F, L)).astype(np.int32)
    for row in ids:
        row[rng.choice(L, invalid, replace=False)] = -1
    return ids, ids >= 0


@pytest.mark.parametrize("F,L,cap", [
    (4, 32, None), (4, 32, 16), (2, 45, 30), (8, 16, 3), (4, 64, 4), (1, 9, 2)])
@pytest.mark.parametrize("invalid", [0, 5])
def test_route_equals_jax(F, L, cap, invalid):
    """Uniform owners at every cap: capped (including caps tight enough to
    overflow, and one member), uncapped, with and without invalid lanes;
    the answers bitwise JAX's and the dense rows, the overflow JAX's."""
    rng = np.random.default_rng(F * 100 + L)
    ids, valid = _requests(F, L, rng, invalid=invalid)
    tables = _tables(F)
    want, ov_j = _jax_route(ids, valid, tables, cap)
    got, route = _port_route(ids, valid, tables, cap)
    assert np.array_equal(got, want)
    dense = tables.reshape(F * R, W)[np.where(valid, ids, 0)] * valid[..., None]
    assert np.array_equal(got, dense)
    assert int(route.overflow) == ov_j
    assert int(route.member_overflow.sum()) == ov_j
    if cap is None or cap >= L:
        assert ov_j == 0 and route.cap == L


def test_forced_overflow_served_by_fallback():
    """Every id owned by member 0 and a cap of 4: each member keeps 4
    lanes and the fallback serves the other L - 4 exactly
    (``test_forced_overflow_served_by_fallback``: 8 x (32 - 4))."""
    F, L = 8, 32
    rng = np.random.default_rng(3)
    ids, valid = _requests(F, L, rng, owners=1)
    tables = _tables(F)
    want, ov_j = _jax_route(ids, valid, tables, 4)
    reg = MetricsRegistry()
    reg.counter(ROUTED_OVERFLOW)
    tape = reg.tape()
    got, route = _port_route(ids, valid, tables, 4, tape=tape)
    assert np.array_equal(got, want) and np.array_equal(got, tables[0][ids])
    assert int(route.overflow) == ov_j == F * (L - 4)
    assert route.member_overflow.tolist() == [L - 4] * F
    assert int(tape.finalize()[ROUTED_OVERFLOW]) == ov_j


def test_clean_batch_overflows_nothing():
    """Round-robin owners, 8 lanes per bucket under a cap of 16: overflow
    0 on both sides (``test_no_overflow_on_clean_batch_metadata_zero``)."""
    F, L = 4, 32
    lanes = np.arange(F * L)
    ids = ((lanes % F) * R + (lanes // F) % R).astype(np.int32).reshape(F, L)
    tables = _tables(F)
    want, ov_j = _jax_route(ids, ids >= 0, tables, 16)
    got, route = _port_route(ids, ids >= 0, tables, 16)
    assert np.array_equal(got, want) and ov_j == int(route.overflow) == 0


@pytest.mark.parametrize("cap", [None, 3])
def test_payload_exchange_equals_jax(cap):
    """The payload form (the distributed sampler's second exchange): one
    int32 payload per lane travels with its id and the owner answers
    ``id * 1000 + payload``; a second exchange through the same plan sends
    only the payload and answers alike."""
    F, L = 4, 24
    rng = np.random.default_rng(7)
    ids, valid = _requests(F, L, rng, invalid=3)
    payload = rng.integers(0, 1000, (F, L)).astype(np.int32)
    tables = _tables(F)
    want, ov_j = _jax_route(ids, valid, tables, cap, payload)
    got, route = _port_route(ids, valid, tables, cap, payload)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(got, np.where(valid, ids * 1000 + payload, 0))
    assert int(route.overflow) == ov_j
    table = torch.from_numpy(tables)
    rows = route.exchange(lambda d, req: torch.where(
        ((req >= 0) & (torch.div(req, R, rounding_mode="floor") == d))[:, None],
        table[d][(req - d * R).clamp(0, R - 1)], 0.0))
    assert np.array_equal(rows.numpy(),
                          tables.reshape(F * R, W)[np.where(valid, ids, 0)] * valid[..., None])


def test_plan_checks():
    ids = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="cap must be >= 1"):
        BucketRoute(ids, ids >= 0, ids, num_shards=2, cap=0)
    with pytest.raises(ValueError, match="one row per member"):
        BucketRoute(ids, ids >= 0, ids, num_shards=4)


@pytest.mark.parametrize("cap", [None, 5])
def test_every_exchange_serves_the_requests(cap):
    """``serve`` receives ``requests()[member]`` itself in every exchange
    (so an owner may look its rows up once per plan): the member's
    received bucket lanes, then, with a fallback, every member's overflow
    lanes; ``-1`` on dead lanes, and every valid id exactly once per
    owner that holds it in its buckets or the fallback."""
    F, L = 4, 24
    rng = np.random.default_rng(11)
    ids, valid = _requests(F, L, rng, invalid=3)
    t_ids = torch.from_numpy(ids)
    route = BucketRoute(t_ids, torch.from_numpy(valid),
                        torch.div(t_ids, R, rounding_mode="floor"), num_shards=F, cap=cap)
    reqs = route.requests()
    width = F * route.cap + (F * route.ov_budget if route.ov_budget else 0)
    assert [tuple(r.shape) for r in reqs] == [(width,)] * F
    seen = []

    def serve(d, req, p=None):
        seen.append(req is reqs[d])
        return torch.zeros(req.shape, dtype=torch.int32)

    route.exchange(serve)
    route.exchange(serve, payload=torch.from_numpy(ids))
    assert seen == [True] * (2 * F) and route.requests() is reqs
    # each owner's bucket lanes are the valid ids it owns, each once
    for d, r in enumerate(reqs):
        live = r[:F * route.cap]
        live = live[live >= 0]
        owned = ids[valid & (ids // R == d)]
        if route.ov_budget == 0:
            assert sorted(live.tolist()) == sorted(owned.tolist())
        else:
            assert set(live.tolist()) <= set(owned.tolist())
    if route.ov_budget:
        ov = reqs[0][F * route.cap:]
        assert int((ov >= 0).sum()) == int(route.overflow)
