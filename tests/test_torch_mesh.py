"""The device mesh of quiver_tpu_torch (``parallel/mesh.py``) against
quiver_tpu's: ``make_mesh`` shapes and errors over a device list (the
port's repeated CPU device standing in for JAX's 8 forced host devices),
``MeshTopo`` / ``p2pCliqueTopo`` cliques, ``can_device_access_peer``,
``init_p2p``, and ``init_distributed`` at world size 1 on ``gloo``.
Without a card, ``make_mesh()`` and ``MeshTopo()`` raise.

Tolerance: shapes, cliques and messages are compared exactly.
"""

import socket

import jax
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.parallel import mesh as mesh_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.parallel import mesh as mesh_t  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("kw", [
    dict(), dict(data=8), dict(data=4, feature=2), dict(feature=4),
    dict(n_devices=4), dict(n_devices=4, data=2, feature=2), dict(n_devices=2, feature=2),
])
def test_make_mesh_shapes_equal_jax(kw):
    got = mesh_t.make_mesh(devices=CPU8, **kw)
    want = mesh_j.make_mesh(devices=jax.devices()[:8], **kw)
    assert got.shape == dict(want.shape)
    assert got.shape[mesh_t.DATA_AXIS] == want.shape[mesh_j.DATA_AXIS]
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert got.devices.size == want.size


@pytest.mark.parametrize("kw", [dict(data=3), dict(data=2, feature=3),
                                dict(n_devices=6, feature=4)])
def test_make_mesh_errors_equal_jax(kw):
    with pytest.raises(ValueError) as e_t:
        mesh_t.make_mesh(devices=CPU8, **kw)
    with pytest.raises(ValueError) as e_j:
        mesh_j.make_mesh(devices=jax.devices()[:8], **kw)
    assert str(e_t.value) == str(e_j.value)


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="needs 4"):
        mesh_t.make_mesh(n_devices=4, devices=["cpu"] * 2)


def test_no_card_no_default_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        mesh_t.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_t.MeshTopo()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_t.init_distributed("localhost:1", 1, 0)


def test_default_mesh_takes_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = mesh_t.make_mesh()
    assert mesh.shape == {"data": 1, "feature": 1}
    assert mesh.devices[0, 0] == torch.device("cuda", 0)


def test_mesh_topo_on_a_cpu_device_list():
    topo = mesh_t.MeshTopo(CPU8)
    want = mesh_j.MeshTopo(jax.devices()[:8])
    assert topo.cliques == want.cliques == [list(range(8))]
    assert topo.p2p_clique == topo.cliques
    assert all(topo.get_clique_id(i) == want.get_clique_id(i) for i in range(8))
    assert topo.p2p_clique_device_list(0) == want.p2p_clique_device_list(0)
    assert topo.info.startswith("Clique 0 (peer access): devices [0, 1, 2")
    assert repr(topo) == repr(want)
    assert qt.p2pCliqueTopo is qt.MeshTopo is mesh_t.MeshTopo


def test_mesh_topo_splits_devices_without_peer_access(monkeypatch):
    """Two cards with peer access between 0-1 and 2-3 only: two cliques
    (the reference's ``find_cliques`` over the peer-access pairs)."""
    pairs = {(0, 1), (1, 0), (2, 3), (3, 2)}
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) in pairs)
    topo = mesh_t.MeshTopo([0, 1, 2, 3])
    assert topo.cliques == [[0, 1], [2, 3]]
    assert topo.get_clique_id(3) == 1
    assert mesh_t.can_device_access_peer(0, 1)
    assert not mesh_t.can_device_access_peer(1, 2)
    assert mesh_t.can_device_access_peer(2, 2)


def test_peer_access_of_cpu_devices():
    assert mesh_t.can_device_access_peer("cpu", "cpu")
    assert mesh_j.can_device_access_peer(0, 0)
    assert mesh_t.init_p2p() is None and mesh_j.init_p2p() is None
    assert qt.init_p2p([0, 1]) is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_world_of_one_on_gloo():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh_t.init_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        assert dist.is_initialized()
        assert dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        t = torch.tensor([3.0])
        dist.all_reduce(t)
        assert t.item() == 3.0
    finally:
        dist.destroy_process_group()
