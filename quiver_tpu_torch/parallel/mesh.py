"""Device mesh and peer-access topology.

The port of ``quiver_tpu/parallel/mesh.py``: a ``(data, feature)`` grid of
``torch.device``s (:class:`Mesh`, :func:`make_mesh`), the reference's
clique view of the devices (:class:`MeshTopo`, cliques of CUDA devices
that can reach each other's memory, the reference's ``find_cliques`` over
``torch.cuda.can_device_access_peer``), and the process-group entry point
(:func:`init_distributed`). The JAX package's ``shard_map`` has no
counterpart: work on a mesh runs as ordinary torch code.

A mesh takes one of two forms:

* **logical**, one process over every slot (``make_mesh(devices=...)``,
  or ``make_mesh()`` without a process group): its members run one after
  another in the process, and a collective is a tensor operation over
  them (``parallel/routing.py``, ``feature/shard.py``). Its slots may sit
  on one device repeated (``devices=["cuda:0"] * 4``; on a CPU-only
  machine the tests stand in for JAX's eight forced host devices with
  ``devices=["cpu"] * 8``) or on distinct devices (``devices=["cuda:0",
  "cuda:1"]``, or a card and the host, ``["cuda:0", "cpu"]``): each slot's
  work runs on its own device, state kept per device is keyed by the
  device as the mesh lists it (:func:`mesh_devices`), and the sums that
  decide a step (gradients, loss, metrics, the tuners' inputs) run on the
  lead device (:func:`lead_device`).
* **world**, one process per slot (:class:`WorldMesh`: ``make_mesh(data=,
  feature=)`` after :func:`init_distributed`, as JAX's ``make_mesh()``
  spans every process after ``jax.distributed.initialize``): rank ``r``
  holds slot ``(r // F, r % F)`` on its own device, and the collectives
  run over ``torch.distributed`` groups (``parallel/world.py``) with
  results bitwise the logical mesh's of the same shape.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.memory import resolve_device

__all__ = [
    "DATA_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "MeshTopo",
    "AxisGroup",
    "WorldMesh",
    "axis_devices",
    "axis_groups",
    "can_device_access_peer",
    "current_world",
    "init_distributed",
    "init_p2p",
    "shutdown_distributed",
    "is_world",
    "lead_device",
    "mesh_devices",
    "shard_seed_blocks",
    "make_mesh",
]

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


class Mesh:
    """A ``(data, feature)`` grid of devices: ``devices`` is a 2-D object
    array of ``torch.device``, ``shape`` maps each axis name to its size
    (``mesh.shape[DATA_AXIS]`` reads as in JAX)."""

    axis_names = (DATA_AXIS, FEATURE_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, feature), got {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


class AxisGroup(NamedTuple):
    """One rank's process group along some mesh axes: the member ranks in
    member order, this rank's index among them, and the
    ``torch.distributed`` group."""

    ranks: list
    index: int
    group: object


class WorldMesh(Mesh):
    """A ``(data, feature)`` mesh over a world of processes, one slot each.

    Rank ``r`` holds slot ``(d, f) = (r // F, r % F)``, so its flat worker
    index (JAX's ``_worker_index``) is ``r``. A process sees only its own
    device, so ``devices`` holds this rank's device in every slot: code
    that places a tensor "on the mesh" places it on the rank's device.
    Every rank builds one ``torch.distributed`` group per feature group
    and one per data group, in :func:`axis_groups`' order (``new_group``
    must be called identically on every rank, members or not);
    :meth:`group` returns this rank's."""

    def __init__(self, data: int, feature: int, rank: int, device: torch.device):
        devices = np.empty((data, feature), dtype=object)
        devices.fill(device)
        super().__init__(devices)
        self.rank = int(rank)
        self.world_size = data * feature
        self.slot = divmod(self.rank, feature)
        self.device = device
        dist = torch.distributed
        self._groups = {}
        for axis in (FEATURE_AXIS, DATA_AXIS):
            for ranks in axis_groups(self, axis):
                pg = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[(axis,)] = AxisGroup(ranks, ranks.index(self.rank), pg)
        self._groups[self.axis_names] = AxisGroup(
            list(range(self.world_size)), self.rank, dist.group.WORLD)
        global _CURRENT_WORLD
        _CURRENT_WORLD = self

    def group(self, axes) -> AxisGroup:
        """This rank's group over ``axes`` (an axis name or a tuple of
        them): its feature group, its data group, or the whole world in
        rank (= worker) order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups or len(key) != len(set(axes)):
            raise ValueError(f"unknown mesh axes {axes!r}; the axes are {self.axis_names}")
        return self._groups[key]

    def __repr__(self):
        return (f"WorldMesh({self.shape}, rank={self.rank}, slot={self.slot}, "
                f"device={self.device})")


def is_world(mesh) -> bool:
    """Whether ``mesh`` is a :class:`WorldMesh` (one process per slot)."""
    return isinstance(mesh, WorldMesh)


_CURRENT_WORLD: WorldMesh | None = None  # the process's newest WorldMesh


def current_world() -> WorldMesh | None:
    """The newest :class:`WorldMesh` this process built (None without a
    process group): the mesh whose axes a collective named only by its
    axes runs over, as JAX's axis names refer to the enclosing mesh."""
    return _CURRENT_WORLD


def mesh_devices(mesh: Mesh) -> list:
    """The mesh's distinct devices in slot order (row-major over the
    ``(data, feature)`` grid), each as the mesh lists it: the keys of state
    kept once per device (model replicas, the L0 block, translation
    tables). One entry on a mesh of one repeated device and on a world
    mesh (the rank's)."""
    return list(dict.fromkeys(mesh.devices.ravel().tolist()))


def lead_device(mesh: Mesh) -> torch.device:
    """The device of the mesh's first slot, ``devices.flat[0]``: the
    gradient mean, the optimizer step, checkpoints and the tuners' inputs
    live there."""
    return mesh.devices.flat[0]


def axis_devices(mesh: Mesh, axis: str) -> list:
    """The devices of the members along ``axis`` (the first group's; a
    sharded table or topology keeps one copy, which every group reads)."""
    devices = mesh.devices if axis == FEATURE_AXIS else mesh.devices.T
    return list(devices[0])


def axis_groups(mesh: Mesh, axis: str) -> list[list[int]]:
    """The groups of workers that span ``axis``: one list per slot of the
    other axis, each the flat worker indices (row-major over the mesh's
    axis names, JAX's ``_worker_index``) of its members in axis order."""
    D, F = mesh.shape[DATA_AXIS], mesh.shape[FEATURE_AXIS]
    if axis == FEATURE_AXIS:
        return [[g * F + f for f in range(F)] for g in range(D)]
    if axis == DATA_AXIS:
        return [[d * F + g for d in range(D)] for g in range(F)]
    raise ValueError(f"axis must be {DATA_AXIS!r} or {FEATURE_AXIS!r}, got {axis!r}")


def shard_seed_blocks(seeds, workers: int, local_cap: int,
                      cap_name: str = "capacity") -> np.ndarray:
    """Split a global seed array into per-worker valid-prefix blocks
    (``np.array_split``), padded to ``(workers, local_cap)`` with -1."""
    seeds = np.asarray(seeds)
    out = np.full((workers, local_cap), -1, np.int32)
    for i, b in enumerate(np.array_split(seeds, workers)):
        if len(b) > local_cap:
            raise ValueError(f"per-worker block {len(b)} exceeds {cap_name} {local_cap}")
        out[i, : len(b)] = b
    return out


def _cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; without a card this raises (no CPU
    default may hide the missing device)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n for a "
            "CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    feature: int = 1,
    devices=None,
) -> Mesh:
    """Build a ``(data, feature)`` mesh. The ``data`` axis carries data
    parallelism (the reference's one process per GPU); the ``feature`` axis
    shards the hot feature cache.

    After :func:`init_distributed`, and with no ``devices``, the mesh spans
    the world's ranks (:class:`WorldMesh`; ``data * feature`` must be the
    world size). Otherwise it is a logical mesh over ``devices`` (default:
    every visible CUDA device), in which a device may appear more than
    once and distinct devices may mix (cards, the host). A device that
    cannot compute (``meta``) raises ``ValueError``."""
    if devices is None and _WORLD_DEVICE is not None:
        return _world_mesh(n_devices, data, feature)
    devices = _cuda_devices() if devices is None else [
        resolve_device(d) for d in devices]
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(
                f"mesh device {d} cannot run a slot's work: give CUDA devices "
                "or the CPU")
    n = n_devices or len(devices)
    if data is None:
        data = n // feature
    if data * feature != n:
        raise ValueError(f"data*feature = {data}*{feature} != {n} devices")
    if n > len(devices):
        raise ValueError(f"a mesh of {n} devices needs {n}, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(data, feature))


def _world_mesh(n_devices, data, feature) -> WorldMesh:
    dist = torch.distributed
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a world mesh spans the world's {n} ranks, got n_devices={n_devices}")
    if data is None:
        data = n // feature
    if data * feature != n:
        raise ValueError(
            f"data*feature = {data}*{feature} != the world size {n} (one rank per slot)")
    return WorldMesh(int(data), int(feature), dist.get_rank(), _WORLD_DEVICE)


def _as_device(d) -> torch.device:
    return torch.device("cuda", d) if isinstance(d, int) else torch.device(d)


def can_device_access_peer(a, b) -> bool:
    """Whether device ``a`` can read device ``b``'s memory: the same
    device, or two CUDA devices (indices or ``torch.device``) with peer
    access (``torch.cuda.can_device_access_peer``, the reference's
    binding)."""
    da, db = _as_device(a), _as_device(b)
    if da == db:
        return True
    if da.type != "cuda" or db.type != "cuda":
        return False
    return bool(torch.cuda.can_device_access_peer(da.index, db.index))


class MeshTopo:
    """Clique view of the device set (the reference's ``p2pCliqueTopo``).

    Devices are grouped greedily, in order, into cliques whose members can
    all reach each other's memory (:func:`can_device_access_peer`): one
    card is one clique, ``[0]``. ``devices`` defaults to every visible
    CUDA device.
    """

    def __init__(self, devices=None):
        self.devices = _cuda_devices() if devices is None else [
            _as_device(d) for d in devices]
        self.cliques: list[list[int]] = []
        for i, d in enumerate(self.devices):
            for clique in self.cliques:
                if all(can_device_access_peer(d, self.devices[j]) for j in clique):
                    clique.append(i)
                    break
            else:
                self.cliques.append([i])
        self.device2clique = {
            i: ci for ci, clique in enumerate(self.cliques) for i in clique
        }

    @property
    def p2p_clique(self) -> list[list[int]]:
        return self.cliques

    def get_clique_id(self, device_index: int) -> int:
        return self.device2clique[device_index]

    def p2p_clique_device_list(self, clique_id: int) -> list[int]:
        return self.cliques[clique_id]

    @property
    def info(self) -> str:
        return "\n".join(
            f"Clique {ci} (peer access): devices {clique} "
            f"[{', '.join(str(self.devices[i]) for i in clique)}]"
            for ci, clique in enumerate(self.cliques)
        )

    def __repr__(self):
        return f"MeshTopo(cliques={self.cliques})"


def init_p2p(device_list=None) -> None:
    """No-op, as in the JAX package (the reference enables peer access
    here; PyTorch's CUDA copies enable it on first use)."""
    return None


_WORLD_DEVICE: torch.device | None = None  # this rank's, after init_distributed


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> torch.device:
    """Join a process group and record this rank's device: ``cpu`` over
    ``gloo`` when ``device`` names the CPU; else a card over ``nccl``,
    ``device`` itself when it names one by index, otherwise
    ``cuda:LOCAL_RANK`` (``cuda:rank % device_count`` when ``LOCAL_RANK``
    is unset). ``coordinator_address`` is ``host:port``, a URL
    (``tcp://localhost:29500``, ``file:///path/to/store``) or None
    (``env://``); unset arguments come from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Call once
    per process, before any collective; :func:`make_mesh` then builds a
    :class:`WorldMesh`. Returns the rank's device."""
    global _WORLD_DEVICE
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(device)  # raises without a card
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    torch.distributed.init_process_group("gloo" if cpu else "nccl", **kwargs)
    if cpu:
        dev = torch.device("cpu")
    elif device is not None and torch.device(device).index is not None:
        dev = torch.device(device)
    else:
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else torch.distributed.get_rank() % torch.cuda.device_count())
        dev = torch.device("cuda", index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _WORLD_DEVICE = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the process group (``destroy_process_group``) and forget the
    rank's device: :func:`make_mesh` builds logical meshes again."""
    global _WORLD_DEVICE, _CURRENT_WORLD
    _WORLD_DEVICE = _CURRENT_WORLD = None
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
