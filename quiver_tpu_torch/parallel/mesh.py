"""Device mesh and peer-access topology.

The port of ``quiver_tpu/parallel/mesh.py`` for a world of one process:
a ``(data, feature)`` grid of ``torch.device``s (:class:`Mesh`,
:func:`make_mesh`), the reference's clique view of the devices
(:class:`MeshTopo`, cliques of CUDA devices that can reach each other's
memory, the reference's ``find_cliques`` over
``torch.cuda.can_device_access_peer``), and the process-group entry point
(:func:`init_distributed`). The JAX package's ``shard_map`` has no
counterpart: work on a mesh runs as ordinary torch code, one feature
group's members at a time (``parallel/routing.py``, ``feature/shard.py``);
meshes of distinct cards are ROADMAP A.11e.

On a CPU-only machine the tests stand in for JAX's eight forced host
devices with a mesh whose device repeats (``devices=["cpu"] * 8``); a
trainer runs the workers of a repeated device one after another on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.memory import resolve_device

__all__ = [
    "DATA_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "MeshTopo",
    "axis_devices",
    "axis_groups",
    "can_device_access_peer",
    "init_distributed",
    "init_p2p",
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
    """Build a ``(data, feature)`` mesh over ``devices`` (default: every
    visible CUDA device). The ``data`` axis carries data parallelism (the
    reference's one process per GPU); the ``feature`` axis shards the hot
    feature cache. A device may appear more than once."""
    devices = _cuda_devices() if devices is None else [
        resolve_device(d) for d in devices]
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


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> None:
    """Join a process group: ``torch.distributed.init_process_group`` with
    ``nccl`` on a card and ``gloo`` when ``device`` names the CPU.
    ``coordinator_address`` is ``host:port`` (or a URL such as
    ``tcp://localhost:29500``); unset arguments come from the environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Call once per process, before any collective."""
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    torch.distributed.init_process_group(backend, **kwargs)
