"""Memory and layout accounting over recorded programs.

The port of ``quiver_tpu/tools/audit/mem.py``. The comm rules say what a
program moves; this module says what it holds, from the same recorded
:class:`~.ir.Program`:

* **lifetimes, not last uses**: eager torch frees a buffer when its last
  reference dies, so :func:`estimate_peak` walks the recorded alloc and
  free events (each storage followed by ``weakref.finalize``), not the
  JAX package's last-use rule;
* **the whole process**: the port's logical mesh lives on one card, and
  ``torch.cuda.max_memory_allocated`` measures the whole process, so the
  estimate prices every storage on the program's device type, not one
  member of a mesh (the JAX package divides by the audit mesh's
  shardings);
* **kernel nodes**: a kernel's results are its only allocations (the
  wrapper allocates them; the kernel itself allocates nothing), which is
  what a launch on the card does; the plain version's intermediates on the
  CPU are not the program's;
* **rounding**: the card's caching allocator rounds every block up to 512
  bytes, which dominates at the registry's sizes of a few KB, so the
  estimate rounds the same way (``round_to=ALLOCATOR_ROUND``) whenever it
  is compared with the card (:func:`cuda_memory_stats`).

The estimate cannot see what the dispatcher never returns: cub's temporary
storage inside a CUDA ``sort`` / ``unique`` / ``cumsum``, cuBLAS's
workspace and the kernel wrappers' small argument tensors (allocated inside
a kernel node). Where those stand at the peak, the card's measured growth
exceeds the estimate; the registry states the band
(``audit_targets.PEAK_BAND``). Garbage in reference cycles that a
collection frees during the run would make the measured growth read low,
so :func:`cuda_memory_stats` collects first.

The kernel-resource half (:func:`vmem_usages`) reads each launched
kernel's ``cudaFuncGetAttributes`` through the ``quiver_kernel_attrs``
entry every kernel library exports: registers, static shared memory, local
(spill) bytes, max threads per block, and the block size the host code
launches with. That is the JAX package's VMEM accounting for Hopper.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from . import ir

__all__ = [
    "ALLOCATOR_ROUND",
    "DEFAULT_VMEM_BUDGET",
    "KERNEL_ENTRIES",
    "PADDING_WASTE_LIMIT",
    "REGISTERS_PER_SM",
    "REPLICATION_BYTES_LIMIT",
    "MemoryEstimate",
    "VmemUsage",
    "cuda_memory_stats",
    "estimate_peak",
    "feature_replications",
    "format_peak_table",
    "kernel_attrs",
    "padding_waste",
    "peak_table",
    "vmem_usages",
]

# the CUDA caching allocator's block granularity
ALLOCATOR_ROUND = 512

# Hopper: the shared memory one block may use (227 KB, dynamic above 48
# KB), and the registers of one SM; targets override the first via
# meta["vmem_budget"] (the hopper-kernels figures, NVIDIA's data sheet)
DEFAULT_VMEM_BUDGET = 232_448
REGISTERS_PER_SM = 65_536

# a feature-axis-gathered intermediate below this is noise (overflow ids,
# counts); above it, replication is a real F-times memory cliff
REPLICATION_BYTES_LIMIT = 1 << 10

# padded all_to_all lanes above this fraction of the shipped buckets are a
# finding: alpha=2 sits at 0.5 waste by construction
PADDING_WASTE_LIMIT = 0.6

# kernel wrapper (a kernel node's name) -> the C entry that launches it
# (ops/kernels/build.py _ENTRIES), whose kernels the attributes describe
KERNEL_ENTRIES = {
    "select": "select",
    "uniform_hop": "uniform_hop",
    "gather_rows": "gather",
    "tiered_gather": "gather",
    "tiered_gather_dequant": "gather_dequant",
    "wselect": "wselect",
    "weighted_hop": "weighted_hop",
}


def _rounded(nbytes: int, round_to: int) -> int:
    if round_to <= 1 or nbytes <= 0:
        return max(nbytes, 0)
    return int(math.ceil(nbytes / round_to)) * round_to


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """The recorded program's memory on its device type."""

    peak_bytes: int  # held (inputs and state touched) + growth
    arg_bytes: int  # the inputs' bytes
    out_bytes: int  # the outputs' bytes
    aliased_bytes: int  # input and state storages written in place (reused)
    n_args: int
    n_outputs: int
    state_bytes: int = 0  # storages alive before the run (parameters, tables)
    growth_bytes: int = 0  # peak of new storages less state freed: the card's growth


def estimate_peak(program: ir.Program, round_to: int = 1) -> MemoryEstimate:
    """Walk the program's alloc and free events on its device type: the
    growth is the largest ``live new bytes - freed pre-existing bytes`` at
    any event (what ``max_memory_allocated`` less the bytes allocated
    before the run measures), the peak adds the inputs and state the
    program held. ``round_to`` rounds every storage up (512: the card's
    caching allocator)."""
    dev = program.device
    store = program.storages
    mine = {k: s for k, s in store.items() if s.device == dev}
    size = {k: _rounded(s.nbytes, round_to) for k, s in mine.items()}
    live = growth = 0
    for kind, key, _node in program.events:
        if key not in mine:
            continue
        if kind == "alloc":
            live += size[key]
            growth = max(growth, live)
        else:  # a new storage, or one that predates the run, freed
            live -= size[key]
    held = sum(size[k] for k, s in mine.items() if s.role in ("input", "state"))
    state = sum(size[k] for k, s in mine.items() if s.role == "state")
    written = {k for n in program.nodes for k in n.writes}
    aliased = sum(size[k] for k in written if k in mine and mine[k].role != "new")
    arg = sum(v.nbytes for v in program.inputs)
    out = sum(v.nbytes for v in program.outputs)
    return MemoryEstimate(peak_bytes=held + growth, arg_bytes=arg, out_bytes=out,
                          aliased_bytes=aliased, n_args=len(program.inputs),
                          n_outputs=len(program.outputs), state_bytes=state,
                          growth_bytes=growth)


# -- kernel resources (the VMEM accounting's counterpart) ------------------------


@dataclasses.dataclass(frozen=True)
class VmemUsage:
    """One kernel instantiation's static resources, as a launch uses them."""

    name: str  # the kernel wrapper
    kernel: str  # the __global__ instantiation
    block: int  # threads per block the host code launches with
    regs: int  # registers per thread
    shared_bytes: int  # static + dynamic shared memory per block
    local_bytes: int  # local (spill) bytes per thread
    max_threads: int  # the most threads per block the kernel can launch

    def __str__(self):
        return (f"{self.name} ({self.kernel}): block {self.block}, "
                f"{self.regs} regs, shared {self.shared_bytes} B, "
                f"local {self.local_bytes} B, max threads {self.max_threads}")


@functools.cache
def kernel_attrs() -> dict:
    """``{C entry: [attribute dicts]}`` of every kernel instantiation, read
    on the card (``build.kernel_attrs``); builds the kernels first."""
    from ...ops.kernels.build import kernel_attrs as read

    out: dict = {}
    for a in read():
        out.setdefault(a["entry"], []).append(a)
    return out


def vmem_usages(program: ir.Program, attrs: dict) -> list:
    """Each distinct kernel entry the program launched, with every kernel
    instantiation that entry may launch (``attrs``: :func:`kernel_attrs`'s
    form). An entry with no attributes gives no usage."""
    out, seen = [], set()
    for n in program.kernels:
        if n.name in seen:
            continue
        seen.add(n.name)
        for a in attrs.get(KERNEL_ENTRIES.get(n.name, n.name), ()):
            out.append(VmemUsage(
                name=n.name, kernel=a["kernel"], block=int(a["block"]),
                regs=int(a["regs"]),
                shared_bytes=int(a["shared_static"]) + int(a["shared_dynamic"]),
                local_bytes=int(a["local"]), max_threads=int(a["max_threads"])))
    return out


# -- replication and padding -------------------------------------------------------


def feature_replications(program: ir.Program, axis: str = "feature",
                         limit: int = REPLICATION_BYTES_LIMIT) -> list:
    """Every ``all_gather`` over ``axis`` whose gathered result reaches
    ``limit`` bytes: the op that makes a sharded operand cost F times per
    member. Each entry names the producer of the gathered tensor."""
    made = {}
    for n in program.nodes:
        for v in n.results:
            made.setdefault(v.storage, n.name)
    out = []
    for n in program.nodes:
        if n.kind != "collective" or n.name != "all_gather" or axis not in n.axes:
            continue
        res = n.results[0]
        if res.nbytes >= int(limit):
            out.append({
                "prim": n.name, "path": (f"node{n.index}",), "axis": axis,
                "shape": res.shape, "dtype": res.dtype, "bytes": res.nbytes,
                "producer": made.get(n.operands[0].storage, "a program input"),
            })
    return out


def padding_waste(built) -> list:
    """Lanes against payload per routed ``all_to_all`` of a target that
    declares a comm model (``meta["comm"]``): the buckets ship ``F * cap``
    lanes, the payload is ``local_len * (1 - h0)`` requests."""
    comm = built.meta.get("comm")
    if comm is None:
        return []
    payload = int(comm["local_len"]) * (1.0 - float(comm.get("h0", 0.0)))
    out = []
    for c in ir.collectives_of(built.program):
        if c.prim != "all_to_all" or len(c.shape) < 2:
            continue
        lanes = int(c.shape[0]) * int(c.shape[1])
        waste = 1.0 - min(payload / lanes, 1.0) if lanes else 0.0
        out.append({"collective": str(c), "cap": int(c.shape[1]), "lanes": lanes,
                    "payload_lanes": payload, "waste": waste})
    return out


# -- the card's measurement and the table --------------------------------------------


def cuda_memory_stats(target) -> dict:
    """Run one registry target's program once more on the card and measure
    it: ``reset_peak_memory_stats()``, the run, then the growth of
    ``max_memory_allocated()`` over what was allocated before. The only
    audit path that needs the card (it raises without one); the target's
    fixtures come from the registry's cache, so only the run is measured."""
    import gc

    import torch

    from .audit_targets import build

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_memory_stats measures on a CUDA card; none is available")
    built = build(target.name, "cuda")
    fn, inputs = built.program.fn, built.inputs
    # garbage in reference cycles, collected during the run, would free
    # memory the run never held
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"before_bytes": before, "peak_bytes": peak, "growth_bytes": peak - before}


def peak_table(names=None, device=None, with_cuda: bool = False) -> list:
    """Per-target memory rows: the estimate (and its growth rounded as the
    card allocates), the declared budget and its headroom; with
    ``with_cuda``, the card's measured growth (:func:`cuda_memory_stats`)
    beside it. ``CostModel.calibrate_hbm`` takes the ``peak_bytes``
    column."""
    from .audit_targets import REGISTRY, build

    rows = []
    for name in (names or list(REGISTRY)):
        built = build(name, device)
        est = estimate_peak(built.program)
        budget = built.meta.get("hbm_budget")
        row = {
            "target": name,
            "device": built.program.device,
            "peak_bytes": est.peak_bytes,
            "arg_bytes": est.arg_bytes,
            "out_bytes": est.out_bytes,
            "state_bytes": est.state_bytes,
            "growth_bytes": est.growth_bytes,
            "growth_512_bytes": estimate_peak(built.program, ALLOCATOR_ROUND).growth_bytes,
            "hbm_budget": None if budget is None else int(budget),
            "headroom_bytes": None if budget is None else int(budget) - est.peak_bytes,
        }
        if with_cuda:
            stats = cuda_memory_stats(REGISTRY[name])
            row["cuda_growth_bytes"] = stats["growth_bytes"]
            row["cuda_ratio"] = (None if not stats["growth_bytes"] else
                                 round(row["growth_512_bytes"] / stats["growth_bytes"], 3))
        rows.append(row)
    return rows


def format_peak_table(rows) -> str:
    """Render :func:`peak_table` rows as a fixed-width table."""
    with_cuda = any("cuda_growth_bytes" in r for r in rows)
    head = (f"{'target':22s} {'est-peak':>10s} {'args':>8s} {'out':>7s} "
            f"{'growth':>8s} {'budget':>8s} {'headroom':>9s}")
    if with_cuda:
        head += f" {'grow-512':>9s} {'cuda-grow':>9s} {'ratio':>6s}"
    lines = [head]
    for r in rows:
        budget, room = r["hbm_budget"], r["headroom_bytes"]
        line = (f"{r['target']:22s} {r['peak_bytes']:10d} {r['arg_bytes']:8d} "
                f"{r['out_bytes']:7d} {r['growth_bytes']:8d} "
                f"{'-' if budget is None else budget:>8} {'-' if room is None else room:>9}")
        if with_cuda:
            ratio = r.get("cuda_ratio")
            line += (f" {r['growth_512_bytes']:9d} {r['cuda_growth_bytes']:9d}"
                     f" {'-' if ratio is None else ratio:>6}")
        lines.append(line)
    return "\n".join(lines)
