"""The memory half of quiver_tpu_torch's program audit
(``tools/audit/mem.py``) and ``MmapFeatureStore.trace_lookup``, on the CPU.

Held here:
- the recorded alloc/free walk follows lifetimes, not last uses: a freed
  buffer leaves the live set, views and the plain version's intermediates
  inside a kernel node allocate nothing, a pre-existing buffer freed
  during the run counts against the growth, the allocator's 512 B rounding
  is applied only when asked;
- every registry target is priced and fits its budget, and the
  ``CostModel`` surface JAX's ``test_cost_model_hbm_surface`` holds, fed by
  the port's ``peak_table``;
- the contract of JAX's ``test_arg_and_out_bytes_exact_on_routed_gather``
  (failing on this image): argument and output bytes exact on the routed
  gather (the card test holds the peak against the allocator);
- ``trace_lookup``: its argument bytes equal JAX's ``estimate_peak`` of
  JAX's traced merge for the same store, and its merge given the staged
  block is bitwise ``store[ids]``;
- each target's ``sources`` cover its builder's import closure;
- a kernel's shared memory is its static plus its dynamic bytes (the int8
  lookup's ring is dynamic), and the vmem-budget rule flags a launch whose
  sum passes ``DEFAULT_VMEM_BUDGET`` and passes one that meets it.
Every comparison is exact (integer bytes, names, bitwise rows).
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.ooc.store import MmapFeatureStore as StoreJ  # noqa: E402
from quiver_tpu.tools.audit import mem as jax_mem  # noqa: E402

from quiver_tpu_torch.control.cost import CostModel  # noqa: E402
from quiver_tpu_torch.core.topology import CSRTopo  # noqa: E402
from quiver_tpu_torch.ooc.store import MmapFeatureStore  # noqa: E402
from quiver_tpu_torch.ops.kernels.gather import tiered_gather_dequant  # noqa: E402
from quiver_tpu_torch.tools.audit import audit_targets as at  # noqa: E402
from quiver_tpu_torch.tools.audit import ir, mem, rules  # noqa: E402
from quiver_tpu_torch.tools.audit.audit_targets import Case, Target, build_from  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rows():
    """The memory table of every registry target, recorded on the CPU."""
    yield mem.peak_table(device="cpu")
    at.clear_cache()


# -- the walk ---------------------------------------------------------------------


def test_walk_follows_lifetimes_not_last_uses():
    def freed_between(x):
        a = x * 2  # 1 KiB, dead after the next line
        s = a.sum()
        del a
        b = x + 1  # 1 KiB again: the first one is gone
        return b, s

    def held(x):
        a = x * 2
        b = x + 1
        return a, b

    x = torch.ones(256)
    one = 256 * 4
    lean = mem.estimate_peak(ir.record(freed_between, x))
    fat = mem.estimate_peak(ir.record(held, x))
    assert lean.growth_bytes == one + 4 and fat.growth_bytes == 2 * one
    assert lean.arg_bytes == fat.arg_bytes == one
    assert lean.peak_bytes == one + lean.growth_bytes


def test_views_and_kernel_nodes_allocate_only_their_results():
    from quiver_tpu_torch.ops.kernels.gather import gather_rows

    table = torch.ones(64, 8)
    ids = torch.arange(16, dtype=torch.int32)
    views = mem.estimate_peak(ir.record(lambda t: t[2:10].reshape(-1), table))
    assert views.growth_bytes == 0
    program = ir.record(gather_rows, table, ids)
    assert [n.name for n in program.kernels] == ["gather_rows"] and not program.ops
    assert mem.estimate_peak(program).growth_bytes == 16 * 8 * 4  # the rows alone


def test_state_freed_during_the_run_and_rounding():
    holder = [torch.ones(1024)]  # 4 KiB alive before the run

    def run(x):
        holder.clear()  # the state dies
        return x + 1  # 4 KiB: the process holds no more than before

    est = mem.estimate_peak(ir.record(run, torch.ones(1024)))
    assert est.growth_bytes == 4096
    tiny = ir.record(lambda x: x + 1, torch.ones(1))
    assert mem.estimate_peak(tiny).growth_bytes == 4
    assert mem.estimate_peak(tiny, mem.ALLOCATOR_ROUND).growth_bytes == 512


def test_recorder_refuses_nothing_and_leaves_no_trace():
    """A recording returns what the function returns, records aten ops with
    their in-place writes, and leaves no recorder behind."""
    from quiver_tpu_torch.obs import marks

    acc = torch.zeros(4)
    program = ir.record(lambda u: acc.add_(u), torch.ones(4))
    assert torch.equal(program.result, torch.ones(4)) and program.result is acc
    (node,) = program.ops
    assert node.name == "aten.add_.Tensor" and node.writes == (node.results[0].storage,)
    assert marks.active() is None


# -- the registry's prices ------------------------------------------------------------


def test_every_target_declares_hbm_budget():
    for name, target in at.REGISTRY.items():
        budget = target.meta.get("hbm_budget")
        assert isinstance(budget, int) and budget > 0, name


def test_peak_table_budgets_all_in_headroom(rows):
    assert [r["target"] for r in rows] == list(at.REGISTRY)
    for r in rows:
        assert r["device"] == "cpu" and r["hbm_budget"] is not None, r
        assert 0 <= r["headroom_bytes"] < r["hbm_budget"], r
        assert r["peak_bytes"] >= r["growth_bytes"] > 0, r
    assert len(mem.format_peak_table(rows).splitlines()) == len(rows) + 1


def test_cost_model_hbm_surface(rows):
    """JAX's contract for ``calibrate_hbm`` / ``predict_hbm``, then the
    port's table as its feed: every target fits its budget."""
    model = CostModel(local_len=16, num_shards=2)
    assert not model.hbm_calibrated
    assert model.calibrate_hbm({}) is False
    assert model.calibrate_hbm({"serve_forward": 9384}) is True
    fits = model.predict_hbm("serve_forward", budget_bytes=24 * 1024)
    assert fits == {"target": "serve_forward", "known": True, "peak_bytes": 9384,
                    "budget_bytes": 24 * 1024, "headroom_bytes": 24 * 1024 - 9384,
                    "fits": True}
    assert model.predict_hbm("serve_forward", budget_bytes=9000)["fits"] is False
    unknown = model.predict_hbm("nope", budget_bytes=1)
    assert unknown["known"] is False and unknown["fits"] is None

    fed = CostModel(local_len=16, num_shards=2)
    assert fed.calibrate_hbm({r["target"]: r["peak_bytes"] for r in rows})
    for name, target in at.REGISTRY.items():
        got = fed.predict_hbm(name, budget_bytes=target.meta["hbm_budget"])
        assert got["known"] and got["fits"], got


def test_fleet_target_joined_warm():
    """serve_fleet_forward's program is the warm joiner's: its programs
    came from the first replica's cache, no capture on join."""
    warm = at.build("serve_fleet_forward", "cpu").meta["warm_join"]
    assert warm["loaded"] > 0 and warm["compiled"] == 0


def test_arg_and_out_bytes_exact_on_routed_gather():
    """The routed gather's argument and output bytes to the byte: the
    (2, 4) int32 ids; the (2, 4, 4) float32 rows and the int32 overflow."""
    est = mem.estimate_peak(at.build("routed_gather", "cpu").program)
    assert est.arg_bytes == 2 * 4 * 4
    assert est.out_bytes == 2 * 4 * 4 * 4 + 4
    assert (est.n_args, est.n_outputs) == (1, 2)
    assert est.peak_bytes == est.state_bytes + est.arg_bytes + est.growth_bytes


# -- shared memory (the vmem-budget rule) ---------------------------------------------


def _dequant_program():
    """A CPU recording of one int8 tiered lookup: one ``tiered_gather_dequant``
    kernel node."""
    codes = torch.ones(8, 4, dtype=torch.int8)
    args = (torch.arange(6, dtype=torch.int32), None, 8, codes, None, torch.ones(8))
    return args, ir.record(tiered_gather_dequant, *args)


def _dequant_attrs(static: int, dynamic: int) -> dict:
    return {"gather_dequant": [{
        "kernel": f"gather_dequant_kernel<{s}>", "entry": "gather_dequant", "block": 256,
        "regs": 40, "shared_static": static, "shared_dynamic": dynamic, "local": 0,
        "max_threads": 1024} for s in (4, 2, 1)]}


def test_vmem_usages_sum_static_and_dynamic_shared_bytes():
    _, program = _dequant_program()
    assert [n.name for n in program.kernels] == ["tiered_gather_dequant"]
    usages = mem.vmem_usages(program, _dequant_attrs(16, 49_664))
    assert [u.kernel for u in usages] == [f"gather_dequant_kernel<{s}>" for s in (4, 2, 1)]
    assert {u.shared_bytes for u in usages} == {16 + 49_664}


@pytest.mark.parametrize("dynamic,flagged", [(mem.DEFAULT_VMEM_BUDGET - 16, False),
                                             (mem.DEFAULT_VMEM_BUDGET - 15, True)])
def test_vmem_budget_flags_dynamic_shared_memory_over_the_budget(dynamic, flagged):
    args, _ = _dequant_program()
    target = Target("vmem_dynamic", "vmem_dynamic",
                    lambda dev: Case(tiered_gather_dequant, args),
                    ("tests/test_torch_memaudit.py",),
                    meta={"kernel_attrs": _dequant_attrs(16, dynamic)})
    found = rules.check_vmem_budget(target, build_from(target, "cpu"), None)
    assert [f.rule for f in found] == (["vmem-budget"] * 3 if flagged else [])
    assert all(not f.suppressed and f"shared {mem.DEFAULT_VMEM_BUDGET + 1} B" in f.message
               for f in found)


# -- trace_lookup ----------------------------------------------------------------------


def _stores(tmp_path, dtype):
    rng = np.random.default_rng(5)
    n, f = 64, 8
    ei = np.stack([rng.integers(0, n, 400), rng.integers(0, n, 400)])
    x = rng.normal(size=(n, f)).astype(np.float32)
    budget = 16 * f * (1 if dtype == "int8" else 4) + (4 * n if dtype == "int8" else 0)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    StoreJ.write(pj, x, device_cache_size=budget, csr_topo=_jax_topo(ei), dtype=dtype)
    MmapFeatureStore.write(pt, x, device_cache_size=budget, csr_topo=CSRTopo(edge_index=ei),
                           dtype=dtype)
    return StoreJ(pj, access="mmap", window_rows=16), pt


def _jax_topo(ei):
    from quiver_tpu.core.topology import CSRTopo as TopoJ

    return TopoJ(edge_index=ei)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_trace_lookup_arg_bytes_equal_jax(tmp_path, dtype):
    store_j, path = _stores(tmp_path, dtype)
    want = jax_mem.estimate_peak(store_j.trace_lookup(16).jaxpr).arg_bytes
    with MmapFeatureStore(path, window_rows=16, kernel="pallas", device="cpu") as store:
        assert 0 < store.hot_rows < 64
        program = store.trace_lookup(16)
        assert mem.estimate_peak(program).arg_bytes == want
    store_j.close()


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_trace_lookup_merge_bitwise_getitem(tmp_path, dtype, kernel):
    """The recorded merge, given the ids' translated rows and the block the
    stager assembles for them, returns bitwise ``store[ids]`` (ids past the table and -1
    lanes included), through one K2 launch with the pallas kernel."""
    _, path = _stores(tmp_path, dtype)
    with MmapFeatureStore(path, window_rows=16, kernel=kernel, device="cpu") as store:
        program = store.trace_lookup(24)
        entry = "tiered_gather_dequant" if dtype else "tiered_gather"
        assert [n.name for n in program.kernels] == ([entry] if kernel == "pallas" else [])
        ids = np.random.default_rng(1).integers(-1, 70, 24).astype(np.int32)
        t = store._translate(ids)
        block = store._gather_cold(store._cold_local(t))
        got = program.fn(torch.from_numpy(t.astype(np.int32)), torch.from_numpy(block))
        assert torch.equal(got, store[ids])


# -- sources coverage (the --changed contract) -------------------------------------------

# Modules a builder's import closure reaches that no target lists as a
# source, each tolerated because it shapes no recorded program: host-side
# construction, observability, control and resilience code the registry's
# programs never run, and the audit's own tools (editing those re-audits
# every target already: runner.select_targets).
_SOURCES_EXEMPT = frozenset({
    "quiver_tpu_torch/control/controller.py",
    "quiver_tpu_torch/control/freq.py",
    "quiver_tpu_torch/core/config.py",
    "quiver_tpu_torch/core/memory.py",
    "quiver_tpu_torch/native/__init__.py",
    "quiver_tpu_torch/obs/endpoint.py",
    "quiver_tpu_torch/obs/export.py",
    "quiver_tpu_torch/obs/timeline.py",
    "quiver_tpu_torch/obs/tracing.py",
    "quiver_tpu_torch/resilience/elastic.py",
    "quiver_tpu_torch/resilience/faults.py",
    "quiver_tpu_torch/resilience/guard.py",
    "quiver_tpu_torch/resilience/integrity.py",
    "quiver_tpu_torch/serving/coalesce.py",
    "quiver_tpu_torch/utils/checkpoint.py",
    "quiver_tpu_torch/utils/reorder.py",
    "quiver_tpu_torch/utils/trace.py",
})


def _module_file(parts):
    p = ROOT.joinpath(*parts).with_suffix(".py")
    if p.is_file():
        return p
    p = ROOT.joinpath(*parts) / "__init__.py"
    return p if p.is_file() else None


def _imports_of(path):
    pkg = list(path.relative_to(ROOT).parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if parts[0] == "quiver_tpu_torch" and _module_file(parts):
                    out.add(_module_file(parts))
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - (node.level - 1)] if node.level else []
            full = base + (node.module.split(".") if node.module else [])
            if not full or full[0] != "quiver_tpu_torch":
                continue
            for alias in node.names:
                f = _module_file(full + [alias.name]) or _module_file(full)
                if f:
                    out.add(f)
    return out


def test_builder_import_closure_covered_by_sources():
    seen, todo = set(), [ROOT / "quiver_tpu_torch/tools/audit/audit_targets.py"]
    while todo:
        p = todo.pop()
        if p not in seen:
            seen.add(p)
            todo.extend(_imports_of(p) - seen)
    closure = {str(p.relative_to(ROOT)) for p in seen}
    closure = {r for r in closure if not r.endswith("__init__.py") or "native" in r}
    closure = {r for r in closure if not r.startswith("quiver_tpu_torch/tools/")}
    union = {s for t in at.REGISTRY.values() for s in t.sources}
    assert all((ROOT / s).is_file() for s in union), sorted(s for s in union
                                                           if not (ROOT / s).is_file())
    missing = closure - union - _SOURCES_EXEMPT
    assert not missing, f"recorded modules invisible to --changed: {sorted(missing)}"
    assert not _SOURCES_EXEMPT & union, sorted(_SOURCES_EXEMPT & union)
    assert _SOURCES_EXEMPT <= closure, sorted(_SOURCES_EXEMPT - closure)
    required = {"quiver_tpu_torch/ops/election.py", "quiver_tpu_torch/serving/aot.py",
                "quiver_tpu_torch/serving/fleet.py", "quiver_tpu_torch/ooc/store.py",
                "quiver_tpu_torch/ooc/format.py", "quiver_tpu_torch/ooc/stager.py",
                "quiver_tpu_torch/parallel/routing.py", "quiver_tpu_torch/ops/kernels/gather.py"}
    assert required <= union
