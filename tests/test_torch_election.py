"""The port's kernel election (quiver_tpu_torch/ops/election.py and the
gather and sample elections) on the contract of
``tests/test_kernel_election.py``, and against the JAX package's.

The card branch (a CUDA device) runs here through the device-taking
resolver with injected smoke and measure callables and an injected
device name, so no card is touched. Tolerance: exact (decisions, cache
entries) and bitwise (rows and samples of the two paths).
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import quiver_tpu as qj  # noqa: E402
import quiver_tpu.ops.election as ELJ  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
import quiver_tpu_torch.ops.election as EL  # noqa: E402
from quiver_tpu_torch.feature import feature as F  # noqa: E402
from quiver_tpu_torch.sampling import sampler as S  # noqa: E402
from quiver_tpu_torch.utils.graphgen import generate_pareto_graph  # noqa: E402
from quiver_tpu_torch.utils.trace import reset_once  # noqa: E402

CARD = torch.device("cuda", 0)  # named, never probed


@pytest.fixture(autouse=True)
def fresh_election(tmp_path, monkeypatch):
    """A fresh process's elections: both packages' cache-path pins unset,
    the cache file in ``tmp_path``, no env force, the memos forgotten, and
    a fake card name."""
    for mod in (EL, ELJ):
        monkeypatch.setattr(mod, "_ELECTION_CACHE_PATH", None)
    monkeypatch.setenv("QUIVER_ELECTION_CACHE", str(tmp_path / "election.json"))
    monkeypatch.delenv("QUIVER_GATHER_KERNEL", raising=False)
    monkeypatch.delenv("QUIVER_SAMPLE_KERNEL", raising=False)
    monkeypatch.setattr(EL, "device_kind", lambda device: "Fake Card sm90")
    F.GATHER_ELECTION.reset()
    S.SAMPLE_ELECTION.reset()
    reset_once()
    yield tmp_path / "election.json"
    F.GATHER_ELECTION.reset()
    S.SAMPLE_ELECTION.reset()
    reset_once()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def port_log():
    """Records of the ``quiver_tpu_torch`` logger, captured by a handler
    attached to it (not through propagation)."""
    logger = logging.getLogger("quiver_tpu_torch")
    level, handler = logger.level, _Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)
    logger.setLevel(level)


def _scores(xla, pallas):
    return lambda k, device, **kw: {"xla": xla, "pallas": pallas}[k]


def test_election_picks_measured_winner(fresh_election, monkeypatch):
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: True)
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(10.0, 4.0))
    assert S.resolve_sample_kernel("auto", CARD) == "xla"
    assert S.SAMPLE_ELECTION.result["how"] == "measured"
    assert S.SAMPLE_ELECTION.result["key"].endswith("Fake Card sm90")
    assert f"torch{torch.__version__}" in S.SAMPLE_ELECTION.result["key"]
    S.SAMPLE_ELECTION.reset()
    monkeypatch.setattr(EL, "_ELECTION_CACHE_PATH", None)
    monkeypatch.setenv("QUIVER_ELECTION_CACHE",
                       str(fresh_election.parent / "election2.json"))
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(4.0, 10.0))
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"


@pytest.mark.parametrize("smoke_ok", [True, False])
def test_gather_auto_is_k2_on_the_card(smoke_ok, fresh_election, monkeypatch,
                                       port_log):
    """The lookup's ``auto`` on the card is K2 once its smoke passes: the
    stock lookup runs no port kernel, so nothing is measured and nothing
    is cached; a failed smoke raises. ``kernel="xla"`` still passes
    through."""
    monkeypatch.setattr(F, "_pallas_gather_usable", lambda device: smoke_ok)
    if smoke_ok:
        assert F.resolve_gather_kernel("auto", CARD) == "pallas"
        assert F.GATHER_ELECTION.result == {"kernel": "pallas", "how": "smoke"}
        assert any("gather kernel=auto -> pallas" in r.getMessage() for r in port_log)
    else:
        with pytest.raises(RuntimeError, match="smoke returned wrong results"):
            F.resolve_gather_kernel("auto", CARD)
        assert F.GATHER_ELECTION.result is None
    assert not fresh_election.exists()
    assert F.resolve_gather_kernel("xla", CARD) == "xla"


def test_election_disk_cache_roundtrip(fresh_election, monkeypatch):
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: True)
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(1.0, 9.0))
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"
    blob = json.loads(fresh_election.read_text())
    cached = blob["torch.sample"]  # the port's own entry name
    assert cached["kernel"] == "pallas" and cached["score"]["pallas"] == 9.0
    S.SAMPLE_ELECTION.reset()

    def boom(k, device, **kw):
        raise AssertionError("re-measured despite disk cache")

    monkeypatch.setattr(S, "_measure_sample_eps", boom)
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"
    assert S.SAMPLE_ELECTION.result["how"] == "disk cache"
    # another key (card, torch, CUDA or kernel revision) re-elects
    cached["key"] = "rev0-torchother-cudaother-Other Card sm80"
    fresh_election.write_text(json.dumps({"torch.sample": cached}))
    S.SAMPLE_ELECTION.reset()
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(9.0, 1.0))
    assert S.resolve_sample_kernel("auto", CARD) == "xla"


def test_shared_cache_holds_both_elections(fresh_election, monkeypatch):
    """One file, nested by entry name; a flat legacy file is ignored, then
    rewritten nested. The port's gather resolution writes no entry."""
    fresh_election.write_text(json.dumps(
        {"kernel": "pallas", "gbps": {"pallas": 9.0, "xla": 1.0}, "key": "old"}))
    monkeypatch.setattr(F, "_pallas_gather_usable", lambda device: True)
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: True)
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(7.0, 3.0))
    assert F.resolve_gather_kernel("auto", CARD) == "pallas"
    assert S.resolve_sample_kernel("auto", CARD) == "xla"
    assert S.SAMPLE_ELECTION.result["how"] == "measured"
    blob = json.loads(fresh_election.read_text())
    assert set(blob) == {"torch.sample"}
    assert blob["torch.sample"]["kernel"] == "xla"


def test_corrupt_cache_fails_safe_with_one_warning(fresh_election, monkeypatch,
                                                   port_log):
    fresh_election.write_text('{"torch.sample": {"kernel": "pal')  # truncated
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: True)
    monkeypatch.setattr(S, "_measure_sample_eps", _scores(2.0, 8.0))
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"
    assert S.SAMPLE_ELECTION.result["how"] == "measured"
    warns = [r for r in port_log if "unreadable" in r.getMessage()]
    assert len(warns) == 1 and warns[0].levelno == logging.WARNING
    assert json.loads(fresh_election.read_text())["torch.sample"]["kernel"] == "pallas"
    S.SAMPLE_ELECTION.reset()

    def boom(k, device, **kw):
        raise AssertionError("re-measured despite healed disk cache")

    monkeypatch.setattr(S, "_measure_sample_eps", boom)
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"
    assert S.SAMPLE_ELECTION.result["how"] == "disk cache"
    assert not [p.name for p in fresh_election.parent.iterdir() if ".tmp." in p.name]


def test_env_knobs_pinned_at_first_use(fresh_election, monkeypatch):
    monkeypatch.setenv("QUIVER_GATHER_KERNEL", "xla")
    assert F.GATHER_ELECTION.forced() == "xla"
    first_path = EL._election_cache_path()
    assert first_path == str(fresh_election)
    monkeypatch.setenv("QUIVER_GATHER_KERNEL", "pallas")
    monkeypatch.setenv("QUIVER_ELECTION_CACHE", str(fresh_election.parent / "other.json"))
    assert F.GATHER_ELECTION.forced() == "xla"
    assert EL._election_cache_path() == first_path
    assert F.resolve_gather_kernel("auto", CARD) == "xla"
    assert F.GATHER_ELECTION.result["how"] == "env override"
    F.GATHER_ELECTION.reset()
    assert F.GATHER_ELECTION.forced() == "pallas"


def test_env_override_and_the_card_raises(fresh_election, monkeypatch):
    """The env force skips smoke and measurement; on the card a failed
    smoke or a failed measurement raises (the JAX package degrades to xla
    there; the port swaps in nothing quietly)."""
    def never(*a, **kw):
        raise AssertionError("smoke or measure ran under an env force")

    monkeypatch.setattr(S, "_pallas_sample_usable", never)
    monkeypatch.setattr(S, "_measure_sample_eps", never)
    monkeypatch.setenv("QUIVER_SAMPLE_KERNEL", "pallas")
    assert S.resolve_sample_kernel("auto", CARD) == "pallas"
    assert S.SAMPLE_ELECTION.result == {"kernel": "pallas", "how": "env override"}
    monkeypatch.delenv("QUIVER_SAMPLE_KERNEL")
    S.SAMPLE_ELECTION.reset()
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: False)
    with pytest.raises(RuntimeError, match="smoke returned wrong results"):
        S.resolve_sample_kernel("auto", CARD)
    assert S.SAMPLE_ELECTION.result is None
    monkeypatch.setattr(S, "_pallas_sample_usable", lambda device: True)

    def chip_gone(k, device, **kw):
        raise RuntimeError("chip went away")

    monkeypatch.setattr(S, "_measure_sample_eps", chip_gone)
    with pytest.raises(RuntimeError, match="chip went away"):
        S.resolve_sample_kernel("auto", CARD)
    assert S.SAMPLE_ELECTION.result is None


def test_resolve_passthrough_and_cpu_auto(monkeypatch):
    """Explicit kernels bypass the election; ``auto`` on the CPU is xla
    without a smoke or a measurement, as JAX's ``auto`` off the TPU."""
    def never(*a, **kw):
        raise AssertionError("smoke ran for an explicit or CPU resolve")

    monkeypatch.setattr(F, "_pallas_gather_usable", never)
    monkeypatch.setattr(S, "_pallas_sample_usable", never)
    monkeypatch.setattr(S, "_measure_sample_eps", never)
    for resolve in (F.resolve_gather_kernel, S.resolve_sample_kernel):
        assert resolve("pallas", CARD) == "pallas" and resolve("xla", CARD) == "xla"
        assert resolve("auto", "cpu") == "xla"
        assert resolve("auto", torch.device("cpu")) == "xla"
        with pytest.raises(ValueError, match="kernel"):
            resolve("nope", "cpu")


def test_smokes_pass_on_the_cpu():
    """The smokes' own checks run on the CPU (the wrappers take the plain
    versions): K2 against ``table[ids]``, and the fused hops against the
    composed path on shared draws, uniform and weighted."""
    assert F._pallas_gather_usable("cpu")
    assert S._pallas_sample_usable("cpu")


# -- against the JAX package ------------------------------------------------------


def _pair(smoke_ok, scores):
    """A JAX and a port KernelElection on the same injected callables."""
    ej = ELJ.KernelElection("demo", env_var="QUIVER_DEMO_KERNEL", rev=3,
                            smoke=lambda: smoke_ok, measure=lambda k: scores[k])
    et = EL.KernelElection("demo", env_var="QUIVER_DEMO_KERNEL", rev=3,
                           smoke=lambda device: smoke_ok,
                           measure=lambda k, device: scores[k])
    return ej, et


def _less_key(result):
    return {k: v for k, v in result.items() if k != "key"}


@pytest.mark.parametrize("scores", [{"xla": 1.234, "pallas": 5.678},
                                    {"xla": 9.0, "pallas": 8.999}])
def test_results_equal_jax(scores, monkeypatch):
    """Measured, then from the disk cache, then under the env force: the
    two packages decide the same and report the same result less the key."""
    ej, et = _pair(True, scores)
    assert et.elect(CARD) == ej.elect()
    assert _less_key(et.result) == _less_key(ej.result)
    assert et.result["how"] == "measured"
    ej.reset()
    et.reset()
    assert et.elect(CARD) == ej.elect()
    assert _less_key(et.result) == _less_key(ej.result)
    assert et.result["how"] == "disk cache"
    ej.reset()
    et.reset()
    monkeypatch.setenv("QUIVER_DEMO_KERNEL", "xla")
    assert et.elect(CARD) == ej.elect() == "xla"
    assert et.result == ej.result == {"kernel": "xla", "how": "env override"}


def test_shared_file_keeps_the_other_packages_entries(fresh_election):
    """Both packages read QUIVER_ELECTION_CACHE; each keeps the other's
    entries when it rewrites the file, and each still reads its own."""
    ej, et = _pair(True, {"xla": 1.0, "pallas": 2.0})
    ej.elect()
    et.elect(CARD)
    ej2, et2 = _pair(True, {"xla": 3.0, "pallas": 1.0})
    ej2.name = et2.name = "other"
    et2.elect(CARD)
    ej2.elect()
    blob = json.loads(fresh_election.read_text())
    assert set(blob) == {"demo", "torch.demo", "other", "torch.other"}
    assert blob["demo"]["key"].startswith("rev3-jax")
    assert blob["torch.demo"]["key"].startswith("rev3-torch")
    for e in (ej, et):
        e.reset()
    assert et.elect(CARD) == ej.elect() == "pallas"
    assert et.result["how"] == ej.result["how"] == "disk cache"


# -- the two paths ---------------------------------------------------------------

N, FD = 400, 8


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("store,reorder", [("hot", False), ("cold", False),
                                           ("split", False), ("split", True)])
def test_xla_rows_bitwise_jax_and_kernel(dtype, store, reorder):
    """``Feature(kernel="xla")`` rows are bitwise JAX's ``kernel="xla"``
    rows and the K2 path's (``kernel="pallas"``, its plain version here),
    in every store layout, at ids past the table and on ``-1`` lanes."""
    coo = generate_pareto_graph(N, 5.0, seed=4)
    x = np.random.default_rng(4).normal(size=(N, FD)).astype(np.float32)
    itemsize = {None: 4, "bfloat16": 2, "int8": 1}[dtype]
    budget = {"hot": "1G", "cold": 0,
              "split": (4 * N if dtype == "int8" else 0) + 120 * FD * itemsize}[store]
    tj = qj.CSRTopo(edge_index=coo) if reorder else None
    fj = qj.Feature(device_cache_size=budget, csr_topo=tj, kernel="xla",
                    dtype=dtype).from_cpu_tensor(x)
    rows = {}
    for kernel in ("xla", "pallas"):
        tt = qt.CSRTopo(edge_index=coo) if reorder else None
        ft = qt.Feature(device_cache_size=budget, csr_topo=tt, kernel=kernel,
                        dtype=dtype, device="cpu").from_cpu_tensor(x)
        assert ft.kernel == kernel and ft.hot_rows == fj.hot_rows
        n_id = np.array([0, 5, -1, N - 1, N, 3 * N, 2**31 - 1, 77, -1, 199], np.int32)
        rows[kernel] = ft[torch.from_numpy(n_id)]
    want = np.asarray(fj[jnp.asarray(n_id)])
    for got in rows.values():
        g = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(g.numpy().view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("weighted", [False, True])
def test_sampler_paths_bitwise(weighted):
    """A sampler's composed path (``kernel="xla"``) returns the fused
    path's samples bitwise from the same generator draws, and so does a
    server's ladder."""
    coo = generate_pareto_graph(300, 6.0, seed=8)
    w = np.random.default_rng(8).random(coo.shape[1]).astype(np.float32)
    outs = {}
    for kernel in ("pallas", "xla"):
        topo = qt.CSRTopo(edge_index=coo, edge_weight=w)
        smp = qt.GraphSageSampler(topo, [4, 3], device="cpu", seed=5,
                                  weighted=weighted, kernel=kernel, with_eid=True)
        assert smp.kernel == kernel
        outs[kernel] = [smp.sample(np.arange(s, s + 20)) for s in (0, 40)]
    for a, b in zip(outs["pallas"], outs["xla"]):
        assert torch.equal(a.n_id, b.n_id)
        for x, y in zip(a.adjs, b.adjs):
            assert torch.equal(x.edge_index, y.edge_index) and torch.equal(x.e_id, y.e_id)
