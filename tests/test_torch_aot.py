"""The port's program cache (quiver_tpu_torch/serving/aot.py) against the
JAX package's (quiver_tpu/serving/aot.py): the fingerprint, its keying,
the manifests' tolerant load and atomic publish, the counters' layout,
and the process registry behind them.

Tolerance: exact (hashes, counters, file contents).
"""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.serving import aot as aot_j  # noqa: E402

import quiver_tpu_torch as qt  # noqa: E402
from quiver_tpu_torch.ops import election  # noqa: E402
from quiver_tpu_torch.serving import aot as aot_t  # noqa: E402
from quiver_tpu_torch.utils.trace import get_logger, reset_once  # noqa: E402

COMPONENTS = [
    {},
    {"target": "serve.sample", "bucket": 8, "sizes": [5, 5]},
    {"b": [1, 2, {"z": None, "a": 1.5}], "a": "héllo", "c": True},
    {"target": "serve.forward", "bucket": 1, "params": [["convs.0.lin_l.weight",
                                                         [256, 100], "float32"]]},
]


@pytest.mark.parametrize("comp", COMPONENTS)
def test_program_fingerprint_equals_jax(comp):
    fp = qt.program_fingerprint(comp)
    assert fp == aot_j.program_fingerprint(comp)
    assert len(fp) == 32 and int(fp, 16) >= 0
    shuffled = dict(reversed(list(comp.items())))
    assert qt.program_fingerprint(shuffled) == fp


class FakeClock:
    def __call__(self):
        return 0.0


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    rng = np.random.default_rng(2)
    coo = rng.integers(0, 160, size=(2, 900))
    tt = qt.CSRTopo(edge_index=coo, edge_weight=rng.random(900))
    feat = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(
        rng.normal(size=(160, 8)).astype(np.float32))
    torch.manual_seed(0)
    srv = qt.InferenceServer(
        qt.GraphSageSampler(tt, [3, 2], device="cpu", seed=2), qt.GraphSAGE(8, 8, 3),
        feat, device="cpu", max_batch=2, clock=FakeClock(), seed=7,
        aot_cache=str(tmp_path_factory.mktemp("aot") / "programs"))
    srv.warm_from_cache()
    return srv


def test_fingerprint_keying(server):
    """Same program, same fingerprint; bucket, target and the committed
    CSR version fork it (the JAX test's cases)."""
    lad = server.ladder
    assert lad.fingerprint("sample", 2) == lad.fingerprint("sample", 2)
    assert lad.fingerprint("sample", 1) != lad.fingerprint("sample", 2)
    assert lad.fingerprint("forward", 2) != lad.fingerprint("sample", 2)
    comp = lad.fingerprint_components("sample", 2)
    bumped = dict(comp, csr_version=comp["csr_version"] + 1)
    assert qt.program_fingerprint(bumped) != qt.program_fingerprint(comp)


@pytest.mark.parametrize("kind", ["sample", "forward"])
def test_fingerprint_forks_on_every_component(server, kind):
    """Every keyed component moves the fingerprint, and the keys are the
    JAX ladder's with torch, CUDA and the card in place of JAX's
    toolchain."""
    comp = server.ladder.fingerprint_components(kind, 2)
    base = qt.program_fingerprint(comp)
    for key, value in comp.items():
        moved = dict(comp, **{key: [value, "moved"]})
        assert qt.program_fingerprint(moved) != base, key
    jax_keys = {"target", "bucket", "sizes", "lane_caps", "kernel", "dedup",
                "weighted", "csr_version", "topo_avals", "n_devices"}
    if kind == "forward":
        jax_keys |= {"model", "feature_dim", "row_dtype"}
    assert jax_keys <= set(comp)
    assert {"torch", "cuda", "device_kind"} <= set(comp)
    assert comp["target"] == f"serve.{kind}" and comp["device_kind"] == "cpu"


def test_manifest_layout_and_len(server):
    cache = server.aot_cache
    assert len(cache) == 4 and cache.stores == 4
    for kind in ("sample", "forward"):
        fp = server.ladder.fingerprint(kind, 2)
        with open(cache.entry_path(fp)) as f:
            blob = json.load(f)
        assert blob == {"format": 1, "fingerprint": fp,
                        "components": server.ladder.fingerprint_components(kind, 2)}


def test_stats_keys_equal_jax(tmp_path):
    t, j = aot_t.AOTExecutableCache(str(tmp_path)), aot_j.AOTExecutableCache(str(tmp_path))
    assert set(t.stats()) == set(j.stats())
    assert t.stats() == {"path": str(tmp_path), "entries": 0, "hits": 0,
                         "misses": 0, "stores": 0, "rejects": 0}
    assert t.entry_path("ab") == j.entry_path("ab")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("damage", ["truncate", "skew"])
def test_corrupt_manifest_one_warning_then_republish(server, damage):
    """A truncated or skewed manifest is a miss with ONE warning; the
    capture that follows republishes over it, so the next replica captures
    nothing, and the atomic publish leaves no temp file."""
    reset_once()
    cache = server.aot_cache
    fp = server.ladder.fingerprint("forward", 1)
    path = cache.entry_path(fp)
    if damage == "truncate":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:20])
    else:
        with open(path, "w") as f:
            json.dump({"format": 1, "fingerprint": "0" * 32, "components": {}}, f)
    handler = _Capture()
    get_logger().addHandler(handler)
    try:
        rejects = cache.rejects
        c = qt.InferenceServer(server.sampler, server.model, server.feature,
                               device="cpu", max_batch=2, clock=FakeClock(), seed=7,
                               aot_cache=cache)
        assert c.warm_from_cache() == {"loaded": 3, "compiled": 1}
        assert c.recompiles == 1 and cache.rejects == rejects + 1
    finally:
        get_logger().removeHandler(handler)
    warns = [m for m in handler.messages if "unreadable" in m or "does not match" in m]
    assert len(warns) == 1, handler.messages
    d = qt.InferenceServer(server.sampler, server.model, server.feature, device="cpu",
                           max_batch=2, clock=FakeClock(), seed=7, aot_cache=cache)
    assert d.warm_from_cache() == {"loaded": 4, "compiled": 0}
    residue = [n for n in os.listdir(cache.path) if ".tmp." in n]
    assert not residue, residue
    for r in d.serve([3, 4, 5]):
        np.testing.assert_array_equal(r.result, server.oracle(r.node, r.seq))


def test_fresh_process_captures_again(server, monkeypatch):
    """Manifests persist, programs do not: with the process registry empty
    (a fresh process) every build captures again and republishes, which is
    where the port differs from the JAX package."""
    monkeypatch.setattr(aot_t, "_PROGRAMS", type(aot_t._PROGRAMS)())
    cache = aot_t.AOTExecutableCache(server.aot_cache.path)
    e = qt.InferenceServer(server.sampler, server.model, server.feature, device="cpu",
                           max_batch=2, clock=FakeClock(), seed=7, aot_cache=cache)
    assert e.warm_from_cache() == {"loaded": 0, "compiled": 4}
    assert cache.stats()["misses"] == 4 and cache.rejects == 0 and cache.stores == 4
    assert len(cache) == 4


def test_programs_live_while_a_ladder_holds_them(tmp_path):
    """The registry holds programs weakly: a program of a dropped ladder
    is gone, and a later build captures it again."""
    rng = np.random.default_rng(1)
    tt = qt.CSRTopo(edge_index=rng.integers(0, 50, size=(2, 300)))
    feat = qt.Feature(device_cache_size="1G", device="cpu").from_cpu_tensor(
        np.ones((50, 4), np.float32))
    smp, model = qt.GraphSageSampler(tt, [2], device="cpu"), qt.GraphSAGE(4, 4, 2, num_layers=1)
    kw = dict(device="cpu", max_batch=1, clock=FakeClock(), aot_cache=str(tmp_path))
    first = qt.InferenceServer(smp, model, feat, **kw)
    assert first.warm_from_cache()["compiled"] == 2
    assert qt.InferenceServer(smp, model, feat, **kw).warm_from_cache()["compiled"] == 0
    del first
    import gc
    gc.collect()
    assert qt.InferenceServer(smp, model, feat, **kw).warm_from_cache()["compiled"] == 2


def test_cache_dir_resolved_once(monkeypatch, tmp_path):
    """``QUIVER_AOT_CACHE`` wins; without it the directory sits beside the
    election cache; either is read once per process, as in JAX."""
    monkeypatch.setattr(aot_t, "_AOT_CACHE_DIR", None)
    monkeypatch.setattr(election, "_ELECTION_CACHE_PATH", None)
    monkeypatch.delenv("QUIVER_AOT_CACHE", raising=False)
    monkeypatch.setenv("QUIVER_ELECTION_CACHE", str(tmp_path / "e" / "elect.json"))
    assert aot_t.AOTExecutableCache().path == str(tmp_path / "e" / "aot_executables")
    monkeypatch.setenv("QUIVER_AOT_CACHE", str(tmp_path / "other"))
    assert aot_t.AOTExecutableCache().path == str(tmp_path / "e" / "aot_executables")
    monkeypatch.setattr(aot_t, "_AOT_CACHE_DIR", None)
    assert aot_t.AOTExecutableCache().path == str(tmp_path / "other")


def test_server_takes_path_true_or_cache(tmp_path, monkeypatch, server):
    monkeypatch.setattr(aot_t, "_AOT_CACHE_DIR", str(tmp_path / "default"))
    for arg, path in ((True, str(tmp_path / "default")),
                      (tmp_path / "p", str(tmp_path / "p")),
                      (aot_t.AOTExecutableCache(str(tmp_path / "q")), str(tmp_path / "q"))):
        s = qt.InferenceServer(server.sampler, server.model, server.feature,
                               device="cpu", max_batch=1, aot_cache=arg)
        assert s.aot_cache.path == path
    assert qt.InferenceServer(server.sampler, server.model, server.feature,
                              device="cpu", max_batch=1).aot_cache is None
