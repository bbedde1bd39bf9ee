"""The checkpoint store of quiver_tpu_torch (``utils/checkpoint.py``): the
contracts of ``tests/test_checkpoint.py`` (round trip, retention, resume,
rejected saves, atomic commit, quarantine and fallback) on torch state,
and the store against the JAX package's on plain-dict state.

Every comparison is bitwise: restored leaves, manifests (``path``,
``shape``, ``dtype``, ``nbytes``, ``crc32``), and a model plus Adam state
resumed from the store against an uninterrupted run.
"""

import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu.resilience.integrity import verify_checkpoint_dir as verify_j  # noqa: E402
from quiver_tpu.utils.checkpoint import Checkpointer as CheckpointerJ  # noqa: E402

from quiver_tpu_torch.parallel.train import init_model  # noqa: E402
from quiver_tpu_torch.resilience.integrity import FORMAT, CorruptCheckpoint  # noqa: E402
from quiver_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402


def _flip_byte(path, where=0.5):
    with open(path, "r+b") as fh:
        fh.seek(int(os.path.getsize(path) * where))
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))


def _equal(a, b):
    """Bitwise equality of two state trees (containers by type)."""
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b) or sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(7, state, wait=True)
        _equal(ckpt.restore(), state)
        _equal(ckpt.restore(template=state), state)


def test_latest_and_retention(tmp_path):
    with Checkpointer(tmp_path / "ck", max_to_keep=2) as ckpt:
        for s in (1, 2, 3):
            ckpt.save(s, {"x": torch.full((2,), float(s))}, wait=True)
        assert ckpt.latest_step() == 3
        assert ckpt.all_steps() == [2, 3]
        _equal(ckpt.restore(), {"x": torch.full((2,), 3.0)})
        _equal(ckpt.restore(step=2), {"x": torch.full((2,), 2.0)})


def test_restore_empty_raises(tmp_path):
    with Checkpointer(tmp_path / "ck") as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore()


def _mlp(seed):
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 3))
    return init_model(model, torch.Generator().manual_seed(seed))


def _adam_run(steps, model=None, opt=None):
    """A small model trained by Adam on fixed data for ``steps`` steps."""
    if model is None:
        model = _mlp(0)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 5)).astype(np.float32))
    y = torch.arange(16) % 3
    for _ in steps:
        opt.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return model, opt


def test_resume_training_continues_identically(tmp_path):
    """Save model and Adam state at step 3, train on to 6; a fresh model
    and optimizer restored from step 3 and trained 3 more steps end
    bitwise where the uninterrupted run ended."""
    model, opt = _adam_run(range(3))
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(3, {"params": model.state_dict(), "opt_state": opt.state_dict()},
                  wait=True)
        _adam_run(range(3, 6), model, opt)
        fresh = _mlp(1)  # a different starting point
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
        state = ckpt.restore()
        fresh.load_state_dict(state["params"])
        fresh_opt.load_state_dict(state["opt_state"])
        _adam_run(range(3, 6), fresh, fresh_opt)
    _equal(fresh.state_dict(), model.state_dict())
    _equal(fresh_opt.state_dict(), opt.state_dict())


def test_save_rejection_surfaces_as_false(tmp_path):
    """Re-saving a committed step returns False and writes nothing."""
    with Checkpointer(tmp_path / "ck") as ckpt:
        assert ckpt.save(5, {"x": torch.zeros(2)}, wait=True) is True
        assert ckpt.save(5, {"x": torch.ones(2)}, wait=True) is False
        assert ckpt.save(5, {"x": torch.ones(2)}, wait=True) is False
        assert ckpt.all_steps() == [5]
        _equal(ckpt.restore(), {"x": torch.zeros(2)})  # the original stands


def test_close_waits_for_inflight_async_save(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    state = {"x": torch.full((3,), 7.0)}
    assert ckpt.save(1, state)  # async, no wait
    state["x"].add_(1.0)  # the saved copy was taken in save()
    ckpt.close()
    with Checkpointer(tmp_path / "ck") as reopened:
        assert reopened.latest_step() == 1
        _equal(reopened.restore(template={"x": torch.zeros(3)}),
               {"x": torch.full((3,), 7.0)})


def test_manifest_roundtrip_and_verify(tmp_path):
    """Per-leaf key path, shape, dtype and checksum plus writer metadata;
    tuples, None, 0-d leaves, Python scalars and bf16 survive."""
    state = {
        "params": {"w": torch.arange(6.0).reshape(2, 3)},
        "step": torch.tensor(7, dtype=torch.int32),
        "opt": (torch.zeros(2), torch.ones(2)),
        "groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "amsgrad": False,
                    "foreach": None, "params": [0, 1]}],
        "half": torch.arange(4, dtype=torch.bfloat16) / 3,
    }
    with Checkpointer(tmp_path / "ck") as ckpt:
        assert ckpt.save(7, state, wait=True, metadata={"workers": 8, "local_batch": 16})
        manifest = ckpt.verify(7)
        assert manifest["format"] == FORMAT and manifest["step"] == 7
        by_path = {rec["path"]: rec for rec in manifest["leaves"]}
        w = by_path["['params']['w']"]
        assert w["shape"] == [2, 3] and w["dtype"] == "float32"
        assert by_path["['step']"]["shape"] == []
        assert by_path["['half']"]["dtype"] == "bfloat16"
        assert by_path["['half']"]["nbytes"] == 8
        assert by_path["['groups'][0]['betas'][1]"]["dtype"] == "float64"
        assert by_path["['groups'][0]['amsgrad']"]["dtype"] == "bool"
        assert ckpt.metadata(7) == {"workers": 8, "local_batch": 16}
        restored = ckpt.restore()
        assert isinstance(restored["opt"], tuple)
        _equal(restored, state)


def test_uncommitted_partial_directory_is_invisible(tmp_path):
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(1, {"x": torch.full((2,), 1.0)}, wait=True)
        partial = tmp_path / "ck" / "step-9"
        partial.mkdir()
        (partial / "arrays.bin").write_bytes(b"\x00" * 16)  # no COMMIT
        assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
        _equal(ckpt.restore(), {"x": torch.full((2,), 1.0)})


def test_corrupt_newest_quarantines_and_falls_back(tmp_path):
    """A flipped payload byte in the newest checkpoint: the restore falls
    back to the newest valid one, and the corrupt directory is renamed
    out of the step scan."""
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(1, {"x": torch.full((2,), 1.0)}, wait=True)
        ckpt.save(2, {"x": torch.full((2,), 2.0)}, wait=True)
        _flip_byte(tmp_path / "ck" / "step-2" / "arrays.bin")
        _equal(ckpt.restore(template={"x": torch.zeros(2)}), {"x": torch.full((2,), 1.0)})
        assert ckpt.all_steps() == [1]
        quarantined = [n for n in os.listdir(tmp_path / "ck")
                       if n.startswith("quarantine-")]
        assert len(quarantined) == 1 and quarantined[0].startswith("quarantine-step-2-")


def test_explicit_corrupt_step_raises(tmp_path):
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(1, {"x": torch.zeros(2)}, wait=True)
        ckpt.save(2, {"x": torch.ones(2)}, wait=True)
        _flip_byte(tmp_path / "ck" / "step-2" / "arrays.bin")
        with pytest.raises(CorruptCheckpoint, match="checksum"):
            ckpt.restore(step=2)


def test_integrity_enforces_retention_floor(tmp_path):
    with pytest.raises(ValueError, match="max_to_keep"):
        Checkpointer(tmp_path / "ck", max_to_keep=1)
    Checkpointer(tmp_path / "ck2", max_to_keep=1, integrity=False).close()


def test_template_mismatch_raises(tmp_path):
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(1, {"x": torch.zeros(2)}, wait=True)
        with pytest.raises(ValueError, match="template"):
            ckpt.restore(template={"x": torch.zeros(3)})
        with pytest.raises(ValueError, match="template"):
            ckpt.restore(template={"x": torch.zeros(2, dtype=torch.float64)})


def test_template_gives_leaves_in_its_kinds(tmp_path):
    """A template's numpy leaves come back numpy, its scalars as Python
    scalars, its tensors as tensors."""
    state = {"a": np.arange(3, dtype=np.int32), "b": 0.5, "c": torch.ones(2)}
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(1, state, wait=True)
        got = ckpt.restore(template=state)
    assert isinstance(got["a"], np.ndarray) and got["a"].dtype == np.int32
    np.testing.assert_array_equal(got["a"], state["a"])
    assert got["b"] == 0.5 and type(got["b"]) is float
    assert torch.equal(got["c"], state["c"])


# -- the two packages' stores on one plain-dict state -------------------------


def _plain_state():
    rng = np.random.default_rng(3)
    return {
        "params": {"conv0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                             "bias": rng.normal(size=(3,)).astype(np.float32)},
                   "conv1": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}},
        "count": np.asarray(5, np.int32),
        "ids": rng.integers(0, 100, 7).astype(np.int64),
        "pair": (np.ones(2, np.float32), np.zeros((2, 2), np.float64)),
        "mask": rng.random(5) < 0.5,
    }


def _leaf_records(manifest):
    keys = ("path", "shape", "dtype", "nbytes", "crc32")
    return [tuple(rec[k] if k != "shape" else tuple(rec[k]) for k in keys)
            for rec in manifest["leaves"]]


def test_manifest_leaves_equal_jax(tmp_path):
    state = _plain_state()
    with CheckpointerJ(tmp_path / "j") as cj, Checkpointer(tmp_path / "t") as ct:
        cj.save(1, state, wait=True)
        ct.save(1, {k: v for k, v in reversed(list(state.items()))}, wait=True)
        assert _leaf_records(ct.verify(1)) == _leaf_records(cj.verify(1))
    # the JAX package's verification accepts the port's directory
    verify_j(str(tmp_path / "t" / "step-1"))


def test_each_package_restores_the_others_checkpoint(tmp_path):
    state = _plain_state()
    with CheckpointerJ(tmp_path / "j") as cj:
        cj.save(2, state, wait=True)
    with Checkpointer(tmp_path / "t") as ct:
        ct.save(2, {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
                        else torch.from_numpy(np.asarray(v)) if k != "params" else v)
                    for k, v in state.items()}, wait=True)
    from_jax = Checkpointer(tmp_path / "j").restore()
    from_port = CheckpointerJ(tmp_path / "t").restore()
    flat_want = _flat(state)
    assert _flat(from_port).keys() == flat_want.keys() == _flat(from_jax).keys()
    for path, want in flat_want.items():
        for got in (_flat(from_jax)[path], _flat(from_port)[path]):
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)
    assert isinstance(from_jax["pair"], tuple) and isinstance(from_port["pair"], tuple)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree}


def test_flatten_order_matches_jax_for_optimizer_state(tmp_path):
    """A torch model plus Adam state (int keys, tuples, scalars, None, an
    OrderedDict) flattens in ``jax.tree_util``'s order with its key
    paths."""
    import jax

    model, opt = _adam_run(range(2))
    state = {"params": model.state_dict(), "opt_state": opt.state_dict()}
    with Checkpointer(tmp_path / "t") as ct:
        ct.save(1, state, wait=True)
        paths = [rec["path"] for rec in ct.verify(1)["leaves"]]
    as_np = jax.tree_util.tree_map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, state)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(as_np)[0]]
    assert paths == want
    assert isinstance(state["params"], collections.OrderedDict)
    assert "['opt_state']['param_groups'][0]['betas'][0]" in paths
