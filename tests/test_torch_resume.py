"""The torch twin's ``--save-dir`` (``examples/train_sage_torch.py``), as
``examples/train_sage.py`` runs it: checkpoint each epoch, and on a rerun
restore the latest checkpoint and skip the epochs up to it.

Checks, bitwise: the state the resumed run restores (model parameters and
Adam state) is the state the first run saved after its last epoch; the
checkpoint's manifest verifies; the resumed run trains only the epochs
past the checkpoint.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from quiver_tpu_torch.utils import checkpoint  # noqa: E402

ARGS = ["--dataset", "planted:4000:6", "--batch", "256", "--hidden", "32",
        "--fanout", "10", "5", "--feature-dim", "6", "--device", "cpu"]


def _copy(tree):
    """A deep copy of a state tree with every tensor cloned."""
    if isinstance(tree, dict):
        return type(tree)((k, _copy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.device)), path
    else:
        assert a == b and type(a) is type(b), path


def test_twin_resumes_from_save_dir(tmp_path, monkeypatch, capsys):
    from examples.train_sage_torch import main

    saved, restored = {}, []
    save, restore = checkpoint.Checkpointer.save, checkpoint.Checkpointer.restore

    def record_save(self, step, state, *a, **kw):
        saved[step] = _copy(state)
        return save(self, step, state, *a, **kw)

    def record_restore(self, *a, **kw):
        state = restore(self, *a, **kw)
        restored.append(_copy(state))
        return state

    monkeypatch.setattr(checkpoint.Checkpointer, "save", record_save)
    monkeypatch.setattr(checkpoint.Checkpointer, "restore", record_restore)
    d = str(tmp_path / "ckpt")
    main(ARGS + ["--epochs", "1", "--save-dir", d])
    first = capsys.readouterr().out
    assert re.findall(r"Epoch (\d+)", first) == ["01"] and "resumed" not in first
    assert sorted(saved) == [1] and not restored

    acc, _ = main(ARGS + ["--epochs", "2", "--save-dir", d])
    second = capsys.readouterr().out
    assert f"resumed from {d} at epoch 1" in second
    assert re.findall(r"Epoch (\d+)", second) == ["02"]  # epoch 1 skipped
    assert len(restored) == 1
    _assert_equal(saved[1], restored[0])
    assert sorted(saved) == [1, 2] and 0.0 <= acc <= 1.0
    store = checkpoint.Checkpointer(d)
    assert store.all_steps() == [1, 2]
    store.verify(2)
    params = restored[0]["params"]
    assert any(k.endswith("lin_l.weight") for k in params)
    assert restored[0]["opt_state"]["param_groups"][0]["betas"] == (0.9, 0.999)
    store.close()

    main(ARGS + ["--epochs", "2", "--save-dir", d])  # nothing left to train
    third = capsys.readouterr().out
    assert "at epoch 2" in third and "Epoch" not in third.replace("at epoch", "")
