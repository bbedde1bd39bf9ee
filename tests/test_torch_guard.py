"""The non-finite step guard (``resilience/guard.py``) and
``validate_resume_meta`` (``resilience/elastic.py``) of quiver_tpu_torch
against quiver_tpu's.

- ``nonfinite_count`` on seeded trees (float leaves with NaN and Inf,
  integer and boolean leaves that count zero, nested dicts, lists and
  tuples, Python and numpy scalars) equals JAX's count on the same trees.
- ``guarded_update`` with Adam: ``ok=False`` leaves the parameters and the
  whole optimizer state (``step``, ``exp_avg``, ``exp_avg_sq``)
  bit-unchanged and drops the gradients; ``ok=True`` is a plain
  ``optimizer.step()``.
- ``validate_resume_meta`` raises JAX's three errors with JAX's messages.

Tolerance: every comparison is bitwise (integer counts, unchanged or
identically updated float32 tensors, strings).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from quiver_tpu.resilience.elastic import validate_resume_meta as validate_j  # noqa: E402
from quiver_tpu.resilience.guard import nonfinite_count as count_j  # noqa: E402

from quiver_tpu_torch.resilience import (  # noqa: E402
    guard_verdict,
    guarded_update,
    nonfinite_count,
    validate_resume_meta,
)


def _trees(seed):
    """The same tree for both packages: numpy leaves (JAX takes them as
    they are, the port as tensors, where it could be given either)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(7, 5)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = np.nan
    a[rng.random(a.shape) < 0.1] = np.inf
    b = rng.normal(size=(11,)).astype(np.float64)
    b[rng.random(b.shape) < 0.3] = -np.inf
    ints = rng.integers(-5, 5, size=(4, 3)).astype(np.int32)
    flags = rng.random(6) < 0.5
    scalar = np.float32(np.nan) if seed % 2 else np.float32(1.5)
    np_tree = {"w": a, "inner": [b, (ints, flags)], "s": scalar, "k": 3}
    torch_tree = {"w": torch.from_numpy(a), "inner": [torch.from_numpy(b),
                  (torch.from_numpy(ints), torch.from_numpy(flags))],
                  "s": scalar, "k": 3}
    return np_tree, torch_tree


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nonfinite_count_equals_jax(seed):
    np_tree, torch_tree = _trees(seed)
    want = int(count_j(np_tree))
    got = nonfinite_count(torch_tree)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want > 0


def test_nonfinite_count_ignores_integer_leaves():
    """``tests/test_resilience.py``'s case on both packages."""
    tree_j = {"f": jnp.array([1.0, jnp.nan, jnp.inf]), "i": jnp.arange(3),
              "b": jnp.float32(0.0)}
    tree = {"f": torch.tensor([1.0, float("nan"), float("inf")]),
            "i": torch.arange(3), "b": torch.tensor(0.0)}
    assert int(nonfinite_count(tree)) == int(count_j(tree_j)) == 2
    assert int(nonfinite_count({"i": torch.arange(3)})) == 0


def test_guard_verdict():
    grads = [torch.ones(3), torch.zeros(2, 2)]
    ok, bad = guard_verdict(torch.tensor(0.5), grads, ("data", "feature"))
    assert bool(ok) and int(bad) == 0
    grads[1][0, 1] = float("nan")
    ok, bad = guard_verdict(torch.tensor(float("inf")), grads)
    assert not bool(ok) and int(bad) == 2


def _adam_after_steps(steps=2):
    """A small model and Adam with ``steps`` real updates behind it (so
    every state tensor is populated), and a fresh gradient in ``.grad``."""
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x = torch.randn(8, 6, generator=g)
    for _ in range(steps + 1):
        opt.zero_grad()
        model(x).square().sum().backward()
        if _ < steps:
            opt.step()
    return model, opt


def _state(model, opt):
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def _bitwise(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_guarded_update_skip_leaves_params_and_adam_state():
    model, opt = _adam_after_steps()
    params_before, opt_before = _state(model, opt)
    assert all(int(s["step"]) == 2 for s in opt_before["state"].values())
    applied = guarded_update(opt, model, torch.tensor(False))
    assert applied is False
    params_after, opt_after = _state(model, opt)
    assert _bitwise(params_before, params_after)
    assert _bitwise(opt_before, opt_after)
    assert all(p.grad is None for p in model.parameters())


def test_guarded_update_ok_is_a_plain_step():
    model, opt = _adam_after_steps()
    twin_model = copy.deepcopy(model)
    twin_opt = torch.optim.Adam(twin_model.parameters(), lr=1e-2)
    # a copy: load_state_dict keeps the given tensors, which step updates
    twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    for p, q in zip(model.parameters(), twin_model.parameters()):
        q.grad = p.grad.clone()
    assert guarded_update(opt, list(model.parameters()), torch.tensor(True)) is True
    twin_opt.step()
    assert _bitwise(_state(model, opt), _state(twin_model, twin_opt))
    assert all(int(s["step"]) == 3 for s in opt.state_dict()["state"].values())


def _error(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("meta,match", [
    ({"workers": 8, "local_batch": 8}, "logical workers"),
    ({"workers": 4, "local_batch": 16}, "local_batch=16"),
    ({"workers": 4, "local_batch": 8, "mesh": {"data": 1, "feature": 8},
      "elastic": False}, "NON-elastic"),
])
def test_validate_resume_meta_errors_equal_jax(meta, match):
    kw = dict(mesh_shape={"data": 1, "feature": 4}, workers=4, local_batch=8)
    got = _error(validate_resume_meta, meta, **kw)
    assert got == _error(validate_j, meta, **kw)
    assert match in got


def test_validate_resume_meta_accepts_matching_and_elastic():
    kw = dict(mesh_shape={"data": 1, "feature": 4}, workers=4, local_batch=8)
    validate_resume_meta({"workers": 4, "local_batch": 8,
                          "mesh": {"data": 1, "feature": 4}}, **kw)
    validate_resume_meta({"workers": 4, "local_batch": 8, "elastic": True,
                          "mesh": {"data": 1, "feature": 8}}, **kw)
    validate_resume_meta({}, **kw)
