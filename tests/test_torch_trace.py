"""quiver_tpu_torch's logging, tracing and debug helpers (``utils/trace.py``
and ``utils/debug.py``, the ports of quiver_tpu's): ``info_once`` /
``warn_once`` log once per key, ``trace_scope`` is a no-op when tracing is
off and a profiler annotation when it is on, ``Timer``, the
``QUIVER_LOG_LEVEL`` bootstrap, the profile ``obs.profile_epoch`` writes
around a lookup, and ``tensor_info``.

Records are captured by a handler attached to the ``quiver_tpu_torch``
logger itself, not through propagation to the root logger.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quiver_tpu_torch.utils import trace  # noqa: E402
from quiver_tpu_torch.utils.debug import show_tensor_info, tensor_info  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def records():
    trace.reset_once()
    logger = trace.get_logger()
    level, handler = logger.level, _Records()
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)
    logger.setLevel(level)
    trace.reset_once()


@pytest.fixture
def tracing(monkeypatch):
    """Restores the trace switch after the test."""
    monkeypatch.setattr(trace, "_enabled", None)
    monkeypatch.delenv("QUIVER_ENABLE_TRACE", raising=False)
    yield


def test_info_and_warn_once_log_once_per_key(records):
    for _ in range(3):
        trace.info_once("k1", "hello %d", 1, child="feature")
        trace.warn_once("k2", "careful %s", "x")
    assert [(r.levelno, r.getMessage(), r.name) for r in records] == [
        (logging.INFO, "hello 1", "quiver_tpu_torch.feature"),
        (logging.WARNING, "careful x", "quiver_tpu_torch"),
    ]
    trace.info_once("k2", "shares the key of a warning")
    assert len(records) == 2
    trace.reset_once()
    trace.info_once("k1", "again")
    assert records[-1].getMessage() == "again"


def test_logger_is_library_friendly():
    logger = trace.get_logger()
    assert logger.name == "quiver_tpu_torch"
    assert trace.get_logger("feature").name == "quiver_tpu_torch.feature"
    if not os.environ.get("QUIVER_LOG_LEVEL"):
        assert any(isinstance(h, logging.NullHandler) for h in logger.handlers)


def test_log_level_env_bootstrap():
    """``QUIVER_LOG_LEVEL`` opts into a stderr handler; an invalid level is
    reported and ignored."""
    code = ("from quiver_tpu_torch.utils.trace import get_logger\n"
            "get_logger('feature').info('placed %d rows', 7)\n")
    env = dict(os.environ, QUIVER_LOG_LEVEL="INFO", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "quiver_tpu_torch.feature INFO placed 7 rows" in out.stderr
    env["QUIVER_LOG_LEVEL"] = "bogus"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "ignoring invalid QUIVER_LOG_LEVEL='bogus'" in out.stderr
    assert "placed 7 rows" not in out.stderr


def test_trace_scope_is_a_no_op_when_disabled(tracing, monkeypatch):
    assert not trace.trace_enabled()
    scope = trace.trace_scope("feature_gather")
    assert isinstance(scope, contextlib.nullcontext)
    with scope:
        pass
    monkeypatch.setenv("QUIVER_ENABLE_TRACE", "1")
    assert trace.trace_enabled()
    assert isinstance(trace.trace_scope("x"), torch.profiler.record_function)
    trace.disable_trace()  # the live switch overrides the env var
    assert isinstance(trace.trace_scope("x"), contextlib.nullcontext)
    trace.enable_trace()
    assert trace.trace_enabled()


def test_feature_lookup_annotated_only_when_tracing(tracing, tmp_path):
    """Inside ``obs.profile_epoch`` a store's lookup shows up as a
    ``feature_gather`` range in the written profile; with tracing off the
    lookup is the same, and the switch is restored after the block."""
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.obs import profile_epoch

    x = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    feat = qt.Feature(device_cache_size="1M", device="cpu").from_cpu_tensor(x)
    ids = np.array([1, 2, -1], np.int32)
    off = feat[ids]
    with profile_epoch(str(tmp_path), "lookup"):
        assert trace.trace_enabled()
        on = feat[ids]
    assert torch.equal(on, off) and not trace.trace_enabled()
    with open(tmp_path / "lookup.trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"lookup", "feature_gather"} <= names


def test_timer(records):
    seen = []

    class Registry:
        def observe(self, name, seconds):
            seen.append((name, seconds))

    with trace.Timer("sample", registry=Registry(), metric="stage/sample") as t:
        sum(range(10000))
    assert t.seconds > 0 and seen == [("stage/sample", t.seconds)]
    assert records[-1].getMessage().startswith("[sample] ")
    assert records[-1].getMessage().endswith(" ms")
    n = len(records)
    with trace.Timer("quiet", quiet=True, sync=True) as q:
        pass
    assert len(records) == n and q.seconds >= 0


def test_tensor_info(capsys):
    t = torch.zeros(3, 4, dtype=torch.int8)
    assert tensor_info(t) == "torch.Tensor dtype=torch.int8 shape=(3, 4) [cpu]"
    assert tensor_info(np.zeros((2,), np.float32)) == "numpy dtype=float32 shape=(2,) [host]"
    assert tensor_info([1, 2]) == "numpy dtype=int64 shape=(2,) [host]"
    s = show_tensor_info(t)
    assert capsys.readouterr().out.strip() == s
