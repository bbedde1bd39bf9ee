"""A run with the timed path broken underneath must come out not correct:
once for each fault the cell can have. The run is driven past the command
line's look for a card, on the CPU at a tiny size.

The layer-wise pass keeps no state from pass to pass, so there is no step
that could leave its state unchanged; the cell runs on one card, so there
is no exchange between chips to leave out. What is left: half of each
node's neighbours left out, the mean taken over the rest, and an answer
altered where it is produced."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root):
    c = harness.load_cell(root, "tiny.infer")
    return harness.run_cell(c, 31337, 0.2, False, CPU, time.perf_counter())


def test_unbroken_run_is_correct(root):
    result, compared = _run(root)
    assert result["correct"], compared


def test_half_of_the_neighbours_left_out(root, monkeypatch):
    from quiver_tpu_torch.models import inference

    real = inference._neighbor_mean_dev

    def half(indptr, indices, x_all, chunk, host=False):
        deg = indptr[1:] - indptr[:-1]
        keep = (deg + 1) // 2
        pos = torch.arange(indices.shape[0]) - torch.repeat_interleave(indptr[:-1], deg)
        kept = indices[pos < torch.repeat_interleave(keep, deg)]
        starts = torch.cat([torch.zeros(1, dtype=indptr.dtype), torch.cumsum(keep, 0)])
        return real(starts, kept, x_all, chunk, host)

    monkeypatch.setattr(inference, "_neighbor_mean_dev", half)
    result, compared = _run(root)
    assert not result["correct"]
    assert [k for k, v, lim in compared if not v <= lim] == ["logprob_gap"]


def test_answer_altered_where_it_is_produced(root, monkeypatch):
    from quiver_tpu_torch.models import inference

    real = inference.sage_layerwise_inference

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, 0] += 1e-3
        return out

    monkeypatch.setattr(inference, "sage_layerwise_inference", altered)
    result, compared = _run(root)
    assert not result["correct"]
    assert [k for k, v, lim in compared if not v <= lim] == ["logprob_gap"]
