"""The control on the card at a size a test run holds: the reference in the
program's place with TF32 products must come out not correct under the
committed limit, and the program itself correct. Marked ``cuda``; skips
without a card. On a GPU machine: ``python -m pytest --noconftest
perfbench/tests/test_perfbench_control.py -q -m cuda``. The same readings
at the cell's own size come from ``python -m perfbench.control``."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

pytestmark = pytest.mark.cuda

SMALL = dict(tiny.TINY, num_nodes=20000, num_edges=800000, num_features=256,
             num_classes=40, hidden_channels=256, num_layers=3, data_seed=4,
             assumed={"degree_exponent": 1.0, "degree_cap": 4000})


def test_infer_control_fails_and_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(tiny.ROOT, tiny.REAL_CELL)
    loop = harness.load_module(tiny.ROOT, "loops", cell.mix["loop"])
    lim = cell.limits["logprob_gap"]
    mix = dict(cell.mix, chunk_edges=1 << 18)
    got = list(loop.readings(SMALL, mix, [11, 12, 13], torch.device("cuda", 0)))
    assert len(got) == 3
    for line in got:
        assert line["program"]["logprob_gap"] <= lim, line
        assert line["control"]["logprob_gap"] > lim, line
        assert line["altered"]["logprob_gap"] > lim, line
