"""The torch twin of ``examples/train_host_offload.py``
(``examples/train_host_offload_torch.py``) on the CPU at a small size: a
HOST-mode sampler with auto caps, a 10%-hot store with a cold tier, and
both ``--trainer`` modes (the example's loop, and
``DataParallelTrainer.train_epoch``), prefetched and serial. Each run
prints the example's done line with a finite loss. Without a card and
without ``--device cpu`` it raises.

Tolerance: the prefetched and the serial runs of one mode give the same
loss (bitwise: the same batches and ops).
"""

import math
import re

import pytest

torch = pytest.importorskip("torch")

from examples.train_host_offload_torch import main  # noqa: E402

SMALL = ["--nodes", "5000", "--steps", "5", "--device", "cpu"]
DONE = re.compile(r"^done: 5 steps at \S+ ms/step, \S+ steps/s, loss (\S+) "
                  r"\(cache 10% hot, topology host-resident\)$", re.M)


@pytest.mark.parametrize("trainer", ["loop", "dp"])
def test_twin_runs_on_cpu(capsys, trainer):
    losses = []
    for depth in ("2", "0"):
        loss, steps_per_s = main(SMALL + ["--trainer", trainer,
                                          "--prefetch-depth", depth])
        out = capsys.readouterr().out
        assert out.startswith("building synthetic graph (5000 nodes)...")
        done = DONE.findall(out)
        assert len(done) == 1 and float(done[0]) == pytest.approx(loss, abs=1e-4)
        assert math.isfinite(loss) and steps_per_s > 0
        losses.append(loss)
    assert losses[0] == losses[1]


def test_twin_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--nodes", "500", "--steps", "1"])
