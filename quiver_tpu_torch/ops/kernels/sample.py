"""``sample_layer_windowed``, kept as a name: the port of
``quiver_tpu/ops/pallas/sample.py``. On Hopper the hop has no window, so
it is the exact K1-backed hop of ``ops.sample.sample_layer``."""

from __future__ import annotations

from .fused import fused_sample_layer as sample_layer_windowed

__all__ = ["sample_layer_windowed"]
