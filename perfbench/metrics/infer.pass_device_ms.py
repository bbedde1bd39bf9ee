"""``infer.pass_device_ms``: device milliseconds of one layer-wise pass, the
mean over the passes of the traced window: every kernel, copy and set
launched inside the loop's span around ``sage_layerwise_inference``, on
every stream."""


def read(rec):
    tr = rec.get("trace")
    calls = tr.calls.get("bench.pass") if tr is not None else None
    if not calls or sum(calls.values()) <= 0:
        return None
    return 1e3 * sum(calls.values()) / len(calls)
