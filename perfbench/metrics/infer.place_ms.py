"""``infer.place_ms``: milliseconds on the card's stream of a pass's
``infer.place`` span (``_place``: the CSR's copies to the card, from
pageable host memory on every call, and the features' placement; the
host widens ``indptr`` before the span opens), timed by the program's
CUDA events; the mean over the traced window's passes. A pageable copy
is staged through the host, so the host's pace is part of it.

The other readers of the program's spans load this file for
:func:`passes` and :func:`span_ms`."""

NAME = "infer.place"


def passes(rec):
    """The traced window's complete passes, each as the spans of its trace:
    the program's default tracer's ``infer.pass`` traces holding their
    ``infer.place`` and an ``infer.layer`` per layer, the last
    ``rec["passes"]`` of them. None without a traced window, or where the
    program records no spans of its own."""
    if rec.get("trace") is None:
        return None
    try:
        from quiver_tpu_torch.obs import default_tracer
    except ImportError:
        return None
    done = []
    for spans in default_tracer().traces("infer.pass"):
        names = [s.name for s in spans]
        root = spans[names.index("infer.pass")]
        if names.count("infer.place") == 1 and names.count("infer.layer") == root.attrs.get(
                "layers"):
            done.append(spans)
    return done[-rec["passes"]:] if rec.get("passes") else done


def span_ms(rec, name):
    """The mean over the window's passes of the summed ``device_ms`` of
    each pass's spans ``name``; None where a pass has one untimed."""
    done = passes(rec)
    if not done:
        return None
    per_pass = [[s.device_ms for s in spans if s.name == name] for spans in done]
    if any(None in ms for ms in per_pass):
        return None
    return sum(map(sum, per_pass)) / len(per_pass)


def read(rec):
    return span_ms(rec, NAME)
