"""Structured export of :class:`MetricSnapshot` streams.

The port of ``quiver_tpu/obs/export.py``, in pure Python and numpy: for
the same snapshots it writes the same bytes as the JAX package, and each
package parses the other's output. Two formats, both round-trippable:

* **JSON lines**: one self-describing object per snapshot
  (``{"name", "kind", "steps", "shape", "dtype", "value", ...}``) for
  long-run artifacts (``metrics.jsonl``) and offline analysis;
* **Prometheus-style text exposition**: ``# HELP``/``# TYPE`` plus one
  sample per element (vector metrics carry an ``idx="i,j"`` label) for
  scraping live runs. A ``# QUIVER`` metadata comment per metric (ignored
  by scrapers: ``#`` lines that are not HELP/TYPE are comments) carries
  the original dotted name, dtype, steps and shape so the exposition
  parses back losslessly.
"""

from __future__ import annotations

import io
import json
import re

import numpy as np

from .registry import MetricSnapshot

__all__ = [
    "snapshot_to_dict",
    "snapshot_from_dict",
    "write_jsonl",
    "read_jsonl",
    "to_prometheus",
    "from_prometheus",
    "prometheus_name",
    "escape_label_value",
]


# -- JSON lines ---------------------------------------------------------------

def snapshot_to_dict(snap: MetricSnapshot) -> dict:
    arr = snap.numpy
    return {
        "name": snap.name,
        "kind": snap.kind,
        "steps": snap.steps,
        "shape": list(arr.shape),
        "dtype": arr.dtype.name,
        "value": arr.tolist(),
        "unit": snap.unit,
        "doc": snap.doc,
    }


def snapshot_from_dict(d: dict) -> MetricSnapshot:
    arr = np.asarray(d["value"], dtype=np.dtype(d["dtype"]))
    arr = arr.reshape(tuple(d["shape"]))
    return MetricSnapshot(
        d["name"], d["kind"], arr, d.get("steps"),
        d.get("unit", ""), d.get("doc", ""),
    )


def write_jsonl(snapshots, path_or_file, extra: dict | None = None) -> int:
    """Append one JSON line per snapshot; ``extra`` fields (run identity —
    job key, platform, timestamp) are merged into every line. Returns the
    number of lines written."""
    rows = []
    for snap in snapshots:
        d = snapshot_to_dict(snap)
        if extra:
            d.update(extra)
        rows.append(json.dumps(d))
    if not rows:
        return 0
    if hasattr(path_or_file, "write"):
        path_or_file.write("\n".join(rows) + "\n")
    else:
        with open(path_or_file, "a", encoding="utf-8") as fh:
            fh.write("\n".join(rows) + "\n")
    return len(rows)


def read_jsonl(path_or_text) -> list[MetricSnapshot]:
    """Parse a metrics.jsonl file (path, file object, or text) back into
    snapshots; non-metric lines are skipped."""
    if hasattr(path_or_text, "read"):
        text = path_or_text.read()
    elif "\n" in path_or_text or path_or_text.lstrip().startswith("{"):
        text = path_or_text
    else:
        with open(path_or_text, encoding="utf-8") as fh:
            text = fh.read()
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and {"name", "kind", "value"} <= d.keys():
            out.append(snapshot_from_dict(d))
    return out


# -- Prometheus-style exposition ----------------------------------------------

def prometheus_name(name: str) -> str:
    """Dotted metric name -> a legal exposition metric name."""
    return "quiver_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition format: backslash, double
    quote, and newline must be escaped or a hostile name breaks the line
    out of its sample (label injection)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(value: str) -> str:
    # HELP text: backslash and newline escape; quotes are legal verbatim
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def to_prometheus(snapshots) -> str:
    """Text exposition of the snapshots (one sample per array element).

    Hygiene: dotted/hostile metric names sanitize via
    :func:`prometheus_name` (distinct names that sanitize to the same
    exposition name get a ``_2``/``_3`` suffix instead of silently
    merging); every metric emits ``# HELP`` (escaped) and ``# TYPE``;
    the original name rides both as an escaped ``name=""`` label on each
    sample and in the ``# QUIVER`` JSON metadata comment, which is what
    makes :func:`from_prometheus` a lossless inverse even for names
    containing ``\\``, ``"`` or newlines."""
    out = io.StringIO()
    assigned: dict[str, str] = {}  # dotted name -> exposition name
    for snap in snapshots:
        arr = snap.numpy
        pname = assigned.get(snap.name)
        if pname is None:
            base = prometheus_name(snap.name)
            pname, n = base, 1
            taken = set(assigned.values())
            while pname in taken:
                n += 1
                pname = f"{base}_{n}"
            assigned[snap.name] = pname
        meta = {
            "pname": pname,
            "name": snap.name,
            "kind": snap.kind,
            "dtype": arr.dtype.name,
            "steps": snap.steps,
            "shape": list(arr.shape),
            "unit": snap.unit,
            "doc": snap.doc,
        }
        out.write(f"# QUIVER {json.dumps(meta, sort_keys=True)}\n")
        out.write(f"# HELP {pname} {_escape_help(snap.doc)}\n")
        out.write(f"# TYPE {pname} {snap.kind}\n")
        name_lbl = escape_label_value(snap.name)
        if arr.ndim == 0:
            out.write(f'{pname}{{name="{name_lbl}"}} {_fmt(arr[()])}\n')
        else:
            for idx in np.ndindex(arr.shape):
                lbl = ",".join(str(i) for i in idx)
                out.write(
                    f'{pname}{{name="{name_lbl}",idx="{lbl}"}} '
                    f"{_fmt(arr[idx])}\n"
                )
    return out.getvalue()


def _fmt(v) -> str:
    if np.issubdtype(np.asarray(v).dtype, np.integer):
        return str(int(v))
    return repr(float(v))


_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<val>\S+)$'
)
# idx label anchored at the END of the label block — a hostile name label
# (escaped, quoted, emitted first) cannot spoof it
_IDX = re.compile(r'(?:^|,)idx="(?P<idx>[0-9,]*)"$')
# legacy space-separated metadata comment (pre-hygiene expositions)
_META = re.compile(
    r"^# QUIVER (?P<pname>\S+) name=(?P<name>\S+) kind=(?P<kind>\S+) "
    r"dtype=(?P<dtype>\S+) steps=(?P<steps>\S+) shape=(?P<shape>\S+)$"
)


def _parse_meta(line: str) -> dict | None:
    body = line[len("# QUIVER "):]
    if body.startswith("{"):
        try:
            d = json.loads(body)
        except ValueError:
            return None
        if isinstance(d, dict) and "pname" in d:
            d["shape"] = tuple(d.get("shape") or ())
            return d
        return None
    m = _META.match(line)
    if not m:
        return None
    d = m.groupdict()
    d["steps"] = None if d["steps"] == "None" else int(d["steps"])
    d["shape"] = (
        () if d["shape"] == "-"
        else tuple(int(s) for s in d["shape"].split(","))
    )
    return d


def from_prometheus(text: str) -> list[MetricSnapshot]:
    """Parse an exposition produced by :func:`to_prometheus` back into
    snapshots (the ``# QUIVER`` metadata lines make the round trip
    lossless — original name, dtype, steps axis, shape, unit and doc are
    all recovered, hostile names included). Legacy (pre-hygiene)
    expositions parse too."""
    meta: dict[str, dict] = {}
    samples: dict[str, dict[tuple, str]] = {}
    order: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# QUIVER "):
            d = _parse_meta(line)
            if d is not None:
                meta[d["pname"]] = d
                if d["pname"] not in order:
                    order.append(d["pname"])
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        pname = m.group("name")
        labels = m.group("labels")
        idx = None
        if labels is not None:
            mi = _IDX.search(labels)
            if mi is not None:
                idx = mi.group("idx")
        key = () if idx is None else tuple(
            int(i) for i in idx.split(",") if i != ""
        )
        samples.setdefault(pname, {})[key] = m.group("val")
        if pname not in order:
            order.append(pname)
    out = []
    for pname in order:
        vals = samples.get(pname, {})
        md = meta.get(pname)
        if md is None or not vals:
            continue
        dtype = np.dtype(md["dtype"])
        shape = tuple(md["shape"])
        arr = np.zeros(shape, dtype)
        for key, raw in vals.items():
            v = int(raw) if np.issubdtype(dtype, np.integer) else float(raw)
            arr[key] = v
        out.append(
            MetricSnapshot(
                md["name"], md["kind"], arr, md["steps"],
                md.get("unit", ""), md.get("doc", ""),
            )
        )
    return out
