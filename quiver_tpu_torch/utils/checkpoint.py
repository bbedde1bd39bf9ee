"""Checkpoint / resume of training state: atomic and integrity-verified.

The port of ``quiver_tpu/utils/checkpoint.py``, over the port's
``resilience/integrity.py`` (the same file names, CRC32 and manifest
layout), so each package verifies and restores the other's plain-dict
checkpoints:

* **Atomic**: leaves are copied to the host and checksummed in
  :meth:`Checkpointer.save` (the caller may keep training right after);
  one worker thread writes and fsyncs everything into a temp directory,
  the ``COMMIT`` marker lands last, and one ``os.replace`` renames the
  directory into place. A crash mid-save leaves only a skipped temp
  directory.
* **Integrity-verified**: restore re-derives every checksum; a corrupt or
  uncommitted newest directory is quarantined (renamed ``quarantine-*``,
  logged once per directory) and the newest valid step is restored.
  ``max_to_keep >= 2`` while integrity is on.

A state is a tree of dicts, lists, tuples (named or not) and ``None``,
with tensors, numpy arrays and Python scalars as leaves, flattened as
``jax.tree_util`` flattens it: a dict's keys sorted (an ``OrderedDict``
keeps its order), ``None`` an empty node, a scalar a 0-d leaf. The
manifest's ``path`` of a leaf is ``jax.tree_util.keystr``'s, so one state
gives the JAX package's manifest leaf for leaf. bfloat16 leaves are
written as their raw 2-byte words, named ``"bfloat16"``.

>>> ckpt = Checkpointer("/tmp/run1", max_to_keep=3)
>>> ckpt.save(epoch, {"params": model.state_dict(),
...                   "opt_state": optimizer.state_dict()})
>>> state = ckpt.restore()                    # newest VALID step
>>> model.load_state_dict(state["params"])
>>> optimizer.load_state_dict(state["opt_state"])
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import pickle
import re
import shutil
import time
import zlib

import numpy as np
import torch

from ..resilience.integrity import (ARRAYS_NAME, COMMIT_NAME, MANIFEST_NAME,
                                    TREEDEF_NAME, CorruptCheckpoint,
                                    array_checksum, build_manifest,
                                    load_manifest, quarantine_name,
                                    verify_checkpoint_dir)
from .trace import info_once

__all__ = ["Checkpointer"]

_STEP_RE = re.compile(r"^step-(\d+)$")
_TMP_PREFIX = ".tmp-"
# 0-d leaves of these dtypes come back from an untemplated restore as the
# Python scalars that are saved as them (float, int, bool)
_SCALAR_DTYPES = ("float64", "int64", "bool")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = ""):
    """``(leaves as (keystr path, leaf), skeleton)``: the leaves in
    ``jax.tree_util`` order, and the tree with each leaf replaced by its
    index (``None`` and the containers kept, a dict's keys sorted)."""
    leaves: list = []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = (list(node) if isinstance(node, collections.OrderedDict)
                    else sorted(node))
            kids = {k: walk(node[k], f"{path}[{k!r}]") for k in keys}
            return type(node)(kids) if isinstance(
                node, collections.OrderedDict) else kids
        if _is_namedtuple(node):
            return type(node)(*(walk(v, f"{path}.{f}")
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, f"{path}[{i}]") for i, v in enumerate(node))
        leaves.append((path, node))
        return len(leaves) - 1

    skeleton = walk(tree, path)
    return leaves, skeleton


def _unflatten(skeleton, leaves):
    """The skeleton with each index replaced by its leaf."""
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        kids = {k: _unflatten(v, leaves) for k, v in skeleton.items()}
        return type(skeleton)(kids) if isinstance(
            skeleton, collections.OrderedDict) else kids
    if _is_namedtuple(skeleton):
        return type(skeleton)(*(_unflatten(v, leaves) for v in skeleton))
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return leaves[skeleton]


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """``(host array, manifest dtype name)`` of one leaf, copied off the
    card now; a bfloat16 tensor becomes its raw int16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        # np.asarray, not ascontiguousarray: the latter makes a 0-d
        # scalar (1,), and the manifest records the true shape
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _leaf_array(payload: bytes, rec: dict) -> torch.Tensor:
    """One manifest record's bytes as a CPU tensor of its dtype."""
    name = rec["dtype"]
    dtype = np.dtype("int16" if name == "bfloat16" else name)
    arr = np.frombuffer(payload, dtype=dtype,
                        count=int(rec["nbytes"]) // max(dtype.itemsize, 1),
                        offset=int(rec["offset"])).reshape(tuple(rec["shape"])).copy()
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _like(t: torch.Tensor, template):
    """A restored leaf in the template leaf's kind: a tensor on the
    template's device, a numpy array, or a Python scalar."""
    if isinstance(template, torch.Tensor):
        return t.to(template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(t.item())
    return t.numpy() if t.dtype != torch.bfloat16 else t


def _template_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _fsync_dir(path: str) -> None:
    """Flush directory metadata (the rename's durability point);
    best-effort on filesystems without directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


class Checkpointer:
    """Atomic manifest-based checkpoint store for training-state trees.

    Args:
      directory: checkpoint root (created if missing; made absolute).
      max_to_keep: retention window (the oldest committed checkpoints are
        deleted). At least 2 while ``integrity=True``: the fallback from a
        corrupt checkpoint needs a previous valid one.
      integrity: verify every leaf's checksum on restore and quarantine a
        failing directory (on by default; ``False`` trusts the COMMIT
        marker alone).
      tracer: optional ``Tracer``: each save lands a ``ckpt.save`` span
        (subsystem ``resilience``) over the worker's write, tagged with
        the caller's trace.
      read_only: a reader of a directory another process writes (a world
        rank other than 0): the directory must exist, :meth:`save` raises,
        and a corrupt checkpoint is skipped, never quarantined.
    """

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3,
                 integrity: bool = True, tracer=None, read_only: bool = False):
        self.directory = os.path.abspath(os.fspath(directory))
        self.integrity = bool(integrity)
        self.tracer = tracer
        self.read_only = bool(read_only)
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        if self.integrity and max_to_keep < 2:
            raise ValueError(
                f"max_to_keep must be >= 2 with integrity verification on "
                f"(got {max_to_keep}): a corrupt newest checkpoint needs a "
                f"previous valid one to fall back to; pass integrity=False "
                f"to keep a single-checkpoint window"
            )
        self.max_to_keep = int(max_to_keep)
        if self.read_only:
            if not os.path.isdir(self.directory):
                raise FileNotFoundError(f"no checkpoint directory at {self.directory}")
        else:
            os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="quiver-ckpt"
        )
        self._pending: list[concurrent.futures.Future] = []
        self._inflight: set[int] = set()

    # -- directory scanning --------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step)}")

    def _committed(self, step: int) -> bool:
        d = self._step_dir(step)
        return os.path.isdir(d) and os.path.exists(os.path.join(d, COMMIT_NAME))

    def all_steps(self) -> list[int]:
        """Committed steps, ascending. Directories without a COMMIT marker,
        temp and quarantined ones never show here."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        steps = []
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, COMMIT_NAME)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        """Newest committed step (the marker only; restore and
        :meth:`latest_valid_step` verify the checksums)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid_step(self) -> int | None:
        """Newest step that passes full verification; corrupt committed
        directories met on the way are quarantined. With
        ``integrity=False`` this is :meth:`latest_step`."""
        if not self.integrity:
            return self.latest_step()
        for step in reversed(self.all_steps()):
            try:
                verify_checkpoint_dir(self._step_dir(step))
            except CorruptCheckpoint as e:
                self._quarantine(step, e)
                continue
            return step
        return None

    def _latest_or_raise(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return int(step)

    def verify(self, step: int | None = None) -> dict:
        """Full integrity check of ``step`` (default the latest committed);
        returns the manifest or raises :class:`CorruptCheckpoint`."""
        return verify_checkpoint_dir(self._step_dir(self._latest_or_raise(step)))

    def metadata(self, step: int | None = None) -> dict:
        """The writer's ``meta`` dict of ``step`` (default the latest
        committed); empty for a save without metadata."""
        manifest = load_manifest(self._step_dir(self._latest_or_raise(step)))
        return dict(manifest.get("meta") or {})

    def _quarantine(self, step: int, err: CorruptCheckpoint) -> None:
        """Rename a failed directory out of the step namespace (one log
        line per directory); a reader leaves it where it is."""
        if self.read_only:
            return
        src = self._step_dir(step)
        dst = os.path.join(self.directory, quarantine_name(
            os.path.basename(src), time.time() * 1000))
        try:
            os.replace(src, dst)
            where = dst
        except OSError:
            where = src  # could not rename; the step scan still skips it
        info_once(
            f"checkpoint-quarantine-{os.path.basename(src)}",
            "checkpoint step %d FAILED integrity verification (%s); "
            "quarantined at %s and falling back to the newest valid "
            "checkpoint",
            int(step), str(err), where,
        )

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state, wait: bool = False,
             metadata: dict | None = None, trace: str | None = None) -> bool:
        """Save a state tree at ``step`` (the write runs on the worker).

        The leaves are copied to the host and checksummed now, so the
        caller may update its parameters in place right after. Returns
        whether the save was accepted: ``False`` (logged once per
        process) when ``step`` is already committed or in flight, and
        nothing is written. ``metadata`` lands in the manifest's
        ``meta``.
        """
        if self.read_only:
            raise RuntimeError(f"a read-only Checkpointer of {self.directory} cannot save")
        step = int(step)
        if step in self._inflight or self._committed(step):
            info_once(
                "checkpoint-save-rejected",
                "Checkpointer.save(step=%d) was REJECTED (the step is "
                "already checkpointed or in flight) — nothing was "
                "written; further rejections in this process stay silent",
                step,
            )
            return False
        leaves, skeleton = _flatten(state)
        treedef_bytes = pickle.dumps(skeleton)
        records, chunks, offset = [], [], 0
        for path, leaf in leaves:
            arr, dtype = _host_array(leaf)
            data = arr.tobytes()
            records.append({
                "path": path,
                "shape": list(arr.shape),
                "dtype": dtype,
                "offset": offset,
                "nbytes": len(data),
                "crc32": array_checksum(arr),
            })
            chunks.append(data)
            offset += len(data)
        manifest = build_manifest(step, records,
                                  zlib.crc32(treedef_bytes) & 0xFFFFFFFF, metadata)
        self._inflight.add(step)
        self._pending.append(self._pool.submit(
            self._write_sync, step, b"".join(chunks), treedef_bytes, manifest, trace))
        if wait:
            self.wait_until_finished()
        return True

    def _write_sync(self, step: int, payload: bytes, treedef_bytes: bytes,
                    manifest: dict, trace: str | None = None) -> None:
        """Worker body: temp dir -> payload -> COMMIT -> atomic rename ->
        retention. One worker, so saves are serialised."""
        t0 = self.tracer.now() if (
            self.tracer is not None and self.tracer.enabled) else None
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}step-{step}-{os.getpid()}")
        try:
            self._sweep_stale_tmp(keep=tmp)
            os.makedirs(tmp, exist_ok=True)
            _write_file(os.path.join(tmp, ARRAYS_NAME), payload)
            _write_file(os.path.join(tmp, TREEDEF_NAME), treedef_bytes)
            _write_file(os.path.join(tmp, MANIFEST_NAME),
                        json.dumps(manifest, indent=1).encode())
            # the marker goes in last; the rename is the one commit point
            _write_file(os.path.join(tmp, COMMIT_NAME), b"COMMIT\n")
            os.replace(tmp, self._step_dir(step))
            _fsync_dir(self.directory)
            self._enforce_retention()
        finally:
            self._inflight.discard(step)
            shutil.rmtree(tmp, ignore_errors=True)
            if t0 is not None:
                self.tracer.record(
                    "ckpt.save", t0, self.tracer.now() - t0, trace=trace,
                    subsystem="resilience", step=step, nbytes=len(payload),
                )

    def _sweep_stale_tmp(self, keep: str) -> None:
        """Best-effort removal of temp directories a crashed writer left."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            full = os.path.join(self.directory, name)
            if name.startswith(_TMP_PREFIX) and full != keep:
                shutil.rmtree(full, ignore_errors=True)

    def _enforce_retention(self) -> None:
        """Delete the oldest committed checkpoints beyond ``max_to_keep``
        (the COMMIT marker first, so a kill mid-delete leaves a skipped
        directory, not a corrupt-looking one)."""
        steps = self.all_steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            d = self._step_dir(step)
            try:
                os.remove(os.path.join(d, COMMIT_NAME))
            except OSError:
                pass
            shutil.rmtree(d, ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def restore(self, step: int | None = None, template=None):
        """Restore the state at ``step`` (default: the newest valid).

        With ``step=None`` corrupt or uncommitted directories are
        quarantined and the newest checkpoint that passes verification is
        restored; an explicit step that fails verification raises
        :class:`CorruptCheckpoint`.

        Without ``template`` the saved structure comes back from its
        skeleton (tuples stay tuples, ``None`` stays), the leaves as CPU
        tensors, except 0-d float64, int64 and bool leaves, which come back
        as the Python ``float``, ``int`` and ``bool`` that are saved as
        them (so an optimizer's ``state_dict()`` loads back as it was).
        With ``template`` (a matching tree) each leaf is checked against
        the manifest's shape and dtype and comes back as the template
        leaf's kind: a tensor on its device, a numpy array, or a Python
        scalar.
        """
        self.wait_until_finished()
        if step is None:
            step = self.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        step = int(step)
        path = self._step_dir(step)
        if self.integrity:
            manifest = verify_checkpoint_dir(path)
        else:
            if not self._committed(step):
                raise CorruptCheckpoint(
                    f"{path}: no COMMIT marker (uncommitted/partial save)")
            manifest = load_manifest(path)
        with open(os.path.join(path, ARRAYS_NAME), "rb") as fh:
            payload = fh.read()
        records = manifest["leaves"]
        leaves = [_leaf_array(payload, rec) for rec in records]
        if template is None:
            with open(os.path.join(path, TREEDEF_NAME), "rb") as fh:
                skeleton = pickle.load(fh)
            leaves = [t.item() if t.dim() == 0 and rec["dtype"] in _SCALAR_DTYPES
                      else t for t, rec in zip(leaves, records)]
            return _unflatten(skeleton, leaves)
        t_leaves, t_skeleton = _flatten(template)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"template has {len(t_leaves)} leaves, checkpoint step "
                f"{step} has {len(leaves)}")
        for rec, (_, t) in zip(records, t_leaves):
            shape = tuple(t.shape) if hasattr(t, "shape") else np.shape(t)
            if tuple(rec["shape"]) != tuple(shape) or rec["dtype"] != _template_dtype(t):
                raise ValueError(
                    f"checkpoint leaf {rec['path']!r} is "
                    f"{tuple(rec['shape'])}/{rec['dtype']}, template "
                    f"expects {tuple(shape)}/{_template_dtype(t)}")
        return _unflatten(t_skeleton, [_like(v, t) for v, (_, t) in zip(leaves, t_leaves)])

    # -- lifecycle -----------------------------------------------------------

    def wait_until_finished(self) -> None:
        """Block until every in-flight save has committed (raising the
        first worker failure, if any)."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        """Wait for in-flight saves, then release the worker."""
        try:
            self.wait_until_finished()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
