"""Recorded torch programs: what the audit walks.

The port of ``quiver_tpu/tools/audit/ir.py``. The JAX package traces each
target with ``jax.jit(...).trace`` and walks its jaxpr and StableHLO
without running anything. The port cannot: its kernels are ctypes calls
no tracer sees through, its entry points read numpy on the host, and it
runs eagerly. So a target is run once, on small inputs, under a recorder,
and the audit walks what was recorded, a :class:`Program`:

* **ops**: every aten op the dispatcher ran, with its operands' and
  results' shapes, dtypes, devices and storages, and the storages it wrote
  in place (from the op's schema: in-place and ``out=`` arguments);
* **kernel nodes**: each call of a kernel wrapper (``obs.marks
  .kernel_entry``) is ONE opaque node, its operands and its results; the
  ops of the plain version that runs inside it on the CPU are not
  recorded, so a CPU recording has the nodes a recording on the card has
  (the JAX package's ``pallas_call`` special case);
* **collective nodes**: the mesh exchanges the code marks
  (``obs.marks.collective``), with JAX's ``Collective`` fields;
* **lifetimes**: eager torch frees a buffer when its last reference dies,
  not at its last use, so every storage the program touches is followed by
  a ``weakref.finalize``: its birth (the op that made it) and its death
  are memory events in program order (:mod:`.mem` walks them);
* the inputs, the outputs and the storages claimed as written in place
  (the port's donation).

The recorder is a ``torch.utils._python_dispatch.TorchDispatchMode``,
chosen over ``torch.overrides.TorchFunctionMode``: it sees the aten ops
after Python-level calls are decomposed, including the ops the autograd
engine runs for a backward (the mode rides the engine's thread-local
state) and an optimizer's ``torch._foreach_*`` updates, and each op's
schema states which arguments it writes; a function mode sees ``torch.*``
calls only, not the backward, and would need a table of in-place
semantics. Both exist unchanged in torch 2.11 and 2.13. Nothing is
recorded under CUDA-graph capture (a replay runs no op the dispatcher
sees): :func:`record` refuses to start during one.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ...obs import marks

__all__ = [
    "COLLECTIVES",
    "REDUCTIONS",
    "Collective",
    "Node",
    "Program",
    "Value",
    "collectives_of",
    "f64_eqns",
    "iter_consts",
    "kernel_nodes",
    "record",
]

# the port's marked collectives (obs.marks.collective): one reduction and
# the two data movements of parallel/routing.py's exchange
REDUCTIONS = frozenset({"psum"})
COLLECTIVES = REDUCTIONS | frozenset({"all_to_all", "all_gather"})

# ops that make a tensor from host data (``torch.tensor``, ``torch.from_numpy``
# and ``torch.as_tensor`` of an array lift a fresh host tensor)
_HOST_FACTORIES = frozenset({"aten.lift_fresh.default", "aten.lift_fresh_copy.default"})
_COPIES = frozenset({"aten._to_copy.default", "aten.copy_.default", "aten.copy.default"})


@dataclasses.dataclass(frozen=True)
class Value:
    """One tensor as a node saw it; ``storage`` keys ``Program.storages``
    (-1 for none)."""

    shape: tuple
    dtype: str
    device: str
    storage: int
    nbytes: int

    def __str__(self):
        return f"{self.dtype}{list(self.shape)}@{self.device}"


@dataclasses.dataclass(frozen=True)
class Node:
    """One recorded step: an aten op (``kind="op"``), a kernel wrapper call
    (``"kernel"``) or a marked collective (``"collective"``)."""

    kind: str
    name: str
    operands: tuple
    results: tuple
    writes: tuple = ()  # storage keys written in place
    axes: tuple = ()  # collective nodes: the mesh axes
    index: int = 0  # position in Program.nodes


@dataclasses.dataclass
class Storage:
    """One storage the program touched: ``role`` is ``"input"`` (the
    target's inputs), ``"state"`` (alive before the program and not an
    input: parameters, tables) or ``"new"`` (made by the program, its
    birth an ``"alloc"`` event)."""

    key: int
    nbytes: int
    device: str
    role: str


@dataclasses.dataclass
class Program:
    """A recorded run: the ``Built`` counterpart of the JAX package's
    traced jaxpr and lowered text."""

    name: str
    device: str  # the device type it ran on: "cpu" or "cuda"
    nodes: list = dataclasses.field(default_factory=list)
    inputs: tuple = ()
    outputs: tuple = ()
    storages: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)  # ("alloc"|"free", key, node)
    claimed: dict = dataclasses.field(default_factory=dict)  # key -> (ptr before, after)
    meta: dict = dataclasses.field(default_factory=dict)
    fn: object = None  # the recorded callable, to run again on ``args``
    args: tuple = ()  # the inputs it was recorded on
    result: object = None  # what the recorded run returned

    @property
    def kernels(self) -> list:
        return [n for n in self.nodes if n.kind == "kernel"]

    @property
    def ops(self) -> list:
        return [n for n in self.nodes if n.kind == "op"]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One marked comm op of a recorded program, as the rules compare
    them (the JAX package's fields)."""

    prim: str
    axes: tuple
    shape: tuple  # the per-member operand
    dtype: str
    path: tuple = dataclasses.field(default=(), compare=False)

    @property
    def lanes(self) -> int:
        """Leading-two-dims product: the bucket lanes of a routed
        ``all_to_all`` operand shaped ``(F, cap, ...)``."""
        if len(self.shape) >= 2:
            return int(self.shape[0]) * int(self.shape[1])
        return int(self.shape[0]) if self.shape else 1

    def signature(self):
        """Identity used for multiset comparison across programs."""
        return (self.prim, self.axes, self.shape, self.dtype)

    def __str__(self):
        loc = "/".join(self.path) or "top"
        return (f"{self.prim}[{','.join(self.axes)}] "
                f"{self.dtype}{list(self.shape)} @ {loc}")


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _tensors(obj) -> list:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    """Appends every op, kernel call and collective of the calling thread
    to ``program``, and follows the storages they touch."""

    def __init__(self, program: Program):
        super().__init__()
        self.program = program
        self._opaque = 0  # inside a kernel node: its ops are not the program's
        self._live: dict[int, int] = {}  # id(storage) -> key, while alive
        self._finalizers: list = []
        self._closed = False

    # -- storages ----------------------------------------------------------

    def see(self, t, role: str) -> Value:
        """``t``'s :class:`Value`, registering its storage on first sight
        (``role`` then says what it is: a result is ``"new"``, an operand
        first seen ``"state"``)."""
        nbytes = t.numel() * t.element_size()
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return Value(tuple(t.shape), _dtype(t), t.device.type, -1, nbytes)
        p = self.program
        key = self._live.get(id(s))
        if key is None:
            key = len(p.storages)
            self._live[id(s)] = key
            p.storages[key] = Storage(key, int(s.nbytes()), t.device.type, role)
            if role == "new":
                p.events.append(("alloc", key, len(p.nodes)))
            self._finalizers.append(weakref.finalize(s, self._freed, id(s), key))
        else:
            info = p.storages[key]
            info.nbytes = max(info.nbytes, int(s.nbytes()))
        return Value(tuple(t.shape), _dtype(t), t.device.type, key, nbytes)

    def _freed(self, sid: int, key: int) -> None:
        if self._closed:
            return
        p = self.program
        if self._live.get(sid) == key:
            del self._live[sid]
        p.events.append(("free", key, len(p.nodes)))

    def close(self) -> None:
        self._closed = True
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        self._live.clear()

    # -- the three kinds of node ---------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._opaque:
            return out
        name = str(func)
        written = []
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is not None and info.is_write:
                val = args[i] if i < len(args) else kwargs.get(arg.name)
                written += _tensors(val)
        operands = tuple(self.see(t, "state") for t in _tensors((args, kwargs)))
        results = tuple(self.see(t, "new") for t in _tensors(out))
        writes = tuple(sorted({self.see(t, "state").storage for t in written}))
        p = self.program
        p.nodes.append(Node("op", name, operands, results, writes, index=len(p.nodes)))
        return out

    def kernel(self, name: str, fn, args, kwargs):
        """One kernel wrapper call as one node; its inner ops unrecorded."""
        if self._opaque:
            return fn(*args, **kwargs)
        self._opaque += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._opaque -= 1
        operands = tuple(self.see(t, "state") for t in _tensors((args, kwargs)))
        results = tuple(self.see(t, "new") for t in _tensors(out))
        keys = {v.storage for v in operands}
        writes = tuple(sorted({v.storage for v in results if v.storage in keys}))
        p = self.program
        p.nodes.append(Node("kernel", name, operands, results, writes, index=len(p.nodes)))
        return out

    def collective(self, prim: str, axes: tuple, value, shape=None,
                   member: bool = False) -> None:
        if self._opaque:
            return
        full = tuple(value.shape)
        if member:
            operand = tuple(shape) if shape is not None else full
            full = operand
        elif prim in ("all_to_all", "all_gather"):
            operand = full[1:]
        else:
            operand = tuple(shape) if shape is not None else full
        result = operand if prim == "all_to_all" else full
        src = self.see(value, "state")
        elem = value.element_size()
        numel = lambda s: int(torch.Size(s).numel())  # noqa: E731
        p = self.program
        p.nodes.append(Node(
            "collective", prim,
            (Value(operand, _dtype(value), value.device.type, src.storage,
                   numel(operand) * elem),),
            (Value(result, _dtype(value), value.device.type, -1, numel(result) * elem),),
            axes=axes, index=len(p.nodes)))


def record(fn, *inputs, name: str = "program", device=None, donated=(),
           meta=None) -> Program:
    """Run ``fn(*inputs)`` once under a recorder and return its
    :class:`Program`. ``device`` is the device type the accounting prices
    (default: the first input's, else the CPU); ``donated`` the tensors the
    program claims to write in place (their storages and addresses before
    and after are kept in ``claimed``)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a program cannot be recorded under CUDA-graph capture")
    flat_in = _tensors(inputs)
    if device is None:
        device = flat_in[0].device.type if flat_in else "cpu"
    program = Program(name=name, device=torch.device(device).type,
                      meta=dict(meta or {}), fn=fn, args=tuple(inputs))
    rec = _Recorder(program)
    claims = [(t, t.data_ptr()) for t in _tensors(list(donated))]
    previous = marks.set_recorder(rec)
    try:
        with rec:
            program.inputs = tuple(rec.see(t, "input") for t in flat_in)
            claimed = [rec.see(t, "state").storage for t, _ in claims]
            out = fn(*inputs)
            program.outputs = tuple(rec.see(t, "new") for t in _tensors(out))
    finally:
        marks.set_recorder(previous)
        rec.close()
    program.claimed = {key: (ptr, t.data_ptr()) for key, (t, ptr) in zip(claimed, claims)}
    program.result = out
    return program


# -- walks -----------------------------------------------------------------------


def collectives_of(program: Program, include_paths: bool = True) -> list:
    """The ordered marked collectives of a recorded program."""
    out = []
    for n in program.nodes:
        if n.kind == "collective":
            v = n.operands[0]
            path = (f"node{n.index}",) if include_paths else ()
            out.append(Collective(n.name, n.axes, v.shape, v.dtype, path))
    return out


def kernel_nodes(program: Program) -> list:
    """``(entry, operand (shape, dtype) pairs, result pairs)`` of every
    kernel node, in order: what a CPU and a card recording must share."""
    sig = lambda vals: tuple((v.shape, v.dtype) for v in vals)  # noqa: E731
    return [(n.name, sig(n.operands), sig(n.results)) for n in program.kernels]


def iter_consts(program: Program):
    """Yield ``(value, path)`` for every tensor the program builds from
    host data on each run: a factory from a host array (``torch.tensor``,
    ``torch.from_numpy``), and, when the program runs on a card, each copy
    whose source lies on the CPU (a host upload)."""
    for n in program.nodes:
        if n.kind != "op":
            continue
        path = (f"{n.name}#{n.index}",)
        if n.name in _HOST_FACTORIES:
            for v in n.results:
                yield v, path
        elif (n.name in _COPIES and program.device != "cpu"
              and any(v.device == "cpu" for v in n.operands)
              and any(v.device != "cpu" for v in n.results)):
            yield n.results[0], path


def f64_eqns(program: Program) -> list:
    """``(node, value, path)`` wherever a float64/complex128 value is
    produced: the port keeps f32 (and ints) on every path."""
    out = []
    for n in program.nodes:
        for v in n.results:
            if v.dtype in ("float64", "complex128"):
                out.append((n, v, (f"{n.name}#{n.index}",)))
    return out
