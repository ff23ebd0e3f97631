"""One rank's step on ``meta`` tensors: the recording mesh and the cost
counter behind the dry-run stand-in (``launch.dryrun``).

Nothing here allocates memory on a device, runs a collective or needs a
card.  A step built by ``launch.steps`` on a ``MetaMesh`` and ``meta``
inputs traces as the rank would run it: every collective goes through
one of the mesh's methods (``collectives.py``, ``steps.py`` and
``models/*`` call nothing else), which records it and returns a ``meta``
tensor of the real method's output shape; every aten op goes through a
``CostMode``, which counts its flops, its bytes and the step's live
storage; every kernel op takes its meta route (``kernels/ops.py``),
which hands the counter the kernel's own flops and bytes.

- ``Collective``: one record, in call order: the method (``kind``), its
  ``axis``, the input's ``shape`` and ``dtype``, and ``wire_bytes``, the
  bytes the rank receives over the wire under the ring algorithms
  (``wire_bytes``).
- ``MetaMesh``: a production layout and this rank's coordinates.
- ``record_collectives(mesh)``: the same records from a real mesh
  inside a ``with`` block, its collectives run as they were, for holding
  the stand-in against a run.
- ``CostMode``: flops, bytes, peak live bytes and kernel launches.
- ``HostSync``: what a step's host read (``.item()``, ``.cpu()``,
  ``.tolist()``) raises under ``CostMode``: a meta tensor has no value to
  read, and a read on the card is a sync every step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.launch.mesh import AXES, INTRA, Axis, Mesh, n_pods

aten = torch.ops.aten

#: the collective methods of ``Mesh`` that a record names
KINDS = ("all_reduce", "all_gather_dim", "reduce_scatter_dim", "all_gather",
         "gather", "all_to_all", "barrier")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call of a rank, as ``Mesh``'s method took it."""
    kind: str
    axis: Axis
    shape: Tuple[int, ...]
    dtype: str
    wire_bytes: int

    def key(self) -> Tuple:
        """What two runs of one step must agree on: kind, axis, shape and
        dtype."""
        return (self.kind, self.axis, self.shape, self.dtype)


def _axis_index(mesh: Mesh, axis: Axis) -> int:
    """This rank's index along ``axis`` (row-major over its names)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    i = 0
    for a in names:
        i = i * mesh.shape.get(a, 1) + mesh.coords.get(a, 0)
    return i


def wire_bytes(mesh: Mesh, kind: str, axis: Axis, x: Optional[torch.Tensor],
               out_splits: Optional[Sequence[int]] = None) -> int:
    """The bytes a rank receives for one collective over the ``n`` ranks
    along ``axis``, under the ring algorithms: an all-reduce 2 (n - 1) /
    n of ``x``, an all-gather the n - 1 other blocks, a reduce-scatter
    (n - 1) / n of ``x``, an all-to-all the rows the other ranks send
    (``out_splits`` but its own), a gather the n - 1 other blocks on the
    group's first rank; a barrier none."""
    if x is None or kind == "barrier":
        return 0
    n = mesh.size_of(axis)
    nbytes = x.numel() * x.element_size()
    if kind == "all_reduce":
        return 2 * (n - 1) * nbytes // n
    if kind in ("all_gather_dim", "all_gather"):
        return (n - 1) * nbytes
    if kind == "reduce_scatter_dim":
        return (n - 1) * nbytes // n
    if kind == "gather":
        return (n - 1) * nbytes if _axis_index(mesh, axis) == 0 else 0
    row = nbytes // max(x.shape[0], 1)
    return (sum(out_splits) - out_splits[_axis_index(mesh, axis)]) * row


def _record(mesh: Mesh, kind: str, axis: Axis, x: Optional[torch.Tensor],
            out_splits=None) -> Collective:
    return Collective(kind, axis, () if x is None else tuple(x.shape),
                      "" if x is None else str(x.dtype).replace("torch.", ""),
                      wire_bytes(mesh, kind, axis, x, out_splits))


class MetaMesh(Mesh):
    """A mesh that runs no collective: a layout of ``shape`` over
    ``axis_names`` (the reference's production meshes, or any other) and
    this rank's ``coords``, on ``meta``.  Each collective method appends
    a ``Collective`` to ``records`` and returns a ``meta`` tensor of the
    real method's output (shape, dtype and strides), keeping ``Mesh``'s
    shortcut for an axis of one rank exactly (that call records nothing);
    ``collectives.py``'s autograd functions then record the backward's
    collectives too.  ``name`` is the mesh's label in a report (its shape
    joined by ``x`` by default)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES,
                 *, coords: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        super().__init__(shape, axis_names, coords=coords, device="meta")
        self.name = name or "x".join(str(n) for n in shape)
        self.records: List[Collective] = []

    def all_reduce(self, x, axis: Axis = "pod", op=dist.ReduceOp.SUM):
        if _skips(self, "all_reduce", axis):
            return x
        self.records.append(_record(self, "all_reduce", axis, x))
        return x

    def all_gather_dim(self, x, dim: int, axis: Axis):
        if _skips(self, "all_gather_dim", axis):
            return x
        n = self.size_of(axis)
        self.records.append(_record(self, "all_gather_dim", axis, x))
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
            dim, dim + 1)

    def reduce_scatter_dim(self, x, dim: int, axis: Axis):
        if _skips(self, "reduce_scatter_dim", axis):
            return x
        n = self.size_of(axis)
        self.records.append(_record(self, "reduce_scatter_dim", axis, x))
        blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(
            dim, 0).contiguous()
        return blocks.new_empty(blocks.shape[1:])

    def all_gather(self, x):
        self.records.append(_record(self, "all_gather", "pod", x))
        return x.new_empty((n_pods(self) * x.shape[0],) + tuple(x.shape[1:]))

    def gather(self, x):
        self.records.append(_record(self, "gather", "pod", x))
        if self.pod_rank:
            return None
        return x.new_empty((n_pods(self) * x.shape[0],) + tuple(x.shape[1:]))

    def all_to_all(self, x, in_splits, out_splits, axis: Axis = "pod"):
        self.records.append(_record(self, "all_to_all", axis, x, out_splits))
        return x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))

    def barrier(self) -> None:
        self.records.append(_record(self, "barrier", INTRA, None))


def _skips(mesh: Mesh, kind: str, axis: Axis) -> bool:
    """``Mesh``'s shortcut: a collective along an axis of one rank sends
    nothing and returns its input (the pod axis's ``all_reduce``
    excepted)."""
    if kind == "all_reduce":
        return axis != "pod" and mesh.size_of(axis) == 1
    return kind in ("all_gather_dim", "reduce_scatter_dim") and \
        mesh.size_of(axis) == 1


@contextlib.contextmanager
def record_collectives(mesh: Mesh) -> Iterator[List[Collective]]:
    """Inside the block, ``mesh``'s collective methods (wrapped on the
    instance) append each call's ``Collective`` to the list yielded, then
    run as they did; a barrier is one record (its inner all-reduces are
    not).  The records of a real run, to hold against a ``MetaMesh``'s.
    The methods are the class's again after the block."""
    out: List[Collective] = []
    inside = [0]

    def wrap(kind, fn):
        sig = inspect.signature(getattr(Mesh, kind))

        def call(*args, **kw):
            a = sig.bind(mesh, *args, **kw)
            a.apply_defaults()
            axis = a.arguments.get("axis",
                                   INTRA if kind == "barrier" else "pod")
            if inside[0] or _skips(mesh, kind, axis):
                return fn(*args, **kw)
            out.append(_record(mesh, kind, axis, a.arguments.get("x"),
                               a.arguments.get("out_splits")))
            inside[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                inside[0] -= 1
        return call

    for kind in KINDS:
        setattr(mesh, kind, wrap(kind, getattr(mesh, kind)))
    try:
        yield out
    finally:
        for kind in KINDS:
            delattr(mesh, kind)


# ---------------------------------------------------------------------------
# The cost counter
# ---------------------------------------------------------------------------

class HostSync(RuntimeError):
    """A host read of a device value inside a traced step: ``op`` is the
    aten op that would read it (``_local_scalar_dense`` for ``.item()``,
    ``int()``, ``bool()``; ``_to_copy`` to the CPU for ``.cpu()`` and
    ``.tolist()``)."""

    def __init__(self, op: str):
        super().__init__(f"host sync in the step: {op}")
        self.op = op


#: ops that move no bytes: storage made and not written, or a view of one
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default,
               aten.lift_fresh.default}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors under ``tree``: in lists, tuples, dicts and
    dataclasses, in order."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return out


def block_bytes(tree) -> int:
    """Bytes of the tensors under ``tree`` as blocks (numel times element
    size each): what a rank holds where each is its own allocation."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


class CostMode(TorchDispatchMode):
    """Counts one traced step on ``meta`` tensors, op by op:

    - ``flops``: each aten op's flops by the formulas
      ``torch.utils.flop_counter`` registers (matmuls, convolutions,
      attention), plus the kernel launches' (``kernels``);
    - ``bytes``: each aten op's distinct tensor inputs plus outputs, the
      ops that make storage without writing it and views left out, plus
      the kernel launches' bytes.  Every op's traffic counted on its own
      is unfused traffic: an upper bound on what the card moves, where a
      fused kernel keeps an intermediate in registers (the reference's
      bytes are XLA's, after fusion);
    - ``peak_bytes``: the most bytes of storage made inside the step and
      alive at once (a storage lives while a tensor that views it does;
      ``arguments``, the tensors the caller holds, are left out);
    - ``kernels``: ``{name: {"launches", "flops", "bytes"}}``, one entry
      a launch the kernel ops' meta routes stand for (``ops.meta_sinks``,
      this thread's);
    - a host read raises ``HostSync`` naming the op: the trace cannot go
      on past a value it does not have."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak_bytes = 0
        self._args = {_storage_key(t) for t in tensors_of(arguments)}
        self._held: Dict[int, List[int]] = {}    # storage: [tensors, bytes]
        self._refs: Dict[int, weakref.ref] = {}  # tensor id: its weakref

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        """One launch of the kernel ``name``: an ``ops.meta_sinks``
        entry."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.flops += flops
        self.bytes += n_bytes

    def __enter__(self):
        ops.meta_sinks().append(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.meta_sinks().remove(self.kernel)
        return super().__exit__(*exc)

    def _hold(self, t: torch.Tensor) -> None:
        tid = id(t)
        if tid in self._refs:
            return
        key = _storage_key(t)
        if key in self._args:
            return
        held = self._held.get(key)
        if held is None:
            held = self._held[key] = [0, t.untyped_storage().nbytes()]
            self.live += held[1]
            if self.live > self.peak_bytes:
                self.peak_bytes = self.live
        held[0] += 1
        self._refs[tid] = weakref.ref(t, lambda _, tid=tid, key=key:
                                      self._drop(tid, key))

    def _drop(self, tid: int, key: int) -> None:
        del self._refs[tid]
        held = self._held[key]
        held[0] -= 1
        if held[0] == 0:
            self.live -= held[1]
            del self._held[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten._local_scalar_dense.default or (
                func is aten._to_copy.default
                and torch.device(kwargs.get("device") or "meta").type
                != "meta"):
            raise HostSync(str(func))
        out = func(*args, **kwargs)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        outs = _flat(out)
        if not func.is_view and func not in _NO_TRAFFIC:
            moved = {id(t): t for t in _flat(args) + _flat(kwargs.values())
                     + outs}
            self.bytes += sum(t.numel() * t.element_size()
                              for t in moved.values())
        for t in outs:
            self._hold(t)
        return out


def _flat(xs) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs: a tensor, or a
    sequence of tensors and sequences of them."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    out = []
    for x in xs if isinstance(xs, (list, tuple, type({}.values()))) else ():
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def totals(records: Sequence[Collective]) -> Dict[str, float]:
    """Wire bytes by kind, then by kind and axis (``"all_reduce@pod"``)."""
    out: Dict[str, float] = {}
    for r in records:
        ax = "+".join(r.axis) if isinstance(r.axis, tuple) else r.axis
        out[r.kind] = out.get(r.kind, 0) + r.wire_bytes
        out[f"{r.kind}@{ax}"] = out.get(f"{r.kind}@{ax}", 0) + r.wire_bytes
    return out


# ---------------------------------------------------------------------------
# One traced step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What tracing one rank's step recorded (``trace_step``): its
    ``collectives`` in call order, the mesh's ``axes`` and ``pods``, the
    ``host_syncs`` it attempted (the op that raised; the trace ends
    there), ``wire_groups`` (a leaf dtype's name: the width of one pod's
    row of that dtype group, what the gossip ships of it), the ``cost``
    counter, ``n_args`` (the argument tensors) and the step's ``output``
    (None where a host sync ended the trace)."""
    collectives: List[Collective]
    axes: Tuple[str, ...]
    pods: int
    host_syncs: List[str]
    wire_groups: Dict[str, int]
    cost: CostMode
    n_args: int
    output: object = None


def trace_step(step, args: Sequence, mesh: MetaMesh, *,
               wire_groups: Optional[Dict[str, int]] = None) -> Trace:
    """Run ``step(*args)`` once on ``meta`` tensors under a ``CostMode``
    whose arguments are ``args``, with ``mesh``'s records emptied first.
    A ``HostSync`` ends the trace and is recorded, not raised."""
    mesh.records.clear()
    cost = CostMode(arguments=args)
    syncs: List[str] = []
    out = None
    try:
        with cost:
            out = step(*args)
    except HostSync as e:
        syncs.append(e.op)
    return Trace(list(mesh.records), tuple(mesh.axis_names), n_pods(mesh),
                 syncs, dict(wire_groups or {}), cost,
                 len(tensors_of(args)), out)
