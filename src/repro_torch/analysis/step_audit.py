"""Dataflow audit of one call of a step (``repro.analysis.jaxpr_audit``'s
JA400–JA405, with the reference's codes and names).

The reference audits the closed jaxpr of a step before XLA lowers it.
The port has no such graph: its counterpart is one call of the step
under a ``TorchDispatchMode`` that sees every aten op, forward and
backward, on ``meta`` tensors through the dry-run stand-in
(``launch.meta.trace_step``, where nothing runs) or on real tensors on
any device (where the step runs as it would).  The mesh's collective
methods are wrapped on the instance for the call, and a train step's
``exchange`` (``launch.steps.make_train_step``) too, so a collective is
seen with its input and knows whether the gossip exchange made it.

Rules (whole-trace findings; the fingerprint baseline suppresses them,
there is no source line to carry ``# repro-allow:``):

* **JA400 step-trace-failure**: a combo's builder or trace raised
  (``audit_combos``): the combo stays in the matrix as an error row.
* **JA401 host-callback-in-step**: a read of a device value on the host.
  On ``meta`` the ops ``launch.meta.CostMode`` raises ``HostSync`` for
  (``_local_scalar_dense``: ``.item()``, ``int()``, ``bool()``; a copy
  off ``meta``: ``.cpu()``, ``.tolist()``), where the trace ends; on a
  card each synchronizing CUDA call that PyTorch's sync debug mode
  reports.  The CPU has no device to wait for.
* **JA402 widen-into-collective**: a transfer collective
  (``all_gather``, ``all_gather_dim``, ``all_to_all``) ships a float
  tensor wider than the float a widening cast (``_to_copy`` to a wider
  float dtype) took its data from: the AD-PSGD bf16 -> float32 wire bug
  the reference's rule was written for.  The mark follows the data
  through views and the ops that move it without arithmetic (``cat``,
  ``index_select``, ``copy_``, ...): arithmetic in the wide dtype (an
  update summed in float32, a float32 leaf's step) makes a value that
  needs the width, and a cast back to the narrow dtype clears the mark
  (the wire operand itself must be a widened copy).  Reductions
  (``all_reduce``, ``reduce_scatter_dim``) sum in float32 by design
  (``steps.make_exchange``) and are not held to the leaves' dtype.
* **JA403 off-pod-axis-collective**: a collective made by a gossip
  strategy's exchange on an axis other than ``pod``: the gossip belongs
  on the links between pods.
* **JA404 large-closed-constant**: a tensor of at least
  ``CONST_THRESHOLD_BYTES`` read by an op that entered the step neither
  through its arguments (the state among them) nor from an op inside it:
  a closure's or a module's tensor, baked into every call.  On ``meta``
  any tensor off ``meta`` counts so too.
* **JA405 rng-key-not-from-args**: a random aten op (one PyTorch tags
  ``nondeterministic_seeded``) whose ``generator`` is missing or is not
  one of the ``torch.Generator`` objects the step received: the trace
  twin of RA101.

``audit_step`` audits one call; ``trace_and_audit`` does it inside the
stand-in's ``launch.meta.trace_step``, so one trace serves the graph
audit (GA2xx) and this one; ``audit_combos`` sweeps
``launch.dryrun.iter_combos()``, one row a combo, always.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import Finding
from repro_torch.launch import meta
from repro_torch.launch.mesh import INTRA, Mesh

RULES = {
    "JA400": "step-trace-failure",
    "JA401": "host-callback-in-step",
    "JA402": "widen-into-collective",
    "JA403": "off-pod-axis-collective",
    "JA404": "large-closed-constant",
    "JA405": "rng-key-not-from-args",
}

#: JA404's threshold: a tensor this large baked into a step is a decision,
#: not an incidental table
CONST_THRESHOLD_BYTES = 1 << 20

#: the ``Mesh`` methods that ship rows (the rest reduce, or synchronise)
TRANSFERS = ("all_gather", "all_gather_dim", "all_to_all")

#: ops that move or copy data without arithmetic (views besides): the
#: widening mark follows the data through these alone, since arithmetic in
#: the wide dtype makes a value that needs the width
_MOVES = {"cat", "stack", "clone", "copy", "copy_", "index_select", "index",
          "gather", "repeat", "_unsafe_view", "_to_copy", "lift_fresh",
          "lift_fresh_copy", "contiguous", "reshape", "flatten", "expand",
          "select_scatter", "slice_scatter", "constant_pad_nd"}

aten = torch.ops.aten


def _walk(tree):
    """Every object under ``tree``: in lists, tuples, dicts and
    dataclasses."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _walk(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _walk(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name))
    else:
        yield tree


@dataclass
class StepAudit:
    """Findings and the summary of one audited call (the reference's
    ``JaxprAudit`` keys: ``n_eqns`` counts aten ops, ``n_rng_prims``
    random ones).  ``output`` is the step's return (None where a host read
    ended a ``meta`` trace, ``host_sync`` naming its op); neither is
    serialised."""
    tag: str
    findings: List[Finding] = field(default_factory=list)
    n_eqns: int = 0
    n_collectives: int = 0
    collective_axes: List[str] = field(default_factory=list)
    max_const_bytes: int = 0
    n_rng_prims: int = 0
    error: Optional[str] = None          # JA400: the trace never ran
    output: object = None
    host_sync: Optional[str] = None      # the op that ended a meta call

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict:
        return {
            "tag": self.tag, "ok": self.ok,
            "n_eqns": self.n_eqns,
            "n_collectives": self.n_collectives,
            "collective_axes": self.collective_axes,
            "max_const_bytes": self.max_const_bytes,
            "n_rng_prims": self.n_rng_prims,
            "error": self.error,
            "findings": [f.to_json() for f in self.findings],
        }


class _AuditMode(TorchDispatchMode):
    """Sees each aten op of the call: the provenance of its inputs
    (JA404), a host read on ``meta`` (JA401), a random op's generator
    (JA405) and the widening mark (JA402)."""

    def __init__(self, rep: StepAudit, arguments, *, on_meta: bool,
                 const_threshold_bytes: int):
        super().__init__()
        self.rep = rep
        self.on_meta = on_meta
        self.threshold = const_threshold_bytes
        args = [t for t in _walk(arguments) if isinstance(t, torch.Tensor)]
        self._args = {meta._storage_key(t) for t in args}
        # a generator by its C++ object: the dispatcher hands the op a new
        # Python wrapper of the one the caller passed
        self._gens = {g._cdata for g in _walk(arguments)
                      if isinstance(g, torch.Generator)}
        self._made: Set[int] = set()       # storages ops inside made
        self._flagged: Set[int] = set()    # JA404 storages reported
        #: storage: [live tensors seen, the narrowest float bytes its
        #: data was widened from (None: not widened)]
        self._live: Dict[int, list] = {}
        self._refs: Dict[int, weakref.ref] = {}

    # ---- the widening mark, a storage's, while a tensor holds it ----
    def widened_from(self, t: torch.Tensor) -> Optional[int]:
        entry = self._live.get(meta._storage_key(t))
        return entry[1] if entry else None

    def _hold(self, t: torch.Tensor, narrow: Optional[int]) -> None:
        key = meta._storage_key(t)
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [0, None]
        if narrow is not None:
            entry[1] = narrow if entry[1] is None else min(entry[1], narrow)
        tid = id(t)
        if tid in self._refs:
            return
        entry[0] += 1
        self._refs[tid] = weakref.ref(t, lambda _, tid=tid, key=key:
                                      self._drop(tid, key))

    def _drop(self, tid: int, key: int) -> None:
        del self._refs[tid]
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._live[key]
            self._made.discard(key)

    def _emit(self, rule: str, message: str, source: str) -> None:
        self.rep.findings.append(Finding(rule=rule, path=self.rep.tag,
                                         line=0, message=message,
                                         source=source))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rep = self.rep
        rep.n_eqns += 1
        ins = meta._flat(args) + meta._flat(kwargs.values())
        name = func.overloadpacket.__name__

        # JA404: a tensor from outside the call
        for t in ins:
            key = meta._storage_key(t)
            outside = key not in self._args and key not in self._made
            if self.on_meta and t.device.type != "meta":
                outside = True
            if not outside:
                continue
            nbytes = t.numel() * t.element_size()
            rep.max_const_bytes = max(rep.max_const_bytes, nbytes)
            if nbytes >= self.threshold and key not in self._flagged:
                self._flagged.add(key)
                dt = str(t.dtype).replace("torch.", "")
                self._emit("JA404",
                           f"{nbytes}-byte tensor ({dt}{list(t.shape)} on "
                           f"{t.device.type}) read by `{name}` enters the "
                           "step neither from its arguments nor from an op "
                           "inside it: a closure's constant, baked into "
                           "every call — make it a step argument",
                           f"const:{dt}{list(t.shape)}@{name}")

        # JA401 on meta: a value the trace does not have
        if self.on_meta and (
                func is aten._local_scalar_dense.default or (
                    func is aten._to_copy.default and torch.device(
                        kwargs.get("device") or "meta").type != "meta")):
            self._emit("JA401",
                       f"host read `{func}` in the step: a device->host "
                       "sync every call that device profiles never show",
                       f"host:{func}")
            raise meta.HostSync(str(func))

        # JA405: a random op's generator
        if torch.Tag.nondeterministic_seeded in func.tags:
            rep.n_rng_prims += 1
            gen = kwargs.get("generator")
            if gen is None or gen._cdata not in self._gens:
                why = "no generator" if gen is None else \
                    "a generator the step did not receive"
                self._emit("JA405",
                           f"random op `{name}` draws with {why}: the "
                           "stream is not a function of the step's "
                           "arguments — pass a keyed `torch.Generator` "
                           "(trace twin of RA101)", f"rng:{name}")

        out = func(*args, **kwargs)

        narrow = None
        if func.is_view or name in _MOVES:
            for t in ins:
                w = self.widened_from(t)
                if w is not None:
                    narrow = w if narrow is None else min(narrow, w)
        if func is aten._to_copy.default and ins and isinstance(
                out, torch.Tensor) and ins[0].dtype.is_floating_point and \
                out.dtype.is_floating_point:
            src_b, dst_b = ins[0].element_size(), out.element_size()
            if dst_b > src_b:
                narrow = src_b if narrow is None else min(narrow, src_b)
            elif narrow is not None and dst_b <= narrow:
                narrow = None               # cast back: the mark clears
        for t in meta._flat(out):
            key = meta._storage_key(t)
            if key in self._args:
                continue
            self._made.add(key)
            self._hold(t, narrow)
        return out


def _names(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


@contextlib.contextmanager
def _watch(mesh, step, mode: _AuditMode, *, gossip: bool):
    """For the block: ``mesh``'s collective methods wrapped on the
    instance (JA402, JA403 and the counts) and ``step.exchange`` marked,
    each restored after."""
    rep = mode.rep
    axes: Set[str] = set()
    in_exchange = [0]
    saved: Dict[str, object] = {}

    def wrap(kind, fn):
        sig = inspect.signature(getattr(Mesh, kind))

        def call(*args, **kw):
            a = sig.bind(mesh, *args, **kw)
            a.apply_defaults()
            axis = a.arguments.get("axis",
                                   INTRA if kind == "barrier" else "pod")
            x = a.arguments.get("x")
            rep.n_collectives += 1
            axes.update(_names(axis))
            site = f"{kind}@{'+'.join(_names(axis))}"
            if gossip and in_exchange[0] and _names(axis) != ("pod",):
                mode._emit("JA403",
                           f"collective `{kind}` of the gossip exchange "
                           f"runs over {axis!r}, not the 'pod' axis: the "
                           "exchange belongs on the links between pods",
                           site)
            if kind in TRANSFERS and isinstance(x, torch.Tensor) and \
                    x.dtype.is_floating_point:
                narrow = mode.widened_from(x)
                if narrow is not None and x.element_size() > narrow:
                    dt = str(x.dtype).replace("torch.", "")
                    mode._emit("JA402",
                               f"collective `{kind}` ships {dt}"
                               f"{list(x.shape)} widened by a cast from "
                               f"{narrow} byte(s) an element: the payload "
                               "widened on the wire", site)
            return fn(*args, **kw)
        return call

    if mesh is not None:
        for kind in meta.KINDS:
            saved[kind] = mesh.__dict__.get(kind)
            setattr(mesh, kind, wrap(kind, getattr(mesh, kind)))
    exchange = getattr(step, "exchange", None)
    if exchange is not None:
        def marked(*args, **kw):
            in_exchange[0] += 1
            try:
                return exchange(*args, **kw)
            finally:
                in_exchange[0] -= 1
        step.exchange = marked
    try:
        yield
    finally:
        if exchange is not None:
            step.exchange = exchange
        for kind, fn in saved.items():
            if fn is None:
                delattr(mesh, kind)
            else:
                setattr(mesh, kind, fn)
        rep.collective_axes = sorted(axes)


#: the text of PyTorch's sync debug-mode warning
SYNC_WARNING = "called a synchronizing"


@contextlib.contextmanager
def host_syncs():
    """For the block: PyTorch's CUDA sync debug mode at "warn", and the
    message of each synchronizing call it reports appended to the list
    this yields (after the block).  The warnings are recorded whatever
    the caller's filters, and the caller's mode is restored after."""
    syncs: List[str] = []
    prior = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode(prior)
            syncs += [str(w.message) for w in caught
                      if SYNC_WARNING in str(w.message)]


def _on_meta(args) -> bool:
    return any(t.device.type == "meta" for t in _walk(args)
               if isinstance(t, torch.Tensor))


def audit_step(step, args: Sequence, kwargs: Optional[Dict] = None, *,
               mesh=None, gossip: bool = False, tag: str = "<step>",
               const_threshold_bytes: int = CONST_THRESHOLD_BYTES
               ) -> StepAudit:
    """Call ``step(*args, **kwargs)`` once under the audit and return its
    findings, the step's return in ``.output``.

    ``mesh``: the mesh whose collectives the step calls (its methods are
    wrapped for the call).  ``gossip``: the step's strategy gossips, so
    its exchange's collectives are held to the ``pod`` axis (JA403).  On
    ``meta`` a host read ends the call (JA401, the output None); on a
    card the sync debug mode reports each synchronizing call the step
    makes (JA401)."""
    kwargs = kwargs or {}
    rep = StepAudit(tag=tag)
    on_meta = _on_meta((args, kwargs))
    mode = _AuditMode(rep, (args, kwargs), on_meta=on_meta,
                      const_threshold_bytes=const_threshold_bytes)
    cuda = not on_meta and torch.cuda.is_available() and any(
        t.device.type == "cuda" for t in _walk((args, kwargs))
        if isinstance(t, torch.Tensor))
    syncs: List[str] = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(_watch(mesh, step, mode, gossip=gossip))
        if cuda:
            syncs = stack.enter_context(host_syncs())
        try:
            with mode:
                rep.output = step(*args, **kwargs)
        except meta.HostSync as e:
            rep.output, rep.host_sync = None, e.op
    for msg in syncs:
        rep.findings.append(Finding(
            rule="JA401", path=tag, line=0,
            message=f"host sync in the step: {msg}",
            source=f"sync:{msg.split(':')[0]}"))
    return rep


def trace_and_audit(step, args: Sequence, mesh, *,
                    wire_groups: Optional[Dict[str, int]] = None,
                    gossip: bool = False, tag: str = "<trace>",
                    const_threshold_bytes: int = CONST_THRESHOLD_BYTES
                    ) -> Tuple[object, StepAudit]:
    """``launch.meta.trace_step`` with the audit inside it: one call of
    ``step`` on ``meta`` tensors gives the stand-in's ``Trace`` (for the
    graph audit and the dry-run's report) and this audit's findings."""
    got: List[StepAudit] = []

    def audited(*a):
        rep = audit_step(step, a, mesh=mesh, gossip=gossip, tag=tag,
                         const_threshold_bytes=const_threshold_bytes)
        got.append(rep)
        if rep.host_sync is not None:
            raise meta.HostSync(rep.host_sync)
        return rep.output

    trace = meta.trace_step(audited, args, mesh, wire_groups=wire_groups)
    return trace, got[0]


# ------------------------------------------------------------ the sweep

def combo_name(shape_name: str, strategy: Optional[str],
               topology: Optional[str]) -> str:
    return f"{shape_name}/{strategy or '-'}/{topology or '-'}"


def audit_combos(*, combos: Optional[Sequence[Tuple]] = None,
                 const_threshold_bytes: int = CONST_THRESHOLD_BYTES,
                 verbose: bool = False) -> List[Tuple]:
    """Trace and audit the step of every combo of the matrix (``combos``,
    by default ``launch.dryrun.iter_combos()``: every strategy x topology
    of the train step, then prefill and decode) for the reduced
    ``SWEEP_ARCH`` on rank 0 of ``SWEEP_MESH``, through
    ``dryrun.build_step``, as the stand-in's ``--all-combos`` does.

    Returns ``[(combo, StepAudit, GraphAudit or None)]``, each combo
    traced and audited by ``dryrun.trace_combo``, the code the stand-in's
    ``dryrun_one`` runs: one row a combo, always.  A combo whose builder
    or trace raises gets a JA400 finding (and no graph audit) instead of
    vanishing from the matrix."""
    from repro_torch.launch import dryrun
    arch, mesh_spec = dryrun.SWEEP_ARCH, dryrun.SWEEP_MESH
    out: List[Tuple] = []
    for shape_name, strategy, topology in (combos if combos is not None
                                           else dryrun.iter_combos()):
        combo = combo_name(shape_name, strategy, topology)
        tag = f"step:{arch}/{combo}@{mesh_spec}"
        ga = None
        try:
            _, _, rep, ga = dryrun.trace_combo(
                arch, shape_name, dryrun._parse_mesh(mesh_spec),
                strategy=strategy, topology=topology, tag=tag, combo=combo,
                const_threshold_bytes=const_threshold_bytes, reduced=True)
        except Exception as e:  # repro-allow: RA104 — the sweep: a broken
            #                     builder becomes a JA400 row, not the end
            #                     of the remaining combos
            rep = StepAudit(tag=tag, error=f"{type(e).__name__}: {e}")
            rep.findings.append(Finding(
                rule="JA400", path=tag, line=0,
                message=f"step trace failed: {type(e).__name__}: {e} — "
                        "this combo is unaudited until the builder is "
                        "fixed", source=f"trace:{combo}"))
        if verbose:
            state = ("FAIL" if rep.error else
                     f"{len(rep.findings)} finding(s)" if rep.findings
                     else "ok")
            print(f"[step-audit] {combo}: {state} ({rep.n_eqns} ops, "
                  f"{rep.n_collectives} collectives)", flush=True)
        out.append((combo, rep, ga))
    return out
