"""Graph audit of one rank's traced step (``repro.analysis.graph_audit``).

The reference audits the partitioned HLO of a compiled step; the port has
no compiled graph, so the audit reads what the dry-run stand-in records
while it traces one rank's step on ``meta`` tensors (``launch.meta.Trace``):
every collective in call order (``Mesh``'s method, axis, shape, dtype and
wire bytes), every host read the step attempted, and the train state's
dtype groups, whose rows the gossip exchange ships.

Rules (the reference's codes and names):

* **GA201 off-pod-axis**: on a gossip strategy, traffic across pods other
  than the exchange (the pod-axis ``all_gather`` of D-PSGD, the pod-axis
  ``all_to_all`` of AD-PSGD) and the step's 0-d metrics (the loss's
  one-element ``all_reduce``): the gossip leaking into reductions, or a
  collective that joins ranks of more than one pod off the ``pod`` axis.
* **GA202 wire-dtype-widening**: a cross-pod exchange row whose dtype is
  wider than the dtype of the leaves' group it carries (a bf16 group
  shipped as float32).
* **GA203 host-callback**: a host read inside the step (``.item()``,
  ``.cpu()``, ``.tolist()``: ``launch.meta.HostSync``), a sync every
  step that no device profile shows.
* **GA204 donation-drift**: never fires.  The reference donates the train
  state and the decode cache to the compiled step, and the rule catches a
  lost alias map; the port's steps return a new state (the train step
  writes none of the old one), so there is no alias to lose.  The code
  stays listed so that a report has the reference's rules.
* **GA205 unclassified-collective**: a collective the record cannot
  attribute to the exchange or to a pod: a ``gather`` or ``barrier``
  (checkpoint plumbing) inside a step, or an axis that is not the mesh's.

``audit_trace`` returns the findings (``analysis.base.Finding``, the
record every pass shares) and a summary whose ``to_json()`` has the
reference's keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis.base import Finding

RULES = {
    "GA201": "off-pod-axis",
    "GA202": "wire-dtype-widening",
    "GA203": "host-callback",
    "GA204": "donation-drift",
    "GA205": "unclassified-collective",
}

_FLOAT_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1}

#: the transfers (the reference's collective-permutes), by ``Mesh``
#: method; the other records are reductions
_TRANSFERS = ("all_gather", "all_to_all", "all_gather_dim")


@dataclass
class PodExchange:
    """Where the trace's collective traffic flows (the reference's
    ``hlo.PodExchange``): wire bytes a rank, transfers and reductions
    across pods and inside one."""
    devices_per_pod: int
    permute_cross_bytes: float = 0.0
    permute_local_bytes: float = 0.0
    reduce_cross_bytes: float = 0.0
    reduce_local_bytes: float = 0.0
    pod_axis_only: bool = True
    unparsed: int = 0

    @property
    def cross_pod_bytes(self) -> float:
        return self.permute_cross_bytes + self.reduce_cross_bytes


@dataclass
class GraphAudit:
    """Findings and the summary of one trace."""
    tag: str
    combo: Optional[str] = None
    findings: List[Finding] = field(default_factory=list)
    pod_exchange: Optional[PodExchange] = None
    expected_wire_dtype: Optional[str] = None
    cross_pod_dtype_bytes: Dict[str, float] = field(default_factory=dict)
    host_callbacks: List[str] = field(default_factory=list)
    donated_pairs: int = 0
    n_params: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict:
        pex = None
        if self.pod_exchange is not None:
            p = self.pod_exchange
            pex = {
                "devices_per_pod": p.devices_per_pod,
                "permute_cross_bytes": p.permute_cross_bytes,
                "permute_local_bytes": p.permute_local_bytes,
                "reduce_cross_bytes": p.reduce_cross_bytes,
                "reduce_local_bytes": p.reduce_local_bytes,
                "pod_axis_only": p.pod_axis_only,
                "unparsed": p.unparsed,
            }
        return {
            "tag": self.tag, "combo": self.combo, "ok": self.ok,
            "pod_exchange": pex,
            "expected_wire_dtype": self.expected_wire_dtype,
            "cross_pod_dtype_bytes": self.cross_pod_dtype_bytes,
            "host_callbacks": self.host_callbacks,
            "donated_pairs": self.donated_pairs,
            "n_params": self.n_params,
            "findings": [f.to_json() for f in self.findings],
        }


def _names(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _crosses(record, axis) -> bool:
    return "pod" in _names(axis) and record.pods > 1


def _known(record, axis) -> bool:
    return set(_names(axis)) <= set(record.axes)


def pod_exchange_report(record, devices_per_pod: int) -> PodExchange:
    """Classify every collective of ``record`` (a ``launch.meta.Trace``)
    by whether it joins ranks of more than one pod: ``permute_*`` the
    transfers (``all_gather``, ``all_to_all``, ``all_gather_dim``),
    ``reduce_*`` the reductions (``all_reduce``, ``reduce_scatter_dim``);
    ``*_cross`` across pods, ``*_local`` inside one.  ``pod_axis_only``:
    every collective across pods is on the ``pod`` axis alone, so it
    keeps the rank's (data, model) coordinate.  ``unparsed``: ``gather``
    and ``barrier`` records, and records on an axis not the mesh's."""
    rep = PodExchange(devices_per_pod=devices_per_pod)
    for c in record.collectives:
        if c.kind in ("gather", "barrier") or not _known(record, c.axis):
            rep.unparsed += 1
            continue
        cross = _crosses(record, c.axis)
        if cross and _names(c.axis) != ("pod",):
            rep.pod_axis_only = False
        if c.kind in _TRANSFERS:
            if cross:
                rep.permute_cross_bytes += c.wire_bytes
            else:
                rep.permute_local_bytes += c.wire_bytes
        elif cross:
            rep.reduce_cross_bytes += c.wire_bytes
        else:
            rep.reduce_local_bytes += c.wire_bytes
    return rep


def infer_wire_dtype(record) -> Optional[str]:
    """The narrowest floating dtype of the train state's leaf groups: the
    widest thing the gossip should ship where a row's group is unknown."""
    best = None
    for dt in record.wire_groups:
        if dt in _FLOAT_BYTES and (best is None
                                   or _FLOAT_BYTES[dt] < _FLOAT_BYTES[best]):
            best = dt
    return best


def audit_trace(record, *, tag: str = "<trace>",
                combo: Optional[str] = None,
                devices_per_pod: Optional[int] = None,
                check_wire_dtype: bool = True,
                check_pod_axis: bool = True,
                expect_donation: bool = False) -> GraphAudit:
    """Audit one rank's trace ``record`` (``launch.meta.Trace``).

    ``combo`` labels the sweep row (``shape/strategy/topology``).
    ``devices_per_pod`` enables the pod-axis report and GA205 (the
    multi-pod train step); ``check_pod_axis`` GA201 (the gossip
    strategies); ``check_wire_dtype`` GA202 over the cross-pod transfers.
    ``expect_donation`` is kept for the reference's signature: GA204
    never fires (module docstring)."""
    rep = GraphAudit(tag=tag, combo=combo, n_params=record.n_args)

    def emit(rule: str, message: str, source: str) -> None:
        rep.findings.append(Finding(rule=rule, path=tag, line=0,
                                    message=message, source=source))

    if devices_per_pod is not None:
        pex = pod_exchange_report(record, devices_per_pod)
        rep.pod_exchange = pex
        if check_pod_axis:
            if not pex.pod_axis_only:
                emit("GA201", "a collective joins ranks of more than one "
                     "pod off the pod axis: the gossip is leaking off it",
                     "pod_axis_only")
            for i, c in enumerate(record.collectives):
                if not _crosses(record, c.axis) or c.kind in (
                        "all_gather", "all_to_all"):
                    continue
                if c.kind == "all_reduce" and math.prod(c.shape) <= 1:
                    continue                        # the step's 0-d metrics
                if c.kind in ("gather", "barrier"):
                    continue                        # GA205's
                emit("GA201", f"cross-pod `{c.kind}` of {c.shape} "
                     f"{c.dtype} ({c.wire_bytes} bytes) beside the gossip "
                     "exchange: the gossip is leaking into reduction "
                     "collectives", f"collective:{i}")
        if pex.unparsed:
            emit("GA205", f"{pex.unparsed} collective(s) the pod report "
                 "cannot attribute (a gather or barrier inside the step, or "
                 "an axis not the mesh's): cross-pod bytes would understate "
                 "the exchange", "unparsed")

    expected = infer_wire_dtype(record)
    rep.expected_wire_dtype = expected if check_wire_dtype else None
    if check_wire_dtype:
        by_width = {n: dt for dt, n in record.wire_groups.items()}
        for i, c in enumerate(record.collectives):
            if c.kind not in ("all_gather", "all_to_all") or not _crosses(
                    record, c.axis):
                continue
            rep.cross_pod_dtype_bytes[c.dtype] = \
                rep.cross_pod_dtype_bytes.get(c.dtype, 0.0) + c.wire_bytes
            want = by_width.get(math.prod(c.shape[1:]), expected)
            if (c.dtype in _FLOAT_BYTES and want in _FLOAT_BYTES
                    and _FLOAT_BYTES[c.dtype] > _FLOAT_BYTES[want]):
                emit("GA202", f"cross-pod `{c.kind}` ships {c.dtype} rows of "
                     f"a {want} leaf group: the payload widened on the wire "
                     f"({c.wire_bytes} bytes/step)", f"collective:{i}")

    for op in record.host_syncs:
        rep.host_callbacks.append(op)
        emit("GA203", f"host read `{op}` in the step: a device->host sync "
             "every step that device profiles never show", op)
    return rep
