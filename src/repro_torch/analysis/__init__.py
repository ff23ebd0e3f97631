"""``repro_torch.analysis``: the checks the dry-run stand-in runs over a
traced step (``repro.analysis``'s graph audit; its other passes are to
come).

* :mod:`repro_torch.analysis.graph_audit`: the GA2xx rules over one
  rank's trace (``launch.meta``'s collective records and host reads).
"""
from repro_torch.analysis import graph_audit
from repro_torch.analysis.graph_audit import (RULES, Finding, GraphAudit,
                                              audit_trace)

__all__ = ["graph_audit", "RULES", "Finding", "GraphAudit", "audit_trace"]
