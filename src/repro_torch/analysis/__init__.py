"""``repro_torch.analysis``: the port's static and trace analysis, the twin
of ``repro.analysis``.  Four passes, one CLI (``python -m
repro_torch.analysis``):

* :mod:`repro_torch.analysis.astlint`: AST lints over ``src/repro_torch``
  (RA1xx): unkeyed randomness, host reads in a step, a compile or kernel
  build in a loop, broad excepts.
* :mod:`repro_torch.analysis.parity`: kernel registry parity (PA3xx):
  every public op of ``kernels/ops.py`` has its plain version, its hold
  in ``chip_smoke.py``, its bench row and a test.
* :mod:`repro_torch.analysis.graph_audit`: the GA2xx rules over one
  rank's trace (``launch.meta``'s collective records and host reads).
* :mod:`repro_torch.analysis.step_audit`: the dataflow audit (JA4xx) of
  one call of a step under a dispatch mode: host reads, widened payloads
  on the wire, the gossip off the pod axis, large closed-over tensors,
  draws from no generator the step received.

Findings share one record (:class:`repro_torch.analysis.base.Finding`),
are suppressible per line (``# repro-allow: <rule>``) and grandfathered
by a baseline file (:mod:`repro_torch.analysis.base`).
"""
from repro_torch.analysis import (astlint, graph_audit, parity,  # noqa: F401
                                  step_audit)
from repro_torch.analysis.astlint import lint_file, lint_paths
from repro_torch.analysis.base import (Finding, apply_baseline,
                                       load_baseline, write_baseline)
from repro_torch.analysis.graph_audit import GraphAudit, audit_trace
from repro_torch.analysis.parity import check_parity
from repro_torch.analysis.step_audit import (StepAudit, audit_combos,
                                             audit_step, trace_and_audit)

#: the graph audit's rules, under the name the dry-run stand-in reads
RULES = graph_audit.RULES

#: every rule id -> short name, across the four passes
ALL_RULES = {**astlint.RULES, **parity.RULES, **graph_audit.RULES,
             **step_audit.RULES}

__all__ = ["Finding", "apply_baseline", "load_baseline", "write_baseline",
           "lint_file", "lint_paths", "check_parity", "GraphAudit",
           "audit_trace", "StepAudit", "audit_step", "trace_and_audit",
           "audit_combos", "ALL_RULES", "RULES", "graph_audit"]
