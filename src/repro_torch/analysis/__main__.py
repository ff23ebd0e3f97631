"""The port's lint-deep gate: ``python -m repro_torch.analysis``, the twin
of ``python -m repro.analysis``.

Runs the AST lints (RA1xx) over ``src/repro_torch`` and the kernel
registry parity (PA3xx), then, unless ``--skip-graph``, the step audit's
sweep (JA4xx: every combo of ``launch.dryrun.iter_combos()``, reduced
qwen3-0.6b on rank 0 of the 2 x 2 x 2 mesh, each step traced once on
``meta`` tensors) and the graph audit (GA2xx) over the same traces: the
smoke combo's (train_4k/dpsgd/ring) by default, every combo's with
``--all-combos``.  No card, no process group.

  PYTHONPATH=src python -m repro_torch.analysis                  # the gate
  PYTHONPATH=src python -m repro_torch.analysis --all-combos     # GA2xx on all
  PYTHONPATH=src python -m repro_torch.analysis --skip-graph     # AST+parity
  PYTHONPATH=src python -m repro_torch.analysis --update-baseline

Writes ``out/AUDIT_TORCH.json`` (the reference's keys: the findings, the
rule registry and the coverage matrix, one row a combo with the rules run
and their findings; its ``jaxpr`` column holds the step audit, its
``hlo`` column the graph audit) and exits non-zero on any finding the
baseline does not grandfather, on a combo that failed to trace, and with
``--fail-on-stale`` on a stale baseline entry.

Baseline: ``.lint-deep-baseline-torch.json`` at the repo root (a JSON
list of fingerprints), present only while a finding is grandfathered.
Per-line suppression: ``# repro-allow: <rule>``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from repro_torch.analysis import (ALL_RULES, Finding, apply_baseline,
                                  astlint, check_parity, graph_audit,
                                  load_baseline, step_audit, write_baseline)

BASELINE_NAME = ".lint-deep-baseline-torch.json"

#: the combo whose graph audit the default gate reads: the reference's
#: smoke combo (its dry-run CI target)
_GRAPH_COMBO = "train_4k/dpsgd/ring"

_EPILOG = """The reference's --graph-hlo, --devices-per-pod, --wire-dtype and
--expect-donation read a saved HLO text; the port compiles no HLO, so it
has no counterpart of them: its graph audit reads the stand-in's trace of
each combo (launch.meta), which this CLI makes itself."""


def _repo_root() -> str:
    """<root>/src/repro_torch/analysis/__main__.py -> <root>."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis: AST lints, registry "
                    "parity, the step audit and the graph audit over "
                    "traced steps", epilog=_EPILOG)
    ap.add_argument("--root", default=_repo_root(),
                    help="repo root (default: inferred from the package)")
    ap.add_argument("--skip-graph", action="store_true",
                    help="AST + parity only (no trace)")
    ap.add_argument("--all-combos", action="store_true",
                    help="graph-audit EVERY combo's trace instead of the "
                         f"smoke combo's ({_GRAPH_COMBO}); the step audit "
                         "always covers the matrix")
    ap.add_argument("--const-threshold", type=int,
                    default=step_audit.CONST_THRESHOLD_BYTES,
                    help="JA404 closed-constant size threshold in bytes")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the machine-readable audit here "
                         "(default: <root>/out/AUDIT_TORCH.json)")
    ap.add_argument("--baseline", default=None,
                    help=f"fingerprint baseline (default: "
                         f"<root>/{BASELINE_NAME})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="grandfather the current findings (pruning "
                         "stale fingerprints; no findings removes the "
                         "file) and exit 0")
    ap.add_argument("--fail-on-stale", action="store_true",
                    help="fail when the baseline carries fingerprints "
                         "matching no current finding")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    t0 = time.time()
    findings: List[Finding] = []

    findings += astlint.lint_paths(root)
    n_ast = len(findings)
    findings += check_parity(root)
    n_parity = len(findings) - n_ast

    rows = None
    if not args.skip_graph:
        rows = step_audit.audit_combos(
            const_threshold_bytes=args.const_threshold,
            verbose=not args.quiet)
        for _, sa, _ in rows:
            findings += sa.findings
    n_step = len(findings) - n_ast - n_parity

    graph_summary = None
    audited = {}
    for combo, _, ga in rows or ():
        if ga is not None and (args.all_combos or combo == _GRAPH_COMBO):
            audited[combo] = ga
            findings += ga.findings
    if len(audited) == 1:
        graph_summary = next(iter(audited.values())).to_json()
    n_graph = len(findings) - n_ast - n_parity - n_step

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    stale = apply_baseline(findings, load_baseline(baseline_path))
    if args.update_baseline:
        if findings:
            write_baseline(baseline_path, findings)
        elif os.path.exists(baseline_path):
            os.remove(baseline_path)
        print(f"[analysis] baselined {len(findings)} finding(s) "
              f"({len(stale)} stale fingerprint(s) pruned) -> "
              f"{baseline_path if findings else 'no baseline file'}")
        return 0
    failing = [f for f in findings if not f.baselined]
    trace_errors = [(c, sa.error) for c, sa, _ in rows or () if sa.error]

    # the coverage matrix, one row a combo, built after apply_baseline so
    # that its rows carry the baselined flags
    coverage = None
    if rows is not None:
        coverage = []
        for combo, sa, _ in rows:
            row = {"combo": combo,
                   "jaxpr": {"rules": sorted(step_audit.RULES),
                             **sa.to_json()},
                   "hlo": None}
            if combo in audited:
                row["hlo"] = {"rules": sorted(graph_audit.RULES),
                              "error": None, **audited[combo].to_json()}
            coverage.append(row)

    ok = (not failing and not trace_errors
          and not (stale and args.fail_on_stale))
    json_out = args.json_out or os.path.join(root, "out", "AUDIT_TORCH.json")
    payload = {
        "ok": ok,
        "elapsed_s": round(time.time() - t0, 2),
        "counts": {"ast": n_ast, "parity": n_parity, "jaxpr": n_step,
                   "graph": n_graph,
                   "baselined": len(findings) - len(failing)},
        "stale_baseline": stale,
        "compile_errors": [f"{c}: {e}" for c, e in trace_errors],
        "rules": ALL_RULES,
        "findings": [f.to_json() for f in findings],
        "graph": graph_summary,
        "coverage": coverage,
    }
    d = os.path.dirname(json_out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(json_out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)

    for f in findings:
        print(f"[analysis] {f.format()}")
    for fp in stale:
        print(f"[analysis] stale baseline fingerprint: {fp!r} matches "
              "no current finding (prune with --update-baseline)")
    print(f"[analysis] ast={n_ast} parity={n_parity} step={n_step} "
          f"graph={n_graph} ({len(findings) - len(failing)} baselined, "
          f"{len(stale)} stale) in {payload['elapsed_s']}s -> {json_out}")
    if failing:
        print(f"[analysis] FAIL: {len(failing)} finding(s); suppress a "
              "line with `# repro-allow: <rule>` or grandfather with "
              "--update-baseline")
        return 1
    if trace_errors:
        print(f"[analysis] FAIL: {len(trace_errors)} combo(s) failed to "
              "trace — the matrix has unaudited rows")
        return 1
    if stale and args.fail_on_stale:
        print(f"[analysis] FAIL: {len(stale)} stale baseline "
              "fingerprint(s); prune with --update-baseline")
        return 1
    print("[analysis] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
