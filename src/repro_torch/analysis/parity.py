"""Kernel registry parity (``repro.analysis.parity``'s PA301–PA305): an
op of the port cannot ship half-wired.

A public op is a top-level function of ``repro_torch/kernels/ops.py``
that reaches a kernel launch (``_launched`` or ``_kernel``), in its own
body or through the module-level helpers it names, resolved as the
reference's ``op_wirings`` resolves them; a name starting with ``_`` or
``launch_`` is no op (``launch_*`` launch a kernel alone, for timing).
The set comes from the AST, so the check needs no import and works on a
planted tree in tests.  Each op needs:

* **PA301** a plain version in ``kernels/ref.py`` that it reaches
  (``ref.<fn>``): its CPU route and what the card's kernel is held to;
* **PA302** a hold in ``chip_smoke.py`` (``ops.<name>`` there).  The
  reference's PA302 asks for a dispatcher entry (``_decide("<op>")``);
  the port has no dispatcher (one route a device: ``ops.py``'s
  docstring), and the script is what holds the card's route, so the twin
  asks for the op there under the reference's code;
* **PA303** a row of ``repro_torch/benchmarks/kernels_bench.py``
  (``ops.<name>`` there), so the bench and its gate
  (``repro_torch.benchmarks.report --gate``) see it;
* **PA304** a test under ``tests/`` that names it.

And one rule over the analysis itself:

* **PA305** every rule id of ``repro_torch.analysis.ALL_RULES`` appears
  in ``tests/test_torch_analysis.py``: a rule no planted violation tests
  can stop firing unseen.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.analysis.base import Finding, iter_py_files

RULES = {
    "PA301": "missing-ref-oracle",
    "PA302": "missing-dispatch-entry",
    "PA303": "missing-bench-row",
    "PA304": "missing-test-reference",
    "PA305": "untested-analysis-rule",
}

ANALYSIS_TESTS = os.path.join("tests", "test_torch_analysis.py")

OPS_PATH = os.path.join("src", "repro_torch", "kernels", "ops.py")
REF_PATH = os.path.join("src", "repro_torch", "kernels", "ref.py")
BENCH_PATH = os.path.join("src", "repro_torch", "benchmarks",
                          "kernels_bench.py")
SMOKE_PATH = "chip_smoke.py"
TESTS_DIR = "tests"

#: the names ops.py imports its plain versions under
_REF_ALIASES = ("_ref", "ref")
#: the helpers through which an op launches a kernel
_LAUNCHERS = ("_launched", "_kernel")


@dataclass
class OpWiring:
    """What one top-level function of ops.py statically reaches."""
    name: str
    lineno: int
    ref_fns: Set[str] = field(default_factory=set)   # ref.<X> reached
    launches: bool = False                           # a launcher reached


def _collect(node: ast.AST, wiring: OpWiring,
             helper_names: Set[str]) -> Set[str]:
    """Scan one definition: record ``ref.X`` loads and a launcher into
    ``wiring``; return the module-level names it uses (for the walk)."""
    used: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.value, ast.Name) and \
                sub.value.id in _REF_ALIASES:
            wiring.ref_fns.add(sub.attr)
        if isinstance(sub, ast.Name):
            if sub.id in _LAUNCHERS:
                wiring.launches = True
            if sub.id in helper_names:
                used.add(sub.id)
    return used


def op_wirings(ops_source: str) -> List[OpWiring]:
    """The public ops of an ops.py source and what each reaches."""
    tree = ast.parse(ops_source)
    defs: Dict[str, ast.AST] = {}
    publics: List[ast.AST] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
            if not node.name.startswith(("_", "launch_")):
                publics.append(node)
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defs[t.id] = node
    out = []
    for fn in publics:
        w = OpWiring(name=fn.name, lineno=fn.lineno)
        seen: Set[str] = {fn.name}
        frontier = [fn]
        while frontier:
            node = frontier.pop()
            for used in _collect(node, w, set(defs)):
                if used not in seen:
                    seen.add(used)
                    frontier.append(defs[used])
        if w.launches:
            out.append(w)
    return out


def _read(path: str) -> Optional[str]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return f.read()


def check_parity(root: str, *, ops_path: str = OPS_PATH,
                 ref_path: str = REF_PATH, bench_path: str = BENCH_PATH,
                 smoke_path: str = SMOKE_PATH,
                 tests_dir: str = TESTS_DIR) -> List[Finding]:
    """Parity findings of the tree at ``root`` (paths relative to it, so
    tests can point this at a planted layout)."""
    findings: List[Finding] = []
    rel = ops_path.replace(os.sep, "/")
    ops_src = _read(os.path.join(root, ops_path))
    if ops_src is None:
        return [Finding(rule="PA301", path=rel, line=0,
                        message=f"ops module {ops_path} not found",
                        source=ops_path)]
    ref_src = _read(os.path.join(root, ref_path)) or ""
    ref_fns = {n.name for n in ast.parse(ref_src).body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    bench_src = _read(os.path.join(root, bench_path)) or ""
    smoke_src = _read(os.path.join(root, smoke_path)) or ""
    test_srcs = [_read(p) or "" for p in iter_py_files(root, (tests_dir,))]

    for w in op_wirings(ops_src):
        if not w.ref_fns & ref_fns:
            missing = ", ".join(sorted(w.ref_fns)) or "none referenced"
            findings.append(Finding(
                rule="PA301", path=rel, line=w.lineno, source=w.name,
                message=f"op `{w.name}` has no plain version in "
                        f"{ref_path} ({missing})"))
        if not re.search(rf"\bops\.{w.name}\b", smoke_src):
            findings.append(Finding(
                rule="PA302", path=rel, line=w.lineno, source=w.name,
                message=f"op `{w.name}` is not held on the card: no "
                        f"`ops.{w.name}` in {smoke_path}"))
        if not re.search(rf"\bops\.{w.name}\b", bench_src):
            findings.append(Finding(
                rule="PA303", path=rel, line=w.lineno, source=w.name,
                message=f"op `{w.name}` has no row in {bench_path} — "
                        "the bench's gate cannot see it regress"))
        pat = re.compile(rf"\b{w.name}\b")
        if not any(pat.search(src) for src in test_srcs):
            findings.append(Finding(
                rule="PA304", path=rel, line=w.lineno, source=w.name,
                message=f"op `{w.name}` is named by no test under "
                        f"{tests_dir}/ — nothing pins its numerics"))
    findings += _check_rule_tests(root)
    return findings


def _check_rule_tests(root: str) -> List[Finding]:
    """PA305: every registered rule id needs a planted-violation test.

    Skipped where ``root`` has no ``tests/test_torch_analysis.py``: a
    planted tree has none, and a partial checkout should not fail on
    it."""
    test_src = _read(os.path.join(root, ANALYSIS_TESTS))
    if test_src is None:
        return []
    # late import: repro_torch.analysis imports this module
    from repro_torch.analysis import ALL_RULES
    rel = ANALYSIS_TESTS.replace(os.sep, "/")
    out: List[Finding] = []
    for rule in sorted(ALL_RULES):
        if not re.search(rf"\b{rule}\b", test_src):
            out.append(Finding(
                rule="PA305", path=rel, line=0, source=rule,
                message=f"rule {rule} ({ALL_RULES[rule]}) appears "
                        f"nowhere in {rel} — a rule with no "
                        "planted-violation test can stop firing unseen"))
    return out
