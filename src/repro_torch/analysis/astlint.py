"""AST lints over the port (``repro.analysis.astlint``'s RA100–RA104,
with the reference's codes and names, read for PyTorch).

Rules (ids are stable; suppress a line with ``# repro-allow: <id>``):

* **RA100 syntax-error**: the file does not parse.
* **RA101 unkeyed-randomness**: a draw from ambient state.  NumPy's
  global draws as the reference flags them (``np.random.<fn>()``,
  ``np.random.seed``, an argless ``default_rng()``); a torch draw without
  an explicit ``generator=`` (``torch.rand``, ``randn``, ``randint``,
  ``randperm``, the ``*_like`` draws, ``bernoulli``, ``multinomial``,
  ``normal``, and the in-place ``normal_``, ``uniform_``, ``bernoulli_``,
  ``random_``, ``exponential_`` on any tensor); and ``torch.manual_seed``
  or ``torch.cuda.manual_seed*``, which reseed the global generators as
  ``np.random.seed`` does.  Keyed constructions pass
  (``torch.Generator().manual_seed(s)``, ``default_rng(seed)``);
  ``kernels/rng.py``, the counter hash every in-kernel draw keys from,
  is exempt as a whole, as the reference's is.
* **RA102 host-sync-in-step**: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` or ``torch.cuda.synchronize()`` inside a step: a function
  named ``step`` or ``*_step`` (a ``make_*step`` builder itself aside: its
  body runs once, at build time), or a closure a ``make_*step`` builder
  returns (and what is nested in either).  On a card each is a
  device-to-host wait every step.  The reference's other leg, a host
  cast of a parameter (``int(n)``), has no twin: the port's step index
  is a host ``int`` by design (``int(step_idx)`` in the algorithms).
* **RA103 compile-in-loop**: ``torch.compile(...)`` (or a def decorated
  with it), or a kernel build or load through ``kernels/build.py``
  (``build.build``, ``build.load``, ``build.load_built``), inside a
  ``for``/``while`` body: a fresh compile or build every iteration.
* **RA104 broad-except**: a bare ``except:``, ``except Exception`` or
  ``except BaseException`` whose body does not end in a bare ``raise``.
  A handler that cleans up and re-raises swallows nothing; a site that
  means "any failure makes this a failed row" carries
  ``# repro-allow: RA104`` with its reason.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.base import (Finding, SourceFile, iter_py_files,
                                       load_source)

RULES: Dict[str, str] = {
    "RA100": "syntax-error",
    "RA101": "unkeyed-randomness",
    "RA102": "host-sync-in-step",
    "RA103": "compile-in-loop",
    "RA104": "broad-except",
}

#: directories linted by default (repo-relative)
DEFAULT_SUBDIRS = ("src/repro_torch",)

#: per-rule allow-list of paths (repo-relative globs), each file exempt
#: from that rule as a whole: ``kernels/rng.py`` is the keyed counter
#: hash itself
RULE_ALLOW_PATHS: Dict[str, Sequence[str]] = {
    "RA101": ("src/repro_torch/kernels/rng.py",),
}

#: np.random attributes that construct a keyed generator, not draws from
#: the global one
_KEYED_CONSTRUCTORS = {"default_rng", "Generator", "SeedSequence",
                       "PCG64", "Philox", "SFC64", "MT19937",
                       "BitGenerator", "RandomState"}

#: ``torch.<fn>`` draws that take a ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal"}
#: in-place draws, a method of any tensor (or ``torch.nn.init.<fn>``)
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_"}
#: modules whose ``manual_seed*`` reseeds a global generator
_SEEDED_MODULES = {("torch",), ("torch", "random"), ("torch", "cuda")}

#: methods that read a device tensor on the host
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
#: ``kernels/build.py``'s functions that build or load a kernel library
_BUILD_FNS = {"build", "load", "load_built"}


def _dotted(node: ast.AST) -> Optional[tuple]:
    """``a.b.c`` as ("a", "b", "c"); None unless a chain of names."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return tuple(reversed(parts))


def _is_np_random_attr(node: ast.AST) -> Optional[str]:
    """If ``node`` is ``np.random.<X>`` / ``numpy.random.<X>``, X."""
    d = _dotted(node)
    if d and len(d) == 3 and d[0] in ("np", "numpy") and d[1] == "random":
        return d[2]
    return None


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def _is_compile(node: ast.AST) -> bool:
    """Is this expression ``torch.compile`` (called or bare, as a
    decorator or inside ``functools.partial``)?"""
    return any(_dotted(sub) == ("torch", "compile")
               for sub in ast.walk(node))


def _is_build_call(node: ast.Call) -> bool:
    d = _dotted(node.func)
    return bool(d) and len(d) >= 2 and d[-2] == "build" and \
        d[-1] in _BUILD_FNS


def _is_step_name(name: str) -> bool:
    return name == "step" or name.endswith("_step")


def _returned_names(fn: ast.AST) -> Set[str]:
    """Names a function returns (directly, or in a returned tuple), not
    counting the returns of functions nested in it."""
    out: Set[str] = set()

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Return) and child.value is not None:
                vals = child.value.elts if isinstance(
                    child.value, ast.Tuple) else [child.value]
                out.update(v.id for v in vals if isinstance(v, ast.Name))
            walk(child)
    walk(fn)
    return out


def _reraises(handler: ast.ExceptHandler) -> bool:
    last = handler.body[-1] if handler.body else None
    return isinstance(last, ast.Raise) and last.exc is None


class _Linter(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: List[Finding] = []
        self._loop_depth = 0
        self._in_step = 0
        #: a function a level: the names of the closures it returns where
        #: it is a ``make_*step`` builder, else None
        self._built: List[Optional[Set[str]]] = []

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        f = self.src.finding(rule, getattr(node, "lineno", 0), message)
        if f is not None:
            self.findings.append(f)

    # ---- loops (RA103 context) ----
    def visit_For(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_AsyncFor = visit_For
    visit_While = visit_For

    # ---- functions (step context, RA103 for a compiled def) ----
    def _visit_fn(self, node):
        compiled = any(_is_compile(d) for d in node.decorator_list)
        if compiled and self._loop_depth:
            self._emit("RA103", node,
                       f"`torch.compile`-decorated `{node.name}` defined "
                       "inside a loop: a fresh compile every iteration "
                       "(compile once, pass the changing values as "
                       "arguments)")
        builder = node.name.startswith("make_") and \
            node.name.endswith("step")
        step = (_is_step_name(node.name) and not builder) or bool(
            self._built and self._built[-1]
            and node.name in self._built[-1])
        self._in_step += step
        self._built.append(_returned_names(node) if builder else None)
        # a nested def's body runs when it is called, not in this loop
        saved, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = saved
        self._built.pop()
        self._in_step -= step

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # ---- except handlers (RA104) ----
    def visit_ExceptHandler(self, node):
        broad = node.type is None
        types = []
        if isinstance(node.type, ast.Tuple):
            types = node.type.elts
        elif node.type is not None:
            types = [node.type]
        for t in types:
            name = t.attr if isinstance(t, ast.Attribute) else \
                t.id if isinstance(t, ast.Name) else ""
            if name in ("Exception", "BaseException"):
                broad = True
        if broad and not _reraises(node):
            what = "bare `except:`" if node.type is None else \
                "`except Exception`"
            self._emit("RA104", node,
                       f"{what} swallows every failure mode — catch "
                       "concrete exception types, re-raise, or justify "
                       "with `# repro-allow: RA104`")
        self.generic_visit(node)

    # ---- calls (RA101, RA102, RA103) ----
    def _ra101(self, node: ast.Call) -> None:
        attr = _is_np_random_attr(node.func)
        d = _dotted(node.func)
        if attr is not None:
            if attr == "default_rng" and not node.args and not node.keywords:
                self._emit("RA101", node,
                           "argless `np.random.default_rng()` draws from "
                           "OS entropy — pass an explicit seed")
            elif attr == "seed":
                self._emit("RA101", node,
                           "`np.random.seed` mutates global RNG state — "
                           "use an explicitly keyed `default_rng(seed)`")
            elif attr not in _KEYED_CONSTRUCTORS:
                self._emit("RA101", node,
                           f"`np.random.{attr}` draws from the global "
                           "generator — use an explicitly keyed "
                           "`default_rng(seed)`")
        elif (isinstance(node.func, ast.Name)
              and node.func.id == "default_rng"
              and not node.args and not node.keywords):
            self._emit("RA101", node,
                       "argless `default_rng()` draws from OS entropy — "
                       "pass an explicit seed")
        elif d and d[-1].startswith("manual_seed") and \
                d[:-1] in _SEEDED_MODULES:
            self._emit("RA101", node,
                       f"`{'.'.join(d)}` reseeds a global generator — "
                       "draw from a keyed `torch.Generator().manual_seed"
                       "(seed)` passed as `generator=`")
        elif d and len(d) == 2 and d[0] == "torch" and \
                d[1] in _TORCH_DRAWS and not _has_kw(node, "generator"):
            self._emit("RA101", node,
                       f"`torch.{d[1]}` without `generator=` draws from "
                       "the global generator — pass a keyed "
                       "`torch.Generator`")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_DRAWS and \
                not _has_kw(node, "generator"):
            self._emit("RA101", node,
                       f"in-place `{node.func.attr}` without `generator=` "
                       "draws from the global generator — pass a keyed "
                       "`torch.Generator`")

    def visit_Call(self, node):
        self._ra101(node)

        if self._loop_depth and (_dotted(node.func) == ("torch", "compile")
                                 or _is_build_call(node)):
            what = "torch.compile" if _dotted(node.func) == (
                "torch", "compile") else ".".join(_dotted(node.func))
            self._emit("RA103", node,
                       f"`{what}(...)` called inside a loop: a fresh "
                       "compile or kernel build every iteration (hoist "
                       "it out of the loop)")

        if self._in_step:
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _HOST_READS
                    and not node.args and not node.keywords):
                self._emit("RA102", node,
                           f"`.{f.attr}()` inside a step reads a device "
                           "value on the host: a device->host wait every "
                           "step — keep it a tensor, read it outside the "
                           "step")
            elif _dotted(f) == ("torch", "cuda", "synchronize"):
                self._emit("RA102", node,
                           "`torch.cuda.synchronize()` inside a step "
                           "waits for the card every step")
        self.generic_visit(node)


def lint_source(src: SourceFile) -> List[Finding]:
    """Every AST finding of one file (the path allow-lists applied)."""
    try:
        tree = ast.parse(src.text, filename=src.path)
    except SyntaxError as e:
        return [Finding(rule="RA100", path=src.rel,
                        line=e.lineno or 0,
                        message=f"syntax error: {e.msg}",
                        source="")]
    linter = _Linter(src)
    linter.visit(tree)
    out = []
    for f in linter.findings:
        allows = RULE_ALLOW_PATHS.get(f.rule, ())
        if any(fnmatch.fnmatch(src.rel, pat) for pat in allows):
            continue
        out.append(f)
    return out


def lint_paths(root: str, subdirs: Sequence[str] = DEFAULT_SUBDIRS
               ) -> List[Finding]:
    """Lint every .py file under ``root/<subdir>``."""
    findings: List[Finding] = []
    for path in iter_py_files(root, subdirs):
        findings.extend(lint_source(load_source(path, root)))
    return findings


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    """Lint a single file (tests plant violations through this)."""
    return lint_source(load_source(path, root or os.path.dirname(path)))
