"""Shared plumbing of the port's analysis passes (``repro.analysis.base``):
the Finding record, inline suppression comments and the baseline of
grandfathered findings.

Suppression
-----------
A finding is suppressed when the flagged source line carries a marker
naming its rule (or an ``RA*``-style family wildcard)::

    except Exception:          # repro-allow: RA104 — any failure = skip

Suppressions are per line and per rule: a file-wide opt-out would let a
second, unrelated violation ride in on an old comment.

Baseline
--------
``load_baseline``/``write_baseline`` read and write a JSON list of
finding fingerprints.  A fingerprint is ``rule|path|<stripped source
line>``: free of line numbers, so a grandfathered finding survives edits
above it and expires the moment the flagged line itself changes.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

#: inline suppression marker: ``# repro-allow: RA104`` (comma-separated
#: rule ids; a family prefix like ``RA*`` allows the whole class)
_ALLOW_RE = re.compile(r"#\s*repro-allow:\s*([A-Z]{2}[\w*,\s]*)")


@dataclass
class Finding:
    """One rule violation at one site."""
    rule: str                   # e.g. "RA101"
    path: str                   # repo-relative posix path, or a trace tag
    line: int                   # 1-based; 0 for a whole-trace finding
    message: str
    source: str = ""            # the stripped offending line (fingerprint)
    baselined: bool = False     # grandfathered by the baseline file

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.source}"

    def format(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}{tag}"

    def to_json(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "source": self.source,
                "baselined": self.baselined}


def allowed_rules(line: str) -> List[str]:
    """Rule ids (or family wildcards) a suppression marker on ``line``
    names; empty where the line has none."""
    m = _ALLOW_RE.search(line)
    if not m:
        return []
    return [r.strip() for r in m.group(1).split(",") if r.strip()]


def is_suppressed(rule: str, line: str) -> bool:
    for allowed in allowed_rules(line):
        if allowed == rule:
            return True
        if allowed.endswith("*") and rule.startswith(allowed[:-1]):
            return True
    return False


@dataclass
class SourceFile:
    """A source file read for linting: its path and its lines, so every
    rule shares one read."""
    path: str                   # absolute
    rel: str                    # repo-relative posix
    text: str
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.text.splitlines()

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: str, lineno: int, message: str
                ) -> Optional[Finding]:
        """A Finding, unless the flagged line suppresses the rule."""
        src = self.line_at(lineno).strip()
        if is_suppressed(rule, src):
            return None
        return Finding(rule=rule, path=self.rel, line=lineno,
                       message=message, source=src)


def load_source(path: str, root: str) -> SourceFile:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    return SourceFile(path=path, rel=rel, text=text)


def iter_py_files(root: str, subdirs: Iterable[str]) -> List[str]:
    """Every .py file under ``root/<subdir>`` for each subdir, sorted."""
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


# ------------------------------------------------------------- baseline

def load_baseline(path: Optional[str]) -> List[str]:
    if not path or not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"baseline {path}: expected a JSON list of "
                         "fingerprints")
    return [str(x) for x in data]


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(fps, f, indent=1)
        f.write("\n")


def apply_baseline(findings: List[Finding], baseline: List[str]
                   ) -> List[str]:
    """Mark the findings whose fingerprint is grandfathered (in place).

    Returns the **stale** fingerprints: baseline entries that matched no
    current finding.  The CLI reports them, prunes them on
    ``--update-baseline`` and fails on them under ``--fail-on-stale``."""
    known = set(baseline)
    hit = set()
    for f in findings:
        f.baselined = f.fingerprint in known
        if f.baselined:
            hit.add(f.fingerprint)
    return sorted(known - hit)
