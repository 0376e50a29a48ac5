"""ctt-lint framework core: findings, pragmas, parsed sources, runner.

Port of cluster_tools_tpu/analysis/base.py.  The JAX package's
traced-scope rules (``trace-purity``, ``dtype-f64``) have no meaning for
PyTorch; the port's two rules take their place: ``port-boundary`` (no
JAX, no JAX package, no h5py/tensorstore/numcodecs, sklearn and imageio
only inside functions) and ``device-fallback`` (nothing falls back to a
kernel's plain version or to the CPU on its own).

Every pass is a ``Pass`` instance: a name, the rule ids it may emit and
a function ``(SourceFile) -> [Finding]``.  The runner parses each file
ONCE, hands the shared :class:`SourceFile` to every pass, then applies
pragma suppression uniformly.

Suppression is *only* via the inline pragma::

    some_call()  # ctt-lint: disable=blocking-under-lock (log under the
                 # executor lock keeps multi-thread output readable)

The reason in parentheses is MANDATORY: a pragma without one both fails
to suppress and raises its own ``pragma-reason`` finding.  A pragma on
the line above the finding also applies (for lines too long to annotate
in place).  Suppressed findings are not dropped — they are counted and
reported with their reasons, so the suppression budget is audited in
CI.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import sources

#: ``# ctt-lint: disable=<rule>[,<rule>...] (reason)``
PRAGMA_RE = re.compile(
    r"#\s*ctt-lint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:\((.+)\))?\s*$")

#: every rule id the framework knows about (CLI validation + reporting)
ALL_RULES = (
    "pragma-reason",
    "port-boundary",
    "device-fallback",
    "blocking-under-lock",
    "stage-registry",
    "metric-registry",
    "dtype-int32",
    "config-key",
    "atomic-write",
    "parse-error",
)


@dataclass
class Finding:
    path: str                 # repo-relative
    line: int
    rule: str
    message: str
    suppressed: bool = False
    reason: str = ""

    def format(self) -> str:
        tag = " [suppressed: %s]" % self.reason if self.suppressed else ""
        return "%s:%d: %s: %s%s" % (
            self.path, self.line, self.rule, self.message, tag)

    def as_dict(self) -> dict:
        d = {"path": self.path, "line": self.line,
             "rule": self.rule, "message": self.message}
        if self.suppressed:
            d["suppressed"] = True
            d["reason"] = self.reason
        return d


@dataclass
class Pragma:
    line: int
    rules: Tuple[str, ...]    # rule ids, or ("all",)
    reason: str

    def covers(self, rule: str) -> bool:
        return "all" in self.rules or rule in self.rules


class SourceFile:
    """One parsed source file shared by every pass.

    ``tree`` is ``None`` when the file does not parse (the runner emits
    a ``parse-error`` finding instead of crashing the whole lint)."""

    def __init__(self, path: str, text: Optional[str] = None):
        self.path = os.path.abspath(path)
        self.rel = sources.relpath(path)
        if text is None:
            with open(self.path, "r", encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=self.rel)
        except SyntaxError as exc:   # pragma: no cover - corrupt source
            self.parse_error = "line %s: %s" % (exc.lineno, exc.msg)
        self.pragmas: Dict[int, Pragma] = self._scan_pragmas()
        #: scratch space for cross-pass memoization (e.g. traced scopes)
        self.cache: dict = {}

    def _scan_pragmas(self) -> Dict[int, Pragma]:
        out: Dict[int, Pragma] = {}
        for i, line in enumerate(self.lines, start=1):
            if "ctt-lint" not in line:
                continue
            m = PRAGMA_RE.search(line)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            out[i] = Pragma(line=i, rules=rules,
                            reason=(m.group(2) or "").strip())
        return out

    def pragma_for(self, line: int) -> Optional[Pragma]:
        """The pragma governing ``line``: on the line itself, or on the
        immediately preceding line."""
        return self.pragmas.get(line) or self.pragmas.get(line - 1)

    # -- helpers shared by passes ------------------------------------

    def in_dir(self, name: str) -> bool:
        """True when the file lives under a ``<name>/`` component of the
        package (``core``, ``ops``, ``workflows``...)."""
        parts = self.rel.replace(os.sep, "/").split("/")
        return name in parts[:-1]


@dataclass
class Pass:
    name: str
    rules: Tuple[str, ...]
    run: Callable[[SourceFile], List[Finding]]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def load_passes() -> List[Pass]:
    from . import (atomic_write, boundary, config_keys, dtype_discipline,
                   fallback, locks, registry)
    return [
        boundary.PASS,
        fallback.PASS,
        locks.PASS,
        registry.STAGE_PASS,
        registry.METRIC_PASS,
        dtype_discipline.PASS,
        config_keys.PASS,
        atomic_write.PASS,
    ]


def run_analysis(files: Optional[Sequence[str]] = None,
                 root: Optional[str] = None,
                 rules: Optional[Iterable[str]] = None,
                 passes: Optional[Sequence[Pass]] = None) -> dict:
    """Run every pass over ``files`` (default: the whole package plus
    ``chip_smoke.py``) and return the report dict.

    Report keys: ``findings`` (unsuppressed, sorted), ``suppressed``
    (with reasons), ``counts`` (per rule, unsuppressed),
    ``suppressed_counts``, ``files_scanned``.
    """
    if passes is None:
        passes = load_passes()
    rule_filter = set(rules) if rules else None
    paths = list(files) if files is not None \
        else sources.source_files(root=root)

    raw: List[Finding] = []
    n_files = 0
    for path in paths:
        sf = SourceFile(path)
        n_files += 1
        if sf.parse_error is not None:
            raw.append(Finding(sf.rel, 1, "parse-error", sf.parse_error))
            continue
        for p in passes:
            for f in p.run(sf):
                raw.append(f)
        # pragma hygiene: a pragma with no reason is itself a finding,
        # regardless of whether anything tried to use it.
        for pragma in sf.pragmas.values():
            if not pragma.reason:
                raw.append(Finding(
                    sf.rel, pragma.line, "pragma-reason",
                    "ctt-lint pragma without a (reason) — the reason "
                    "is mandatory and the suppression does not apply"))
        # apply suppression for this file's findings
        for f in raw:
            if f.path != sf.rel or f.rule in ("pragma-reason",
                                              "parse-error"):
                continue
            pragma = sf.pragma_for(f.line)
            if pragma is not None and pragma.covers(f.rule) \
                    and pragma.reason:
                f.suppressed = True
                f.reason = pragma.reason

    if rule_filter is not None:
        raw = [f for f in raw if f.rule in rule_filter]
    raw.sort(key=lambda f: (f.path, f.line, f.rule))

    findings = [f for f in raw if not f.suppressed]
    suppressed = [f for f in raw if f.suppressed]

    def _counts(fs: List[Finding]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in fs:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    return {
        "findings": findings,
        "suppressed": suppressed,
        "counts": _counts(findings),
        "suppressed_counts": _counts(suppressed),
        "files_scanned": n_files,
    }


def report_as_json(report: dict) -> dict:
    """A JSON-serializable view of :func:`run_analysis`'s output."""
    return {
        "findings": [f.as_dict() for f in report["findings"]],
        "suppressed": [f.as_dict() for f in report["suppressed"]],
        "counts": dict(report["counts"]),
        "suppressed_counts": dict(report["suppressed_counts"]),
        "n_findings": len(report["findings"]),
        "n_suppressed": len(report["suppressed"]),
        "files_scanned": report["files_scanned"],
    }
