"""stage-registry / metric-registry: canonical-name discipline, as AST
passes.

Port of cluster_tools_tpu/analysis/registry.py: the same rule over the
port's sources.

These take the place of a stage-name and a metric-name grep lint.
Being AST-based they additionally catch what a quoted-
literal grep structurally cannot: f-string and concatenated names
(``stage_add(f"sync-{kind}")``) that bypass the registry at runtime.

* stage names: every literal first argument of ``stage`` /
  ``timed_stage`` / ``stage_add`` / ``stage_bytes`` must be in
  ``telemetry.STAGE_REGISTRY``; a dynamic first argument is its own
  finding (register the canonical literal instead).
* metric names: every full-string constant matching ``ctt_\\w+`` must
  be in ``telemetry.METRIC_REGISTRY``; f-strings/concatenations whose
  literal head starts with ``ctt_`` are dynamic-name findings.
  (Requiring the FULL constant to match keeps docstrings and prose
  mentioning ``ctt_*`` names out of scope, same as the old grep.)
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .base import Finding, Pass, SourceFile, dotted_name

_STAGE_CALLS = frozenset({"stage", "timed_stage", "stage_add",
                          "stage_bytes"})
_METRIC_RE = re.compile(r"^ctt_[a-zA-Z0-9_]+$")
#: the head of a metric family's name (dynamic names that start with it
#: bypass the registry)
_METRIC_HEAD = re.compile(r"^ctt_")


def _telemetry():
    from ..core import telemetry
    return telemetry


def _stage_name_arg(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "name":
            return kw.value
    return None


def run_stage(sf: SourceFile) -> List[Finding]:
    tele = _telemetry()
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = dotted_name(node.func)
        if not fn or fn.rsplit(".", 1)[-1] not in _STAGE_CALLS:
            continue
        arg = _stage_name_arg(node)
        if arg is None:
            continue
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not tele.is_registered(arg.value):
                out.append(Finding(
                    sf.rel, arg.lineno, "stage-registry",
                    "stage name %r is not in STAGE_REGISTRY — "
                    "register_stage() the canonical name" % arg.value))
        elif isinstance(arg, (ast.JoinedStr, ast.BinOp, ast.Name,
                              ast.Attribute, ast.Call)):
            out.append(Finding(
                sf.rel, arg.lineno, "stage-registry",
                "dynamic stage name in `%s(...)` — pass a registered "
                "literal so the registry stays authoritative" % fn))
    return out


def run_metric(sf: SourceFile) -> List[Finding]:
    tele = _telemetry()
    out: List[Finding] = []
    seen = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _METRIC_RE.match(node.value) \
                    and not tele.is_registered_metric(node.value):
                key = (node.lineno, node.value)
                if key in seen:
                    continue
                seen.add(key)
                out.append(Finding(
                    sf.rel, node.lineno, "metric-registry",
                    "metric name %r is not in METRIC_REGISTRY — "
                    "register_metric() it" % node.value))
        elif isinstance(node, ast.JoinedStr):
            head = node.values[0] if node.values else None
            if isinstance(head, ast.Constant) \
                    and isinstance(head.value, str) \
                    and _METRIC_HEAD.match(head.value):
                out.append(Finding(
                    sf.rel, node.lineno, "metric-registry",
                    "f-string metric name starting with 'ctt_' — "
                    "dynamic family names bypass the registry"))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = node.left
            if isinstance(left, ast.Constant) \
                    and isinstance(left.value, str) \
                    and _METRIC_HEAD.match(left.value):
                out.append(Finding(
                    sf.rel, node.lineno, "metric-registry",
                    "concatenated metric name starting with 'ctt_' — "
                    "dynamic family names bypass the registry"))
    return out


STAGE_PASS = Pass(name="stage-registry", rules=("stage-registry",),
                  run=run_stage)
METRIC_PASS = Pass(name="metric-registry", rules=("metric-registry",),
                   run=run_metric)
