"""atomic-write: JSON artifacts must not be written in place.

Port of cluster_tools_tpu/analysis/atomic_write.py: the same rule over the
port's sources.

A reader (resumed task, status poller, trace merger) that opens a
status/artifact JSON mid-write sees a truncated document — the exact
shared-filesystem consistency class the reference's checkpoint
discipline exists for.  The repo-wide idiom is write-to-temp +
``os.replace`` (``config.write_config`` is the canonical helper); this
pass flags any ``json.dump`` into a handle from a plain
``open(path, "w")`` in a function that never calls ``os.replace``.

The temp-file half of the atomic idiom itself (``open(tmp, "w")`` then
``os.replace(tmp, path)``) is exempt precisely because the replace is
in the same function.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from .base import Finding, Pass, SourceFile, dotted_name


def _walk_scope(node: ast.AST, *, root: bool = True) -> Iterator[ast.AST]:
    """Walk one function scope without descending into nested defs."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not root:
            continue
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield from _walk_scope(child, root=False)


def _scopes(tree: ast.AST) -> Iterator[ast.AST]:
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_write_open(call: ast.Call) -> bool:
    if dotted_name(call.func) != "open":
        return False
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return isinstance(mode, ast.Constant) \
        and isinstance(mode.value, str) and "w" in mode.value


def _is_json_dump(call: ast.Call) -> bool:
    fn = dotted_name(call.func)
    return bool(fn) and fn.rsplit(".", 1)[-1] == "dump" \
        and "json" in fn.lower()


def run(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    seen = set()
    for scope in _scopes(sf.tree):
        body = list(_walk_scope(scope))
        has_replace = any(
            isinstance(n, ast.Call)
            and dotted_name(n.func) in ("os.replace", "os.rename")
            for n in body)
        if has_replace:
            continue
        for node in body:
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(isinstance(i.context_expr, ast.Call)
                       and _is_write_open(i.context_expr)
                       for i in node.items):
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and _is_json_dump(sub) \
                            and sub.lineno not in seen:
                        seen.add(sub.lineno)
                        out.append(Finding(
                            sf.rel, sub.lineno, "atomic-write",
                            "json.dump through a plain open(..., 'w') "
                            "with no os.replace in scope — readers can "
                            "observe a truncated document; use "
                            "config.write_config (tmp + os.replace)"))
    return out


PASS = Pass(name="atomic-write", rules=("atomic-write",), run=run)
