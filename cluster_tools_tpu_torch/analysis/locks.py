"""blocking-under-lock: blocking/IO calls lexically inside ``with
<lock>:`` blocks in ``core/``.

Port of cluster_tools_tpu/analysis/locks.py: the same rule over the
port's sources.

This is the "span emitted OUTSIDE the locked accumulation" rule,
generalized: anything that can block for unbounded time (file IO,
device syncs, ``.result()``/``.join()`` waits, subprocess, sleeps) or
re-enters the telemetry/stage machinery must not run while a lock is
held — it stalls every thread contending on that lock and is the
static half of the lock-order witness's held-across-blocking-call
check (``core.runtime.witness_blocking``).

Deliberately NOT flagged:

* ``.wait()`` — Condition waits RELEASE the lock while blocked;
  waiting under ``with cond:`` is the correct idiom,
* ``", ".join(...)`` / ``os.path.join(...)`` — string/path joins, not
  thread joins,
* code inside nested ``def``/``lambda`` — defined under the lock,
  executed elsewhere.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional

from .base import Finding, Pass, SourceFile, dotted_name

#: last-segment call names that re-enter stage/telemetry/status IO
_REENTRANT = frozenset({
    "stage_add", "stage_bytes", "stage", "timed_stage",
    "flight_record", "write_prometheus", "write_metrics",
    "write_config", "_write_status", "_store", "_load",
})

_OS_BLOCKING = frozenset({
    "os.replace", "os.remove", "os.rename", "os.makedirs",
    "os.listdir", "os.stat", "os.unlink", "os.fsync",
})


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


_LOCK_NAME = re.compile(r"(?:^|_)r?lock$|^r?lock(?:$|_)")


def _looks_like_lock(expr: ast.AST) -> Optional[str]:
    """The lock's display name when ``expr`` is a lock acquisition.
    Word-boundary match so e.g. ``witness_blocking`` ("bLOCKing") does
    not read as a lock."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    name = dotted_name(expr)
    if name and _LOCK_NAME.search(_last(name).lower()):
        return name
    return None


def _walk_no_fn(node: ast.AST) -> Iterator[ast.AST]:
    """Walk skipping nested function/lambda bodies (they run later,
    not under the lock)."""
    yield node
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield from _walk_no_fn(child)


def _string_or_path_join(func: ast.Attribute) -> bool:
    recv = func.value
    if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
        return True
    rn = dotted_name(recv)
    return bool(rn) and ("path" in rn.lower() or rn in ("os", "sep"))


def _violation(call: ast.Call) -> Optional[str]:
    fn = dotted_name(call.func)
    if fn is not None:
        last = _last(fn)
        if fn in ("open", "print"):
            return "%s() is IO" % fn
        if fn in _OS_BLOCKING or fn.startswith("subprocess."):
            return "%s() is blocking IO" % fn
        if fn == "time.sleep":
            return "time.sleep() stalls every contender"
        if last == "dump" and "json" in fn.lower():
            return "%s() serializes + writes under the lock" % fn
        if last in _REENTRANT:
            return "`%s` re-enters stage/telemetry/status IO" % fn
        if last == "block_until_ready":
            return "device sync under the lock"
        if last == "result":
            return ".result() waits on another thread under the lock"
        if last == "join" and isinstance(call.func, ast.Attribute) \
                and not _string_or_path_join(call.func):
            return ".join() waits on another thread under the lock"
        return None
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr == "block_until_ready":
            return "device sync under the lock"
        if attr == "result":
            return ".result() waits on another thread under the lock"
        if attr == "join" and not _string_or_path_join(call.func):
            return ".join() waits on another thread under the lock"
    return None


def run(sf: SourceFile) -> List[Finding]:
    if not sf.in_dir("core"):
        return []
    out: List[Finding] = []
    seen = set()
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock = None
        for item in node.items:
            lock = _looks_like_lock(item.context_expr)
            if lock:
                break
        if not lock:
            continue
        # block-level suppression: a reasoned pragma on the ``with``
        # line covers every finding inside the block (the common case
        # where the IO *is* the critical section being serialized)
        block_pragma = sf.pragma_for(node.lineno)
        if block_pragma is not None and (
                not block_pragma.covers("blocking-under-lock")
                or not block_pragma.reason):
            block_pragma = None
        for stmt in node.body:
            for sub in _walk_no_fn(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                why = _violation(sub)
                if why is None:
                    continue
                key = (sub.lineno, sub.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                f = Finding(
                    sf.rel, sub.lineno, "blocking-under-lock",
                    "inside `with %s`: %s" % (lock, why))
                if block_pragma is not None:
                    f.suppressed = True
                    f.reason = block_pragma.reason
                out.append(f)
    return out


PASS = Pass(name="blocking-under-lock",
            rules=("blocking-under-lock",), run=run)
