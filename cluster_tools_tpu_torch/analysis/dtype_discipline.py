"""dtype-int32: packed keys and seed ids kept out of int32 on ``ops/``
paths.

Port of cluster_tools_tpu/analysis/dtype_discipline.py without its
``dtype-f64`` half, which checks JAX's traced scopes (PyTorch has none).

* ``dtype-int32`` — ``.astype(int32)`` on names that look like packed
  keys / seed ids / label offsets, anywhere in ``ops/``.  Global seed
  ids exceed 2**31 on real volumes; the sanctioned route is a compaction
  that range-checks after it compacts.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .base import Finding, Pass, SourceFile, dotted_name

_I32 = frozenset({"int32", "i4"})
#: receiver-name tokens that mark a global-id/packed-key value.
#: Deliberately does NOT include "label": post-relabel dense labels are
#: block-local by construction; the >2**31 corruption class is global
#: SEED/packed-edge ids.
_KEY_TOKENS = ("seed", "packed", "key", "offset")


def _dtype_token(node: ast.AST) -> Optional[str]:
    """'int32' / 'float64' / ... for a dtype-valued expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = dotted_name(node)
    if name:
        return name.rsplit(".", 1)[-1]
    return None


def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id.lower())
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr.lower())
    return out


def _is_keyish(node: ast.AST) -> bool:
    names = _names_in(node)
    return any(tok in n for n in names for tok in _KEY_TOKENS)


def run(sf: SourceFile) -> List[Finding]:
    if not sf.in_dir("ops"):
        return []
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "astype" and node.args \
                and _dtype_token(node.args[0]) in _I32 \
                and _is_keyish(node.func.value):
            out.append(Finding(
                sf.rel, node.lineno, "dtype-int32",
                "bare int32 cast on a packed-key/seed-id value — global "
                "ids exceed 2**31; compact and range-check first"))
    return out


PASS = Pass(name="dtype-discipline", rules=("dtype-int32",), run=run)
