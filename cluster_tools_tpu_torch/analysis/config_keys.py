"""config-key: global-config key accesses checked against the declared
schema.

Port of cluster_tools_tpu/analysis/config_keys.py: the same rule over the
port's sources.

A typo'd ``global_config.get("max_num_retires")`` returns the default
silently and the knob is dead — the classic config-drift bug.  The
schema is declared in ONE place
(:func:`core.config.declared_global_config_keys` =
``default_global_config`` ∪ ``default_task_resources`` ∪ the documented
runtime-written extras); every literal key in a ``.get("...")`` or
``["..."]`` access on a global-config expression must be in it.

Recognized global-config expressions:

* anything whose dotted form ends in ``global_config``
  (``self.global_config``, ``cfg.global_config``),
* ``something["global_config"]`` subscripts (job-config dicts),
* local aliases assigned from either of the above
  (``gc = self.global_config``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .base import Finding, Pass, SourceFile, dotted_name


def _schema() -> frozenset:
    from ..core import config as config_mod
    return config_mod.declared_global_config_keys()


def _is_gc_expr(node: ast.AST, aliases: Set[str]) -> bool:
    name = dotted_name(node)
    if name and (name == "global_config"
                 or name.endswith(".global_config")):
        return True
    if name and name in aliases:
        return True
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and sl.value == "global_config":
            return True
    if isinstance(node, ast.Call):          # .global_config() accessor
        fn = dotted_name(node.func)
        return bool(fn) and fn.rsplit(".", 1)[-1] == "global_config"
    return False


def _collect_aliases(tree: ast.AST) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and _is_gc_expr(node.value, set()):
            aliases.add(tgt.id)
    return aliases


def _key_of(node: ast.AST) -> Optional[ast.Constant]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node
    return None


def run(sf: SourceFile) -> List[Finding]:
    schema = _schema()
    aliases = _collect_aliases(sf.tree)
    out: List[Finding] = []
    seen = set()

    def _check(key_node: ast.Constant) -> None:
        key = key_node.value
        if key in schema or key == "global_config":
            return
        loc = (key_node.lineno, key)
        if loc in seen:
            return
        seen.add(loc)
        out.append(Finding(
            sf.rel, key_node.lineno, "config-key",
            "global-config key %r is not declared in "
            "config.declared_global_config_keys() — a typo here "
            "silently falls back to the default" % key))

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "pop", "setdefault") \
                and node.args \
                and _is_gc_expr(node.func.value, aliases):
            key = _key_of(node.args[0])
            if key is not None:
                _check(key)
        elif isinstance(node, ast.Subscript) \
                and _is_gc_expr(node.value, aliases):
            key = _key_of(node.slice)
            if key is not None:
                _check(key)
    return out


PASS = Pass(name="config-key", rules=("config-key",), run=run)
