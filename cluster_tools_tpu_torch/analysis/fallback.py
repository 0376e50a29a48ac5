"""device-fallback: nothing falls back on its own.

A wrapper of a hand-written kernel takes its plain PyTorch version only
because the tensor it was given lies on the CPU; on a CUDA tensor it
launches the kernel or raises.  Device tasks run where the global config
says, and raise without a card.  Two shapes of code break that and are
findings:

* an ``except`` handler that calls a kernel's plain version (a function
  whose name ends in ``_plain``): a kernel that failed to build or launch
  would be replaced, unseen, by the slow path;
* a CUDA-availability test (``torch.cuda.is_available()``) in an ``if``
  or a conditional expression whose branch names the CPU (``"cpu"``,
  ``torch.device("cpu")``, ``.cpu()``): the card's absence would move the
  work to the host instead of raising.
"""

from __future__ import annotations

import ast
from typing import List

from .base import Finding, Pass, SourceFile, call_name


def _calls_plain(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = call_name(sub) or ""
            if name.rsplit(".", 1)[-1].endswith("_plain"):
                return True
    return False


def _tests_cuda(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and (call_name(sub) or "").endswith(
                "cuda.is_available"):
            return True
    return False


def _names_cpu(nodes) -> bool:
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and sub.value == "cpu":
                return True
            if isinstance(sub, ast.Call) and (call_name(sub) or "") \
                    .rsplit(".", 1)[-1] == "cpu":
                return True
    return False


def run(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ExceptHandler) and any(
                _calls_plain(stmt) for stmt in node.body):
            out.append(Finding(
                sf.rel, node.lineno, "device-fallback",
                "except handler calls a kernel's plain version: a failed "
                "kernel must raise, not fall back unseen"))
        elif isinstance(node, (ast.If, ast.IfExp)) and _tests_cuda(
                node.test):
            branches = ([node.body, node.orelse]
                        if isinstance(node, ast.IfExp)
                        else node.body + node.orelse)
            if _names_cpu(branches if isinstance(node, ast.If)
                          else [node.body, node.orelse]):
                out.append(Finding(
                    sf.rel, node.lineno, "device-fallback",
                    "a CUDA-availability test picks the CPU: without a "
                    "card, raise (the CPU is used only when asked for)"))
    return out


PASS = Pass(name="device-fallback", rules=("device-fallback",), run=run)
