"""port-boundary: what the port may import.

The port runs on a machine with PyTorch and no JAX, no h5py, tensorstore,
orbax or numcodecs (its storage formats are its own: ``core/hdf5.py``,
``core/blosc.py``, ``core/ocdbt.py``), and no sklearn or imageio.  So:

* an import of ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``,
  ``ml_dtypes``, the JAX package (``cluster_tools_tpu``), ``h5py``,
  ``tensorstore``, ``numcodecs`` or ``zstandard`` anywhere — at module
  level or inside a function, by ``import``, ``from ... import`` or
  ``importlib.import_module("...")`` — is a finding;
* ``sklearn`` and ``imageio`` may be imported only inside the function
  that needs them (a host without them still imports every module); at
  module level they are a finding.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from .base import Finding, Pass, SourceFile, dotted_name

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "ml_dtypes", "cluster_tools_tpu", "h5py",
                       "tensorstore", "numcodecs", "zstandard"})
FUNCTION_ONLY = frozenset({"sklearn", "imageio"})


def _imports(tree: ast.AST) -> Iterator[Tuple[ast.AST, str, bool]]:
    """(node, top-level module, inside a function) of every absolute
    import."""

    def walk(node: ast.AST, in_fn: bool):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda))
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield child, alias.name.split(".")[0], fn
            elif isinstance(child, ast.ImportFrom) and not child.level \
                    and child.module:
                yield child, child.module.split(".")[0], fn
            elif isinstance(child, ast.Call) and dotted_name(
                    child.func) in ("importlib.import_module",
                                    "import_module", "__import__") \
                    and child.args \
                    and isinstance(child.args[0], ast.Constant) \
                    and isinstance(child.args[0].value, str):
                yield child, child.args[0].value.split(".")[0], fn
            yield from walk(child, fn)

    yield from walk(tree, False)


def _why(module: str, in_fn: bool) -> Optional[str]:
    if module in FORBIDDEN:
        return ("imports %r: the port runs without it (it imports no JAX, "
                "no JAX package and no storage library)" % module)
    if module in FUNCTION_ONLY and not in_fn:
        return ("imports %r at module level: import it inside the function "
                "that needs it (the card's machine has no %s)"
                % (module, module))
    return None


def run(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    for node, module, in_fn in _imports(sf.tree):
        why = _why(module, in_fn)
        if why:
            out.append(Finding(sf.rel, node.lineno, "port-boundary", why))
    return out


PASS = Pass(name="port-boundary", rules=("port-boundary",), run=run)
