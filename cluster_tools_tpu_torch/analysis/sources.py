"""The source files every lint pass walks: the port's package and the
top-level script that drives it on the card (``chip_smoke.py``).

Port of cluster_tools_tpu/analysis/sources.py.
"""

from __future__ import annotations

import os
from typing import Iterator, List

#: directory names never descended into when walking package sources
EXCLUDE_DIRS = frozenset({
    "__pycache__", ".git", ".pytest_cache", ".ipynb_checkpoints", "_build",
})

#: top-level scripts of the port that live outside the package directory
TOP_LEVEL_SCRIPTS = ("chip_smoke.py",)


def package_root() -> str:
    """Absolute path of the ``cluster_tools_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    """Absolute path of the repository checkout (the package's parent)."""
    return os.path.dirname(package_root())


def iter_source_files(root: str | None = None,
                      include_scripts: bool = True) -> Iterator[str]:
    """Yield every ``.py`` file of the package (sorted, exclude-list
    honored), then the known top-level scripts.  ``root`` overrides the
    package directory (fixture corpora in tests)."""
    base = root or package_root()
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d not in EXCLUDE_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    if include_scripts and root is None:
        for script in TOP_LEVEL_SCRIPTS:
            path = os.path.join(repo_root(), script)
            if os.path.exists(path):
                yield path


def source_files(root: str | None = None,
                 include_scripts: bool = True) -> List[str]:
    return list(iter_source_files(root, include_scripts))


def relpath(path: str) -> str:
    """Repo-relative display path (what findings carry)."""
    try:
        rel = os.path.relpath(os.path.abspath(path), repo_root())
    except ValueError:          # different drive (windows) — keep absolute
        return path
    return path if rel.startswith("..") else rel
