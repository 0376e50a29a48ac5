"""Build-at-first-use for the package's native libraries.

Both native sources of the package — the host C++ solvers
(``native/src/solvers.cpp``, g++) and the CUDA kernels (``csrc/*.cu``,
nvcc) — are compiled from the checkout the first time a process needs
them, into ``<package>/_build/``, which ``.gitignore`` lists.  The
library name embeds a hash of the sources and the compile command, so a
stale binary (from an older checkout: git does not keep mtimes) is never
loaded for edited sources.  Concurrent builders each publish a complete
file by atomic rename.  A failed build raises with the compiler's output:
no caller carries on without its library.

The built libraries are the port's counterpart of the JAX package's
executable cache: ``_build/`` is its disk tier and ``_built`` its memory
tier.  ``EXEC_CACHE_STATS`` counts each resolution under the JAX
package's key names (``compiles``: a compiler ran; ``disk_hits``: the
library was already in ``_build/``; ``hits``: resolved before in this
process), so the resident server's status JSONs show a warm request as
``hits >= 1, compiles == 0``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_built: Dict[str, str] = {}

EXEC_CACHE_STATS: Dict[str, int] = {"compiles": 0, "hits": 0,
                                    "disk_hits": 0}


class BuildError(RuntimeError):
    pass


def library_path(name: str, sources: Sequence[str],
                 cmd: Sequence[str]) -> str:
    """The content-addressed path of ``name`` built from ``sources``."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_shared(name: str, sources: Sequence[str], compiler: List[str],
                 timeout: float = 600.0) -> str:
    """Compile ``sources`` with ``compiler`` (the command without the
    sources and ``-o``) into a shared library once per content hash and
    return its path."""
    from .runtime import ledger_add

    lib = library_path(name, sources, compiler)
    # ctt-lint: disable=blocking-under-lock (the build IS the critical section: one compile of a library per process, later callers wait for it)
    with _lock:
        if lib in _built:
            EXEC_CACHE_STATS["hits"] += 1
            return lib
        if os.path.exists(lib):
            EXEC_CACHE_STATS["disk_hits"] += 1
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.tmp.{os.getpid()}"
            cmd = list(compiler) + list(sources) + ["-o", tmp]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=timeout)
            except FileNotFoundError as e:
                raise BuildError(f"cannot build {name}: compiler "
                                 f"{compiler[0]!r} not found") from e
            if res.returncode != 0:
                raise BuildError(f"building {name} failed:\n{' '.join(cmd)}"
                                 f"\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, lib)
            EXEC_CACHE_STATS["compiles"] += 1
        _built[lib] = lib
        ledger_add("exec_cache", os.path.getsize(lib), 1)
        return lib
