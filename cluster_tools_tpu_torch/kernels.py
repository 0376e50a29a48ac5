"""Registry of the package's hand-written CUDA kernels and their launch
counts.

Every kernel wrapper increments its entry's ``launches`` exactly where it
launches the kernel (never on the plain PyTorch path a CPU tensor takes),
so a run can show that its device path really went through the kernels:
reset the counts, drive the path, read them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Kernel:
    name: str
    route: str          # "cuda" (CUDA C++ built with nvcc)
    source: str         # path in the repository
    replaces: str       # the TPU kernel it ports, file:line
    launches: int = 0


KERNELS: Dict[str, Kernel] = {
    "minplus": Kernel(
        name="minplus", route="cuda",
        source="cluster_tools_tpu_torch/csrc/minplus.cu",
        replaces="cluster_tools_tpu/ops/edt.py:53"),
}


def source_path(name: str) -> str:
    """Absolute path of a kernel's source in this checkout."""
    return os.path.join(os.path.dirname(_PKG), KERNELS[name].source)


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
