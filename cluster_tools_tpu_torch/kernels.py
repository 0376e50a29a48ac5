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
    replaces: str       # the TPU kernel (or XLA-lowered code) it ports
    launches: int = 0


KERNELS: Dict[str, Kernel] = {
    "minplus": Kernel(
        name="minplus", route="cuda",
        source="cluster_tools_tpu_torch/csrc/minplus.cu",
        replaces="cluster_tools_tpu/ops/edt.py:53"),
    # GroupNorm + tanh GELU of the U-Net's ConvBlock (ops/norm.py): the
    # JAX package's flax nn.GroupNorm + nn.gelu, lowered by XLA (no Pallas
    # kernel); one launch = one call of the C entry point (three kernels)
    "groupnorm_gelu": Kernel(
        name="groupnorm_gelu", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="cluster_tools_tpu/models/unet.py:51-53"),
    "groupnorm_gelu_bwd": Kernel(
        name="groupnorm_gelu_bwd", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="cluster_tools_tpu/models/unet.py:51-53"),
    # the same pair with LeakyReLU or no activation, as Swin UNETR's
    # InstanceNorms run it (models/swin_unetr.py); the JAX package has no
    # such model
    "groupnorm_leaky_relu": Kernel(
        name="groupnorm_leaky_relu", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="none: InstanceNorm + LeakyReLU of Swin UNETR"),
    "groupnorm_leaky_relu_bwd": Kernel(
        name="groupnorm_leaky_relu_bwd", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="none: InstanceNorm + LeakyReLU of Swin UNETR"),
    "groupnorm_none": Kernel(
        name="groupnorm_none", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="none: InstanceNorm of Swin UNETR"),
    "groupnorm_none_bwd": Kernel(
        name="groupnorm_none_bwd", route="cuda",
        source="cluster_tools_tpu_torch/csrc/groupnorm.cu",
        replaces="none: InstanceNorm of Swin UNETR"),
}


def source_path(name: str) -> str:
    """Absolute path of a kernel's source in this checkout."""
    return os.path.join(os.path.dirname(_PKG), KERNELS[name].source)


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
