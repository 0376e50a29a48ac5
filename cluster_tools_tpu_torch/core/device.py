"""The device a device task runs on: the global config's ``"device"``
(default ``"cuda"``).  Asking for the card on a host without one raises;
nothing falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device a device task runs on.  Asking for a card that is
    not there raises: the caller asked for the card, not for the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            "set the global config's \"device\" to \"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def task_device(global_config) -> str:
    """The resolved device name of a task's global config, checked when
    the task is constructed (before any work of the DAG runs)."""
    return str(resolve_device(global_config.get("device", "cuda")))
