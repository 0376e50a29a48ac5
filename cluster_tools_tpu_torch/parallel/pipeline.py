"""Pipeline parallelism: microbatched stage execution over a mesh axis.

Port of cluster_tools_tpu/parallel/pipeline.py.  Stage ``i`` of a model
lives on shard ``i`` of the ``pipe`` axis; microbatches stream through the
GPipe schedule (``n_micro + n_stages - 1`` steps), and at every step each
stage's output hops to the next stage's shard as a real copy
(:func:`~.mesh.send`, the counterpart of ``ppermute``).  One driver
process runs the schedule; a stage computes only at the steps where it
holds a microbatch (the JAX program computes every stage every step and
masks).  Positions along the other axes (``data``) would hold replicas of
the same computation, whose result the JAX function returns replicated:
the port runs the first ``pipe`` column and returns the result on the
input's device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, _devices, axis_devices, send


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves (tensors) of dicts, lists and tuples of the
    same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params: Sequence[Any]) -> Any:
    """Stack a list of per-stage parameter trees along a new leading axis
    (the axis :func:`pipeline_apply` spreads over the pipe dimension)."""
    return tree_map(lambda *leaves: torch.stack(
        [torch.as_tensor(v) for v in leaves]), *per_stage_params)


def pipeline_apply(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh: Mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Apply ``n_stages`` chained stages to microbatched input.

    ``fn(params_i, a) -> a`` is one stage (activation-shape preserving);
    ``stage_params`` has a leading ``n_stages`` axis (see
    :func:`stack_stage_params`); ``x`` is ``(n_micro, *mb_shape)``.
    Returns ``(n_micro, *mb_shape)`` on ``x``'s device, equal to applying
    stages 0..n-1 in order to every microbatch.

    Schedule: T = n_micro + n_stages - 1 steps; at step t stage 0 takes
    microbatch t (while t < n_micro), every stage holding a microbatch
    applies ``fn`` on its shard, each result is sent to the next stage's
    shard, and the last stage emits microbatch t - (n_stages - 1).
    """
    ring = axis_devices(mesh, axis)
    n_stages, n_micro = len(ring), int(x.shape[0])
    params = [tree_map(lambda p, i=i: send(p[i], ring[i]), stage_params)
              for i in range(n_stages)]
    held: List[Optional[torch.Tensor]] = [None] * n_stages
    out: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            held[0] = send(x[t], ring[0])
        res = [fn(params[i], held[i]) if held[i] is not None else None
               for i in range(n_stages)]
        # microbatch t exits the pipe at step t + n_stages - 1
        if res[-1] is not None:
            out[t - (n_stages - 1)] = send(res[-1], x.device)
        held = [None] + [send(r, ring[i + 1]) if r is not None else None
                         for i, r in enumerate(res[:-1])]
    return torch.stack(out)


def make_pipe_mesh(n_stages: int, n_devices: Optional[int] = None,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> Mesh:
    """Mesh with a leading ``pipe`` axis of size ``n_stages`` (the rest of
    the ``n_devices`` shard devices ride a ``data`` axis)."""
    devs = _devices(devices, n_devices)
    if len(devs) % n_stages:
        raise ValueError(f"{len(devs)} devices do not split into "
                         f"{n_stages} stages")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n_stages, len(devs) // n_stages),
                ("pipe", "data"))
